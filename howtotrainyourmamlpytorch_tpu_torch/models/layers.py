"""Functional layers over task-batched fast weights, with per-step norm
state (BNRS / BNWB). Counterpart of the JAX ``models/layers.py``.

MAML adapts external "fast" weights, so every layer is a plain function
``apply(params, ..., x)`` over dicts of tensors, as in the JAX package.
Where the JAX package ``vmap``s one task's forward over a batch of tasks,
the port writes the task axis out:

* every parameter and state leaf carries a leading task axis ``T``
  (``conv w`` is ``(T, O, I, kh, kw)``, BN ``gamma`` is
  ``(T, num_steps, C)``, layer-norm ``gamma`` is ``(T, 1, H, W, C)`` in
  the JAX package's NHWC order, ``linear w`` is ``(T, out, in)``);
* activations are NCHW tensors in ``torch.channels_last`` memory format
  with the task axis folded into the channels: ``(N, T·C, H, W)``, where
  ``N`` is the examples of one task. A per-task convolution is then one
  grouped convolution (``groups=T``), and every BN input is a
  C-contiguous ``(N·H·W, T·C)`` matrix whose columns are (task, channel)
  pairs — the layout the BN kernel (ops/bn_act.py) takes.

Weights are stored in torch's layout (OIHW convs, ``(out, in)``
linears); ``convert.state_from_jax`` maps the JAX package's HWIO /
``(in, out)`` leaves onto them. Convolutions and matrix products go to
cuDNN/cuBLAS, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from howtotrainyourmamlpytorch_tpu_torch.ops.bn_act import bn_act

Params = Dict[str, Any]
State = Dict[str, Any]


# ---------------------------------------------------------------------------
# initializers (xavier-uniform weights, zero biases, BN γ=1 β=0)
# ---------------------------------------------------------------------------

def _xavier_uniform(gen: torch.Generator, shape: Tuple[int, ...],
                    fan_in: int, fan_out: int) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit


def conv2d_init(gen: torch.Generator, in_channels: int, out_channels: int,
                kernel_size: int = 3) -> Params:
    """OIHW kernel + bias (one task; no task axis)."""
    receptive = kernel_size * kernel_size
    w = _xavier_uniform(gen, (out_channels, in_channels, kernel_size,
                              kernel_size),
                        in_channels * receptive, out_channels * receptive)
    return {"w": w, "b": torch.zeros(out_channels)}


def linear_init(gen: torch.Generator, in_features: int,
                out_features: int) -> Params:
    """``(out, in)`` weight + bias (one task; no task axis)."""
    w = _xavier_uniform(gen, (out_features, in_features), in_features,
                        out_features)
    return {"w": w, "b": torch.zeros(out_features)}


def batch_norm_init(num_features: int,
                    num_steps: int) -> Tuple[Params, State]:
    """Per-step γ/β and running mean/var rows ``(num_steps, F)``."""
    params = {"gamma": torch.ones(num_steps, num_features),
              "beta": torch.zeros(num_steps, num_features)}
    state = {"mean": torch.zeros(num_steps, num_features),
             "var": torch.ones(num_steps, num_features)}
    return params, state


def layer_norm_init(normalized_shape: Tuple[int, int, int]
                    ) -> Tuple[Params, State]:
    """Elementwise γ/β over one sample's ``(H, W, C)`` features, in the
    JAX package's NHWC order, with a leading step axis of 1 (layer norm
    has no per-step variant); no state."""
    shape = (1,) + tuple(normalized_shape)
    return {"gamma": torch.ones(shape), "beta": torch.zeros(shape)}, {}


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------

def to_task_channels(x: torch.Tensor) -> torch.Tensor:
    """``(T, N, H, W, C)`` NHWC images -> ``(N, T·C, H, W)`` channels_last."""
    t, n, h, w, c = x.shape
    return (x.permute(1, 2, 3, 0, 4).reshape(n, h, w, t * c)
            .permute(0, 3, 1, 2))


def flatten_tasks(x: torch.Tensor, num_tasks: int) -> torch.Tensor:
    """``(N, T·C, H, W)`` -> ``(T, N, H·W·C)``, each task's features in
    NHWC order (the JAX package's ``reshape(N, -1)`` of an NHWC tensor)."""
    n, tc, h, w = x.shape
    c = tc // num_tasks
    return (x.permute(0, 2, 3, 1).reshape(n, h, w, num_tasks, c)
            .permute(3, 0, 1, 2, 4).reshape(num_tasks, n, h * w * c))


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding: ``ceil(size/s)`` outputs, extra pad at the end."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


# ---------------------------------------------------------------------------
# conv / linear
# ---------------------------------------------------------------------------

def conv2d_apply(params: Params, x: torch.Tensor, *, stride: int = 1,
                 padding: str = "SAME",
                 compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Per-task conv of ``(N, T·I, H, W)``: one grouped conv over the
    task axis, computed in ``compute_dtype`` (bias added inside the conv,
    where the JAX package adds it in ``compute_dtype`` after it)."""
    w = params["w"].to(compute_dtype)
    t, o, i, kh, kw = w.shape
    b = params["b"].to(compute_dtype).reshape(t * o)
    x = x.to(compute_dtype)
    if kh == kw == 1 and stride == 1:
        # A 1x1/stride-1 conv is a per-pixel matmul per task.
        n, _, h, wd = x.shape
        xs = x.permute(0, 2, 3, 1).reshape(n, h, wd, t, i)
        y = torch.einsum("nhwti,toi->nhwto", xs, w[:, :, :, 0, 0])
        y = y.reshape(n, h, wd, t * o) + b
        return y.permute(0, 3, 1, 2)
    if padding == "SAME":
        (pt, pb), (pl, pr) = (_same_pads(x.shape[2], kh, stride),
                              _same_pads(x.shape[3], kw, stride))
    else:
        pt = pb = pl = pr = 0
    if pt != pb or pl != pr:
        x = F.pad(x, (pl, pr, pt, pb))
        pad = (0, 0)
    else:
        pad = (pt, pl)
    return F.conv2d(_channels_last(x), w.reshape(t * o, i, kh, kw), b,
                    stride=stride, padding=pad, groups=t)


def linear_apply(params: Params, x: torch.Tensor, *,
                 compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``(T, N, in)`` -> ``(T, N, out)`` per-task linear, one batched
    matmul."""
    w = params["w"].to(compute_dtype)
    b = params["b"].to(compute_dtype)
    return torch.baddbmm(b.unsqueeze(1), x.to(compute_dtype),
                         w.transpose(1, 2))


# ---------------------------------------------------------------------------
# per-step batch norm (BNRS + BNWB)
# ---------------------------------------------------------------------------

def _step_row(params: Params, step: int) -> Tuple[int, torch.Tensor,
                                                  torch.Tensor]:
    """Clip ``step`` to the stored rows; γ/β of that row as ``(T·C,)``."""
    num_steps = params["gamma"].shape[1]
    idx = min(max(int(step), 0), num_steps - 1)
    return (idx, params["gamma"][:, idx].reshape(-1),
            params["beta"][:, idx].reshape(-1))


def _running_update(state: State, idx: int, mean: torch.Tensor,
                    var: torch.Tensor, count: int,
                    momentum: float) -> State:
    """torch's momentum convention at row ``idx``: ``r ← (1−m)·r + m·batch``
    with the unbiased batch variance. Running stats are tracked, never
    used to normalize, and never differentiated."""
    t, _, c = state["mean"].shape
    mean = mean.detach().reshape(t, c)
    unbiased = var.detach().reshape(t, c) * (count / max(count - 1, 1))
    new_state = {}
    for key, batch in (("mean", mean), ("var", unbiased)):
        rows = state[key].clone()
        rows[:, idx] = (1.0 - momentum) * state[key][:, idx] + momentum * batch
        new_state[key] = rows
    return new_state


def _as_matrix(x: torch.Tensor) -> torch.Tensor:
    """``(N, P, H, W)`` channels_last -> the ``(N·H·W, P)`` matrix view."""
    n, p, h, w = x.shape
    return _channels_last(x).permute(0, 2, 3, 1).reshape(n * h * w, p)


def _from_matrix(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    n, p, h, w = like.shape
    return y.view(n, h, w, p).permute(0, 3, 1, 2)


def batch_norm_apply(params: Params, state: State, x: torch.Tensor,
                     step: int, *, training: bool, momentum: float = 0.1,
                     eps: float = 1e-5,
                     fast_math: bool = False) -> Tuple[torch.Tensor, State]:
    """Batch-statistics BN of ``(N, T·C, H, W)`` with per-(task, channel)
    statistics, plus the step row's running-stat update. ``fast_math``
    folds the f32 statistics into a scale/shift applied in x's dtype;
    the default path normalizes in f32 (the exact reference path).
    ``training`` only tells the caller whether to keep the returned
    state, as in the JAX package."""
    idx, gamma, beta = _step_row(params, step)
    x2 = _as_matrix(x)
    xf = x2.float()
    mean = xf.mean(0)
    if fast_math:
        var = torch.clamp(xf.square().mean(0) - mean.square(), min=0.0)
        inv = torch.rsqrt(var + eps)
        scale = (inv * gamma).to(x.dtype)
        shift = (beta - mean * inv * gamma).to(x.dtype)
        y2 = x2 * scale + shift
    else:
        var = xf.var(0, unbiased=False)
        inv = torch.rsqrt(var + eps)
        y2 = ((xf - mean) * inv * gamma + beta).to(x.dtype)
    new_state = _running_update(state, idx, mean, var, x2.shape[0],
                                momentum)
    return _from_matrix(y2, x), new_state


def fused_batch_norm_relu_apply(
        params: Params, state: State, x: torch.Tensor, step: int, *,
        training: bool, momentum: float = 0.1, eps: float = 1e-5,
        negative_slope: float = 0.0,
        plain: bool = False) -> Tuple[torch.Tensor, State]:
    """Per-step BN + activation through the fused kernel (ops/bn_act.py):
    the ``fast_math`` numerics, activation included (callers must not
    apply their own). ``plain`` selects the kernel's plain PyTorch
    version."""
    idx, gamma, beta = _step_row(params, step)
    x2 = _as_matrix(x)
    y2, mean, var = bn_act(x2, gamma, beta, eps, negative_slope,
                           plain=plain)
    new_state = _running_update(state, idx, mean, var, x2.shape[0],
                                momentum)
    return _from_matrix(y2, x), new_state


def batch_norm_act_apply(cfg, params: Params, state: State, x: torch.Tensor,
                         step: int, *, training: bool,
                         negative_slope: float = 0.0, plain: bool = False
                         ) -> Tuple[torch.Tensor, State]:
    """BN + activation with backend dispatch (config ``bn_backend``):
    ``pallas`` is the hand-written kernel, ``composite`` plain torch."""
    if cfg.bn_backend == "pallas":
        return fused_batch_norm_relu_apply(
            params, state, x, step, training=training,
            momentum=cfg.batch_norm_momentum, eps=cfg.batch_norm_eps,
            negative_slope=negative_slope, plain=plain)
    y, new_state = batch_norm_apply(
        params, state, x, step, training=training,
        momentum=cfg.batch_norm_momentum, eps=cfg.batch_norm_eps,
        fast_math=cfg.bn_fast_math)
    if negative_slope == 0.0:
        y = F.relu(y)
    elif negative_slope != 1.0:
        y = leaky_relu(y, negative_slope)
    return y, new_state


def leaky_relu(x: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """``jax.nn.leaky_relu``: ``where(x >= 0, x, slope·x)`` with the slope
    rounded to x's dtype first, as JAX rounds its weakly typed scalar.
    (``F.leaky_relu`` multiplies a bf16 x by the f32 slope and rounds
    once, which differs in the last bit.)"""
    slope = float(torch.tensor(negative_slope, dtype=x.dtype))
    return torch.where(x >= 0, x, x * slope)


# ---------------------------------------------------------------------------
# layer norm (the reference's MetaLayerNormLayer)
# ---------------------------------------------------------------------------

def layer_norm_apply(params: Params, state: State, x: torch.Tensor,
                     step: int, *, training: bool,
                     eps: float = 1e-5) -> Tuple[torch.Tensor, State]:
    """Per-sample normalization of ``(N, T·C, H, W)``: statistics per
    (example, task) over that task's ``(H, W, C)`` features in f32, then
    the elementwise γ/β ``(T, 1, H, W, C)``, applied in their NHWC order
    on the channels_last view. ``step`` and ``training`` are unused (no
    per-step rows, no state), as in the JAX package."""
    gamma, beta = params["gamma"][:, 0], params["beta"][:, 0]
    t, h, w, c = gamma.shape
    n = x.shape[0]
    xs = _channels_last(x).permute(0, 2, 3, 1).reshape(n, h, w, t, c)
    xf = xs.float()
    mean = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = xf.var(dim=(1, 2, 4), correction=0, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * gamma.permute(1, 2, 0, 3) + beta.permute(1, 2, 0, 3)
    return (y.to(x.dtype).reshape(n, h, w, t * c).permute(0, 3, 1, 2),
            state)


def max_pool2d(x: torch.Tensor, window: int = 2,
               stride: int = 2) -> torch.Tensor:
    """2x2 max pool, VALID padding (floor), as torch's default."""
    out_h = (x.shape[-2] - window) // stride + 1
    out_w = (x.shape[-1] - window) // stride + 1
    if out_h <= 0 or out_w <= 0:
        raise ValueError(
            f"max_pool2d: input spatial dims {x.shape[-2]}x{x.shape[-1]} "
            f"too small for a {window}x{window}/stride-{stride} pool — the "
            f"network has more pooling stages than the image size supports")
    return F.max_pool2d(x, window, stride)


def global_mean_pool(x: torch.Tensor, num_tasks: int) -> torch.Tensor:
    """``(N, T·C, H, W)`` -> ``(T, N, C)``: the mean over H and W in x's
    dtype (the JAX package's ``jnp.mean(x, axis=(1, 2))``)."""
    n, tc, _, _ = x.shape
    return (x.mean(dim=(2, 3)).reshape(n, num_tasks, tc // num_tasks)
            .permute(1, 0, 2))
