"""Fused batch-statistics BN + activation: the Hopper kernel and its
plain PyTorch version.

Replaces the TPU kernel ``howtotrainyourmamlpytorch_tpu/ops/pallas_fused.py
§ _kernel`` (public entry ``fused_bn_relu``). It computes the same function
on a C-contiguous ``(R, P)`` matrix with statistics per column: with a
channels_last activation and the task axis folded into the channels,
``P = T·C`` and ``R = N·H·W``, so one launch normalizes every task of a
batch with that task's own statistics (the JAX package's per-task
``vmap``). There is no lane repack and no shape gate: any ``R ≥ 1`` and
``P ≥ 1``.

* :func:`bn_act_plain` — plain PyTorch, differentiable by autograd, the
  same numerics as the JAX package's ``_bn_relu_reference``: f32
  statistics via E[x²]−E[x]² (clamped at 0), scale/shift rounded to
  x's dtype, ``x·scale`` and ``+shift`` each rounded to x's dtype, then
  ``where(y > 0, y, y·slope)`` (slope 0 = relu, 0.1 = leaky, 1 = none).
* :class:`BnActFunction` — ``torch.autograd.Function``. Its forward
  launches the CUDA kernel (``csrc/bn_act.cu``) on a CUDA tensor, or runs
  the plain version on a CPU tensor; its backward is the VJP of the JAX
  package's tangent rule ``_fused_bn_relu_jvp`` in plain differentiable
  torch ops (the ``var > 0`` clamp gate and the ``y > 0`` activation mask
  included), so ``create_graph=True`` composes through it.
* :func:`bn_act` — the entry the model calls; ``plain=True`` selects the
  plain version on any device (the tests and ``chip_smoke.py`` compare
  the kernel with it on the card).

``launches`` counts kernel launches: one per :func:`_launch` call.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from howtotrainyourmamlpytorch_tpu_torch.ops import build

# Kernel launches since the last reset_launches(); incremented only where
# the CUDA kernel is launched.
launches = 0

# Rows per stats block: chunks are summed in a fixed order by the finalize
# pass, so statistics are bitwise reproducible from run to run.
_CHUNK_ROWS = 256
_MAX_CHUNKS = 65535          # the stats grid's y extent
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    global launches
    launches = 0


def _act(y: torch.Tensor, slope: float) -> torch.Tensor:
    if slope == 1.0:
        return y
    # slope in y's dtype, as the reference's jnp.asarray(slope, y.dtype).
    return torch.where(y > 0, y, y * torch.tensor(slope, dtype=y.dtype,
                                                  device=y.device))


def bn_act_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 eps: float, slope: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(y, mean, var)`` for an ``(R, P)`` matrix,
    statistics per column; mean/var f32 (biased var)."""
    xf = x.float()
    mean = xf.mean(0)
    var = torch.clamp(xf.square().mean(0) - mean.square(), min=0.0)
    inv = torch.rsqrt(var + eps)
    scale = (inv * gamma).to(x.dtype)
    shift = (beta - mean * inv * gamma).to(x.dtype)
    return _act(x * scale + shift, slope), mean, var


def _check(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> None:
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"bn_act takes a C-contiguous (R, P) matrix, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"bn_act takes float32 or bfloat16, got {x.dtype}")
    r, p = x.shape
    if r < 1 or p < 1:
        raise ValueError(f"bn_act needs R >= 1 and P >= 1, got {(r, p)}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if (t.shape != (p,) or t.dtype != torch.float32
                or t.device != x.device):
            raise ValueError(f"{name} must be ({p},) float32 on {x.device}, "
                             f"got {tuple(t.shape)} {t.dtype} {t.device}")


def _launch(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            eps: float, slope: float
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``."""
    global launches
    _check(x, gamma, beta)
    gamma, beta = gamma.contiguous(), beta.contiguous()
    r, p = x.shape
    chunk_rows = max(_CHUNK_ROWS, -(-r // _MAX_CHUNKS))
    n_chunks = -(-r // chunk_rows)
    y = torch.empty_like(x)
    mean = torch.empty(p, dtype=torch.float32, device=x.device)
    var = torch.empty(p, dtype=torch.float32, device=x.device)
    partial = torch.empty(2 * n_chunks * p, dtype=torch.float32,
                          device=x.device)
    coef = torch.empty(2 * p, dtype=torch.float32, device=x.device)
    # The slope is applied in x's dtype (jnp.asarray(slope, y.dtype)).
    slope_t = float(torch.tensor(slope, dtype=x.dtype))
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), gamma.data_ptr(),
                 beta.data_ptr(), mean.data_ptr(), var.data_ptr(),
                 partial.data_ptr(), coef.data_ptr(), r, p, chunk_rows,
                 _DTYPE_CODES[x.dtype], float(eps), slope_t, stream)
    if err != 0:
        raise RuntimeError(f"bn_act kernel launch failed: CUDA error {err}")
    launches += 1
    return y, mean, var


def _kernel_fn():
    fn = build.load("bn_act").lib.bn_act_forward
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return fn


def bn_act_vjp(x, gamma, mean, var, y, gy, gm, gv, eps: float,
               slope: float):
    """VJP of ``_fused_bn_relu_jvp`` (pallas_fused.py:232): cotangents of
    ``(y, mean, var)`` -> cotangents of ``(x, gamma, beta)``, in plain
    differentiable torch ops on the primal's saved tensors."""
    n = x.shape[0]
    xf = x.float()
    g = gy.float()
    if slope != 1.0:
        g = g * torch.where(y > 0, 1.0, slope)
    inv = torch.rsqrt(var + eps)
    scale = inv * gamma
    g_shift = g.sum(0)
    g_scale = (g * xf).sum(0) - g_shift * mean
    g_gamma = g_scale * inv
    g_var = g_scale * gamma * (-0.5 * inv * inv * inv)
    if gv is not None:
        g_var = g_var + gv
    g_var = torch.where(var > 0.0, g_var, 0.0)   # the primal's clamp gate
    g_mean = -g_shift * scale - 2.0 * mean * g_var
    if gm is not None:
        g_mean = g_mean + gm
    gx = g * scale + (2.0 / n) * xf * g_var + g_mean / n
    return gx.to(x.dtype), g_gamma, g_shift


class BnActFunction(torch.autograd.Function):
    """Kernel forward (CUDA tensor) or plain forward (CPU tensor); the
    hand-written VJP backward either way."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float, slope: float):
        if x.is_cuda:
            y, mean, var = _launch(x, gamma, beta, eps, slope)
        else:
            y, mean, var = bn_act_plain(x, gamma, beta, eps, slope)
        ctx.save_for_backward(x, gamma, mean, var, y)
        ctx.eps, ctx.slope = eps, slope
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, gm, gv):
        x, gamma, mean, var, y = ctx.saved_tensors
        gx, g_gamma, g_beta = bn_act_vjp(x, gamma, mean, var, y, gy, gm, gv,
                                         ctx.eps, ctx.slope)
        return gx, g_gamma, g_beta, None, None


def bn_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           eps: float = 1e-5, slope: float = 0.0, *, plain: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(act(batch_norm(x)·gamma + beta), mean, var)`` with statistics per
    column of the ``(R, P)`` matrix ``x``. ``plain=True`` runs the plain
    version (autograd through its ops); otherwise :class:`BnActFunction`."""
    if plain:
        return bn_act_plain(x, gamma, beta, eps, slope)
    return BnActFunction.apply(x, gamma, beta, eps, slope)
