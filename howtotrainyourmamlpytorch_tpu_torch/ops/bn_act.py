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
import functools
from typing import NamedTuple, Tuple

import torch

from howtotrainyourmamlpytorch_tpu_torch.ops import build

# Kernel launches since the last reset_launches(); incremented only where
# the CUDA kernel is launched.
launches = 0

# The sum order (csrc/bn_act.cu): chunks of max(256, ceil(R/65535)) rows,
# each column's chunk summed in 8 row lanes. Shared memory of a block: 16
# bytes of mbarriers, the 12 warps' lane folds (32 x 2*vec floats each),
# and for the vector path a ring of two pieces of 128 rows x 49 16-byte
# slots.
_CHUNK_ROWS = 256
_MAX_CHUNKS = 65535
_FOLD_BYTES = 12 * 32 * 2 * 4
_STAGE_BYTES = 2 * 128 * 49 * 16
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


class Plan(NamedTuple):
    """How one launch covers an ``(R, P)`` matrix (see csrc/bn_act.cu)."""
    vec: int           # elements per access: 16 bytes' worth, or 1
    blocks: int        # one per SM, all co-resident
    chunk_rows: int    # rows per chunk of the sum order
    n_chunks: int
    smem_bytes: int    # dynamic shared memory per block
    scratch_floats: int  # mean | var | scale | shift | 2 x n_chunks x P


def chunking(rows: int) -> Tuple[int, int]:
    """``(chunk_rows, n_chunks)``: the chunks whose partial sums the kernel
    adds in order."""
    chunk_rows = max(_CHUNK_ROWS, -(-rows // _MAX_CHUNKS))
    return chunk_rows, -(-rows // chunk_rows)


def slab(rows: int, blocks: int, b: int) -> Tuple[int, int]:
    """Rows ``[r0, r1)`` that block ``b`` normalizes."""
    return rows * b // blocks, rows * (b + 1) // blocks


@functools.lru_cache(maxsize=256)
def plan(rows: int, cols: int, itemsize: int, aligned: bool,
         blocks: int) -> Plan:
    """The launch plan for ``rows x cols`` elements of ``itemsize`` bytes
    on a card with ``blocks`` SMs; ``aligned``: x's data is 16-byte
    aligned. Pure integer arithmetic (the CPU tests pin it)."""
    wide = 16 // itemsize
    vec = wide if aligned and cols % wide == 0 else 1
    chunk_rows, n_chunks = chunking(rows)
    return Plan(vec=vec, blocks=blocks, chunk_rows=chunk_rows,
                n_chunks=n_chunks,
                smem_bytes=(16 + _FOLD_BYTES * vec
                            + (_STAGE_BYTES if vec > 1 else 0)),
                scratch_floats=4 * cols + 2 * n_chunks * cols)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            eps: float, slope: float
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on x's device's current stream: one device
    kernel. ``mean`` and ``var`` are views of its one scratch buffer."""
    global launches
    _check(x, gamma, beta)
    gamma, beta = gamma.contiguous(), beta.contiguous()
    r, p = x.shape
    index = x.device.index
    pl = plan(r, p, x.element_size(), x.data_ptr() % 16 == 0,
              _sm_count(index))
    y = torch.empty_like(x)
    scratch = torch.empty(pl.scratch_floats, dtype=torch.float32,
                          device=x.device)
    fn = _kernel_fn()
    # The launch goes to the calling thread's current device: make it x's
    # for the call (what torch.cuda.device does, without its wrapper).
    prev = torch.cuda._exchange_device(index)
    try:
        # The kernel rounds the slope to x's dtype (jnp.asarray(slope,
        # y.dtype) in the reference).
        err = fn(x.data_ptr(), y.data_ptr(), gamma.data_ptr(),
                 beta.data_ptr(), scratch.data_ptr(), r, p,
                 _DTYPE_CODES[x.dtype], eps, slope, pl.vec, pl.blocks,
                 pl.chunk_rows, pl.n_chunks, pl.smem_bytes,
                 torch._C._cuda_getCurrentRawStream(index))
    finally:
        torch.cuda._maybe_exchange_device(prev)
    if err != 0:
        raise RuntimeError(f"bn_act kernel launch failed: CUDA error {err}")
    launches += 1
    return y, scratch[:p], scratch[p:2 * p]


def _kernel_fn():
    fn = build.load("bn_act").lib.bn_act_forward
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong, i32, i32,
                       ctypes.c_float, ctypes.c_float, i32, i32, i32, i32,
                       i32, vp]
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
    version (autograd through its ops); otherwise :class:`BnActFunction`,
    or on a CUDA tensor that needs no gradient the kernel alone."""
    if plain:
        return bn_act_plain(x, gamma, beta, eps, slope)
    if x.is_cuda and not (torch.is_grad_enabled() and (
            x.requires_grad or gamma.requires_grad or beta.requires_grad)):
        return _launch(x, gamma, beta, eps, slope)   # no graph to record
    return BnActFunction.apply(x, gamma, beta, eps, slope)
