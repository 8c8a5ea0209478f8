"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. With no
CUDA device and no explicit ``device="cpu"`` they raise: the port never
falls back to the CPU on its own.

:func:`numerics_policy` is the card's numerics for an entry point: f32
configs compute in f32 (TF32 off), and the trainer's cuDNN runs
deterministic algorithms, so a paused and resumed run is bitwise the
uninterrupted one, as the JAX package's resume contract is.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card (``cuda``); a CUDA device that is not
    there raises instead of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless "
            "the caller passes device='cpu'")
    return dev


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def numerics_policy(compute_dtype: str, *,
                    deterministic: bool) -> Iterator[None]:
    """TF32 off for cuDNN convolutions and cuBLAS matrix products when
    ``compute_dtype`` is ``"float32"`` (torch's default lets cuDNN round
    their inputs to 10 mantissa bits), and with ``deterministic`` cuDNN's
    deterministic algorithms without autotuning (``cudnn.deterministic``,
    ``cudnn.benchmark=False``). bf16 configs keep the TF32 flags as they
    are. The flags are torch's process-wide settings (they change nothing
    on the CPU); their previous values come back on exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
             cudnn.benchmark)
    try:
        if compute_dtype == "float32":
            cudnn.allow_tf32 = False
            matmul.allow_tf32 = False
        if deterministic:
            cudnn.deterministic = True
            cudnn.benchmark = False
        yield
    finally:
        (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
         cudnn.benchmark) = saved
