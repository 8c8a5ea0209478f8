"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. With no
CUDA device and no explicit ``device="cpu"`` they raise: the port never
falls back to the CPU on its own.

:func:`numerics_policy` is the card's numerics for an entry point: f32
configs compute in f32 (TF32 off), and the trainer's cuDNN runs
deterministic algorithms, so a paused and resumed run is bitwise the
uninterrupted one, as the JAX package's resume contract is.

The backend-option channel (:data:`BACKEND_OPTIONS`) is the port's
counterpart of the JAX package's XLA compiler options: the config key
``xla_compiler_options`` names switches of the card's libraries, and
:func:`numerics_policy` applies them. An unknown key or value raises
``ValueError`` with :data:`NO_SUCH_OPTION` at the start of its message,
as PJRT reports an unknown compile option.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Mapping, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]

# The switches a tuned config may set (``xla_compiler_options``), each to
# "true" or "false", and the ``torch.backends.cudnn`` flag it sets. TF32
# and the f32 numerics are not options: an f32 config always computes in
# f32.
BACKEND_OPTIONS: Dict[str, str] = {
    "cudnn_deterministic": "deterministic",
    "cudnn_benchmark": "benchmark",
}
BACKEND_OPTION_VALUES = {"true": True, "false": False}
# The start of the message an unknown option raises with (the autotune
# harness counts such a trial as an invalid flag).
NO_SUCH_OPTION = "No such backend option"


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


def parse_backend_options(options: Optional[Mapping[str, str]]
                          ) -> Dict[str, bool]:
    """``{cudnn flag: value}`` for a ``{option: "true"|"false"}`` mapping
    (``cfg.xla_compiler_options_dict``); an unknown option or value
    raises ``ValueError`` starting with :data:`NO_SUCH_OPTION`."""
    flags: Dict[str, bool] = {}
    for key, raw in (options or {}).items():
        value = BACKEND_OPTION_VALUES.get(str(raw).strip().lower())
        if key not in BACKEND_OPTIONS or value is None:
            raise ValueError(
                f"{NO_SUCH_OPTION}: {key}={raw!r} (the port's options are "
                f"{sorted(BACKEND_OPTIONS)}, each true or false)")
        flags[BACKEND_OPTIONS[key]] = value
    return flags


def resume_is_bitwise(options: Optional[Mapping[str, str]]) -> bool:
    """Whether a trainer under these backend options keeps the resume
    contract of :func:`numerics_policy` (``deterministic=True``): cuDNN's
    deterministic algorithms without autotuning. ``cudnn_deterministic=
    false`` lets cuDNN pick algorithms whose sums vary run to run, and
    ``cudnn_benchmark=true`` picks them by timing in each process, so a
    resumed run may then differ from the uninterrupted one."""
    flags = parse_backend_options(options)
    return flags.get("deterministic", True) and not flags.get(
        "benchmark", False)


@contextlib.contextmanager
def numerics_policy(compute_dtype: str, *, deterministic: bool,
                    options: Optional[Mapping[str, str]] = None
                    ) -> Iterator[None]:
    """TF32 off for cuDNN convolutions and cuBLAS matrix products when
    ``compute_dtype`` is ``"float32"`` (torch's default lets cuDNN round
    their inputs to 10 mantissa bits), and with ``deterministic`` cuDNN's
    deterministic algorithms without autotuning (``cudnn.deterministic``,
    ``cudnn.benchmark=False``). bf16 configs keep the TF32 flags as they
    are. ``options`` (the config's backend options) then set the cuDNN
    flags they name, over ``deterministic``'s (:func:`resume_is_bitwise`
    says whether they keep its contract); they are checked before
    anything is set. The flags
    are torch's process-wide settings (they change nothing on the CPU);
    their previous values come back on exit."""
    flags = parse_backend_options(options)
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
        for name, value in flags.items():
            setattr(cudnn, name, value)
        yield
    finally:
        (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
         cudnn.benchmark) = saved
