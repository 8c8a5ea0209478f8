"""PyTorch/CUDA port of ``howtotrainyourmamlpytorch_tpu`` for one NVIDIA H100.

The JAX package beside it stays the reference; this package imports
nothing of it (nor JAX). Ported so far: few-shot serving (adapt + predict
through ``serve.engine.ServingEngine``) on the VGG backbone, with the
batch-norm + activation kernel written by hand in CUDA for Hopper
(``csrc/bn_act.cu``). See ROADMAP.md for what remains.
"""

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig

__all__ = ["MAMLConfig"]
