"""PyTorch/CUDA port of ``howtotrainyourmamlpytorch_tpu`` for one NVIDIA H100.

The JAX package beside it stays the reference; this package imports
nothing of it (nor JAX). Ported so far: few-shot serving (adapt + predict
through ``serve.engine.ServingEngine``); every backbone of the JAX
package (``models``: VGG with batch or layer norm, ResNet-12, the MLP);
meta-training
(``meta.outer``) on the episode data path (``data``); the trainer's entry
point (``experiment.ExperimentBuilder``, the ``train_maml_system`` CLI)
with checkpoints in the JAX package's format; and the batch-norm +
activation kernel written by hand in CUDA for Hopper
(``csrc/bn_act.cu``). See ROADMAP.md for what remains.
"""

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig

__all__ = ["MAMLConfig"]
