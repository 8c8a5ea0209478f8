"""Checkpoint lifecycle: the committed manifest, the sync writer and the
model registry's publish side (counterparts of the JAX package's
``ckpt/``)."""
