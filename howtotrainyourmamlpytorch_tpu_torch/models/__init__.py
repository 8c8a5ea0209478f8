"""Functional models over task-batched fast weights."""

from howtotrainyourmamlpytorch_tpu_torch.models.vgg import make_model

__all__ = ["make_model"]
