"""Device-side image decode: uint8 wire pixels -> normalized f32.

Counterpart of the JAX package's ``ops/episode.py § normalize_images`` and
``§ normalize_episode``:
/255 to [0, 1], optional channel reversal, then ``(x − mean)·inv_std``
with the dataset's constants (``cfg.image_norm_resolved``). Images stay
NHWC here; float inputs pass through untouched. Requests cross to the
device as uint8 (4x fewer bytes than f32) and are decoded there. The
episode decode runs under the ``episode_normalize`` profiler label.
"""

from __future__ import annotations

import torch

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.telemetry.profiler import region


def normalize_images(cfg: MAMLConfig, x: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC pixels -> normalized f32 (f32 passes through)."""
    if x.dtype != torch.uint8:
        return x
    mean, inv_std, identity = cfg.image_norm_resolved
    xf = x.float() / 255.0
    if cfg.reverse_channels:
        xf = xf.flip(-1)
    if not identity:
        xf = ((xf - torch.tensor(mean, dtype=torch.float32, device=x.device))
              * torch.tensor(inv_std, dtype=torch.float32, device=x.device))
    return xf


def normalize_episode(cfg: MAMLConfig, ep):
    """Decode an episode batch's support and target images
    (:func:`normalize_images`); labels pass through."""
    with region("episode_normalize"):
        return ep._replace(support_x=normalize_images(cfg, ep.support_x),
                           target_x=normalize_images(cfg, ep.target_x))
