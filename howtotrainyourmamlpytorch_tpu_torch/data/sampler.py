"""Deterministic episodic sampler (the port's copy of the JAX package's
``data/sampler.py``; numpy only, so its episodes are the JAX sampler's bit
for bit).

Reference: ``data.py § FewShotLearningDatasetParallel.__getitem__`` — each
episode index seeds its own RNG (``np.random.RandomState(seed + idx)``),
samples N classes from the split's pool, K support + T target images per
class, relabels classes to 0..N-1. Fixed val/test seeds ⇒ identical
evaluation episodes every epoch and across runs; the train seed stream is a
pure function of the episode index ⇒ exact resume alignment with no
worker-offset bookkeeping (SURVEY.md §7 hard-part #3: counter-based keys
derived from (split_seed, idx) instead of RNG-state-in-worker).

Omniglot class augmentation (``augment_images``): each physical class
appears as four virtual classes, one per 90° rotation (reference rotates at
load; rotation identity is part of the *class*, not a random transform).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.data.sources import source_kind
from howtotrainyourmamlpytorch_tpu_torch.meta.inner import Episode

_ROTATIONS = 4


class EpisodeSampler:
    """Maps an episode index deterministically to an Episode (numpy)."""

    def __init__(self, source, cfg: MAMLConfig, split_seed: int,
                 augment_classes: Optional[bool] = None):
        self.source = source
        self.cfg = cfg
        self.split_seed = int(split_seed)
        self.augment = (cfg.augment_images if augment_classes is None
                        else augment_classes)
        # uint8 wire format: ship raw pixels, normalize on device
        # (ops/episode.py § normalize_episode) — same math to ~1 ulp, 4x
        # fewer host->device bytes. Requires the source to expose raw pixels;
        # falls back to the host-f32 path otherwise.
        self.emit_uint8 = (cfg.transfer_images_uint8
                           and hasattr(source, "get_images_raw"))
        # Regression episodes carry per-sample float targets from the
        # source (SinusoidSource.get_targets) instead of the 0..N-1
        # class relabeling; everything else (class choice, index picks,
        # shapes) is the same deterministic stream.
        self.regression = cfg.task_type == "regression"
        if self.regression and not hasattr(source, "get_targets"):
            raise ValueError(
                f"task_type='regression' needs a source with "
                f"get_targets(); {source_kind(source)!r} has none")
        # Per-dataset normalization constants, config-resolved (defaults
        # documented at MAMLConfig.image_norm_constants / MOUNT-AUDIT.md).
        mean, inv_std, self._norm_identity = cfg.image_norm_resolved
        self._norm_mean = np.asarray(mean, np.float32)
        self._norm_inv_std = np.asarray(inv_std, np.float32)
        base = list(source.class_names)
        if self.augment:
            # Virtual class = (physical class, rotation quarter-turns).
            self.classes = [(name, rot) for name in base
                            for rot in range(_ROTATIONS)]
        else:
            self.classes = [(name, 0) for name in base]
        n = cfg.num_classes_per_set
        if len(self.classes) < n:
            raise ValueError(
                f"split has {len(self.classes)} (virtual) classes, "
                f"need {n} for {n}-way sampling")

    # -- normalization ---------------------------------------------------
    def _normalize(self, x: np.ndarray) -> np.ndarray:
        """Per-dataset affine normalization on [0,1] inputs: optional
        channel reversal, then ``(x - mean) * (1/std)`` with the
        config-resolved constants (``cfg.image_norm_constants`` — defaults
        keep grayscale in [0,1] and map RGB to [-1,1]; the exact reference
        constants are unverifiable against the empty mount, see
        MOUNT-AUDIT.md). Must stay in lockstep with the device path
        (ops/episode.py § normalize_episode)."""
        if self.cfg.reverse_channels:
            x = x[..., ::-1]
        if self._norm_identity:
            return x
        return (x - self._norm_mean) * self._norm_inv_std

    # -- episode sampling ------------------------------------------------
    def sample(self, idx: int) -> Episode:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([self.split_seed, int(idx)]))
        n, k, t = (cfg.num_classes_per_set, cfg.num_samples_per_class,
                   cfg.num_target_samples)
        h, w, c = cfg.image_shape

        chosen = rng.choice(len(self.classes), size=n, replace=False)
        dtype = np.uint8 if self.emit_uint8 else np.float32
        sx = np.empty((n, k, h, w, c), dtype)
        tx = np.empty((n, t, h, w, c), dtype)
        if self.regression:
            sy_f = np.empty((n, k), np.float32)
            ty_f = np.empty((n, t), np.float32)
        for slot, class_id in enumerate(chosen):
            name, rot = self.classes[class_id]
            avail = self.source.num_images(name)
            need = k + t
            picks = rng.choice(avail, size=need, replace=avail < need)
            if self.emit_uint8:
                imgs = self.source.get_images_raw(name, picks)
            else:
                imgs = self.source.get_images(name, picks)
            if rot:
                imgs = np.rot90(imgs, rot, axes=(1, 2)).copy()
            sx[slot] = imgs[:k]
            tx[slot] = imgs[k:]
            if self.regression:
                targets = np.asarray(
                    self.source.get_targets(name, picks), np.float32)
                sy_f[slot] = targets[:k]
                ty_f[slot] = targets[k:]

        sx = sx.reshape(n * k, h, w, c)
        tx = tx.reshape(n * t, h, w, c)
        if not self.emit_uint8:
            # Host-side normalization (uint8 mode defers the SAME math to
            # the device — ops/episode.py § normalize_episode).
            sx = self._normalize(sx)
            tx = self._normalize(tx)
        if self.regression:
            # Labels ARE the targets: float y values aligned row-for-row
            # with sx/tx, same layout as the classification relabeling.
            sy = sy_f.reshape(n * k)
            ty = ty_f.reshape(n * t)
        else:
            sy = np.repeat(np.arange(n, dtype=np.int32), k)
            ty = np.repeat(np.arange(n, dtype=np.int32), t)
        return Episode(sx, sy, tx, ty)
