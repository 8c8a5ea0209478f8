"""Inputs made from the seed: training episodes on the device, the
serving cell's image pool and request plans, and open-loop arrivals.

Images are uint8 pixels in (H, W, C) order, the program's wire format;
labels follow ``serve/loadlab/workloads.py § synthetic_arrays`` and the
trial leg's ``synthetic_batch`` (support labels ``class = index //
shots``, targets alike), so every task is an N-way problem with every
class present. Every seed gives the same sizes and the same set of
arrival gaps, in another order (:func:`arrivals`).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from portbench.lib.weights import generator


class Batch(NamedTuple):
    """A meta-batch: ``support_x (T, N*K, H, W, C)`` uint8, ``support_y
    (T, N*K)`` int32, ``target_x``, ``target_y`` alike."""
    support_x: torch.Tensor
    support_y: torch.Tensor
    target_x: torch.Tensor
    target_y: torch.Tensor


def labels(num_classes: int, per_class: int, tasks: int,
           device) -> torch.Tensor:
    row = torch.arange(num_classes, device=device).repeat_interleave(
        per_class)
    return row.to(torch.int32).unsqueeze(0).expand(tasks, -1).contiguous()


def train_pool(image_shape: Tuple[int, int, int], num_classes: int,
               shots: int, targets: int, tasks: int, count: int, seed: int,
               device) -> List[Batch]:
    """``count`` meta-batches of ``tasks`` tasks with distinct random
    images, drawn on ``device``. Each task has a contrast of its own
    (its pixels scaled by a factor in [0.25, 1]), so tasks differ in
    their statistics as real tasks do, and a task left out shows."""
    h, w, c = image_shape
    s, t = num_classes * shots, num_classes * targets
    g = generator(seed, device)
    pixels = torch.randint(0, 256, (count, tasks, s + t, h, w, c),
                           generator=g, device=device, dtype=torch.uint8)
    contrast = 0.25 + 0.75 * torch.rand(count, tasks, generator=g,
                                        device=device)
    for i in range(count):
        pixels[i] = (pixels[i].float() * contrast[i].view(-1, 1, 1, 1, 1)
                     ).round_().to(torch.uint8)
    sy = labels(num_classes, shots, tasks, device)
    ty = labels(num_classes, targets, tasks, device)
    return [Batch(pixels[i, :, :s], sy, pixels[i, :, s:], ty)
            for i in range(count)]


def image_pool(image_shape: Tuple[int, int, int], count: int, seed: int,
               device) -> np.ndarray:
    """``count`` random uint8 images drawn on ``device`` in one call,
    brought to the host once (requests are host arrays)."""
    g = generator(seed, device)
    return torch.randint(0, 256, (count, *image_shape), generator=g,
                         device=device, dtype=torch.uint8).cpu().numpy()


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Open-loop arrival instants in ``[0, seconds)`` at ``rate`` per
    second: ``round(rate * seconds)`` exponential gaps at evenly spaced
    quantiles (the same set for every seed), in an order drawn from the
    seed, scaled so that the last arrival falls one mean gap before the
    end."""
    n = max(int(round(rate * seconds)), 1)
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q)
    gaps = gaps[np.random.default_rng(seed).permutation(n)]
    times = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return times * (seconds * (n - 1) / n) / max(times[-1], 1e-12) \
        if n > 1 else times


def request_plan(pool_size: int, per_request: int, count: int,
                 seed: int) -> np.ndarray:
    """``(count, per_request)`` image indices, distinct within a request,
    drawn from the seed: every request gets its own images (a new
    tenant, so the adapted-params cache never hits)."""
    rng = np.random.default_rng(seed)
    keys = rng.random((count, pool_size))
    return np.argpartition(keys, per_request, axis=1)[:, :per_request]


def percentile(values, q: float) -> float:
    """Nearest-rank ``q``-quantile (``q`` in (0, 1]) of ``values``."""
    data = sorted(values)
    if not data:
        return float("nan")
    return data[max(math.ceil(q * len(data)), 1) - 1]
