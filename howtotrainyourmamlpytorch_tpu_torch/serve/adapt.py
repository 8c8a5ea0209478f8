"""Serving compute: adapt-only inner loop + batched query predict
(counterpart of the JAX ``serve/adapt.py``).

The adapt path is :func:`meta.inner.support_adapt_step` — the same update
the training inner loop uses — run first-order, with no target forwards
and no meta-loss. The JAX package ``vmap``s one task over the batch; here
the task axis is written out (models/layers.py): one batched forward
adapts every task of the batch with its own statistics and fast weights,
on one card.

``plain=True`` runs the BN kernel's plain PyTorch version instead of the
kernel (bn_backend='pallas'), so a caller can compare the two on the card.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.meta.inner import (
    merge_fast_slow, split_fast_slow, support_adapt_step)
from howtotrainyourmamlpytorch_tpu_torch.ops.episode import normalize_images
from howtotrainyourmamlpytorch_tpu_torch.telemetry.profiler import region
from howtotrainyourmamlpytorch_tpu_torch.tree import stack_tasks

Params = Dict[str, Any]
State = Dict[str, Any]


class AdaptedTask(NamedTuple):
    """Adaptation result; leaves carry a leading task axis when produced by
    :func:`adapt_task`. ``fast`` holds only the inner-adapted leaves: the
    slow leaves stay in the engine's state and are merged back at predict
    time."""
    fast: Params
    bn_state: State
    support_loss: torch.Tensor


def adapt_task(cfg: MAMLConfig, apply_fn, params: Params, lslr: Params,
               bn_state: State, support_x: torch.Tensor,
               support_y: torch.Tensor, support_w: torch.Tensor, *,
               num_steps: int, plain: bool = False) -> AdaptedTask:
    """Adapt a batch of tasks: K first-order support steps, nothing else.

    ``support_x`` is ``(T, S, H, W, C)`` (uint8 wire pixels or f32),
    ``support_y``/``support_w`` are ``(T, S)``; ``params``/``lslr``/
    ``bn_state`` are the shared meta-state (no task axis)."""
    num_tasks = support_x.shape[0]
    with region("serve_adapt"):
        support_x = normalize_images(cfg, support_x)
        fast0, slow = split_fast_slow(cfg, params)
        fast = stack_tasks(fast0, num_tasks)
        slow = stack_tasks(slow, num_tasks)
        bn = stack_tasks(bn_state, num_tasks)
        losses = []
        for step in range(num_steps):
            fast, bn, s_loss = support_adapt_step(
                cfg, apply_fn, slow, lslr, support_x, support_y, fast, bn,
                step, second_order=False, support_w=support_w, plain=plain)
            losses.append(s_loss)
    return AdaptedTask(fast=fast, bn_state=bn,
                       support_loss=torch.stack(losses).mean(0))


def predict_tasks(cfg: MAMLConfig, apply_fn, params: Params, fast: Params,
                  bn_state: State, query_x: torch.Tensor, *, num_steps: int,
                  plain: bool = False) -> torch.Tensor:
    """Query logits ``(T, Q, N)`` under each task's adapted fast weights
    and norm state (task-stacked), at the last adapt step's BN row."""
    _, slow = split_fast_slow(cfg, params)
    run = merge_fast_slow(fast, stack_tasks(slow, query_x.shape[0]))
    with torch.no_grad(), region("serve_predict"):
        logits, _ = apply_fn(run, bn_state, normalize_images(cfg, query_x),
                             num_steps - 1, True, plain=plain)
    return logits
