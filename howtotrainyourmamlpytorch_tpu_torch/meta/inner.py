"""Inner-loop adaptation: fast/slow split, LSLR updates and the one support
step (counterpart of the JAX ``meta/inner.py``).

Reference behavior: ``inner_loop_optimizers.py §
LSLRGradientDescentLearningRule`` (one learnable per-step learning-rate
vector per fast leaf, ``w ← w − lr[step]·g``) and
``few_shot_learning_system.py § get_inner_loop_parameter_dict`` (norm
parameters are slow unless ``enable_inner_loop_optimizable_bn_params``).

Fast weights carry a leading task axis (models/layers.py); the gradient of
the SUM over tasks of each task's support loss with respect to the
task-stacked fast weights is exactly each task's own gradient, since no
task shares a fast weight with another.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.meta.algos import HEAD_PARAM_KEYS
from howtotrainyourmamlpytorch_tpu_torch.ops.losses import task_loss_fns
from howtotrainyourmamlpytorch_tpu_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]
State = Dict[str, Any]


def split_fast_slow(cfg: MAMLConfig,
                    params: Params) -> Tuple[Params, Params]:
    """Partition top-level layers into inner-adapted ("fast") and
    meta-only ("slow"): ``norm*`` layers are slow unless
    ``enable_inner_loop_optimizable_bn_params``; under ANIL
    (``trainable == 'head'``) only the head adapts."""
    head_only = cfg.algo.trainable == "head"
    fast, slow = {}, {}
    for name, sub in params.items():
        if head_only and name not in HEAD_PARAM_KEYS:
            slow[name] = sub
        elif ("norm" in name
                and not cfg.enable_inner_loop_optimizable_bn_params):
            slow[name] = sub
        else:
            fast[name] = sub
    return fast, slow


def merge_fast_slow(fast: Params, slow: Params) -> Params:
    return {**slow, **fast}


def adapted_param_counts(cfg: MAMLConfig,
                         params: Params) -> Tuple[int, int]:
    """``(adapted, total)`` parameter counts under the config's algorithm."""
    fast, _ = split_fast_slow(cfg, params)
    count = lambda t: sum(int(x.numel()) for x in tree_leaves(t))
    return count(fast), count(params)


def lslr_init(cfg: MAMLConfig, fast_params: Params) -> Params:
    """One per-step LR vector of ``cfg.lslr_num_steps`` rows per fast leaf,
    initialized to ``task_learning_rate``."""
    k = cfg.lslr_num_steps
    return tree_map(
        lambda leaf: torch.full((k,), cfg.task_learning_rate,
                                dtype=torch.float32, device=leaf.device),
        fast_params)


def _lslr_update(fast: Params, grads: Params, lslr: Params,
                 step: int) -> Params:
    """``w ← w − lr[step] · g`` per fast leaf."""
    return tree_map(lambda w, g, lr: w - lr[step] * g, fast, grads, lslr)


def support_adapt_step(cfg: MAMLConfig, apply_fn, slow: Params,
                       lslr: Params, support_x: torch.Tensor,
                       support_y: torch.Tensor, fast: Params, bn: State,
                       step: int, *, second_order: bool,
                       support_w: Optional[torch.Tensor] = None,
                       plain: bool = False
                       ) -> Tuple[Params, State, torch.Tensor]:
    """ONE inner support step for a batch of tasks: forward → gradient
    with respect to the fast weights → LSLR update. Returns the updated
    fast weights, the new norm state and each task's support loss
    ``(T,)``.

    ``second_order`` keeps the graph of the gradient
    (``create_graph=True``) so an outer loss can differentiate through
    the update; first order detaches the incoming fast weights.
    ``support_w`` weights each support row (the serving batcher's pad
    rows carry 0)."""
    loss_fn, weighted_loss_fn, _ = task_loss_fns(cfg)
    if not second_order:
        fast = tree_map(lambda w: w.detach().requires_grad_(True), fast)
    with torch.enable_grad():
        logits, bn = apply_fn(merge_fast_slow(fast, slow), bn, support_x,
                              step, True, plain=plain)
        if support_w is None:
            task_loss = loss_fn(logits, support_y)
        else:
            task_loss = weighted_loss_fn(logits, support_y, support_w)
        grads_flat = torch.autograd.grad(task_loss.sum(), tree_leaves(fast),
                                         create_graph=second_order)
    it = iter(grads_flat)  # tree_leaves and tree_map share one order
    grads = tree_map(lambda _: next(it), fast)
    fast = _lslr_update(fast, grads, lslr, step)
    if not second_order:
        fast = tree_map(lambda w: w.detach(), fast)
        task_loss = task_loss.detach()
    return fast, bn, task_loss
