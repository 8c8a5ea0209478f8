"""Inner-loop adaptation: fast/slow split, LSLR updates, the support step,
the multi-step loss and the per-task forward (counterpart of the JAX
``meta/inner.py``).

Reference behavior: ``inner_loop_optimizers.py §
LSLRGradientDescentLearningRule`` (one learnable per-step learning-rate
vector per fast leaf, ``w ← w − lr[step]·g``),
``few_shot_learning_system.py § forward`` (K support steps, MSL-weighted or
final-step target loss), ``§ get_per_step_loss_importance_vector`` (the
MSL schedule) and ``§ get_inner_loop_parameter_dict`` (norm parameters are
slow unless ``enable_inner_loop_optimizable_bn_params``).

The task axis is written out (models/layers.py): a chunk of T tasks is one
task-batched forward over ``tree.stack_tasks`` views of the shared
parameters. The gradient of the SUM over tasks of each task's support loss
with respect to the task-stacked fast weights is each task's own gradient,
since no task shares a fast weight with another; the outer gradient
through the ``expand`` sums the per-task gradients onto the shared leaf.

First order is ``torch.autograd.grad(create_graph=False)``: the inner
gradients are constants to the outer differentiation (the JAX package's
``stop_gradient`` on the gradients), while the fast weights stay in the
outer graph, so the outer gradient still reaches θ through the identity
path of ``w − lr·g`` and each LSLR vector through ``−g``.

Remat (``remat_inner_steps``) uses ``torch.utils.checkpoint`` without
reentry, and only where an outer backward will run:

* ``'block_outs'`` (default): the target forwards run with one checkpoint
  segment per VGG stage or ResNet-12 residual block (the segment inputs,
  i.e. the pooled block outputs, are what stays saved; the MLP has no
  blocks and runs none). Support forwards are not checkpointed: under
  first order no outer backward reads them, and under second order the
  inner ``autograd.grad(create_graph=True)`` unpacks their saved tensors
  at once and the double-backward graph keeps what it unpacked.
* ``'nothing'``: under second order the whole inner step (support
  forward, inner gradient, update, MSL target forward) is one segment,
  as ``jax.checkpoint(policy=nothing_saveable)``; under first order each
  target forward is one segment.
* ``'conv_outs'`` / ``'dots'`` raise ``NotImplementedError``.

The support forward, inner gradient, LSLR update and target forwards run
under the JAX package's ``named_scope`` labels as ``record_function``
ranges (``telemetry/profiler.py § region``), entered only while a
profiler records.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.meta.algos import HEAD_PARAM_KEYS
from howtotrainyourmamlpytorch_tpu_torch.ops.losses import task_loss_fns
from howtotrainyourmamlpytorch_tpu_torch.telemetry.profiler import region
from howtotrainyourmamlpytorch_tpu_torch.tree import (stack_tasks,
                                                      tree_leaves, tree_map)

Params = Dict[str, Any]
State = Dict[str, Any]


class Episode(NamedTuple):
    """A batch of few-shot tasks, images NHWC with a leading task axis:
    ``support_x (T, N*K, H, W, C)``, ``support_y (T, N*K)`` int32 class
    ids in ``[0, N)`` (float32 targets for regression), ``target_x (T,
    N*Q, H, W, C)``, ``target_y (T, N*Q)``. The sampler fills it with
    numpy arrays, the loader with tensors on the device."""
    support_x: Any
    support_y: Any
    target_x: Any
    target_y: Any


class TaskResult(NamedTuple):
    """Per-task results of :func:`task_forward`, each with a leading task
    axis ``T``."""
    loss: torch.Tensor                    # (T,) meta-loss
    target_logits: torch.Tensor           # (T, N*Q, N) final-step logits
    target_accuracy: torch.Tensor         # (T,)
    support_loss: torch.Tensor            # (T,) mean over inner steps
    bn_state: State                       # post-task norm state, (T, ...)
    per_step_target_losses: torch.Tensor  # (T, K); zeros when MSL is off
    per_step_support_losses: torch.Tensor  # (T, K) pre-update losses


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


def per_step_loss_importance(cfg: MAMLConfig, epoch,
                             device=None) -> torch.Tensor:
    """MSL importance weights ``(K,)`` f32 for ``epoch``: start uniform
    ``1/K``; each epoch move ``1/(K·msl_epochs)`` of mass from every
    non-final step to the final one; floor non-final weights at
    ``0.03/K`` and cap the final weight to match."""
    k = cfg.number_of_training_steps_per_iter
    epoch = torch.tensor(float(epoch), dtype=torch.float32, device=device)
    decay = 1.0 / k / cfg.multi_step_loss_num_epochs
    min_nonfinal = 0.03 / k
    nonfinal = torch.clamp(1.0 / k - epoch * decay, min=min_nonfinal)
    final = torch.clamp(1.0 / k + epoch * (k - 1) * decay,
                        max=1.0 - (k - 1) * min_nonfinal)
    idx = torch.arange(k, device=device)
    return torch.where(idx == k - 1, final, nonfinal)


def remat_policy(cfg: MAMLConfig) -> Optional[str]:
    """The remat policy the port runs (module docstring), or None when
    ``remat_inner_steps`` is off."""
    if not cfg.remat_inner_steps:
        return None
    policy = cfg.remat_policy
    if policy in ("conv_outs", "dots"):
        raise NotImplementedError(
            f"remat_policy={policy!r} needs selective checkpointing, not "
            f"ported yet (ROADMAP.md, Queue 1: remat policies "
            f"'conv_outs'/'dots'); use 'block_outs' or 'nothing'")
    if policy not in ("block_outs", "nothing"):
        raise ValueError(f"unknown remat_policy {policy!r}; one of "
                         f"['block_outs', 'conv_outs', 'dots', 'nothing']")
    return policy


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
    ``(T,)`` (detached: it is a metric, never part of the meta-loss).

    ``second_order`` keeps the graph of the gradient
    (``create_graph=True``); first order takes the gradient as a
    constant. Either way the update is computed from the incoming fast
    weights, so it stays in whatever outer graph they carry. Fast weights
    that need no gradient (serving, evaluation) get detached leaves for
    the inner gradient, and their update then builds no graph.
    ``support_w`` weights each support row (the serving batcher's pad
    rows carry 0)."""
    loss_fn, weighted_loss_fn, _ = task_loss_fns(cfg)
    leaves = tree_map(
        lambda w: w if w.requires_grad else w.detach().requires_grad_(True),
        fast)
    with torch.enable_grad():
        with region("inner_support_forward"):
            logits, bn = apply_fn(merge_fast_slow(leaves, slow), bn,
                                  support_x, step, True, plain=plain)
            if support_w is None:
                task_loss = loss_fn(logits, support_y)
            else:
                task_loss = weighted_loss_fn(logits, support_y, support_w)
        with region("inner_support_grad"):
            grads_flat = torch.autograd.grad(task_loss.sum(),
                                             tree_leaves(leaves),
                                             create_graph=second_order)
    it = iter(grads_flat)  # tree_leaves and tree_map share one order
    grads = tree_map(lambda _: next(it), fast)
    with region("inner_lslr_update"):
        fast = _lslr_update(fast, grads, lslr, step)
    return fast, bn, task_loss.detach()


def _needs_outer_graph(*trees) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for tree in trees for t in tree_leaves(tree))


def task_forward(cfg: MAMLConfig, apply_fn, params: Params, lslr: Params,
                 bn_state: State, episode: Episode, *, num_steps: int,
                 second_order: bool, use_msl: bool,
                 msl_weights: Optional[torch.Tensor],
                 plain: bool = False) -> TaskResult:
    """Adapt a batch of tasks and return each task's meta-loss.

    ``params``/``lslr``/``bn_state`` are shared (no task axis); the
    episode's tensors carry the task axis and are already normalized.
    MSL runs the serial path of the JAX package's default
    ``msl_target_batching='auto'``: after each support step, a target
    forward at that step's BN row, the losses weighted by
    ``msl_weights``. Without MSL one target forward after the last step.
    ``plain`` selects the BN kernel's plain version."""
    if cfg.msl_target_batching == "on":
        raise NotImplementedError(
            "msl_target_batching='on' (batched MSL target forwards) is not "
            "ported yet (ROADMAP.md, Queue 1: batched MSL targets); the "
            "default 'auto' runs the serial path")
    num_tasks = episode.support_x.shape[0]
    fast0, slow0 = split_fast_slow(cfg, params)
    fast = stack_tasks(fast0, num_tasks)
    slow = stack_tasks(slow0, num_tasks)
    bn = stack_tasks(bn_state, num_tasks)
    loss_fn, _, metric_fn = task_loss_fns(cfg)
    policy = (remat_policy(cfg) if _needs_outer_graph(params, lslr)
              else None)
    step_segment = policy == "nothing" and second_order

    def target_forward(fast, bn, step):
        run = merge_fast_slow(fast, slow)
        if policy == "nothing" and not step_segment:
            return checkpoint(
                lambda r, b: apply_fn(r, b, episode.target_x, step, True,
                                      plain=plain),
                run, bn, use_reentrant=False, preserve_rng_state=False)
        return apply_fn(run, bn, episode.target_x, step, True, plain=plain,
                        remat=policy == "block_outs")

    def inner_step(fast, bn, step):
        fast, bn, s_loss = support_adapt_step(
            cfg, apply_fn, slow, lslr, episode.support_x, episode.support_y,
            fast, bn, step, second_order=second_order, plain=plain)
        if not use_msl:
            return fast, bn, s_loss, None, None
        with region("inner_msl_target_forward"):
            t_logits, bn = target_forward(fast, bn, step)
            t_loss = loss_fn(t_logits, episode.target_y)
        return fast, bn, s_loss, t_loss, t_logits

    s_losses, t_losses = [], []
    for step in range(num_steps):
        if step_segment:
            out = checkpoint(inner_step, fast, bn, step, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            out = inner_step(fast, bn, step)
        fast, bn, s_loss, t_loss, t_logits = out
        s_losses.append(s_loss)
        t_losses.append(t_loss)

    if use_msl:
        per_step_t = torch.stack(t_losses, dim=1)          # (T, K)
        loss = (msl_weights[:num_steps] * per_step_t).sum(1)
        final_logits = t_logits
    else:
        with region("final_target_forward"):
            final_logits, bn = target_forward(fast, bn, num_steps - 1)
            loss = loss_fn(final_logits, episode.target_y)
        per_step_t = torch.zeros(num_tasks, num_steps,
                                 device=final_logits.device)
    per_step_s = torch.stack(s_losses, dim=1)
    return TaskResult(
        loss=loss, target_logits=final_logits,
        target_accuracy=metric_fn(final_logits.detach(), episode.target_y),
        support_loss=per_step_s.mean(1), bn_state=bn,
        per_step_target_losses=per_step_t.detach(),
        per_step_support_losses=per_step_s)


def reptile_task_forward(cfg: MAMLConfig, apply_fn, params: Params,
                         lslr: Params, bn_state: State, episode: Episode,
                         *, num_steps: int, plain: bool = False
                         ) -> Tuple[TaskResult, Params]:
    """Adapt a batch of tasks first order and return ``(TaskResult,
    delta)`` with ``delta = θ − φ`` per task over the fast leaves
    (Reptile's interpolation "gradient", Nichol et al. 2018). Nothing here
    is differentiated; the target forward only reports loss and
    accuracy."""
    num_tasks = episode.support_x.shape[0]
    fast0, slow0 = split_fast_slow(cfg, params)
    slow = stack_tasks(slow0, num_tasks)
    fast = stack_tasks(fast0, num_tasks)
    bn = stack_tasks(bn_state, num_tasks)
    loss_fn, _, metric_fn = task_loss_fns(cfg)
    s_losses = []
    with torch.no_grad():
        for step in range(num_steps):
            fast, bn, s_loss = support_adapt_step(
                cfg, apply_fn, slow, lslr, episode.support_x,
                episode.support_y, fast, bn, step, second_order=False,
                plain=plain)
            s_losses.append(s_loss)
        with region("final_target_forward"):
            final_logits, bn = apply_fn(merge_fast_slow(fast, slow), bn,
                                        episode.target_x, num_steps - 1,
                                        True, plain=plain)
        delta = tree_map(lambda a, b: a - b, stack_tasks(fast0, num_tasks),
                         fast)
    per_step_s = torch.stack(s_losses, dim=1)
    result = TaskResult(
        loss=loss_fn(final_logits, episode.target_y),
        target_logits=final_logits,
        target_accuracy=metric_fn(final_logits, episode.target_y),
        support_loss=per_step_s.mean(1), bn_state=bn,
        per_step_target_losses=torch.zeros(num_tasks, num_steps,
                                           device=final_logits.device),
        per_step_support_losses=per_step_s)
    return result, delta
