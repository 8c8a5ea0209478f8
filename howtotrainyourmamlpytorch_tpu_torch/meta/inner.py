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
* ``'conv_outs'`` and ``'dots'``: the segments of ``'nothing'``, run
  under a selective policy (:class:`SavePolicy`, through
  ``checkpoint(context_fn=...)``) that keeps some op outputs from the
  forward and recomputes the rest.
  ``'conv_outs'`` keeps the outputs computed inside
  ``models/layers.py § conv_out_tag`` (the JAX package's ``conv_out``
  name: every conv, the 1x1 skip's matmul included); ``'dots'`` keeps
  every convolution and matrix product the segment runs, those of the
  inner gradient included (``jax.checkpoint_policies.dots_saveable``
  saves ``dot_general`` and ``conv_general_dilated``). The BN kernel is
  launched through ctypes between an ``aten.empty`` and its outputs, so
  no policy sees or keeps it: its ``autograd.Function`` forward, a
  fresh launch, reruns in every recompute.

MSL target batching (``msl_target_batching='on'``, JAX
``meta/inner.py:246-340``): where it is exact (MSL on, per-step BN
statistics, batch norm) the support loop only collects each step's
post-update fast weights, then ONE target forward runs over the K·T
instances (s, t), each at BN row s of task t, on the post-loop norm
state; row s of instance (s, t) is folded back into task t's state. That
forward sits outside remat, as in the JAX package, where
``jax.checkpoint`` wraps only the scan body. Elsewhere 'on', and always
'auto' and 'off', run the serial path.

The support forward, inner gradient, LSLR update and target forwards run
under the JAX package's ``named_scope`` labels as ``record_function``
ranges (``telemetry/profiler.py § region``), entered only while a
profiler records.
"""

from __future__ import annotations

import functools
from collections import defaultdict
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map as map_outputs
from torch.utils.checkpoint import checkpoint

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.meta.algos import HEAD_PARAM_KEYS
from howtotrainyourmamlpytorch_tpu_torch.models.layers import in_conv_out_tag
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


REMAT_POLICIES = ("block_outs", "conv_outs", "dots", "nothing")
# Policies that run the segments of 'nothing' (the others save more).
SEGMENT_POLICIES = ("conv_outs", "dots", "nothing")

_aten = torch.ops.aten
# What 'conv_outs' keeps inside the conv tag: the conv, or the matmul of
# the 1x1 conv's einsum.
CONV_OUT_OPS = frozenset({_aten.convolution.default, _aten.bmm.default,
                          _aten.mm.default})
# What 'dots' keeps anywhere in a segment: every convolution and matrix
# product, forward and inner gradient.
DOT_OPS = frozenset({_aten.convolution.default,
                     _aten.convolution_backward.default, _aten.mm.default,
                     _aten.bmm.default, _aten.baddbmm.default,
                     _aten.addmm.default})


def remat_policy(cfg: MAMLConfig) -> Optional[str]:
    """The remat policy the port runs (module docstring), or None when
    ``remat_inner_steps`` is off."""
    if not cfg.remat_inner_steps:
        return None
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; one "
                         f"of {list(REMAT_POLICIES)}")
    return cfg.remat_policy


class SavePolicy:
    """Which op outputs a ``'conv_outs'`` or ``'dots'`` segment keeps.
    ``saved`` counts the outputs kept in forwards."""

    def __init__(self, name: str):
        if name not in ("conv_outs", "dots"):
            raise ValueError(f"no selective policy for {name!r}")
        self.name = name
        self.saved = 0

    def keeps(self, op) -> bool:
        if self.name == "dots":
            return op in DOT_OPS
        return op in CONV_OUT_OPS and in_conv_out_tag()


def _shapes(args) -> Tuple:
    return tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor))


def _detached(out):
    return map_outputs(
        lambda t: t.detach() if isinstance(t, torch.Tensor) else t, out)


class _Keep(TorchDispatchMode):
    """A segment's forward: runs every op, keeps what the policy keeps."""

    def __init__(self, policy: SavePolicy, store):
        super().__init__()
        self.policy, self.store = policy, store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.policy.keeps(func):
            self.store[func].append((_shapes(args), _detached(out)))
            self.policy.saved += 1
        return out


class _Replay(TorchDispatchMode):
    """A segment's recompute: serves each kept op its forward output, in
    order, and runs the rest. Unlike torch's selective checkpoint it
    serves them to every recompute: under second order the inner
    ``autograd.grad`` in the forward recomputes the support forward once
    before the outer backward recomputes the whole step."""

    def __init__(self, policy: SavePolicy, store):
        super().__init__()
        self.policy, self.store = policy, store
        self.served = defaultdict(int)

    def __enter__(self):
        self.served.clear()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.policy.keeps(func):
            return func(*args, **(kwargs or {}))
        i = self.served[func]
        self.served[func] += 1
        kept = self.store[func]
        if i >= len(kept) or kept[i][0] != _shapes(args):
            raise RuntimeError(
                f"remat {self.policy.name!r}: the recompute's call {i} of "
                f"{func} does not match the forward's")
        return _detached(kept[i][1])


def segment_checkpoint(policy: str):
    """``checkpoint`` for one segment under ``policy`` (one of
    :data:`SEGMENT_POLICIES`), with its selective policy where it has
    one."""
    kwargs = dict(use_reentrant=False, preserve_rng_state=False)
    if policy != "nothing":
        save = SavePolicy(policy)

        def contexts():
            store = defaultdict(list)
            return _Keep(save, store), _Replay(save, store)
        kwargs["context_fn"] = contexts
    return functools.partial(checkpoint, **kwargs)


def msl_batched(cfg: MAMLConfig, use_msl: bool) -> bool:
    """Whether :func:`task_forward` batches the MSL target forwards: only
    under ``'on'``, and only where it is exact (JAX ``meta/inner.py:
    260-270``): a shared BN row is blended serially by every forward,
    and layer norm has no per-step rows."""
    return (cfg.msl_target_batching == "on" and use_msl
            and cfg.per_step_bn_statistics
            and cfg.norm_layer == "batch_norm")


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
    MSL runs, by default (``msl_target_batching='auto'``), the serial
    path: after each support step, a target forward at that step's BN
    row, the losses weighted by ``msl_weights``; where
    :func:`msl_batched` holds, one batched target forward after the
    loop (module docstring). Without MSL one target forward after the
    last step. ``plain`` selects the BN kernel's plain version."""
    num_tasks = episode.support_x.shape[0]
    fast0, slow0 = split_fast_slow(cfg, params)
    fast = stack_tasks(fast0, num_tasks)
    slow = stack_tasks(slow0, num_tasks)
    bn = stack_tasks(bn_state, num_tasks)
    loss_fn, _, metric_fn = task_loss_fns(cfg)
    policy = (remat_policy(cfg) if _needs_outer_graph(params, lslr)
              else None)
    segmented = policy in SEGMENT_POLICIES
    step_segment = segmented and second_order
    segment = segment_checkpoint(policy) if segmented else None
    batched = msl_batched(cfg, use_msl)

    def target_forward(fast, bn, step):
        run = merge_fast_slow(fast, slow)
        if segmented and not step_segment:
            return segment(
                lambda r, b: apply_fn(r, b, episode.target_x, step, True,
                                      plain=plain), run, bn)
        return apply_fn(run, bn, episode.target_x, step, True, plain=plain,
                        remat=policy == "block_outs")

    def inner_step(fast, bn, step):
        fast, bn, s_loss = support_adapt_step(
            cfg, apply_fn, slow, lslr, episode.support_x, episode.support_y,
            fast, bn, step, second_order=second_order, plain=plain)
        if batched or not use_msl:
            return fast, bn, s_loss, None, None
        with region("inner_msl_target_forward"):
            t_logits, bn = target_forward(fast, bn, step)
            t_loss = loss_fn(t_logits, episode.target_y)
        return fast, bn, s_loss, t_loss, t_logits

    s_losses, t_losses, fast_steps = [], [], []
    for step in range(num_steps):
        if step_segment:
            out = segment(inner_step, fast, bn, step)
        else:
            out = inner_step(fast, bn, step)
        fast, bn, s_loss, t_loss, t_logits = out
        s_losses.append(s_loss)
        t_losses.append(t_loss)
        if batched:
            fast_steps.append(fast)

    if batched:
        with region("inner_msl_target_forward"):
            per_step_t, final_logits, bn = _batched_targets(
                apply_fn, slow0, fast_steps, bn, episode, loss_fn, plain)
        loss = (msl_weights[:num_steps] * per_step_t).sum(1)
    elif use_msl:
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


def _batched_targets(apply_fn, slow0: Params, fast_steps, bn: State,
                     episode: Episode, loss_fn, plain: bool):
    """The K MSL target forwards of a batch of T tasks as ONE forward over
    K·T instances, instance (s, t) = index s·T + t: step s's fast weights
    of task t, the slow weights, task t's targets and the post-loop norm
    state at BN row s. Returns the per-step target losses ``(T, K)``,
    step K−1's logits and the norm state with row s of instance (s, t)
    folded back into task t's (JAX ``merge_rows``)."""
    k, t = len(fast_steps), episode.target_x.shape[0]
    fast = tree_map(lambda *xs: torch.cat(xs), *fast_steps)
    run = merge_fast_slow(fast, stack_tasks(slow0, k * t))
    bn_k = tree_map(lambda v: torch.cat([v] * k), bn)
    steps = torch.arange(k, device=episode.target_x.device)
    logits, bn_k = apply_fn(run, bn_k, torch.cat([episode.target_x] * k),
                            steps.repeat_interleave(t), True, plain=plain)
    per_step = loss_fn(logits, torch.cat([episode.target_y] * k)).view(
        k, t).t()

    def merge_rows(carried, stepped):
        rows = steps.clamp(0, carried.shape[1] - 1)
        out = carried.clone()
        out[:, rows] = stepped.view(k, t, *carried.shape[1:])[
            steps, :, rows].transpose(0, 1)
        return out

    return (per_step, logits.view(k, t, *logits.shape[1:])[k - 1],
            tree_map(merge_rows, bn, bn_k))


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
