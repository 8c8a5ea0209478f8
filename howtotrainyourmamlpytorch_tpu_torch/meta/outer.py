"""Outer (meta) step: task-batched meta-gradients, gradient accumulation
over task microbatches, Adam with the epoch-granular cosine meta-LR, the
per-parameter clamp, and the evaluation step (counterpart of the JAX
``meta/outer.py``).

Reference behavior (``few_shot_learning_system.py``): the meta-loss is the
mean over the meta-batch of per-task losses; ``meta_update`` is Adam on
(slow weights ∪ LSLR vectors ∪ per-step γ/β) with an optional ±clamp of
the network's gradients (ImageNet runs); the meta-LR follows
``CosineAnnealingLR`` stepped per epoch; evaluation adapts with the
evaluation step count, final-step loss only, no outer gradient, and
discards the norm-state changes.

Also the checkpoint-load helpers :func:`migrate_lslr_rows`,
:func:`state_leaf_shapes` and :func:`reconcile_loaded_shapes`.

Adam is written out functionally in ``optax.adam``'s order of operations,
its state held as ``mu``/``nu`` trees over ``{"params", "lslr"}`` plus a
count, so the JAX package's optimizer state carries over
(``convert.state_from_jax``). The meta-LR and the bias corrections are
computed on the host in float32, as the JAX package computes them on the
device.

``train_step(..., health=True)`` also returns the training-health
diagnostics (``telemetry/health.py``) in ``StepMetrics.health``; the
weights are bitwise those of a step without them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.device import (DeviceLike,
                                                        resolve_device)
from howtotrainyourmamlpytorch_tpu_torch.meta.inner import (
    Episode, lslr_init, per_step_loss_importance, reptile_task_forward,
    split_fast_slow, task_forward)
from howtotrainyourmamlpytorch_tpu_torch.ops.episode import normalize_episode
from howtotrainyourmamlpytorch_tpu_torch.telemetry import health as health_mod
from howtotrainyourmamlpytorch_tpu_torch.telemetry.profiler import region
from howtotrainyourmamlpytorch_tpu_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]
State = Dict[str, Any]
LeafShapes = Tuple[Tuple[str, Tuple[int, ...]], ...]


@dataclass
class AdamState:
    """``optax.adam``'s state: first/second moments over ``{"params":
    ..., "lslr": ...}`` and the update count (optax keeps two equal
    counts, in ``ScaleByAdamState`` and ``ScaleByScheduleState``)."""
    count: int
    mu: Params
    nu: Params


@dataclass
class MetaTrainState:
    """Network params (slow + fast canonical), per-leaf per-step inner LRs,
    per-step BN running stats, Adam's state and the outer iteration
    counter."""
    params: Params
    lslr: Params
    bn_state: Params
    opt_state: AdamState
    step: int = 0

    def to(self, device: torch.device) -> "MetaTrainState":
        move = lambda t: t.to(device)
        opt = AdamState(count=self.opt_state.count,
                        mu=tree_map(move, self.opt_state.mu),
                        nu=tree_map(move, self.opt_state.nu))
        return MetaTrainState(params=tree_map(move, self.params),
                              lslr=tree_map(move, self.lslr),
                              bn_state=tree_map(move, self.bn_state),
                              opt_state=opt, step=self.step)


def meta_lr_schedule(cfg: MAMLConfig) -> Callable[[int], float]:
    """Epoch-granular cosine, in float32: ``lr(e) = eta_min + (lr0 −
    eta_min)·(1 + cos(π·e/E))/2`` with ``e = count // iters_per_epoch``."""
    f32 = np.float32

    def schedule(count: int) -> float:
        epoch = int(count) // cfg.total_iter_per_epoch
        frac = min(f32(epoch) / f32(cfg.total_epochs), f32(1.0))
        cos = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * frac))
        span = f32(cfg.meta_learning_rate - cfg.min_learning_rate)
        return float(f32(cfg.min_learning_rate) + span * cos)
    return schedule


def adam_init(trainable: Params) -> AdamState:
    return AdamState(count=0, mu=tree_map(torch.zeros_like, trainable),
                     nu=tree_map(torch.zeros_like, trainable))


def adam_update(cfg: MAMLConfig, grads: Params, opt: AdamState,
                trainable: Params) -> Tuple[Params, AdamState]:
    """One ``optax.adam(meta_lr_schedule)`` step: ``mu = (1−b1)·g +
    b1·mu``, ``nu = (1−b2)·g² + b2·nu``, bias corrections with
    ``count+1``, ``u = mu_hat / (sqrt(nu_hat) + eps)`` scaled by
    ``−lr(count)``, then ``p + u``. Returns the new trainables and state."""
    b1, b2, eps = cfg.meta_adam_beta1, cfg.meta_adam_beta2, cfg.meta_adam_eps
    f32 = np.float32
    neg_lr = -meta_lr_schedule(cfg)(opt.count)
    count = opt.count + 1
    bc1 = float(f32(1.0) - f32(b1) ** f32(count))
    bc2 = float(f32(1.0) - f32(b2) ** f32(count))
    mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, opt.mu)
    nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, opt.nu)
    new = tree_map(
        lambda p, m, v: p + neg_lr * ((m / bc1) / (torch.sqrt(v / bc2)
                                                   + eps)),
        trainable, mu, nu)
    return new, AdamState(count=count, mu=mu, nu=nu)


def init_train_state(cfg: MAMLConfig, model_init, seed: int,
                     device: DeviceLike = None) -> MetaTrainState:
    """Fresh state from the model's initializer, seeded through a
    ``torch.Generator``; placed on ``device`` (the card by default)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    params, bn_state = model_init(gen)
    fast0, _ = split_fast_slow(cfg, params)
    lslr = lslr_init(cfg, fast0)
    state = MetaTrainState(
        params=params, lslr=lslr, bn_state=bn_state,
        opt_state=adam_init({"params": params, "lslr": lslr}))
    return state.to(device)


def migrate_lslr_rows(cfg: MAMLConfig,
                      state: MetaTrainState) -> MetaTrainState:
    """Forward-compat shim for checkpoints written before the LSLR vectors
    adopted the reference's ``(K+1,)`` sizing (they held ``max(train,
    eval)`` rows): pads each loaded vector with the untrained init row
    (``task_learning_rate``) and its Adam moments with zeros, what a fresh
    ``(K+1,)`` run holds there (no gradient reaches the final row). The
    counterpart of the JAX package's ``meta/outer.py §
    migrate_lslr_rows``."""
    k = cfg.lslr_num_steps
    leaves = tree_leaves(state.lslr)
    if not leaves or all(leaf.shape[0] == k for leaf in leaves):
        return state
    if any(leaf.shape[0] != k - 1 for leaf in leaves):
        raise ValueError(
            f"checkpoint LSLR rows {sorted({l.shape[0] for l in leaves})} "
            f"match neither the current sizing ({k}) nor the pre-(K+1) "
            f"sizing ({k - 1}); refusing to guess a migration")

    def pad_with(value):
        return lambda leaf: torch.cat([leaf, leaf.new_full((1,), value)])

    opt = state.opt_state
    mu = {**opt.mu, "lslr": tree_map(pad_with(0.0), opt.mu["lslr"])}
    nu = {**opt.nu, "lslr": tree_map(pad_with(0.0), opt.nu["lslr"])}
    return dataclasses.replace(
        state, lslr=tree_map(pad_with(cfg.task_learning_rate), state.lslr),
        opt_state=AdamState(count=opt.count, mu=mu, nu=nu))


def _state_trees(state: MetaTrainState) -> Dict[str, Any]:
    """The state's tensor trees, named as the JAX state's fields."""
    return {"params": state.params, "lslr": state.lslr,
            "bn_state": state.bn_state,
            "opt_state": {"mu": state.opt_state.mu,
                          "nu": state.opt_state.nu}}


def _map_paths(tree, fn, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``; paths are
    spelled like ``jax.tree_util.keystr`` (``['params']['conv0']['w']``)
    and visited in sorted key order."""
    if isinstance(tree, dict):
        return {k: _map_paths(tree[k], fn, f"{prefix}['{k}']")
                for k in sorted(tree)}
    return fn(prefix, tree)


def state_leaf_shapes(state: MetaTrainState) -> LeafShapes:
    """``(path, shape)`` of every tensor leaf of a (template) train state —
    capture BEFORE a load replaces the template, feed to
    :func:`reconcile_loaded_shapes` after."""
    out = []
    _map_paths(_state_trees(state),
               lambda path, t: out.append((path, tuple(t.shape))))
    return tuple(out)


def reconcile_loaded_shapes(cfg: MAMLConfig, state: MetaTrainState,
                            template_shapes) -> MetaTrainState:
    """Validate a just-loaded checkpoint's leaf shapes against the fresh
    template's, migrating the one known historical format change: the
    per-channel ``(1, C)`` layer-norm γ/β (and their Adam moments) are
    broadcast over ``(H, W)`` to the elementwise ``(1, H, W, C)`` —
    numerically what the old parameterization computed. Any other shape
    mismatch refuses loudly. Run AFTER :func:`migrate_lslr_rows`. The
    counterpart of the JAX package's ``meta/outer.py §
    reconcile_loaded_shapes``."""
    have = state_leaf_shapes(state)
    if len(have) != len(template_shapes):
        raise ValueError(
            f"checkpoint has {len(have)} leaves but the template state has "
            f"{len(template_shapes)}; refusing to resume")
    want = dict(template_shapes)

    def fix(path, leaf):
        shape, target = tuple(leaf.shape), want.get(path)
        if target is None:
            raise ValueError(f"checkpoint leaf {path} is not in the "
                             f"template state; refusing to resume")
        if shape == tuple(target):
            return leaf
        is_ln_affine = (cfg.norm_layer == "layer_norm"
                        and (path.endswith("['gamma']")
                             or path.endswith("['beta']")))
        if (is_ln_affine and len(shape) == 2 and len(target) == 4
                and shape[0] == target[0] == 1 and shape[1] == target[-1]):
            return leaf[:, None, None, :].expand(tuple(target)).clone()
        raise ValueError(
            f"checkpoint leaf {path} has shape {shape} but the current "
            f"model expects {tuple(target)} — an incompatible checkpoint "
            f"format; refusing to resume with silently mismatched "
            f"parameters")

    trees = _map_paths(_state_trees(state), fix)
    opt = AdamState(count=state.opt_state.count,
                    mu=trees["opt_state"]["mu"], nu=trees["opt_state"]["nu"])
    return MetaTrainState(params=trees["params"], lslr=trees["lslr"],
                          bn_state=trees["bn_state"], opt_state=opt,
                          step=state.step)


class StepMetrics(NamedTuple):
    loss: torch.Tensor          # meta-loss, mean over the batch
    accuracy: torch.Tensor      # final-step target accuracy, mean
    support_loss: torch.Tensor  # mean support loss over inner steps
    learning_rate: float        # the meta-LR this step applied
    # Training-health diagnostics (telemetry/health.py): a dict of small
    # tensors on the steps run with health=True, else None.
    health: Optional[Dict[str, torch.Tensor]] = None


def _chunks(batch: Episode, num_micro: int):
    n = batch.support_x.shape[0]
    if n % num_micro:
        raise ValueError(f"task_microbatches {num_micro} must divide the "
                         f"batch of {n} tasks")
    size = n // num_micro
    for c in range(num_micro):
        yield Episode(*(f[c * size:(c + 1) * size] for f in batch))


def _add(acc, value):
    return value if acc is None else tree_map(torch.add, acc, value)


def _make_accumulation(cfg: MAMLConfig, apply_fn) -> Callable[..., Any]:
    """The chunked forward/backward of :func:`make_meta_gradients`,
    returning its sums as a dict (``loss``, ``acc``, ``s_loss``, ``bn``,
    ``grads``; with ``per_step``, also the per-inner-step support and
    target losses ``ps_s``, ``ps_t``, each the task mean)."""
    num_steps = cfg.number_of_training_steps_per_iter
    interpolate = cfg.algo.outer == "interpolate"
    if cfg.elastic_pad_tasks > 0:
        raise NotImplementedError(
            "elastic_pad_tasks > 0 (elastic pad-and-mask) is not ported "
            "yet (ROADMAP.md, Queue 1: parallel/mesh slice)")

    def accumulate(state: MetaTrainState, batch: Episode, epoch, *,
                   second_order: bool, use_msl: bool, plain: bool = False,
                   per_step: bool = False):
        batch = normalize_episode(cfg, batch)
        device = batch.support_x.device
        msl_w = (per_step_loss_importance(cfg, epoch, device=device)
                 if use_msl else None)
        num_micro = cfg.effective_task_microbatches()
        if interpolate:
            trainable = {"params": state.params, "lslr": state.lslr}
        else:
            trainable = tree_map(
                lambda t: t.detach().requires_grad_(True),
                {"params": state.params, "lslr": state.lslr})
        leaves = tree_leaves(trainable)
        totals = None
        for chunk in _chunks(batch, num_micro):
            if interpolate:
                with region("task_adapt"):
                    res, deltas = reptile_task_forward(
                        cfg, apply_fn, state.params, state.lslr,
                        state.bn_state, chunk, num_steps=num_steps,
                        plain=plain)
                _, slow = split_fast_slow(cfg, state.params)
                grads = {
                    "params": {**tree_map(torch.zeros_like, slow),
                               **tree_map(lambda d: d.mean(0), deltas)},
                    "lslr": tree_map(torch.zeros_like, state.lslr)}
                loss = res.loss.mean()
            else:
                with region("task_adapt"):
                    res = task_forward(
                        cfg, apply_fn, trainable["params"],
                        trainable["lslr"], state.bn_state, chunk,
                        num_steps=num_steps, second_order=second_order,
                        use_msl=use_msl, msl_weights=msl_w, plain=plain)
                loss = res.loss.mean()
                flat = torch.autograd.grad(loss, leaves, allow_unused=True)
                it = iter(g if g is not None else torch.zeros_like(t)
                          for g, t in zip(flat, leaves))
                grads = tree_map(lambda _: next(it), trainable)
                loss = loss.detach()
            sums = {"loss": loss, "acc": res.target_accuracy.mean(),
                    "s_loss": res.support_loss.mean(),
                    "bn": tree_map(lambda a: a.mean(0), res.bn_state),
                    "grads": grads}
            if per_step:
                sums["ps_s"] = res.per_step_support_losses.mean(0)
                sums["ps_t"] = res.per_step_target_losses.mean(0)
            totals = _add(totals, sums)
        out = tree_map(lambda a: a / num_micro, totals)
        out["msl_w"] = msl_w
        return out

    return accumulate


def make_meta_gradients(cfg: MAMLConfig, apply_fn) -> Callable[..., Any]:
    """Build ``meta_gradients(state, batch, epoch, *, second_order,
    use_msl, plain=False) -> (loss, accuracy, support_loss, bn_state,
    grads)``: the batch's meta-loss and its gradient with respect to
    ``{"params", "lslr"}``, before any zeroing, clamp or update.

    The batch (leading task axis, uint8 or f32 images) runs in
    ``cfg.effective_task_microbatches()`` equal chunks, one task-batched
    forward and one backward each; every output is the sum of the chunk
    means divided by the chunk count, the JAX package's accumulation.
    ``bn_state`` is the task mean of the post-task norm states. Under
    ``meta_algorithm='reptile'`` (outer ``'interpolate'``) the gradient
    of each fast leaf is the task mean of ``θ − φ`` and every other leaf
    gets zeros."""
    accumulate = _make_accumulation(cfg, apply_fn)

    def meta_gradients(state: MetaTrainState, batch: Episode, epoch, *,
                       second_order: bool, use_msl: bool,
                       plain: bool = False):
        out = accumulate(state, batch, epoch, second_order=second_order,
                         use_msl=use_msl, plain=plain)
        return out["loss"], out["acc"], out["s_loss"], out["bn"], out["grads"]

    return meta_gradients


def make_train_step(cfg: MAMLConfig, apply_fn, *,
                    reduce_axes=None) -> Callable[..., Any]:
    """Build ``train_step(state, batch, epoch, *, second_order, use_msl,
    plain=False, health=False) -> (new_state, StepMetrics)``: the
    meta-gradients (:func:`make_meta_gradients`), LSLR gradients zeroed
    when they are not learnable, γ/β gradients zeroed when BNWB is off,
    the ±clamp on the network's gradients only, then Adam. ``health``
    adds the training-health diagnostics: gradient norms of the
    meta-gradient before zeroing and clamp, update ratios and LSLR
    statistics of the updated state, per-step losses and the MSL
    weights."""
    if reduce_axes:
        raise NotImplementedError(
            "reduce_axes (the cross-device meta-gradient mean) is not "
            "ported yet (ROADMAP.md, Queue 1: parallel/mesh slice)")
    accumulate = _make_accumulation(cfg, apply_fn)
    schedule = meta_lr_schedule(cfg)
    learnable_lslr = cfg.effective_learnable_lslr

    def train_step(state: MetaTrainState, batch: Episode, epoch, *,
                   second_order: bool, use_msl: bool, plain: bool = False,
                   health: bool = False
                   ) -> Tuple[MetaTrainState, StepMetrics]:
        out = accumulate(state, batch, epoch, second_order=second_order,
                         use_msl=use_msl, plain=plain, per_step=health)
        loss, acc, s_loss = out["loss"], out["acc"], out["s_loss"]
        new_bn, grads = out["bn"], out["grads"]
        diag = None
        with torch.no_grad():
            if health:
                diag = health_mod.grad_health(grads)
            if not learnable_lslr:
                grads["lslr"] = tree_map(torch.zeros_like, grads["lslr"])
            for name, sub in grads["params"].items():
                if "norm" in name:
                    if not cfg.learnable_bn_gamma and "gamma" in sub:
                        sub["gamma"] = torch.zeros_like(sub["gamma"])
                    if not cfg.learnable_bn_beta and "beta" in sub:
                        sub["beta"] = torch.zeros_like(sub["beta"])
            if cfg.clamp_meta_grad_value is not None:
                c = cfg.clamp_meta_grad_value
                grads["params"] = tree_map(lambda g: g.clamp(-c, c),
                                           grads["params"])
            with region("meta_update"):
                new, opt = adam_update(cfg, grads, state.opt_state,
                                       {"params": state.params,
                                        "lslr": state.lslr})
            lr = schedule(state.step)
            if health:
                diag.update(health_mod.update_health(
                    cfg, new, opt, lr, out["ps_s"], out["ps_t"],
                    out["msl_w"]))
        new_state = MetaTrainState(params=new["params"], lslr=new["lslr"],
                                   bn_state=new_bn, opt_state=opt,
                                   step=state.step + 1)
        return new_state, StepMetrics(loss=loss, accuracy=acc,
                                      support_loss=s_loss,
                                      learning_rate=lr, health=diag)

    return train_step


class EvalResult(NamedTuple):
    loss: torch.Tensor           # (B,) per-task target loss
    accuracy: torch.Tensor       # (B,) per-task target accuracy
    target_logits: torch.Tensor  # (B, N*Q, N)


def make_eval_step(cfg: MAMLConfig, apply_fn) -> Callable[..., EvalResult]:
    """Validation/test: adapt every task of the batch at once with the
    evaluation step count, first order, final-step loss only; no outer
    graph is built and the norm-state changes are discarded."""
    num_steps = cfg.number_of_evaluation_steps_per_iter

    def eval_step(state: MetaTrainState, batch: Episode, *,
                  plain: bool = False) -> EvalResult:
        batch = normalize_episode(cfg, batch)
        with torch.no_grad():
            res = task_forward(cfg, apply_fn, state.params, state.lslr,
                               state.bn_state, batch, num_steps=num_steps,
                               second_order=False, use_msl=False,
                               msl_weights=None, plain=plain)
        return EvalResult(loss=res.loss, accuracy=res.target_accuracy,
                          target_logits=res.target_logits)

    return eval_step
