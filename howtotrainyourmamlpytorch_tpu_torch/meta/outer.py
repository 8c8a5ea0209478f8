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
device, and reach the step as 0-dim f32 device tensors with the MSL
epoch (:class:`StepScalars`), filled before each step: a step captured
into a CUDA graph (``parallel/aot.py``) reads the same buffers, so a
replay uses the step's own values, never the captured step's.

``train_step(..., health=True)`` also returns the training-health
diagnostics (``telemetry/health.py``) in ``StepMetrics.health``; the
weights are bitwise those of a step without them.

Over a mesh of ranks (``parallel/mesh.py``) each rank runs its shard of
the batch: the train step all-reduces the meta-gradient, loss and aux
once (``reduce_axes``), the eval step all-gathers the per-task results
(``gather_axes``), and ``elastic_pad_tasks`` zero-weight pad tasks are
masked exactly (:func:`_pad_scale`).
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
from howtotrainyourmamlpytorch_tpu_torch.models.layers import per_task_convs
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


class StepScalars:
    """The per-step host values a train step reads, as 0-dim f32 tensors
    on its device: the MSL epoch, the negated meta-LR and Adam's bias
    corrections of ``count + 1`` (with their f32 reciprocals).

    :meth:`fill` writes them from the same f32 host values as before,
    with fill kernels (no copy from host memory), outside any capture;
    the eager step and a graph replay read them alike."""

    def __init__(self, device):
        self.device = torch.device(device)
        zero = lambda: torch.zeros((), dtype=torch.float32,
                                   device=self.device)
        self.epoch, self.neg_lr = zero(), zero()
        self.bc1, self.bc2, self.inv_bc1, self.inv_bc2 = (
            zero(), zero(), zero(), zero())

    @staticmethod
    def host_values(cfg: MAMLConfig, count: int,
                    epoch) -> Dict[str, float]:
        """The f32 values :meth:`fill` writes, on the host."""
        f32 = np.float32
        c = int(count) + 1
        bc1 = f32(1.0) - f32(cfg.meta_adam_beta1) ** f32(c)
        bc2 = f32(1.0) - f32(cfg.meta_adam_beta2) ** f32(c)
        return {"epoch": float(f32(float(epoch))),
                "neg_lr": -meta_lr_schedule(cfg)(count),
                "bc1": float(bc1), "bc2": float(bc2),
                "inv_bc1": float(f32(1.0) / bc1),
                "inv_bc2": float(f32(1.0) / bc2)}

    def fill(self, cfg: MAMLConfig, count: int, epoch) -> "StepScalars":
        for name, value in self.host_values(cfg, count, epoch).items():
            getattr(self, name).fill_(value)
        return self


def _unbias(m: torch.Tensor, bc: torch.Tensor,
            inv_bc: torch.Tensor) -> torch.Tensor:
    """``m / bc`` as ATen computes a division by a host scalar: on the
    card it multiplies by the f32 reciprocal, on the CPU it divides; the
    tensors keep either arithmetic bitwise what it was with the Python
    number."""
    return m * inv_bc if m.is_cuda else m / bc


def adam_init(trainable: Params) -> AdamState:
    return AdamState(count=0, mu=tree_map(torch.zeros_like, trainable),
                     nu=tree_map(torch.zeros_like, trainable))


def adam_update(cfg: MAMLConfig, grads: Params, opt: AdamState,
                trainable: Params, scalars: Optional[StepScalars] = None
                ) -> Tuple[Params, AdamState]:
    """One ``optax.adam(meta_lr_schedule)`` step: ``mu = (1−b1)·g +
    b1·mu``, ``nu = (1−b2)·g² + b2·nu``, bias corrections with
    ``count+1``, ``u = mu_hat / (sqrt(nu_hat) + eps)`` scaled by
    ``−lr(count)``, then ``p + u``. Returns the new trainables and state.
    ``scalars``: the step's filled :class:`StepScalars` (default: filled
    here from ``opt.count``)."""
    b1, b2, eps = cfg.meta_adam_beta1, cfg.meta_adam_beta2, cfg.meta_adam_eps
    if scalars is None:
        scalars = StepScalars(tree_leaves(trainable)[0].device).fill(
            cfg, opt.count, 0)
    mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, opt.mu)
    nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, opt.nu)
    new = tree_map(
        lambda p, m, v: p + scalars.neg_lr * (
            _unbias(m, scalars.bc1, scalars.inv_bc1)
            / (torch.sqrt(_unbias(v, scalars.bc2, scalars.inv_bc2)) + eps)),
        trainable, mu, nu)
    return new, AdamState(count=opt.count + 1, mu=mu, nu=nu)


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


def _pad_scale(cfg: MAMLConfig, rank: int, n_local: int,
               device) -> Optional[torch.Tensor]:
    """Elastic pad-and-mask: the ``(n_local,)`` per-task scale of this
    rank's shard, ``padded/real`` on real global positions and 0 on the
    pads (the global TAIL; the batch axis is dcn-major over the ranks);
    None without pads. Every per-task output is scaled before its mean,
    so each mean over the padded tasks, and the all-reduce mean of those
    means, equals the exact mean over the REAL tasks."""
    if not cfg.elastic_pad_tasks:
        return None
    f32 = torch.float32
    ratio = (torch.tensor(cfg.padded_batch_size, dtype=f32)
             / torch.tensor(cfg.batch_size, dtype=f32))
    positions = rank * n_local + torch.arange(n_local)
    return torch.where(positions < cfg.batch_size, ratio,
                       torch.zeros((), dtype=f32)).to(device)


def _scaled(tree, scale: Optional[torch.Tensor]):
    """Each leaf of a tree (or of each field of a ``TaskResult``) with a
    leading task axis, times ``scale`` per task."""
    if scale is None:
        return tree

    def mul(a):
        return a * scale.reshape(scale.shape[:1] + (1,) * (a.ndim - 1))
    if isinstance(tree, tuple):
        return type(tree)(*(tree_map(mul, f) for f in tree))
    return tree_map(mul, tree)


def _make_accumulation(cfg: MAMLConfig, apply_fn,
                       rank: int = 0) -> Callable[..., Any]:
    """The chunked forward/backward of :func:`make_meta_gradients`,
    returning its sums as a dict (``loss``, ``acc``, ``s_loss``, ``bn``,
    ``grads``; with ``per_step``, also the per-inner-step support and
    target losses ``ps_s``, ``ps_t``, each the task mean). ``rank`` is
    this rank's position on the mesh, which places its shard's pads."""
    num_steps = cfg.number_of_training_steps_per_iter
    interpolate = cfg.algo.outer == "interpolate"
    # The pad scale per (shard rows, device), made once: a step captured
    # into a CUDA graph makes no host-to-device copy.
    scales: Dict[Tuple[int, torch.device], Optional[torch.Tensor]] = {}

    def accumulate(state: MetaTrainState, batch: Episode, epoch, *,
                   second_order: bool, use_msl: bool, plain: bool = False,
                   per_step: bool = False):
        batch = normalize_episode(cfg, batch)
        device = batch.support_x.device
        msl_w = (per_step_loss_importance(cfg, epoch, device=device)
                 if use_msl else None)
        num_micro = cfg.effective_task_microbatches()
        rows = batch.support_x.shape[0]
        if (rows, device) not in scales:
            scales[(rows, device)] = _pad_scale(cfg, rank, rows, device)
        scale = scales[(rows, device)]
        size = rows // num_micro
        if interpolate:
            trainable = {"params": state.params, "lslr": state.lslr}
        else:
            trainable = tree_map(
                lambda t: t.detach().requires_grad_(True),
                {"params": state.params, "lslr": state.lslr})
        leaves = tree_leaves(trainable)

        def chunk_sums(c, chunk):
            s_c = None if scale is None else scale[c * size:(c + 1) * size]
            if interpolate:
                with region("task_adapt"):
                    res, deltas = reptile_task_forward(
                        cfg, apply_fn, state.params, state.lslr,
                        state.bn_state, chunk, num_steps=num_steps,
                        plain=plain)
                res, deltas = _scaled(res, s_c), _scaled(deltas, s_c)
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
                res = _scaled(res, s_c)
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
            return sums

        totals = None
        with per_task_convs(device):
            for c, chunk in enumerate(_chunks(batch, num_micro)):
                totals = _add(totals, chunk_sums(c, chunk))
        out = tree_map(lambda a: a / num_micro, totals)
        out["msl_w"] = msl_w
        return out

    return accumulate


# The accumulation's outputs that the train step's one all-reduce carries,
# in the order of its flat buffer.
_REDUCED = ("loss", "acc", "s_loss", "bn", "grads", "ps_s", "ps_t")


def pack_f32(tensors) -> torch.Tensor:
    """The tensors flattened, in order, into ONE f32 buffer (every leaf
    here is f32; a bf16 leaf widens exactly): what the train step's one
    all-reduce carries (``parallel/mesh.py § Mesh.reduce_mean_``)."""
    return torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in tensors])


def unpack_f32(flat: torch.Tensor, like) -> list:
    """:func:`pack_f32` undone: views of ``flat`` in the ``(shape,
    dtype)`` of each entry of ``like``, in order."""
    out, i = [], 0
    for shape, dtype in like:
        n = int(np.prod(shape, dtype=np.int64))
        out.append(flat[i:i + n].view(shape).to(dtype))
        i += n
    return out


class SumsLayout(NamedTuple):
    """What the update needs to read the flat buffer back: the tree of
    the accumulated means with each leaf's ``(shape, dtype)``, and the
    MSL weights (read by health only, never reduced)."""
    template: Dict[str, Any]
    msl_w: Optional[torch.Tensor]


class TrainPieces(NamedTuple):
    """The train step as its three pieces (:func:`make_train_pieces`);
    the step (:func:`make_train_step`) is exactly their composition.

    * ``local(state, batch, epoch, *, second_order, use_msl, plain=False,
      health=False) -> (flat, layout)``: this rank's chunked
      forward/backward; ``flat`` is the one f32 buffer of its means
      (:func:`pack_f32`), ``epoch`` the MSL epoch (a number or
      ``StepScalars.epoch``);
    * ``reduce(flat) -> flat``: the one fused all-reduce, the mean over
      the ranks in place (nothing without a process group);
    * ``update(state, flat, layout, *, health=False, scalars) ->
      (new_state, StepMetrics)``: the zeroing, clamp and Adam on the
      reduced buffer (with ``health``, the diagnostics too).

    A CUDA graph captures ``local`` and ``update``; ``reduce`` runs
    eagerly between them (``parallel/aot.py § TrainGraph``)."""
    local: Callable[..., Tuple[torch.Tensor, SumsLayout]]
    reduce: Callable[[torch.Tensor], torch.Tensor]
    update: Callable[..., Tuple["MetaTrainState", "StepMetrics"]]


def _reduced(layout: SumsLayout, flat: torch.Tensor) -> Dict[str, Any]:
    it = iter(unpack_f32(flat, tree_leaves(layout.template)))
    return tree_map(lambda _: next(it), layout.template)


def make_train_pieces(cfg: MAMLConfig, apply_fn, *,
                      reduce_axes=None) -> TrainPieces:
    """The pieces of :func:`make_train_step` (same arguments)."""
    accumulate = _make_accumulation(
        cfg, apply_fn, rank=reduce_axes.rank if reduce_axes else 0)
    schedule = meta_lr_schedule(cfg)
    learnable_lslr = cfg.effective_learnable_lslr

    def local(state: MetaTrainState, batch: Episode, epoch, *,
              second_order: bool, use_msl: bool, plain: bool = False,
              health: bool = False) -> Tuple[torch.Tensor, SumsLayout]:
        out = accumulate(state, batch, epoch, second_order=second_order,
                         use_msl=use_msl, plain=plain, per_step=health)
        sums = {k: out[k] for k in _REDUCED if k in out}
        template = tree_map(lambda t: (tuple(t.shape), t.dtype), sums)
        return pack_f32(tree_leaves(sums)), SumsLayout(template,
                                                       out["msl_w"])

    def reduce(flat: torch.Tensor) -> torch.Tensor:
        if reduce_axes is not None:
            reduce_axes.reduce_mean_(flat)
        return flat

    def update(state: MetaTrainState, flat: torch.Tensor,
               layout: SumsLayout, *, health: bool = False,
               scalars: StepScalars
               ) -> Tuple[MetaTrainState, StepMetrics]:
        out = _reduced(layout, flat)
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
                                        "lslr": state.lslr}, scalars)
            lr = schedule(state.step)
            if health:
                diag.update(health_mod.update_health(
                    cfg, new, opt, lr, out["ps_s"], out["ps_t"],
                    layout.msl_w))
        new_state = MetaTrainState(params=new["params"], lslr=new["lslr"],
                                   bn_state=new_bn, opt_state=opt,
                                   step=state.step + 1)
        return new_state, StepMetrics(loss=loss, accuracy=acc,
                                      support_loss=s_loss,
                                      learning_rate=lr, health=diag)

    return TrainPieces(local=local, reduce=reduce, update=update)


def make_meta_gradients(cfg: MAMLConfig, apply_fn, *,
                        reduce_axes=None) -> Callable[..., Any]:
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
    gets zeros. ``reduce_axes`` (a ``parallel.mesh.Mesh``): the rank's
    local batch, all-reduced to the global mean as the train step does
    (the train step's ``local`` and ``reduce`` pieces)."""
    pieces = make_train_pieces(cfg, apply_fn, reduce_axes=reduce_axes)

    def meta_gradients(state: MetaTrainState, batch: Episode, epoch, *,
                       second_order: bool, use_msl: bool,
                       plain: bool = False):
        flat, layout = pieces.local(state, batch, epoch,
                                    second_order=second_order,
                                    use_msl=use_msl, plain=plain)
        out = _reduced(layout, pieces.reduce(flat))
        return out["loss"], out["acc"], out["s_loss"], out["bn"], out["grads"]

    return meta_gradients


def make_train_step(cfg: MAMLConfig, apply_fn, *,
                    reduce_axes=None) -> Callable[..., Any]:
    """Build ``train_step(state, batch, epoch, *, second_order, use_msl,
    plain=False, health=False, scalars=None) -> (new_state,
    StepMetrics)``: the
    meta-gradients (:func:`make_meta_gradients`), LSLR gradients zeroed
    when they are not learnable, γ/β gradients zeroed when BNWB is off,
    the ±clamp on the network's gradients only, then Adam. ``health``
    adds the training-health diagnostics: gradient norms of the
    meta-gradient before zeroing and clamp, update ratios and LSLR
    statistics of the updated state, per-step losses and the MSL
    weights.

    ``scalars``: a :class:`StepScalars` the caller filled for this step
    (a CUDA graph's); by default the step fills its own from
    ``state.opt_state.count`` and ``epoch``.

    ``reduce_axes`` (a ``parallel.mesh.Mesh``): the batch is this rank's
    shard of the global batch; after the microbatch accumulation ONE
    fused all-reduce makes the meta-gradient, loss and aux global means,
    and with ``elastic_pad_tasks`` the rank's position places its pads
    (:func:`_pad_scale`).

    The step is the composition of its :class:`TrainPieces` (its
    ``pieces`` attribute): ``local``, ``reduce``, then ``update``."""
    pieces = make_train_pieces(cfg, apply_fn, reduce_axes=reduce_axes)
    own: Dict[torch.device, StepScalars] = {}

    def train_step(state: MetaTrainState, batch: Episode, epoch, *,
                   second_order: bool, use_msl: bool, plain: bool = False,
                   health: bool = False,
                   scalars: Optional[StepScalars] = None
                   ) -> Tuple[MetaTrainState, StepMetrics]:
        if scalars is None:
            device = batch.support_x.device
            if device not in own:
                own[device] = StepScalars(device)
            scalars = own[device].fill(cfg, state.opt_state.count, epoch)
        flat, layout = pieces.local(state, batch, scalars.epoch,
                                    second_order=second_order,
                                    use_msl=use_msl, plain=plain,
                                    health=health)
        pieces.reduce(flat)
        return pieces.update(state, flat, layout, health=health,
                             scalars=scalars)

    train_step.pieces = pieces
    return train_step


class EvalResult(NamedTuple):
    loss: torch.Tensor           # (B,) per-task target loss
    accuracy: torch.Tensor       # (B,) per-task target accuracy
    target_logits: torch.Tensor  # (B, N*Q, N)


class EvalPieces(NamedTuple):
    """The eval step as its two pieces (:func:`make_eval_pieces`); the
    step is exactly their composition. ``local(state, batch, *,
    plain=False) -> (loss, accuracy, target_logits)`` of this rank's
    tasks; ``gather(out) -> out`` of the whole batch on every rank, ONE
    all-gather (nothing without a process group). A CUDA graph captures
    ``local``; ``gather`` runs eagerly after it."""
    local: Callable[..., Tuple[torch.Tensor, ...]]
    gather: Callable[[Tuple[torch.Tensor, ...]], Tuple[torch.Tensor, ...]]


def make_eval_pieces(cfg: MAMLConfig, apply_fn, *,
                     gather_axes=None) -> EvalPieces:
    """The pieces of :func:`make_eval_step` (same arguments)."""
    num_steps = cfg.number_of_evaluation_steps_per_iter

    def local(state: MetaTrainState, batch: Episode, *,
              plain: bool = False) -> Tuple[torch.Tensor, ...]:
        batch = normalize_episode(cfg, batch)
        with torch.no_grad():
            res = task_forward(cfg, apply_fn, state.params, state.lslr,
                               state.bn_state, batch, num_steps=num_steps,
                               second_order=False, use_msl=False,
                               msl_weights=None, plain=plain)
        return res.loss, res.target_accuracy, res.target_logits

    def gather(out: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
        if gather_axes is None:
            return out
        return tuple(gather_axes.all_gather(out))

    return EvalPieces(local=local, gather=gather)


def make_eval_step(cfg: MAMLConfig, apply_fn, *,
                   gather_axes=None) -> Callable[..., EvalResult]:
    """Validation/test: adapt every task of the batch at once with the
    evaluation step count, first order, final-step loss only; no outer
    graph is built and the norm-state changes are discarded.

    ``gather_axes`` (a ``parallel.mesh.Mesh``): the batch is this rank's
    shard; ONE all-gather of the per-task results gives every rank the
    whole eval batch's result. The step is the composition of its
    :class:`EvalPieces` (its ``pieces`` attribute)."""
    pieces = make_eval_pieces(cfg, apply_fn, gather_axes=gather_axes)

    def eval_step(state: MetaTrainState, batch: Episode, *,
                  plain: bool = False) -> EvalResult:
        return EvalResult(*pieces.gather(pieces.local(state, batch,
                                                      plain=plain)))

    eval_step.pieces = pieces
    return eval_step
