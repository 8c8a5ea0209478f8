"""The (dcn, tasks) device mesh over ranks (the port's counterpart of the
JAX package's ``parallel/mesh.py``).

One process per device: the mesh is a small value naming the shape, the
axis names, this rank and the process group. It maps onto torchrun's
layout: ``dcn`` is the node (host) index and ``tasks`` the local rank,
so ``rank = dcn_index · tasks + task_index``, dcn-major, the order in
which the JAX package splits the batch axis over ``("dcn", "tasks")``.
Rank ``r`` owns the global task positions ``[r·L, (r+1)·L)``.

* The meta-batch of episodes is split over the ranks; parameters, LSLR
  vectors, BN state and Adam's state are replicated. State is never
  broadcast: every rank builds the same state from the same seed (the
  JAX package's ``replicate_state`` discipline), and a resume agrees on
  the checkpoint's iteration and fingerprint (experiment.py).
* Inner-loop adaptation is local to a rank: zero communication for the
  K inner steps.
* The only collective per outer step is ONE fused all-reduce of the
  meta-gradient, the loss and the aux means (meta/outer.py), where the
  JAX package's ``pmean`` sits; one all-gather of the per-task results
  per eval step.

Also :func:`degraded_mesh_shape` and :func:`derive_degraded_config`, the
elastic pod's pure geometry functions, copied.
"""

from __future__ import annotations

import logging
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
    EvalPieces, TrainPieces, make_eval_step, make_train_step)
from howtotrainyourmamlpytorch_tpu_torch.parallel import multihost


@dataclass(frozen=True)
class Mesh:
    """The (dcn, tasks) mesh as this rank sees it. ``group`` is the
    process group (None: the default group, or no group at all with one
    process)."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    world: int
    group: Any = None

    @property
    def size(self) -> int:
        return self.world

    @property
    def communicates(self) -> bool:
        """Whether the mesh's collectives run: a process group exists
        (also at a world of 1, where each collective returns its input's
        bits)."""
        return multihost.is_initialized()

    def reduce_mean_(self, flat: torch.Tensor) -> torch.Tensor:
        """The train step's one fused all-reduce, in place: ``flat`` (the
        meta-gradient, loss and aux in one f32 buffer, ``meta/outer.py §
        pack_f32``) summed over the ranks and divided by the world (every
        rank ends with the same bits). No process group: ``flat``
        untouched."""
        if self.communicates:
            multihost.all_reduce_sum(flat, self.group)
            flat /= self.world
        return flat

    def all_gather(self, tensors: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """Each tensor of every rank, concatenated along its leading axis
        in rank order, in ONE all-gather (f32 wire, dtypes restored). No
        process group: the tensors themselves."""
        if not self.communicates:
            return list(tensors)
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
        rows = multihost.all_gather_rows(flat[None], self.group)
        out, i = [], 0
        for t in tensors:
            n = t.numel()
            part = rows[:, i:i + n].reshape((self.world * t.shape[0],)
                                            + tuple(t.shape[1:]))
            out.append(part.to(t.dtype))
            i += n
        return out

    def describe(self, device: torch.device) -> str:
        """The start-up line: backend, world, shape, this rank's device,
        and whether device collectives stage through host memory."""
        name = multihost.backend(self.group) or "none"
        line = (f"mesh: backend={name}, world={self.world}, "
                f"shape={tuple(self.shape)}, rank={self.rank}, "
                f"device={device}")
        if name == "gloo" and device.type == "cuda":
            line += (", collectives staged through pinned host memory "
                     "(ranks share a card)")
        return line


def make_mesh(cfg: MAMLConfig, group=None) -> Mesh:
    """The (dcn, tasks) mesh over ``group``'s ranks (the default group; a
    world of 1 without one). ``mesh_shape`` must multiply to the world."""
    world = multihost.process_count(group)
    n = int(np.prod(cfg.mesh_shape))
    if n != world:
        raise ValueError(
            f"mesh_shape {cfg.mesh_shape} needs {n} devices, "
            f"got {world}")
    return Mesh(shape=tuple(int(v) for v in cfg.mesh_shape),
                axis_names=tuple(cfg.mesh_axis_names),
                rank=multihost.process_index(group), world=world,
                group=group)


def batch_positions(mesh: Mesh, batch_size: int) -> Tuple[int, int]:
    """This rank's ``[start, stop)`` of a global batch (the JAX package's
    ``batch_sharding`` + ``shard_batch``)."""
    return multihost.local_batch_positions(mesh, batch_size)


class MeshPlan(NamedTuple):
    """The step functions for one (cfg, mesh) pair. ``train_step(state,
    local_batch, epoch, *, second_order, use_msl, plain=False,
    health=False)`` is the flag-taking step the trainer's loop calls;
    ``train_steps`` maps the two MAML++ phase flags ``(second_order,
    use_msl)`` to that step with its flags bound. ``eval_step(state,
    local_batch)`` returns the whole eval batch's results on every
    rank. ``train_pieces`` and ``eval_pieces`` are the two steps' pieces
    (``meta/outer.py § TrainPieces``, ``§ EvalPieces``): the rank-local
    work and its one collective, which the warm start captures apart
    (``parallel/aot.py``)."""
    mesh: Mesh
    train_step: Callable
    train_steps: Dict[Tuple[bool, bool], Callable]
    eval_step: Callable
    train_pieces: TrainPieces
    eval_pieces: EvalPieces


def _named_phase_fn(train_step, so: bool, msl: bool):
    """A phase step with the name of its profiler cost card."""
    def f(state, batch, epoch, **kw):
        return train_step(state, batch, epoch, second_order=so,
                          use_msl=msl, **kw)
    f.__name__ = f"train_so{int(so)}_msl{int(msl)}"
    return f


def make_sharded_steps(cfg: MAMLConfig, apply_fn, mesh: Mesh) -> MeshPlan:
    """The train and eval steps over the mesh: each rank runs its own
    tasks; the train step all-reduces the meta-gradient, loss and aux
    once (meta/outer.py § make_train_step ``reduce_axes``), the eval step
    all-gathers the per-task results. Refuses a batch the mesh does not
    divide; clamps ``task_microbatches`` to a divisor of the per-rank task
    count as the JAX package does, with its warning."""
    if cfg.padded_batch_size % mesh.size != 0:
        raise ValueError(
            f"batch_size {cfg.padded_batch_size} (incl. "
            f"{cfg.elastic_pad_tasks} elastic pad tasks) not divisible "
            f"by mesh size {mesh.size}")
    if cfg.effective_eval_batch_size % mesh.size != 0:
        raise ValueError(
            f"eval batch size {cfg.effective_eval_batch_size} not "
            f"divisible by mesh size {mesh.size}")
    eff = cfg.effective_task_microbatches(mesh.size)
    if eff != cfg.task_microbatches:
        local = cfg.padded_batch_size // mesh.size
        if eff == 1 and cfg.task_microbatches > 1 and local > 1:
            # A value that degrades to gcd 1 at a multi-task shard shares
            # NO factor with the geometry: the clamp would silently
            # discard all accumulation. Callers that want it pre-resolve
            # through MAMLConfig.effective_task_microbatches.
            raise ValueError(
                f"task_microbatches {cfg.task_microbatches} shares no "
                f"factor with the per-device task count {local} "
                f"(= batch_size {cfg.batch_size} / mesh size "
                f"{mesh.size}); clamping would silently run mb=1. Pick "
                f"a divisor of {local}, or pre-resolve via "
                f"cfg.effective_task_microbatches(mesh_size) to accept "
                f"the degradation.")
        # Through logging too: batch jobs routinely swallow warnings.
        msg = (
            f"task_microbatches {cfg.task_microbatches} does not divide "
            f"the per-device task count {local} "
            f"(= batch_size {cfg.batch_size} / mesh size {mesh.size}); "
            f"clamping to gcd {eff}. The shipped value is a measured "
            f"winner at the shipped batch/mesh geometry — re-sweep at "
            f"this one to tune.")
        warnings.warn(msg)
        logging.getLogger(__name__).warning(msg)
        cfg = cfg.replace(task_microbatches=eff)
    train_step = make_train_step(cfg, apply_fn, reduce_axes=mesh)
    eval_step = make_eval_step(cfg, apply_fn, gather_axes=mesh)
    train_steps = {(so, msl): _named_phase_fn(train_step, so, msl)
                   for so in (False, True) for msl in (False, True)}
    return MeshPlan(mesh=mesh, train_step=train_step,
                    train_steps=train_steps, eval_step=eval_step,
                    # None where a caller wrapped the step builders.
                    train_pieces=getattr(train_step, "pieces", None),
                    eval_pieces=getattr(eval_step, "pieces", None))


# ---------------------------------------------------------------------------
# degraded-mesh plan derivation (the elastic pod's geometry)

def degraded_mesh_shape(mesh_shape: Sequence[int], survivors: int,
                        orig_processes: int) -> Tuple[int, ...]:
    """The survivor-roster mesh: the ``dcn`` (host) axis shrinks to the
    surviving process count; the per-host ``tasks`` axis is untouched.
    Refuses geometries where the dcn axis is not the host axis."""
    shape = tuple(int(v) for v in mesh_shape)
    if shape[0] != int(orig_processes):
        raise ValueError(
            f"mesh_shape {shape} has dcn extent {shape[0]} but the "
            f"original roster had {orig_processes} processes; elastic "
            f"degradation only knows how to shrink a per-host dcn axis")
    if not 1 <= int(survivors) <= int(orig_processes):
        raise ValueError(
            f"survivor count {survivors} outside [1, {orig_processes}]")
    return (int(survivors),) + shape[1:]


def derive_degraded_config(cfg: MAMLConfig, survivors: int,
                           orig_processes: int) -> MAMLConfig:
    """The config a survivor roster of ``survivors`` hosts runs: the
    ``mesh_shape`` dcn axis shrunk to the survivors; ``elastic_pad_tasks``
    padding the ``batch_size`` real tasks up to a multiple of the
    degraded mesh size (masked exactly in the train step);
    ``task_microbatches`` pre-resolved at the degraded geometry; and
    ``eval_batch_size`` the original effective value rounded up to a
    degraded-mesh multiple. A full roster returns ``cfg`` unchanged."""
    if int(survivors) == int(orig_processes) and not cfg.elastic_pad_tasks:
        return cfg
    shape = degraded_mesh_shape(cfg.mesh_shape, survivors, orig_processes)
    m = int(np.prod(shape))
    pad = (-cfg.batch_size) % m
    eval_b = cfg.effective_eval_batch_size
    eval_b = -(-eval_b // m) * m
    derived = cfg.replace(mesh_shape=shape, elastic_pad_tasks=pad,
                          eval_batch_size=eval_b)
    return derived.replace(
        task_microbatches=derived.effective_task_microbatches(m))
