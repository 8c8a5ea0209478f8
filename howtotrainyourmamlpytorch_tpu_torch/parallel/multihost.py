"""Multi-process runtime over ``torch.distributed`` (the port's
counterpart of the JAX package's ``parallel/multihost.py``).

One process per device, PyTorch's idiom: torchrun starts the ranks and
sets ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
``MASTER_PORT``; :func:`initialize_distributed` joins them into one
process group. A rank's device is ``cuda:(LOCAL_RANK % device_count)``
unless the caller asks for the CPU.

The backend follows one rule (:func:`choose_backend`): NCCL when every
rank of a node has a card of its own; gloo on the CPU, or when ranks
share a card. Gloo's collectives on CUDA tensors go through host memory
anyway, so a gloo group on the card stages every device collective
explicitly through pinned host memory (:func:`staged`), one path that
the CPU tests also run.

* :func:`local_batch_positions` / :func:`assemble_global_batch` — each
  rank samples ONLY the episodes of its own positions of the global
  batch. The deterministic episode streams (data/sampler.py) make this
  coordination-free: position ``i`` of outer batch ``b`` is episode
  index ``b·B + i`` on every rank, so ranks agree on the global batch
  without exchanging a byte.
* The host-level agreement collectives (:func:`any_process_true`,
  :func:`agree_int_from_main`, :func:`gather_host_floats`, ...) run
  inside a ``collective`` watchdog phase (:func:`_collective`): a peer
  that dies mid-collective strands the survivors (the hang the
  ``watchdog_collective_timeout_s`` deadline ends, or the tighter
  ``cluster_collective_timeout_s`` with the pod fault domain armed) or
  makes the collective raise (gloo over TCP sees the closed pairs); the
  pod fault domain attributes both. The ``hang_collective`` fault fires
  inside that phase.

Every function is a no-op with one process (no process group).
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from howtotrainyourmamlpytorch_tpu_torch.device import (DeviceLike,
                                                        resolve_device)
from howtotrainyourmamlpytorch_tpu_torch.meta.inner import Episode
from howtotrainyourmamlpytorch_tpu_torch.resilience import (cluster, faults,
                                                            watchdog)

_ENV_RANK = "RANK"
_ENV_WORLD = "WORLD_SIZE"
_ENV_LOCAL_RANK = "LOCAL_RANK"
_ENV_LOCAL_WORLD = "LOCAL_WORLD_SIZE"
_ENV_ADDR = "MASTER_ADDR"
_ENV_PORT = "MASTER_PORT"


@contextlib.contextmanager
def _collective(name: str):
    """Watchdog + chaos scope every host-level collective enters.

    Stamps the ``collective`` phase (restoring the caller's phase with a
    fresh timestamp on exit), so a collective stranded by a dead peer
    trips ``watchdog_collective_timeout_s`` instead of whatever phase the
    caller was in. The ``hang_collective`` fault (call-counted:
    ``hang_collective@N`` sleeps the Nth collective) fires INSIDE the
    scope and before the one-process early returns, so a stuck
    collective is simulable on one process. An exception escaping the
    body (a transport error: a dead gloo peer raises here instead of
    hanging) goes through the pod fault domain's attributed peer-lost
    exit before it is re-raised. One None check each when no beacon,
    plan or domain is installed.
    """
    if faults.maybe_fire("hang_collective"):
        with watchdog.phase("collective", detail=name):
            faults.hang()
    with watchdog.phase("collective", detail=name):
        try:
            yield
        except Exception as e:
            # Exits EXIT_PEER_LOST (73) when a multi-process domain is
            # installed and the leases name a peer; otherwise (or with
            # an injected trip action) the error propagates unchanged.
            cluster.maybe_trip_on_collective_error(name, e)
            raise


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count(group=None) -> int:
    """Ranks in ``group`` (the default group when None); 1 without one."""
    return dist.get_world_size(group) if is_initialized() else 1


def process_index(group=None) -> int:
    """This process's rank in ``group``; 0 without a process group."""
    return dist.get_rank(group) if is_initialized() else 0


def backend(group=None) -> Optional[str]:
    """The group's backend (``"nccl"`` / ``"gloo"``); None without one."""
    return str(dist.get_backend(group)) if is_initialized() else None


def rank_device(device: DeviceLike = None) -> torch.device:
    """The device this rank runs on: ``device`` as given, except that a
    bare ``cuda`` under torchrun becomes ``cuda:(LOCAL_RANK %
    device_count)``. Raises as :func:`resolve_device` does when no card
    is there."""
    dev = resolve_device(device)
    if (dev.type == "cuda" and dev.index is None
            and _ENV_LOCAL_RANK in os.environ):
        dev = torch.device("cuda", int(os.environ[_ENV_LOCAL_RANK])
                           % torch.cuda.device_count())
    return dev


def choose_backend(device: torch.device) -> str:
    """NCCL when every rank of this node has a card of its own
    (``LOCAL_WORLD_SIZE`` <= the visible cards); gloo on the CPU, or
    when ranks share a card."""
    if device.type != "cuda":
        return "gloo"
    local_world = int(os.environ.get(
        _ENV_LOCAL_WORLD, os.environ.get(_ENV_WORLD, "1")))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def staged(tensor: torch.Tensor, group=None) -> bool:
    """Whether a device collective on ``tensor`` goes through pinned host
    memory: a CUDA tensor over a gloo group."""
    return tensor.is_cuda and backend(group) == "gloo"


def initialize_distributed(device: DeviceLike = None,
                           timeout_s: Optional[float] = None) -> bool:
    """Join the ranks torchrun started into the default process group.

    Reads ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``
    (the ``env://`` rendezvous) before anything else touches the group.
    With none of ``RANK`` / ``WORLD_SIZE`` set it is a no-op and returns
    False; a partial set raises. ``device`` is the caller's (the card by
    default): it picks the backend (:func:`choose_backend`), and NCCL
    binds the rank's card (:func:`rank_device`). ``timeout_s`` is the
    group's collective timeout (None: the backend's default, 30 minutes
    for gloo and 10 for NCCL); an armed pod fault domain passes
    ``cluster.process_group_timeout(cfg)``, so the backend cannot end a
    stranded rank before its attributed exit. Returns True iff more
    than one process runs after the call.
    """
    if is_initialized():
        return process_count() > 1
    wanted = (_ENV_RANK, _ENV_WORLD, _ENV_ADDR, _ENV_PORT)
    present = [v for v in wanted if v in os.environ]
    if _ENV_RANK not in os.environ and _ENV_WORLD not in os.environ:
        return False
    missing = [v for v in wanted if v not in present]
    if missing:
        raise RuntimeError(
            f"{' and '.join(v for v in present)} set but "
            f"{', '.join(missing)} missing; a torchrun launch sets all of "
            f"{', '.join(wanted)}")
    dev = rank_device(device)
    name = choose_backend(dev)
    if name == "nccl":
        torch.cuda.set_device(dev)
    kw = ({} if timeout_s is None
          else {"timeout": datetime.timedelta(seconds=float(timeout_s))})
    dist.init_process_group(name, init_method="env://",
                            rank=int(os.environ[_ENV_RANK]),
                            world_size=int(os.environ[_ENV_WORLD]), **kw)
    return process_count() > 1


def _control_device() -> torch.device:
    """Where a host-level collective's small tensor lives: the current
    card under NCCL (which moves CUDA tensors only), else the CPU."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _host_tensor(values: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(values)).to(
        _control_device())


def _all_gather_host(values: np.ndarray) -> np.ndarray:
    """All-gather a small host array; rows ordered by rank."""
    local = _host_tensor(values)
    out = [torch.empty_like(local) for _ in range(process_count())]
    dist.all_gather(out, local)
    return np.stack([t.cpu().numpy() for t in out])


def any_process_true(flag: bool) -> bool:
    """OR-reduce a host-level boolean across processes (no-op with one).
    Used to AGREE on control decisions that would otherwise
    desynchronize the ranks, e.g. the preemption stop: ranks that left
    the train loop at different iterations would wait forever in each
    other's collectives."""
    with _collective("any_process_true"):
        if process_count() <= 1:
            return bool(flag)
        return bool(np.any(_all_gather_host(
            np.asarray([bool(flag)], dtype=np.uint8))))


def any_process_true_each(flags: Sequence[bool]) -> List[bool]:
    """Element-wise OR-reduce a small vector of host-level booleans in
    ONE collective (no-op with one process). The train loop's sync point
    agrees on both stop decisions (divergence rewind, preemption) in one
    round."""
    with _collective("any_process_true_each"):
        if process_count() <= 1:
            return [bool(f) for f in flags]
        gathered = _all_gather_host(np.asarray(list(flags), dtype=np.uint8))
        return [bool(v) for v in np.any(
            gathered.reshape(-1, len(flags)), axis=0)]


def _encode_i64(values: Sequence[int]) -> np.ndarray:
    """Host-level ints as TWO int32 lanes each, the JAX package's wire
    encoding (its collectives canonicalize int64 to int32 without x64);
    the int32 view is exact for the full int64 range."""
    return np.asarray(list(values), dtype=np.int64).view(np.int32)


def _decode_i64(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(
        np.asarray(arr, dtype=np.int32).reshape(-1, 2)).view(
            np.int64).reshape(-1)


def abort_all_if_any(err, peer_msg: str) -> None:
    """Raise on EVERY process when any captured an error: the failing
    process re-raises its own exception, peers raise ``peer_msg``, so no
    process is left stranded inside a later collective."""
    if any_process_true(err is not None):
        raise err if err is not None else RuntimeError(
            peer_msg + "; aborting on all processes")


def agree_int_from_main(value: int) -> int:
    """Adopt process 0's value of a host-level int (no-op with one
    process). Used where every process makes a filesystem-dependent
    decision that MUST come out identical (which checkpoint tag to
    resume from, which iteration)."""
    with _collective("agree_int_from_main"):
        if process_count() <= 1:
            return int(value)
        t = _host_tensor(_encode_i64([int(value)]))
        dist.broadcast(t, src=0)
        return int(_decode_i64(t.cpu().numpy())[0])


def gather_host_floats(value: float) -> List[float]:
    """All-gather one host-level float per process, ordered by rank
    (``[value]`` with one process). The telemetry heartbeat's transport:
    every rank contributes its local step-time mean and sees the whole
    vector. A collective: every process calls it at the same point."""
    with _collective("gather_host_floats"):
        if process_count() <= 1:
            return [float(value)]
        gathered = _all_gather_host(np.asarray([float(value)], np.float64))
        return [float(v) for v in gathered.reshape(-1)]


def gather_host_ints(value: int) -> List[int]:
    """All-gather one host-level int per process, ordered by rank
    (``[value]`` with one process), in the int32-lane encoding."""
    with _collective("gather_host_ints"):
        if process_count() <= 1:
            return [int(value)]
        gathered = _all_gather_host(_encode_i64([int(value)]))
        return [int(v) for v in _decode_i64(gathered)]


def barrier(tag: str) -> None:
    """Cross-process barrier (no-op with one process): orders shared
    filesystem effects — process 0 writes (a checkpoint), every process
    passes the barrier, then all read. One tiny all-reduce, which every
    backend runs on its own device."""
    with _collective(f"barrier:{tag}"):
        if process_count() > 1:
            dist.all_reduce(_host_tensor(np.zeros(1, np.int32)))


def all_reduce_sum(buf: torch.Tensor, group=None) -> torch.Tensor:
    """In-place SUM of ``buf`` over ``group``'s ranks; staged through
    pinned host memory for a CUDA tensor over gloo (:func:`staged`).
    Every rank ends with the same bits."""
    if staged(buf, group):
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        host.copy_(buf)
        dist.all_reduce(host, group=group)
        buf.copy_(host)
    else:
        dist.all_reduce(buf, group=group)
    return buf


def all_gather_rows(buf: torch.Tensor, group=None) -> torch.Tensor:
    """``buf`` of every rank of ``group``, concatenated along dim 0 in
    rank order (equal shapes); staged like :func:`all_reduce_sum`."""
    n = process_count(group)
    if staged(buf, group):
        host = buf.cpu().pin_memory()
        out = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(out, host, group=group)
        return torch.cat(out).to(buf.device)
    out = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(out, buf.contiguous(), group=group)
    return torch.cat(out)


def local_batch_positions(mesh, batch_size: int) -> Tuple[int, int]:
    """This rank's one contiguous ``[start, stop)`` of the global batch
    axis: the batch is split over every mesh axis, dcn-major, so rank
    ``r`` owns ``[r·L, (r+1)·L)`` with ``L = batch_size / world``."""
    world = mesh.size
    if batch_size % world:
        raise ValueError(f"batch of {batch_size} tasks is not divisible "
                         f"by mesh size {world}")
    local = batch_size // world
    return mesh.rank * local, (mesh.rank + 1) * local


def assemble_global_batch(
        sample_range: Callable[[int, int], Episode],
        batch_size: int, mesh,
        positions: Optional[Tuple[int, int]] = None) -> Episode:
    """This rank's part of a global batch, sampling only its positions:
    ``sample_range(start, stop)`` returns the host Episode of global
    positions ``[start, stop)``. There is no global array in torch: the
    rank keeps its local Episode, and the train step's all-reduce (the
    eval step's all-gather) makes the result global. Pass a precomputed
    ``positions`` (from :func:`local_batch_positions`) for many
    batches."""
    start, stop = (local_batch_positions(mesh, batch_size)
                   if positions is None else positions)
    return sample_range(start, stop)
