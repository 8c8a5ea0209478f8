"""Warm-start store: CUDA-graph executables of the port's steps, and the
records that rebuild them in a fresh process (the port's counterpart of
the JAX package's ``parallel/aot.py``).

Eager PyTorch compiles one thing, the hand-written kernel; its build
cache is ``compilation_cache_dir`` (``ops/build.py § set_cache_dir``).
What a restart pays for besides is the host: a flagship train step
issues tens of thousands of small kernels. An *executable* here is a
``torch.cuda.CUDAGraph`` of one step at fixed shapes (:class:`GraphExec`),
with static input and output buffers: one replay issues the whole step.
A graph cannot be written to disk, so the store keeps what rebuilds it:
the executable's name, its input signature (shapes and dtypes), the
BN-kernel launches it captured and the capture's seconds.

The store is also the port's cost database (the JAX module's): every
capture whose card the store lacks counts its eager warm-up
(``telemetry/profiler.py § count_costs``) and records the executable's
cost card (FLOPs, bytes accessed, the graph's memory, the roofline
verdict) in the fingerprint directory's ``PROFILE.json``
(:meth:`AOTStore.record_cost_card`); a capture from a record whose card
is there counts nothing.

* A **hit** is a committed record of this fingerprint whose signature
  is the caller's: the executable is captured before the first step or
  request, off the request path (the trainer's and the engine's
  ``compile`` watchdog phase).
* A **miss** is captured at first use, then recorded.

Layout (one directory per fingerprint, the manifest idioms of
``ckpt/manifest.py``: pending -> committed records, whole-file CRC32,
GC of wreckage)::

    <aot_store_dir>/<fingerprint[:16]>/
        STORE.json          # full fingerprint + the doc it hashes
        MANIFEST.json       # per-record {file, bytes, crc, status}
        train_so0_msl1.graph.json
        eval.graph.json
        serve_adapt_s25.graph.json ...
        PROFILE.json        # cost cards by executable name

Nothing in this module is fatal: a foreign fingerprint, a corrupt record
(quarantined as ``*.corrupt``), an unwritable root or a capture that
fails is a counted miss or error, and the step runs eagerly. An
executable called with a signature it was not captured for demotes to
the eager step (:class:`GuardedExec`, ``aot/exec_fallbacks``).

Graphs need the card: with ``aot_store_dir`` set on a CPU device the
entry points raise ``ValueError`` (:func:`require_card`). The CPU tests
drive the store layer through an injected capture function.

Counters (the JAX module's names): ``aot/hits``, ``aot/misses``,
``aot/load_seconds``, ``aot/save_seconds``, ``aot/compile_seconds`` (the
captures), ``aot/errors``, ``aot/quarantined``, ``aot/gc_deletes`` and
``aot/exec_fallbacks``.
"""

from __future__ import annotations

import contextvars
import dataclasses
import hashlib
import json
import logging
import os
import shutil
import time
import warnings
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from howtotrainyourmamlpytorch_tpu_torch.ckpt.manifest import (
    Manifest, atomic_write_json, file_crc32)
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
from howtotrainyourmamlpytorch_tpu_torch.telemetry import profiler

log = logging.getLogger(__name__)

STORE_FILE = "STORE.json"
STORE_SCHEMA = "maml_torch_aot_store_v1"
RECORD_SUFFIX = ".graph.json"
# Bumped whenever the calling contract of a captured step changes: what
# its static buffers hold and what a replay returns.
LAYOUT_TAG = ("cudagraph;static-in,clone-out;"
              "train:state,batch->local graph->flat f32 sums->eager "
              "all-reduce->update graph->state,metrics (state carried "
              "in-graph);"
              "eval:state,batch->local graph->result->eager all-gather;"
              "serve:state,support*3->adapted|params,adapted,query->logits")
# Fingerprint directories kept by the GC beyond the age floor, and the
# floor itself (the JAX module's retention rules).
GC_KEEP_FINGERPRINTS = 4
GC_MIN_AGE_S = 14 * 24 * 3600.0
# A *.tmp.<pid> younger than this survives the startup sweep even when
# the pid probe is inconclusive (another host's writer).
SWEEP_TMP_GRACE_S = 30 * 60.0

HITS = "aot/hits"
MISSES = "aot/misses"
LOAD_SECONDS = "aot/load_seconds"
SAVE_SECONDS = "aot/save_seconds"
COMPILE_SECONDS = "aot/compile_seconds"
ERRORS = "aot/errors"
QUARANTINED = "aot/quarantined"
GC_DELETES = "aot/gc_deletes"
EXEC_FALLBACKS = "aot/exec_fallbacks"
COUNTERS = (HITS, MISSES, LOAD_SECONDS, SAVE_SECONDS, COMPILE_SECONDS,
            ERRORS, QUARANTINED, GC_DELETES, EXEC_FALLBACKS)

# Config fields that change no captured step (a copy of the JAX module's
# frozenset): paths, resume policy, host-side cadences, deadlines,
# checkpoint, serving and fleet policy. When in doubt a field stays in
# the hash: a spurious recapture is cheap, a wrong executable is not.
_RUNTIME_ONLY_KEYS = frozenset({
    "experiment_name", "experiment_root", "dataset_path",
    "dataset_pack_path", "dataset_name", "download_datasets",
    "load_into_memory", "labels_as_int", "sets_are_pre_split",
    "train_val_test_split", "indexes_of_folders_indicating_class",
    "continue_from_epoch", "total_epochs_before_pause",
    "evaluate_on_test_set_only", "max_models_to_save", "fault_spec",
    "divergence_patience", "divergence_spike_factor",
    "divergence_max_rewinds", "watchdog_step_timeout_s",
    "watchdog_feed_timeout_s", "watchdog_collective_timeout_s",
    "watchdog_compile_timeout_s", "watchdog_serve_timeout_s",
    "watchdog_ckpt_timeout_s", "watchdog_poll_interval_s",
    "flight_recorder_events", "require_mesh",
    "alert_rules_path",
    "cluster_collective_timeout_s", "cluster_lease_interval_s",
    "cluster_peer_stalled_s", "cluster_peer_dead_s",
    "elastic_mode", "elastic_max_lost_hosts", "elastic_reshard_timeout_s",
    "ckpt_async", "ckpt_queue_policy", "ckpt_publish",
    "serve_registry_poll_s", "serve_canary_episodes",
    "serve_canary_acc_drop", "serve_canary_latency_factor",
    "serve_max_queue_depth", "serve_default_deadline_ms",
    "serve_cache_capacity",
    "serve_l2_dir", "serve_l2_max_entries", "fleet_lease_interval_s",
    "fleet_replica_stalled_s", "fleet_replica_dead_s", "fleet_vnodes",
    "fleet_load_factor",
    "fleet_supervisor", "fleet_max_restarts", "fleet_restart_window_s",
    "fleet_scale_min", "fleet_scale_max", "fleet_shed_policy",
    "serve_continuous_batching", "serve_batch_linger_ms",
    "fleet_canary_weights", "fleet_canary_min_requests",
    "fleet_canary_burn_factor", "loadlab_trace_path",
    "loadlab_duration_s", "loadlab_base_rate", "loadlab_peak_rate",
    "loadlab_warp", "loadlab_churn_every_s",
    "health_grad_norm_warn_factor",
    "dispatch_sync_every", "live_progress", "use_tensorboard",
    "profile_dir", "profile_epoch", "profile_num_steps",
    "profile_every_n_steps",
    "compilation_cache_dir", "aot_store_dir", "prefetch_batches",
    "cache_eval_episodes", "precompile_phases", "ignored_keys",
})


# Set by load_or_compile around a capture whose cost card the store
# lacks: the GraphExec built inside counts its eager warm-up.
_COUNT_CAPTURE: contextvars.ContextVar = contextvars.ContextVar(
    "aot_count_capture", default=False)


def enabled(cfg: MAMLConfig) -> bool:
    return bool(cfg.aot_store_dir)


def require_card(cfg: MAMLConfig, device: torch.device) -> None:
    """``aot_store_dir`` on a CPU device raises: CUDA graphs need the
    card, and the port never quietly runs less than its config says."""
    if enabled(cfg) and torch.device(device).type != "cuda":
        raise ValueError(
            f"aot_store_dir is set but the device is {device}: the "
            f"port's executables are CUDA graphs, which need the card "
            f"(unset aot_store_dir to run on the CPU)")


def _cudnn_version() -> Optional[int]:
    try:
        return torch.backends.cudnn.version()
    except Exception:  # noqa: BLE001 — fingerprinting must not raise
        return None


def _world(world_size: Optional[int]) -> int:
    if world_size is not None:
        return int(world_size)
    from howtotrainyourmamlpytorch_tpu_torch.parallel import multihost
    return multihost.process_count()


def fingerprint_doc(cfg: MAMLConfig, device,
                    world_size: Optional[int] = None) -> Dict[str, Any]:
    """Everything that determines the captured steps, as one JSON doc:
    the structural config, torch, CUDA and cuDNN versions, the device's
    name, the world size and the layout tag (where the JAX module has
    jax, jaxlib, the backend and the mesh). Recorded verbatim in
    STORE.json so a mismatch can be read, not only detected.

    ``world_size`` overrides the live process group's (the JAX module's
    ``process_count``): ``scripts/torch_aot_prewarm.py --degraded``
    records a survivor roster's steps from one process, into the
    directory the survivor group's own fingerprint resolves after the
    reshard."""
    device = torch.device(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    return {
        "schema": STORE_SCHEMA,
        "config": {k: v for k, v in sorted(cfg.to_dict().items())
                   if k not in _RUNTIME_ONLY_KEYS},
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cudnn": _cudnn_version(),
        "device_name": name,
        "world_size": _world(world_size),
        "layout": LAYOUT_TAG,
    }


def store_fingerprint(cfg: MAMLConfig, device,
                      world_size: Optional[int] = None) -> str:
    doc = fingerprint_doc(cfg, device, world_size)
    blob = json.dumps(doc, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()


def train_exec_name(phase_key: Tuple[bool, bool]) -> str:
    so, msl = phase_key
    return f"train_so{int(so)}_msl{int(msl)}"


def serve_adapt_name(support_rows: int) -> str:
    # The adapt executable's signature depends only on the bucket's
    # support extent; two buckets sharing it share the executable.
    return f"serve_adapt_s{support_rows}"


def serve_predict_name(query_rows: int) -> str:
    return f"serve_predict_q{query_rows}"


# ---------------------------------------------------------------------------
# Argument trees: the tensors a step reads, flattened in a fixed order.

def flatten(obj: Any) -> Tuple[List[torch.Tensor], Any]:
    """``(tensor leaves, spec)`` of a tree of dicts, lists, tuples,
    NamedTuples and dataclasses. Anything else is a host value, kept in
    the spec as is (a graph cannot read it: the caller passes host
    values through buffers it fills, or patches them after a replay)."""
    leaves: List[torch.Tensor] = []

    def walk(o):
        if isinstance(o, torch.Tensor):
            leaves.append(o)
            return ("t",)
        if isinstance(o, dict):
            keys = sorted(o)
            return ("d", keys, [walk(o[k]) for k in keys])
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            names = [f.name for f in dataclasses.fields(o)]
            return ("c", type(o), names, [walk(getattr(o, n))
                                          for n in names])
        if isinstance(o, tuple) and hasattr(o, "_fields"):
            return ("n", type(o), [walk(v) for v in o])
        if isinstance(o, (list, tuple)):
            return ("l" if isinstance(o, list) else "u", [walk(v) for v in o])
        return ("v", o)

    return leaves, walk(obj)


def unflatten(spec: Any, leaves: Sequence[torch.Tensor]) -> Any:
    it = iter(leaves)

    def build(s):
        kind = s[0]
        if kind == "t":
            return next(it)
        if kind == "d":
            return {k: build(v) for k, v in zip(s[1], s[2])}
        if kind == "c":
            return s[1](**{n: build(v) for n, v in zip(s[2], s[3])})
        if kind == "n":
            return s[1](*(build(v) for v in s[2]))
        if kind in ("l", "u"):
            out = [build(v) for v in s[1]]
            return out if kind == "l" else tuple(out)
        return s[1]

    return build(spec)


def _structure(spec: Any) -> Any:
    """The spec without host values (which may change between calls)."""
    kind = spec[0]
    if kind == "t":
        return "t"
    if kind == "d":
        return ("d", tuple(spec[1]), tuple(_structure(v) for v in spec[2]))
    if kind == "c":
        return ("c", spec[1].__name__, tuple(spec[2]),
                tuple(_structure(v) for v in spec[3]))
    if kind == "n":
        return ("n", spec[1].__name__, tuple(_structure(v) for v in spec[2]))
    if kind in ("l", "u"):
        return (kind, tuple(_structure(v) for v in spec[1]))
    return "v"


def signature(tensors: Sequence[torch.Tensor]) -> List[List[Any]]:
    """``[[shape, dtype], ...]``: what a record stores and a replay
    checks."""
    return [[list(t.shape), str(t.dtype).replace("torch.", "")]
            for t in tensors]


def signature_of(*args: Any) -> List[List[Any]]:
    return signature(flatten(list(args))[0])


# ---------------------------------------------------------------------------


def graph_memory(static: Sequence[torch.Tensor],
                 outputs: Sequence[torch.Tensor], carry: Dict[int, int],
                 pool_bytes: int) -> Dict[str, int]:
    """A captured executable's ``memory`` (:class:`GraphExec`): static
    inputs, outputs, the outputs that are static inputs (``carry``: output
    index -> input index) and the pool's growth less the outputs it
    holds."""
    out_bytes = profiler.tree_bytes(list(outputs))
    alias = profiler.tree_bytes([outputs[j] for j in carry])
    return profiler.memory_stats(
        argument=profiler.tree_bytes(list(static)), output=out_bytes,
        temp=max(int(pool_bytes) - (out_bytes - alias), 0), alias=alias)


class GraphExec:
    """One call of ``fn(*args, **kwargs)`` captured into CUDA graphs.

    ``fn`` is one function, or a sequence of stages captured as one
    graph each: stage 0 is called as ``fn[0](*args, **kwargs)``, stage
    ``i`` as ``fn[i](*args, out)`` on stage ``i-1``'s output ``out``.
    ``between(out)`` runs eagerly on that output between two stages'
    replays (a rank's collective, which no graph holds); the warm-up and
    the captures skip it, so capturing makes no collective.

    The constructor copies the tensor leaves of ``args`` into static
    input buffers, runs the stages once on them on a side stream (the
    first-use work a capture cannot do: the kernel library and its
    shared-memory opt-in, cuDNN and cuBLAS handles, the allocator's
    blocks; its BN-kernel launches count as launches), then captures
    each stage on the thread that steps, in ``thread_local`` mode, so
    another thread's CUDA work (a loader's copies, an L2 writer) cannot
    fail the capture; the stages' graphs share one memory pool.
    ``launches``: the BN-kernel launches captured, ``stage_launches``
    per stage.

    Inside :func:`load_or_compile`'s request to count (the store lacks
    this executable's card), the warm-up runs under
    ``telemetry/profiler.py § count_costs``: ``costs`` then holds its
    FLOPs and bytes accessed, every stage summed (the ``between``
    collective runs in no stage and is not counted), and the graph's
    ``memory``, else ``costs`` is None. Nothing is counted under stream
    capture, and counting takes no extra run. ``memory`` (always): the
    static input buffers (argument), the outputs (output; those that are
    static inputs also as alias), and the graphs' pool, what
    ``torch.cuda.memory_reserved`` gains over the captures from the
    allocator's cache emptied, less the outputs it holds (temp);
    ``peak_bytes`` is their sum, as the JAX package defines it.

    A call checks that its arguments have the captured tensor structure,
    shapes, dtypes and device (else ``TypeError``, before any buffer is
    touched), copies them into the static buffers, replays the stages
    (``between`` after each but the last), adds ``launches`` to the BN
    kernel's count and returns the last stage's outputs as clones, so
    nothing the caller keeps is overwritten by the next replay. An
    output that IS a static input (a train step writes its new state
    there inside the graph) is carried: when the next call passes back
    the clone it was given, that buffer is not copied again. Host values
    in the arguments are not read by a replay; host values in the
    outputs are the captured call's (the caller patches them)."""

    def __init__(self, name: str, fn, args: Sequence[Any],
                 kwargs: Optional[Dict[str, Any]] = None, *,
                 between: Optional[Callable[[Any], Any]] = None):
        self.name = name
        stages = tuple(fn) if isinstance(fn, (tuple, list)) else (fn,)
        leaves, spec = flatten(list(args))
        if not leaves or any(not t.is_cuda for t in leaves):
            raise ValueError(f"{name}: a CUDA graph takes CUDA tensors")
        self.device = leaves[0].device
        self._structure = _structure(spec)
        self.signature = signature(leaves)
        self.static = [t.detach().clone() for t in leaves]
        static_args = unflatten(spec, self.static)
        kwargs = dict(kwargs or {})
        self._between = between

        def run(i, prev):
            if i == 0:
                return stages[0](*static_args, **kwargs)
            return stages[i](*static_args, prev)

        def warm_up():
            out = None
            for i in range(len(stages)):
                out = run(i, out)
            return out

        self.warmups = 1
        self.costs: Optional[Dict[str, Any]] = None
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            if _COUNT_CAPTURE.get():
                self.costs = profiler.counted(warm_up)[1]
            else:
                warm_up()
        current.wait_stream(side)
        torch.cuda.synchronize(self.device)
        self.warmup_seconds = time.perf_counter() - t0
        # A capture begins by releasing the allocator's cached blocks
        # (torch.cuda.graph): release them first, so that what the
        # reserved bytes gain over the captures is the graphs' pool.
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.stage_launches: List[int] = []
        # Stage i's output, which stage i+1's graph reads in place.
        self._stage_out: List[Any] = []
        out, pool = None, None
        for i in range(len(stages)):
            graph = torch.cuda.CUDAGraph()
            before = bn_act.captured
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                out = run(i, out)
            pool = graph.pool() if pool is None else pool
            self.graphs.append(graph)
            self.stage_launches.append(bn_act.captured - before)
            self._stage_out.append(out)
        torch.cuda.synchronize(self.device)
        pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph = self.graphs[0]
        self.launches = sum(self.stage_launches)
        self.capture_seconds = time.perf_counter() - t0
        self._outputs, self._out_spec = flatten(out)
        ids = {id(t): i for i, t in enumerate(self.static)}
        self._carry = {j: ids[id(t)] for j, t in enumerate(self._outputs)
                       if id(t) in ids}
        self.memory = graph_memory(self.static, self._outputs, self._carry,
                                   pool_bytes)
        if self.costs is not None:
            self.costs["memory"] = self.memory
        self._given: Dict[int, torch.Tensor] = {}
        self.replays = 0

    def record(self) -> Dict[str, Any]:
        """What the store keeps of this executable: one record for all
        its stages' graphs (the BN launches captured in each)."""
        return {"name": self.name, "signature": self.signature,
                "launches": self.launches,
                "graphs": [{"stage": i, "launches": n}
                           for i, n in enumerate(self.stage_launches)],
                "capture_seconds": round(self.capture_seconds, 4),
                "torch": torch.__version__}

    def __call__(self, *args: Any) -> Any:
        leaves, spec = flatten(list(args))
        if (_structure(spec) != self._structure
                or signature(leaves) != self.signature
                or any(t.device != self.device for t in leaves)):
            raise TypeError(
                f"{self.name}: arguments {signature(leaves)} do not match "
                f"the captured signature {self.signature}")
        for i, (s, x) in enumerate(zip(self.static, leaves)):
            if self._given.get(i) is not x:
                s.copy_(x)
        for i, graph in enumerate(self.graphs):
            if i:
                self._between(self._stage_out[i - 1])
            graph.replay()
        bn_act.count_replay(self.launches)
        self.replays += 1
        outs = [t.clone() for t in self._outputs]
        self._given = {i: outs[j] for j, i in self._carry.items()}
        return unflatten(self._out_spec, outs)


class AOTStore:
    """One fingerprint's record directory. Never raises from
    ``load``/``save``: every failure is counted, and the step runs
    eagerly or is captured anew."""

    def __init__(self, root: str, fingerprint: str,
                 doc: Optional[Dict[str, Any]] = None,
                 registry=None, writer: bool = True):
        self.root = root
        self.fingerprint = fingerprint
        self.registry = registry
        self.dir = os.path.join(root, fingerprint[:16])
        # writer=False: loads only, saves are silent no-ops (a non-main
        # rank, a read-only consumer).
        self._writer_requested = writer
        self.writable = False
        self.readable = False
        self.hits = 0
        self.misses = 0
        try:
            if writer:
                os.makedirs(self.dir, exist_ok=True)
                self.writable = os.access(self.dir, os.W_OK)
            self.manifest = Manifest(self.dir)
            store_doc = self._read_store_file()
            if store_doc is None:
                if self.writable:
                    atomic_write_json(
                        os.path.join(self.dir, STORE_FILE),
                        {"schema": STORE_SCHEMA, "fingerprint": fingerprint,
                         "doc": doc or {}})
                    self.readable = True
            elif store_doc.get("fingerprint") == fingerprint:
                self.readable = True
            else:
                # Foreign bytes under our key: never load, never write.
                self._count(ERRORS)
                warnings.warn(
                    f"AOT store dir {self.dir} records fingerprint "
                    f"{str(store_doc.get('fingerprint'))[:16]}… but this "
                    f"run computes {fingerprint[:16]}…; ignoring the "
                    f"store (eager fallback)")
                self.writable = False
            if writer and self.writable:
                # Freshness stamp for the shared-root GC.
                try:
                    os.utime(self.dir)
                except OSError:
                    pass
                self._sweep()
                self._gc_fingerprints()
        except Exception as e:  # noqa: BLE001 — a broken store mount
            # must cost misses, never the run.
            self._count(ERRORS)
            log.warning("AOT store unavailable at %s (%s: %s)",
                        self.dir, type(e).__name__, e)
            self.manifest = Manifest(self.dir)
            self.writable = False
            self.readable = False

    @classmethod
    def from_config(cls, cfg: MAMLConfig, device, registry=None,
                    writer: bool = True, world_size: Optional[int] = None
                    ) -> Optional["AOTStore"]:
        """The wiring entry point: None when the subsystem is off. The
        world size is the live process group's unless given."""
        if not enabled(cfg):
            return None
        world = _world(world_size)
        return cls(cfg.aot_store_dir, store_fingerprint(cfg, device, world),
                   doc=fingerprint_doc(cfg, device, world),
                   registry=registry, writer=writer)

    # -- internals -------------------------------------------------------
    def _count(self, name: str, value: float = 1) -> None:
        if self.registry is not None:
            try:
                self.registry.counter(name).inc(value)
            except Exception:  # noqa: BLE001
                pass

    def _read_store_file(self) -> Optional[Dict[str, Any]]:
        try:
            with open(os.path.join(self.dir, STORE_FILE)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _sweep(self) -> None:
        """Startup GC: tmp leftovers and pending records of a killed save
        are wreckage, except a live co-writer's in-flight tmp (its pid is
        alive on this host, or it is younger than the grace window)."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return
        now = time.time()
        removed = 0
        for name in names:
            path = os.path.join(self.dir, name)
            if name.endswith(".tmp") or ".tmp." in name:
                if self._tmp_in_flight(name, path, now):
                    continue
                try:
                    os.remove(path)
                    removed += 1
                except OSError:
                    pass
            elif name.endswith(".corrupt"):
                try:
                    if now - os.path.getmtime(path) > GC_MIN_AGE_S:
                        os.remove(path)
                        removed += 1
                except OSError:
                    pass
        stale = [r["tag"] for r in self.manifest.pending()]
        if stale:
            self.manifest.remove_many(stale)
            removed += len(stale)
        if removed:
            self._count(GC_DELETES, removed)

    @staticmethod
    def _tmp_in_flight(name: str, path: str, now: float) -> bool:
        pid_part = name.rsplit(".", 1)[-1]
        if pid_part.isdigit():
            try:
                os.kill(int(pid_part), 0)
                return True
            except ProcessLookupError:
                pass
            except (OSError, OverflowError):
                return True   # EPERM: the pid exists but is not ours
        try:
            return now - os.path.getmtime(path) < SWEEP_TMP_GRACE_S
        except OSError:
            return False

    def _gc_fingerprints(self) -> None:
        """Drop the least recently opened fingerprint directories beyond
        the retention budget; nothing younger than GC_MIN_AGE_S goes."""
        try:
            entries = []
            for name in os.listdir(self.root):
                path = os.path.join(self.root, name)
                if (os.path.isdir(path)
                        and os.path.isfile(os.path.join(path, STORE_FILE))):
                    entries.append((os.path.getmtime(path), path))
        except OSError:
            return
        entries.sort(reverse=True)
        me = os.path.abspath(self.dir)
        now = time.time()
        keep, dropped = 0, 0
        for mtime, path in entries:
            if os.path.abspath(path) == me or now - mtime <= GC_MIN_AGE_S:
                continue
            keep += 1
            if keep >= GC_KEEP_FINGERPRINTS:
                shutil.rmtree(path, ignore_errors=True)
                dropped += 1
        if dropped:
            self._count(GC_DELETES, dropped)

    def _refresh_manifest(self) -> None:
        """Re-read MANIFEST.json (several processes may write one store;
        each rewrite must carry the others' records)."""
        try:
            fresh = Manifest(self.dir)
        except Exception:  # noqa: BLE001 — keep the current view
            return
        if fresh.loaded:
            self.manifest = fresh

    def _quarantine(self, name: str, path: str) -> None:
        self._count(QUARANTINED)
        try:
            os.replace(path, path + ".corrupt")
        except OSError:
            pass
        try:
            self.manifest.remove(name)
        except Exception:  # noqa: BLE001
            pass

    # -- the store contract ----------------------------------------------
    def load(self, name: str, count: bool = True
             ) -> Optional[Dict[str, Any]]:
        """Executable ``name``'s record, or None (a counted miss).

        Validation before the parse: store fingerprint (constructor),
        committed manifest record, byte count, whole-file CRC32; a
        damaged record is quarantined. ``count=False`` leaves the hit
        and miss counters alone (a re-probe)."""
        t0 = time.perf_counter()

        def _miss() -> None:
            if count:
                self.misses += 1
                self._count(MISSES)

        try:
            if not self.readable:
                _miss()
                return None
            rec = self.manifest.get(name)
            if rec is None or rec.get("status") != "committed":
                self._refresh_manifest()
                rec = self.manifest.get(name)
            if rec is None or rec.get("status") != "committed":
                _miss()
                return None
            path = os.path.join(self.dir, rec["file"])
            try:
                size = os.path.getsize(path)
            except OSError:
                _miss()
                return None
            if size != int(rec.get("bytes") or 0) \
                    or file_crc32(path) != int(rec.get("crc") or 0):
                self._quarantine(name, path)
                _miss()
                return None
            with open(path) as f:
                record = json.load(f)
            if not isinstance(record, dict) or record.get("name") != name:
                raise ValueError(f"record names {record.get('name')!r}")
            if count:
                self.hits += 1
                self._count(HITS)
            return record
        except Exception as e:  # noqa: BLE001 — unparsable record: a
            # counted miss, quarantined so the next run recaptures.
            log.warning("AOT load of %r failed (%s: %s); eager fallback",
                        name, type(e).__name__, e)
            try:
                rec = self.manifest.get(name)
                if rec is not None:
                    self._quarantine(name,
                                     os.path.join(self.dir, rec["file"]))
            except Exception:  # noqa: BLE001
                pass
            _miss()
            self._count(ERRORS)
            return None
        finally:
            self._count(LOAD_SECONDS, time.perf_counter() - t0)

    def save(self, name: str, record: Dict[str, Any]) -> bool:
        """Write ``record`` under ``name`` with a manifest-framed atomic
        commit. False (counted) on any failure."""
        if not self.writable:
            if self._writer_requested:
                self._count(ERRORS)
            return False
        t0 = time.perf_counter()
        try:
            payload = json.dumps({**record, "name": name},
                                 sort_keys=True).encode()
            filename = f"{name}{RECORD_SUFFIX}"
            path = os.path.join(self.dir, filename)
            self._refresh_manifest()
            self.manifest.begin(name, flush=False)["file"] = filename
            self.manifest.flush()
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            # Commit from the freshest view; reopen our record if a
            # co-writer's sweep dropped it meanwhile.
            self._refresh_manifest()
            if self.manifest.get(name) is None:
                self.manifest.begin(name, flush=False)["file"] = filename
            self.manifest.commit(name, nbytes=len(payload),
                                 crc=zlib.crc32(payload))
            self._count(SAVE_SECONDS, time.perf_counter() - t0)
            return True
        except Exception as e:  # noqa: BLE001
            log.warning("AOT save of %r failed (%s: %s); the next run "
                        "captures it again", name, type(e).__name__, e)
            self._count(ERRORS)
            return False


    # -- the cost database ------------------------------------------------
    def profile_path(self) -> str:
        """This fingerprint directory's PROFILE.json (may not exist)."""
        return os.path.join(self.dir, profiler.PROFILE_FILE)

    def cost_card(self, name: str) -> Optional[Dict[str, Any]]:
        """Executable ``name``'s recorded cost card, or None."""
        doc = profiler.load_profile(self.profile_path())
        return None if doc is None else doc["cards"].get(name)

    def records_cards(self) -> bool:
        """Whether :meth:`record_cost_card` writes (the writer only)."""
        return self.writable and self._writer_requested

    def record_cost_card(self, name: str, card: Dict[str, Any],
                         only_if_missing: bool = False) -> bool:
        """Merge executable ``name``'s cost card into this fingerprint
        directory's PROFILE.json (``profiler.merge_profile``), stamped
        with the store's ``fingerprint[:16]``. Writer only (``writer=
        False`` records nothing), best-effort: a card is observability,
        never worth failing a capture over. ``only_if_missing`` keeps a
        card already there."""
        if not self.records_cards():
            return False
        try:
            if only_if_missing and self.cost_card(name) is not None:
                return True
            card = {**card, "name": name,
                    "fingerprint": self.fingerprint[:16]}
            profiler.merge_profile(self.profile_path(), [card],
                                   device_kind=card.get("device_kind", ""),
                                   fingerprint=self.fingerprint)
            return True
        except Exception as e:  # noqa: BLE001 — observability only
            log.warning("cost card for %r not recorded (%s: %s)", name,
                        type(e).__name__, e)
            return False


class GuardedExec:
    """An executable with a one-way escape to the eager step.

    Called with arguments it cannot take (``TypeError``/``ValueError``
    raised before it touches anything), it demotes itself to
    ``fallback`` for the rest of the run, counted in
    ``aot/exec_fallbacks`` and warned once."""

    def __init__(self, compiled, fallback: Callable, name: str,
                 registry=None):
        self._compiled = compiled
        self._fallback = fallback
        self._name = name
        self._registry = registry

    @property
    def compiled(self):
        """The wrapped executable (None after demotion)."""
        return self._compiled

    def __call__(self, *args, **kwargs):
        if self._compiled is None:
            return self._fallback(*args, **kwargs)
        try:
            return self._compiled(*args, **kwargs)
        except (TypeError, ValueError) as e:
            self._compiled = None
            if self._registry is not None:
                try:
                    self._registry.counter(EXEC_FALLBACKS).inc()
                except Exception:  # noqa: BLE001
                    pass
            warnings.warn(
                f"AOT executable {self._name!r} rejected its arguments "
                f"({type(e).__name__}: {e}); demoted to the eager step "
                f"for the rest of this run")
            return self._fallback(*args, **kwargs)


def probe(store: AOTStore, name: str, sig: List[List[Any]],
          count: bool = True) -> bool:
    """Whether the store holds a record of ``name`` for signature
    ``sig`` (a hit), counted as a hit or a miss. A record for another
    signature is no executable of this caller's: a miss."""
    record = store.load(name, count=False)
    hit = record is not None and record.get("signature") == sig
    if count:
        if hit:
            store.hits += 1
            store._count(HITS)
        else:
            store.misses += 1
            store._count(MISSES)
    return hit


def load_or_compile(store: Optional[AOTStore], name: str,
                    capture: Callable[[], Any], sig: List[List[Any]],
                    registry=None, save: bool = True,
                    fallback: Optional[Callable] = None,
                    compile_on_miss: bool = True, count_load: bool = True
                    ) -> Tuple[Callable, bool]:
    """The adoption primitive: ``(callable, hit)``.

    A record of ``name`` with signature ``sig`` is a hit: ``capture()``
    builds the executable from it now. A miss (no record, or one for
    another signature) captures now too, unless ``compile_on_miss`` is
    False (the caller captures at first use), and records it. The
    callable is a :class:`GuardedExec` over ``fallback`` (the eager
    step). ``store=None`` returns ``fallback``. A capture that fails is
    a counted error and leaves the eager step.

    Every capture on a miss, and a capture on a hit whose cost card the
    store lacks, counts its warm-up and records the executable's card
    (:func:`record_capture_card`); a writer-less store counts nothing."""
    if store is None:
        return fallback, False
    hit = probe(store, name, sig, count=count_load)
    if not hit and not compile_on_miss:
        return fallback, False
    want_card = store.records_cards() and (
        not hit or store.cost_card(name) is None)
    t0 = time.perf_counter()
    token = _COUNT_CAPTURE.set(want_card)
    try:
        compiled = capture()
    except Exception as e:  # noqa: BLE001 — the eager step stays right
        store._count(ERRORS)
        log.warning("AOT capture of %r failed (%s: %s); eager step",
                    name, type(e).__name__, e)
        return fallback, False
    finally:
        _COUNT_CAPTURE.reset(token)
    store._count(COMPILE_SECONDS, time.perf_counter() - t0)
    if want_card:
        record_capture_card(store, name, compiled)
    fresh = {**compiled.record(), "signature": sig}
    if hit:
        record = store.load(name, count=False) or {}
        if ((record.get("launches"), record.get("graphs"))
                != (fresh.get("launches"), fresh.get("graphs"))):
            # The record says the step captured another number of BN
            # launches (in all, or in one of its graphs): the executable
            # is right by construction, the record is stale; count it
            # and write the new one.
            store._count(ERRORS)
            if save:
                store.save(name, fresh)
    elif save:
        store.save(name, fresh)
    return GuardedExec(compiled, fallback, name, registry), hit


def record_capture_card(store: AOTStore, name: str, compiled) -> bool:
    """Record the cost card of a capture that counted its warm-up
    (``compiled.costs``; an executable without one records nothing). A
    count that failed records ``flops_source`` ``"unavailable"`` and adds
    one to ``perf/errors``."""
    costs = getattr(compiled, "costs", None)
    if costs is None:
        return False
    kind = profiler.device_kind(getattr(compiled, "device", None))
    card = profiler.card_from_costs(name, costs, kind=kind,
                                    peaks=profiler.resolve_peaks(kind),
                                    memory=costs.get("memory"))
    if "count_error" in card:
        store._count(profiler.ERRORS_COUNTER)
    return store.record_cost_card(name, card)


# ---------------------------------------------------------------------------
# The steps as executables. ONE place builds the arguments every consumer
# captures with (the trainer, the engine and scripts/torch_aot_prewarm.py),
# so a prewarmed record always carries the signature its consumer asks for.

def zero_episode(cfg: MAMLConfig, tasks: int, device) -> Any:
    """A batch of ``tasks`` all-zero tasks in the loader's wire dtypes
    (``data/loader.py § _zero_episodes``), on ``device``: what a capture
    runs on (a replay reads the caller's batch)."""
    import numpy as np

    from howtotrainyourmamlpytorch_tpu_torch.meta.inner import Episode
    h, w, c = cfg.image_shape
    img = np.uint8 if cfg.transfer_images_uint8 else np.float32
    lbl = np.dtype(cfg.label_dtype)
    s, t = cfg.num_support_per_task, cfg.num_target_per_task
    return Episode(*(torch.from_numpy(a).to(device) for a in (
        np.zeros((tasks, s, h, w, c), img), np.zeros((tasks, s), lbl),
        np.zeros((tasks, t, h, w, c), img), np.zeros((tasks, t), lbl))))


def _copy_into(dst: Any, src: Any) -> None:
    """Copy tree ``src`` into tree ``dst`` leaf by leaf, by key."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        dst.copy_(src)


class TrainGraph:
    """The train step of one phase key ``(second_order, use_msl)`` as a
    :class:`GraphExec` of two graphs around the step's one collective,
    called like the eager step: the rank-local accumulation
    (``TrainPieces.local``) into its flat f32 buffer, the all-reduce
    (``TrainPieces.reduce``: gloo staged through pinned host memory, or
    NCCL) run eagerly on that static buffer, then the update
    (``TrainPieces.update``) reading it. Without a process group the
    reduce does nothing: one process's step is the world-1 case.
    ``train_step`` is a step of ``meta/outer.py § make_train_step`` (its
    ``pieces``).

    The graphs read their host values from their own
    :class:`meta.outer.StepScalars` (the MSL epoch, the meta-LR and
    Adam's bias corrections), filled from ``state.opt_state.count`` and
    ``epoch`` before every replay; the update writes the new state into
    the static state buffers inside its graph, and a replay returns
    clones of them with the counters of the step (``opt_state.count``,
    ``step``) and the meta-LR of ``state.step`` set on the host, as the
    eager step sets them. A step with ``health`` or ``plain`` runs the
    eager step. Its one cost card (``costs``) sums both graphs' warm-up;
    the all-reduce between them is not counted."""

    def __init__(self, cfg: MAMLConfig, train_step: Callable,
                 phase_key: Tuple[bool, bool], state, batch, epoch: int):
        from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
            StepScalars, meta_lr_schedule)
        self.cfg = cfg
        self.phase_key = phase_key
        self._eager = train_step
        pieces = train_step.pieces
        self._schedule = meta_lr_schedule(cfg)
        self.scalars = StepScalars(batch.support_x.device).fill(
            cfg, state.opt_state.count, epoch)
        so, msl = phase_key
        layout = []

        def local(state, batch):
            flat, lay = pieces.local(state, batch, self.scalars.epoch,
                                     second_order=so, use_msl=msl)
            layout[:] = [lay]
            return flat

        def update(state, batch, flat):
            new, m = pieces.update(state, flat, layout[0],
                                   scalars=self.scalars)
            for a, b in ((state.params, new.params),
                         (state.lslr, new.lslr),
                         (state.bn_state, new.bn_state),
                         (state.opt_state.mu, new.opt_state.mu),
                         (state.opt_state.nu, new.opt_state.nu)):
                _copy_into(a, b)
            return state, (m.loss, m.accuracy, m.support_loss)

        self.exec = GraphExec(train_exec_name(phase_key), (local, update),
                              (state, batch), between=pieces.reduce)
        self.launches = self.exec.launches
        self.costs, self.device = self.exec.costs, self.exec.device

    def record(self) -> Dict[str, Any]:
        return self.exec.record()

    def __call__(self, state, batch, epoch, *, second_order: bool,
                 use_msl: bool, plain: bool = False, health: bool = False):
        from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
            AdamState, StepMetrics)
        if (second_order, use_msl) != self.phase_key:
            raise ValueError(f"{self.exec.name} runs phase "
                             f"{self.phase_key}, not "
                             f"{(second_order, use_msl)}")
        if plain or health:
            return self._eager(state, batch, epoch,
                               second_order=second_order, use_msl=use_msl,
                               plain=plain, health=health)
        self.scalars.fill(self.cfg, state.opt_state.count, epoch)
        new, (loss, acc, s_loss) = self.exec(state, batch)
        new = dataclasses.replace(
            new, step=state.step + 1,
            opt_state=AdamState(count=state.opt_state.count + 1,
                                mu=new.opt_state.mu, nu=new.opt_state.nu))
        return new, StepMetrics(loss=loss, accuracy=acc,
                                support_loss=s_loss,
                                learning_rate=self._schedule(state.step))


class EvalGraph:
    """The eval step as a :class:`GraphExec` of the rank-local eval
    (``EvalPieces.local``) over ``(params, lslr, bn_state, batch)``,
    then the step's one all-gather run eagerly on the replay's outputs
    (``EvalPieces.gather``; nothing without a process group). Called
    like the eager step (``plain`` runs the eager one); ``eval_step`` is
    a step of ``meta/outer.py § make_eval_step`` (its ``pieces``). Its
    cost card (``costs``) counts the local graph's warm-up, not the
    all-gather."""

    @staticmethod
    def signature(state, batch) -> List[List[Any]]:
        """What a record of the eval step is keyed on."""
        return signature_of(state.params, state.lslr, state.bn_state, batch)

    def __init__(self, eval_step: Callable, state, batch):
        from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
            AdamState, MetaTrainState)
        self._eager = eval_step
        pieces = eval_step.pieces
        self._gather = pieces.gather

        def body(params, lslr, bn_state, batch):
            return tuple(pieces.local(MetaTrainState(
                params=params, lslr=lslr, bn_state=bn_state,
                opt_state=AdamState(count=0, mu={}, nu={})), batch))

        self.exec = GraphExec("eval", body, (state.params, state.lslr,
                                             state.bn_state, batch))
        self.launches = self.exec.launches
        self.costs, self.device = self.exec.costs, self.exec.device

    def record(self) -> Dict[str, Any]:
        return self.exec.record()

    def __call__(self, state, batch, *, plain: bool = False):
        from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
            EvalResult)
        if plain:
            return self._eager(state, batch, plain=True)
        return EvalResult(*self._gather(self.exec(
            state.params, state.lslr, state.bn_state, batch)))


def serve_adapt_args(cfg: MAMLConfig, state, support_rows: int,
                     device) -> Tuple:
    """The serve adapt executable's arguments for one support extent:
    ``(params, lslr, bn_state, support_x, support_y, support_w)`` as
    ``serve/engine.py § _run_adapt`` passes them (wire-dtype images,
    int64 labels, f32 weights; ones, so the capture's run is finite)."""
    b = cfg.serve_batch_tasks
    h, w, c = cfg.image_shape
    wire = torch.uint8 if cfg.transfer_images_uint8 else torch.float32
    return (state.params, state.lslr, state.bn_state,
            torch.zeros((b, support_rows, h, w, c), dtype=wire,
                        device=device),
            torch.zeros((b, support_rows), dtype=torch.long, device=device),
            torch.ones((b, support_rows), dtype=torch.float32,
                       device=device))


def serve_predict_args(cfg: MAMLConfig, state, query_rows: int,
                       device) -> Tuple:
    """The predict executable's arguments for one query extent:
    ``(params, fast, bn_state, query_x)``, the adapted trees stacked
    over the serve batch as ``serve/engine.py § _run_predict`` stacks
    its entries (each adapted leaf has its parameter's shape)."""
    from howtotrainyourmamlpytorch_tpu_torch.meta.inner import (
        split_fast_slow)
    from howtotrainyourmamlpytorch_tpu_torch.tree import tree_map
    b = cfg.serve_batch_tasks
    h, w, c = cfg.image_shape
    wire = torch.uint8 if cfg.transfer_images_uint8 else torch.float32
    stacked = lambda t: torch.zeros((b, *t.shape), dtype=t.dtype,
                                    device=device)
    fast, _ = split_fast_slow(cfg, state.params)
    return (state.params, tree_map(stacked, fast),
            tree_map(stacked, state.bn_state),
            torch.zeros((b, query_rows, h, w, c), dtype=wire,
                        device=device))
