"""ServingEngine: checkpoint → batcher → cache → adapt → predict
(counterpart of the JAX ``serve/engine.py``).

The request lifecycle:

1. ``submit`` buckets the request (BucketError if nothing fits or the
   wire dtype / image shape / labels are off; ShedError when the shed
   policy refuses it) and enqueues it (QueueFullError past
   ``serve_max_queue_depth``).
2. ``step`` dequeues one same-bucket group (a continuous-batching
   assembler, when on, decides when a group is dispatched) and answers
   requests whose deadline already passed with a ``failed`` response.
3. Each request's support set is fingerprinted; L1 hits skip
   adaptation, and with ``serve_l2_dir`` an L1 miss probes the shared
   L2 tier before adapting. Misses are padded into one
   ``(serve_batch_tasks, bucket)`` batch and adapted together
   (serve/adapt.py), cached, and published to the L2 tier from a writer
   thread.
4. One batched predict over the whole group (hits + fresh) gives the
   query logits; padding is sliced off and responses carry argmax
   predictions + logits.

Every stage records into the engine's ``MetricsRegistry`` under the JAX
engine's metric names; ``flush_metrics`` writes one ``metrics`` row that
the JAX package's ``scripts/telemetry_report.py`` renders as its
"serving" section. Request tracing (``reqtrace_sample_rate > 0``) and
alert rules (``alert_rules_path``) are installed only when asked for.

The engine runs on one device: the card unless the caller passes
``device="cpu"``. Adapt and predict run f32 configs with TF32 off
(``device.numerics_policy``; cuDNN's algorithm choice is left free).

Hot-swap: an engine built by ``from_checkpoint`` polls the model
registry (``REGISTRY.json`` beside the checkpoints) in
``maybe_hot_swap``, loads a newly published version between steps, runs
a canary (pinned probe episodes adapted and predicted on both versions,
compared on finiteness, accuracy and adapt latency) and swaps on a pass.
Cache keys fold in the checkpoint's fingerprint, so every entry adapted
under the old weights misses under the new ones. A failed canary keeps
the live version, counts ``serve/hot_swap_rollbacks`` and pins the
version so it is never tried again.

Watchdog (``resilience/watchdog.py``): with ``watchdog_serve_timeout_s >
0`` and no beacon installed in the process (a training-owned watchdog
wins), the engine installs its own beacon, flight recorder and watchdog,
writing to ``<experiment_root>/<experiment_name>/logs/crash_bundle_serve``.
Every ``submit`` and ``step`` runs under a ``serve_request`` scope,
``warmup`` and a candidate's load and warm-up under ``compile``; each
scope restores the previous phase on exit, so an idle engine sits in
``idle`` and never trips. The engine's own watchdog enforces only the
phases the engine stamps. ``close`` (or the engine's collection) stops
it and restores the process's previous beacon and recorder.

Warm start (``parallel/aot.py``, the JAX engine's
``_adopt_serve_bucket``): ``compilation_cache_dir`` is the kernel build
cache while the engine lives. With ``aot_store_dir`` (the card only: a
``ValueError`` on the CPU) each bucket's adapt and predict run as CUDA
graphs, one per support extent and one per query extent, captured by
``warmup`` (or at a bucket's first use): from the store's records (hits)
or captured and recorded (misses). A capture's one run on zero requests
counts as an adapt or predict run (``adapt_runs``, ``predict_runs``);
the hot-swap canary replays the same graphs on the candidate's state.
"""

from __future__ import annotations

import os
import queue
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from howtotrainyourmamlpytorch_tpu_torch import resilience
from howtotrainyourmamlpytorch_tpu_torch.ckpt.registry import ModelRegistry
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.device import (DeviceLike,
                                                        numerics_policy,
                                                        resolve_device,
                                                        synchronize)
from howtotrainyourmamlpytorch_tpu_torch.meta.inner import (
    adapted_param_counts)
from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
    MetaTrainState, init_train_state, migrate_lslr_rows,
    reconcile_loaded_shapes, state_leaf_shapes)
from howtotrainyourmamlpytorch_tpu_torch.models import make_model
from howtotrainyourmamlpytorch_tpu_torch.ops import build
from howtotrainyourmamlpytorch_tpu_torch.parallel import aot
from howtotrainyourmamlpytorch_tpu_torch.resilience import (flightrec,
                                                            watchdog)
from howtotrainyourmamlpytorch_tpu_torch.serve.adapt import (
    AdaptedTask, adapt_task, predict_tasks)
from howtotrainyourmamlpytorch_tpu_torch.serve.batcher import (
    AdmissionController, FewShotRequest, GroupAssembler, QueueFullError,
    RequestBatcher, ShedError, pad_group)
from howtotrainyourmamlpytorch_tpu_torch.serve.cache import (
    AdaptedParamsLRU, support_fingerprint)
from howtotrainyourmamlpytorch_tpu_torch.serve.fleet.l2cache import (
    L2AdaptedParamsCache)
from howtotrainyourmamlpytorch_tpu_torch.telemetry import alerts, reqtrace
from howtotrainyourmamlpytorch_tpu_torch.telemetry.registry import (
    MetricsRegistry)
from howtotrainyourmamlpytorch_tpu_torch.tree import index, stack, tree_map
from howtotrainyourmamlpytorch_tpu_torch.utils.checkpoint import (
    LATEST, CheckpointManager, CorruptCheckpointError)
from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import JsonlLogger

# The phases the engine stamps, which its own watchdog enforces.
SERVE_PHASES = ("serve_request", "compile")

# Batch occupancy lives in [1/B, 1]; the registry's default exponential
# buckets would put every observation into two slots.
_OCCUPANCY_BUCKETS = tuple(i / 16 for i in range(1, 17))

# L2 publishes waiting for the writer thread; a full queue drops the
# publish (counted): it only costs the next cross-replica repeat an adapt.
_L2_QUEUE_DEPTH = 64


def _release_watchdog(dog, beacon, prev_beacon, recorder,
                      prev_recorder) -> None:
    """Stop an engine-owned watchdog and hand the process back its
    previous beacon and recorder, unless another owner replaced them."""
    dog.stop()
    if watchdog.get_beacon() is beacon:
        watchdog.install_beacon(prev_beacon)
    if flightrec.get() is recorder:
        flightrec.install(prev_recorder)


@dataclass
class FewShotResponse:
    """Per-request result: argmax ``predictions`` and ``(Q, N)`` ``logits``
    over the request's real query rows. ``status`` is ``"ok"``,
    ``"failed"`` (a deadline miss after queueing; ``error`` says why and
    the arrays are None), or, on the fleet's wire, ``"shed"`` /
    ``"rejected"``. ``cache_tier`` names where the adaptation came from:
    ``"l1"``, ``"l2"`` or None (freshly adapted)."""
    request_id: int
    predictions: Optional[np.ndarray]
    logits: Optional[np.ndarray]
    cache_hit: bool
    latency_seconds: float
    error: Optional[str] = None
    cache_tier: Optional[str] = None
    status: str = "ok"


def _to_host(tree: Any) -> Any:
    """A tensor tree as numpy arrays (the L2 tier's leaves)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


class ServingEngine:
    """Batched few-shot inference from a meta-initialization."""

    def __init__(self, cfg: MAMLConfig, state: MetaTrainState,
                 device: DeviceLike = None,
                 registry: Optional[MetricsRegistry] = None,
                 state_context: str = ""):
        self.cfg = cfg
        self.device = resolve_device(device)
        aot.require_card(cfg, self.device)
        self.model_init, self.model_apply = make_model(cfg)
        self.num_adapt_steps = cfg.effective_serve_adapt_steps
        self.state = state.to(self.device)
        # Cache entries die with the weights that produced them: the
        # fingerprint folds in this context. ``backend=torch`` keeps the
        # port's entries apart from the JAX package's: both packages
        # fingerprint a checkpoint file by its bytes, but their adapted
        # leaves have different layouts, so a shared L2 directory must
        # never hand one package the other's entry.
        self._fp_context = self._context(state_context)
        self.batcher = RequestBatcher(
            cfg.serve_bucket_shapes,
            max_queue_depth=cfg.serve_max_queue_depth,
            default_deadline_ms=cfg.serve_default_deadline_ms,
            wire_dtype=(np.uint8 if cfg.transfer_images_uint8
                        else np.float32),
            image_shape=cfg.image_shape,
            num_classes=cfg.num_classes_per_set)
        # Shed-at-admission and continuous batching are installed only
        # when on: off, the batcher's hooks stay None and dispatch is
        # the plain FIFO grouping.
        if cfg.fleet_shed_policy != "off":
            self.batcher.admission = AdmissionController(
                cfg.serve_batch_tasks, cfg.serve_max_queue_depth,
                policy=cfg.fleet_shed_policy)
        self._cb_mirrored = (0, 0, 0)
        if cfg.serve_continuous_batching:
            self.batcher.assembler = GroupAssembler(
                cfg.serve_batch_tasks, cfg.serve_batch_linger_ms)
        self._adm_last_done: Optional[float] = None
        self._adm_backlog_at_done = False
        self.cache = AdaptedParamsLRU(cfg.serve_cache_capacity)
        self.registry = registry if registry is not None else (
            MetricsRegistry())
        # Eager registration gated on each knob: a flush row shows "0",
        # not an absent key, and a default engine's snapshot has none.
        if self.batcher.assembler is not None:
            for name in ("serve/cb_groups", "serve/cb_fill_dispatch",
                         "serve/cb_linger_dispatch"):
                self.registry.counter(name)
        if self.batcher.admission is not None:
            self.registry.counter("serve/shed_total")
        adapted, total = adapted_param_counts(cfg, state.params)
        self.registry.gauge("algo/adapted_params").set(adapted)
        self.registry.gauge("algo/total_params").set(total)
        # Request-path timings (device-synchronized) and counts: the
        # recorded ones exclude warm-up and canary batches; ``*_runs``
        # count every batch this engine ran, the BN kernel's launches
        # follow from them.
        self.adapt_invocations = 0
        self.predict_invocations = 0
        self.adapt_runs = 0
        self.predict_runs = 0
        self.adapt_seconds: List[float] = []
        self.predict_seconds: List[float] = []
        self._cache_mirrored = (0, 0, 0)
        # The shared L2 tier, with publishes on a writer thread: a
        # publish is a device-to-host copy and an fsync'd file, which
        # must not sit on the request path.
        self.l2: Optional[L2AdaptedParamsCache] = None
        self._l2_queue: Optional[queue.Queue] = None
        self.l2_dropped_publishes = 0
        if cfg.serve_l2_dir:
            self.l2 = L2AdaptedParamsCache(
                cfg.serve_l2_dir, max_entries=cfg.serve_l2_max_entries,
                registry=self.registry)
            self._l2_queue = queue.Queue(maxsize=_L2_QUEUE_DEPTH)
            threading.Thread(target=self._l2_publish_loop,
                             args=(self._l2_queue, self.l2, self.registry),
                             name="l2-publisher", daemon=True).start()
        # Hot-swap state: from_checkpoint arms the registry directory.
        self._registry_dir: Optional[str] = None
        self._model_version: Optional[int] = None
        self._state_fingerprint: Optional[int] = None
        self._rejected_versions: set = set()
        self._last_registry_poll: Optional[float] = None
        self._canary_probes: Optional[List[FewShotRequest]] = None
        self.registry.counter("serve/hot_swaps")
        self.registry.counter("serve/hot_swap_rollbacks")
        # Storage retries and fault counters land in this engine's
        # registry while it lives (restored on close).
        self._prev_resilience_registry = resilience.set_registry(
            self.registry)
        # Warm start (parallel/aot.py). The fingerprint hashes the
        # resolved task_microbatches, as the trainer's and the prewarm
        # script's do, so all three open the same store directory.
        self._prev_cache_dir = (build.set_cache_dir(cfg.compilation_cache_dir)
                                if cfg.compilation_cache_dir else None)
        self._aot_store = aot.AOTStore.from_config(
            cfg.replace(
                task_microbatches=cfg.effective_task_microbatches()),
            self.device, registry=self.registry)
        if self._aot_store is not None:
            for name in aot.COUNTERS:
                self.registry.counter(name)
        self._aot_adapt: Dict[int, Any] = {}    # support rows -> exec
        self._aot_predict: Dict[int, Any] = {}  # query rows -> exec
        self._closed = False
        self._reqtrace_ring: Optional[reqtrace.SpanRing] = None
        self._prev_reqtrace: Optional[reqtrace.SpanRing] = None
        if cfg.reqtrace_sample_rate > 0:
            self._reqtrace_ring = reqtrace.SpanRing(registry=self.registry)
            self._prev_reqtrace = reqtrace.install(self._reqtrace_ring)
        self._alerts: Optional[alerts.AlertEvaluator] = None
        if cfg.alert_rules_path:
            self._alerts = alerts.AlertEvaluator(
                alerts.load_rules(cfg.alert_rules_path), source="serve")
            self.registry.gauge(alerts.FIRING_GAUGE).set(0.0)
        self._watchdog: Optional[watchdog.Watchdog] = None
        self._release = None
        if (cfg.watchdog_serve_timeout_s > 0
                and watchdog.get_beacon() is None):
            recorder = flightrec.FlightRecorder(cfg.flight_recorder_events)
            prev_recorder = flightrec.install(recorder)
            beacon = watchdog.ProgressBeacon()
            beacon.stamp("idle")
            prev_beacon = watchdog.install_beacon(beacon)
            deadlines = watchdog.deadlines_from_config(cfg)
            self._watchdog = watchdog.Watchdog(
                beacon, {k: deadlines[k] for k in SERVE_PHASES},
                bundle_dir=os.path.join(cfg.experiment_root,
                                        cfg.experiment_name, "logs",
                                        "crash_bundle_serve"),
                registry=self.registry,
                poll_interval_s=cfg.watchdog_poll_interval_s).start()
            self._release = weakref.finalize(
                self, _release_watchdog, self._watchdog, beacon,
                prev_beacon, recorder, prev_recorder)

    def _context(self, state_context: str) -> str:
        return (f"algo={self.cfg.meta_algorithm};backend=torch;"
                f"{state_context}")

    # -- construction ----------------------------------------------------
    @classmethod
    def from_checkpoint(cls, cfg: MAMLConfig,
                        directory: Optional[str] = None, tag=LATEST,
                        device: DeviceLike = None,
                        registry: Optional[MetricsRegistry] = None
                        ) -> "ServingEngine":
        """Serve a checkpoint either package's trainer wrote; the
        directory doubles as the model registry's, which arms
        hot-swap."""
        if directory is None:
            directory = os.path.join(cfg.experiment_root,
                                     cfg.experiment_name, "saved_models")
        dev = resolve_device(device)
        state, fingerprint = _load_state(cfg, make_model(cfg)[0], directory,
                                         tag, dev)
        engine = cls(cfg, state, device=dev, registry=registry,
                     state_context=f"ckpt:{tag}:{fingerprint}")
        engine._registry_dir = directory
        engine._state_fingerprint = fingerprint
        return engine

    # -- L2 publisher ----------------------------------------------------
    @staticmethod
    def _l2_publish_loop(q: queue.Queue, l2: L2AdaptedParamsCache,
                         registry: MetricsRegistry) -> None:
        """The writer thread: host copies of cached entries (their
        tensors are clones nothing writes to again, and the request
        thread synchronized the device after producing them), then the
        fail-soft publish. Holds no reference to the engine."""
        while True:
            item = q.get()
            try:
                if item is None:
                    return
                key, entry = item
                l2.put(key, fast=_to_host(entry.fast),
                       bn_state=_to_host(entry.bn_state))
            except Exception:  # noqa: BLE001 — fail-soft tier
                registry.counter("resilience/cache_errors").inc()
            finally:
                q.task_done()

    def l2_flush(self, timeout_s: float = 30.0) -> bool:
        """Wait (bounded) until every queued L2 publish has landed. For
        callers that need the tier to be visible (a replica about to
        drain, a test); the request path never waits."""
        if self._l2_queue is None:
            return True
        deadline = time.monotonic() + timeout_s
        while self._l2_queue.unfinished_tasks:
            if time.monotonic() > deadline:
                return False
            time.sleep(0.005)
        return True

    def close(self) -> None:
        """Flush the L2 writer (bounded) and stop it, restore the
        process's resilience registry, request-trace ring, and the
        beacon and recorder an engine-owned watchdog replaced
        (idempotent)."""
        if self._l2_queue is not None:
            self.l2_flush(timeout_s=5.0)
            try:
                # Non-blocking: a writer wedged on a hung fsync keeps the
                # queue full, and close must not wait on it (the daemon
                # thread dies with the process).
                self._l2_queue.put_nowait(None)
            except queue.Full:
                pass
            self._l2_queue = None
        if not self._closed:
            self._closed = True
            resilience.set_registry(self._prev_resilience_registry)
            if self.cfg.compilation_cache_dir:
                build.set_cache_dir(self._prev_cache_dir)
        if self._reqtrace_ring is not None:
            reqtrace.install(self._prev_reqtrace)
            self._reqtrace_ring = None
        if self._release is not None:
            self._release()
            self._watchdog = None

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- request path ----------------------------------------------------
    def submit(self, req: FewShotRequest,
               now: Optional[float] = None) -> Tuple[int, int]:
        """Enqueue one request; returns its shape bucket. Raises
        BucketError/QueueFullError/ShedError before any side effect; each
        refusal is counted."""
        with watchdog.phase("serve_request", detail="submit"):
            reg = self.registry
            trace = req.trace if reqtrace.get() is not None else None
            t0 = time.monotonic() if trace is not None else 0.0
            try:
                bucket = self.batcher.submit(req, now=now)
            except ShedError:
                reg.counter("serve/shed_total").inc()
                raise
            except (QueueFullError, ValueError):
                reg.counter("serve/rejected_total").inc()
                raise
            reqtrace.record_span(trace, reqtrace.SPAN_ADMIT, t0,
                                 time.monotonic() - t0)
            reg.counter("serve/requests_total").inc()
            reg.gauge("serve/queue_depth").set(self.batcher.depth)
            return bucket

    def warmup(self) -> None:
        """Run every configured bucket once on zero requests (builds the
        kernel and lets cuDNN set up its algorithms off the request
        path). Not recorded in the timings or request counters."""
        h, w, c = self.cfg.image_shape
        dtype = np.uint8 if self.cfg.transfer_images_uint8 else np.float32
        for s_b, q_b in self.batcher.buckets:
            # The first call per bucket pays for the kernel's build and
            # cuDNN's setup: the compile budget, not the request's.
            with watchdog.phase("compile", detail=f"serve{(s_b, q_b)}"):
                self._adopt_serve_bucket((s_b, q_b))
                req = FewShotRequest(
                    support_x=np.zeros((s_b, h, w, c), dtype),
                    support_y=np.zeros((s_b,), np.int32),
                    query_x=np.zeros((q_b, h, w, c), dtype),
                    deadline=float("inf"))
                batch = pad_group([req], (s_b, q_b),
                                  self.cfg.serve_batch_tasks,
                                  self.cfg.image_shape)
                adapted = self._run_adapt(batch, record=False)
                self._run_predict([self._entry(adapted, 0)], [req],
                                  (s_b, q_b), record=False)

    def step(self, now: Optional[float] = None) -> List[FewShotResponse]:
        """Serve ONE batch: dequeue a same-bucket group, answer expired
        requests with errors, adapt the cache misses (one batch), predict
        for everyone, respond. Returns [] when idle. Runs under a
        ``serve_request`` watchdog scope, which restores the beacon's
        previous phase on exit."""
        with watchdog.phase("serve_request", detail=self.batcher.depth):
            return self._step(now)

    def _step(self, now: Optional[float]) -> List[FewShotResponse]:
        reg = self.registry
        bucket, group, expired = self.batcher.next_group(
            self.cfg.serve_batch_tasks, now=now)
        responses: List[FewShotResponse] = []
        t_now = time.monotonic() if now is None else now
        for req in expired:
            reg.counter("serve/deadline_misses").inc()
            responses.append(FewShotResponse(
                request_id=req.request_id, predictions=None, logits=None,
                cache_hit=False, latency_seconds=t_now - req.arrival_time,
                error="deadline_exceeded", status="failed"))
        reg.gauge("serve/queue_depth").set(self.batcher.depth)
        if not group:
            return responses

        # Queue wait from admission (the batcher's enqueue stamp).
        t_deq = time.monotonic()
        tracing = reqtrace.get() is not None
        for req in group:
            if req.enqueue_time is not None:
                wait = max(0.0, t_deq - req.enqueue_time)
                reg.histogram("serve/queue_wait_seconds").observe(wait)
                if tracing and req.trace is not None:
                    reqtrace.record_span(req.trace,
                                         reqtrace.SPAN_BATCH_WAIT,
                                         req.enqueue_time, wait)

        # The caches are an optimization, never a dependency: a failed
        # lookup or store degrades that request to adapt-on-miss.
        keys = [support_fingerprint(r.support_x, r.support_y,
                                    self.num_adapt_steps,
                                    context=self._fp_context)
                for r in group]
        entries: Dict[int, AdaptedTask] = {}
        tiers: List[Optional[str]] = []
        misses: List[int] = []
        for i, key in enumerate(keys):
            t_probe = (time.monotonic()
                       if tracing and group[i].trace is not None else None)
            try:
                cached = self.cache.get(key)
            except Exception:  # noqa: BLE001
                reg.counter("resilience/cache_errors").inc()
                cached = None
            tier = "l1" if cached is not None else None
            if cached is None and self.l2 is not None:
                cached = self._l2_get(key)
                if cached is not None:
                    tier = "l2"
            if t_probe is not None:
                reqtrace.record_span(group[i].trace,
                                     reqtrace.SPAN_CACHE_PROBE, t_probe,
                                     time.monotonic() - t_probe,
                                     tier=tier or "miss")
            tiers.append(tier)
            if cached is not None:
                entries[i] = cached
            else:
                misses.append(i)
        hit_flags = [t is not None for t in tiers]
        flightrec.record("serve_batch", group=len(group),
                         cache_hits=sum(hit_flags),
                         l2_hits=sum(1 for t in tiers if t == "l2"),
                         cache_misses=len(misses))

        if misses:
            batch = pad_group([group[i] for i in misses], bucket,
                              self.cfg.serve_batch_tasks,
                              self.cfg.image_shape)
            reg.histogram("serve/batch_occupancy",
                          buckets=_OCCUPANCY_BUCKETS).observe(
                              batch["occupancy"])
            t_adapt = time.monotonic()
            adapted = self._run_adapt(batch)
            if tracing:
                dur = time.monotonic() - t_adapt
                for i in misses:
                    reqtrace.record_span(group[i].trace,
                                         reqtrace.SPAN_ADAPT, t_adapt, dur,
                                         batched=len(misses))
            for j, i in enumerate(misses):
                entries[i] = self._entry(adapted, j)
                try:
                    self.cache.put(keys[i], entries[i])
                except Exception:  # noqa: BLE001
                    reg.counter("resilience/cache_errors").inc()
                if self._l2_queue is not None:
                    try:
                        self._l2_queue.put_nowait((keys[i], entries[i]))
                    except queue.Full:
                        self.l2_dropped_publishes += 1
                        reg.counter("resilience/cache_errors").inc()

        t_predict = time.monotonic()
        logits = self._run_predict([entries[i] for i in range(len(group))],
                                   group, bucket)
        t_done = time.monotonic()
        if tracing:
            for req in group:
                reqtrace.record_span(req.trace, reqtrace.SPAN_PREDICT,
                                     t_predict, t_done - t_predict,
                                     batched=len(group))
        for i, req in enumerate(group):
            lg = logits[i, :req.num_query]
            reg.counter("serve/responses_total").inc()
            reg.histogram("serve/latency_seconds").observe(
                t_done - req.arrival_time)
            responses.append(FewShotResponse(
                request_id=req.request_id,
                predictions=np.argmax(lg, axis=-1), logits=lg,
                cache_hit=hit_flags[i],
                latency_seconds=t_done - req.arrival_time,
                cache_tier=tiers[i]))
        if self.batcher.admission is not None:
            # The shed policy's queue-wait estimator: under backlog a
            # queued request pays the completion interval (previous batch
            # done -> this one done), normalized to a full batch.
            adm = self.batcher.admission
            raw = t_done - t_deq
            if self._adm_last_done is not None and self._adm_backlog_at_done:
                raw = t_done - self._adm_last_done
            self._adm_last_done = t_done
            self._adm_backlog_at_done = self.batcher.depth > 0
            adm.record_service(bucket, raw * adm.batch_tasks / len(group))
        self._mirror_cache_counters()
        return responses

    def _l2_get(self, key: str) -> Optional[AdaptedTask]:
        """The L2 tier's entry on this engine's device, back-filled into
        the L1 (fail-soft: damage is a counted miss inside ``get``)."""
        blob = self.l2.get(key)
        if blob is None:
            return None
        to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device)
        entry = AdaptedTask(fast=tree_map(to_dev, blob["fast"]),
                            bn_state=tree_map(to_dev, blob["bn_state"]),
                            support_loss=torch.zeros((), device=self.device))
        try:
            self.cache.put(key, entry)
        except Exception:  # noqa: BLE001
            self.registry.counter("resilience/cache_errors").inc()
        return entry

    def drain(self) -> List[FewShotResponse]:
        """Serve until the queue is empty."""
        out: List[FewShotResponse] = []
        while self.batcher.depth:
            out.extend(self.step())
        return out

    # -- warm start --------------------------------------------------------
    def _adopt_serve_bucket(self, bucket: Tuple[int, int]) -> None:
        """The bucket's adapt and predict executables from the store
        (parallel/aot.py § load_or_compile: a hit is captured from its
        record, a miss captured and recorded). Shared extents share an
        executable. A capture's run is one adapt or predict run."""
        self._adopt_exec("adapt", bucket[0])
        self._adopt_exec("predict", bucket[1])

    def _adopt_exec(self, kind: str, rows: int) -> None:
        """One adapt (``rows`` support rows) or predict (``rows`` query
        rows) executable, unless it is adopted already or the store is
        off."""
        store = self._aot_store
        table = self._aot_adapt if kind == "adapt" else self._aot_predict
        if store is None or rows in table:
            return
        if kind == "adapt":
            name, body = aot.serve_adapt_name(rows), self._adapt_body
            args = aot.serve_adapt_args(self.cfg, self.state, rows,
                                        self.device)
        else:
            name, body = aot.serve_predict_name(rows), self._predict_body
            args = aot.serve_predict_args(self.cfg, self.state, rows,
                                          self.device)
        with numerics_policy(self.cfg.compute_dtype, deterministic=False,
                             options=self.cfg.xla_compiler_options_dict):
            table[rows], _ = aot.load_or_compile(
                store, name, lambda: aot.GraphExec(name, body, args),
                aot.signature_of(*args), registry=self.registry,
                fallback=body)
        warmups = getattr(getattr(table[rows], "compiled", None),
                          "warmups", 0)
        if kind == "adapt":
            self.adapt_runs += warmups
        else:
            self.predict_runs += warmups

    def _adapt_body(self, params, lslr, bn_state, support_x, support_y,
                    support_w) -> AdaptedTask:
        return adapt_task(self.cfg, self.model_apply, params, lslr,
                          bn_state, support_x, support_y, support_w,
                          num_steps=self.num_adapt_steps)

    def _predict_body(self, params, fast, bn_state, query_x
                      ) -> torch.Tensor:
        return predict_tasks(self.cfg, self.model_apply, params, fast,
                             bn_state, query_x,
                             num_steps=self.num_adapt_steps)

    # -- batched compute -------------------------------------------------
    @staticmethod
    def _entry(adapted: AdaptedTask, j: int) -> AdaptedTask:
        """Task ``j`` of a batched adaptation, as its own tensors."""
        return AdaptedTask(fast=index(adapted.fast, j),
                           bn_state=index(adapted.bn_state, j),
                           support_loss=adapted.support_loss[j].clone())

    def _to_device(self, arr: np.ndarray,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            self.device, dtype=dtype)

    def _run_adapt(self, batch: Dict[str, Any], record: bool = True,
                   state: Optional[MetaTrainState] = None) -> AdaptedTask:
        """Adapt one padded miss batch; timed to the device's completion.
        ``record=False`` (warm-up, canary) keeps it out of the request
        timings; ``state`` overrides the live state (the canary)."""
        state = self.state if state is None else state
        s_b = batch["support_x"].shape[1]
        if self._aot_store is not None and s_b not in self._aot_adapt:
            with watchdog.phase("compile", detail=f"serve_adapt{s_b}"):
                self._adopt_exec("adapt", s_b)
        adapt = self._aot_adapt.get(s_b, self._adapt_body)
        t0 = time.perf_counter()
        with numerics_policy(self.cfg.compute_dtype, deterministic=False,
                             options=self.cfg.xla_compiler_options_dict):
            adapted = adapt(
                state.params, state.lslr, state.bn_state,
                self._to_device(batch["support_x"]),
                self._to_device(batch["support_y"], torch.long),
                self._to_device(batch["support_w"]))
            synchronize(self.device)
        self.adapt_runs += 1
        if record:
            dt = time.perf_counter() - t0
            self.adapt_seconds.append(dt)
            self.registry.histogram("serve/adapt_seconds").observe(dt)
            self.registry.counter("serve/adapt_batches").inc()
            self.adapt_invocations += 1
        return adapted

    def _run_predict(self, entries: List[AdaptedTask],
                     group: List[FewShotRequest], bucket: Tuple[int, int],
                     record: bool = True,
                     state: Optional[MetaTrainState] = None) -> np.ndarray:
        """One batched predict over the group's adapted params (the batch
        padded by replicating entry 0); returns ``(B, q_b, N)`` logits."""
        state = self.state if state is None else state
        b = self.cfg.serve_batch_tasks
        q_b = bucket[1]
        h, w, c = self.cfg.image_shape
        padded = entries + [entries[0]] * (b - len(entries))
        qx = np.zeros((b, q_b, h, w, c), group[0].query_x.dtype)
        for i, req in enumerate(group):
            qx[i, :req.num_query] = req.query_x
        for i in range(len(group), b):
            qx[i] = qx[0]
        if self._aot_store is not None and q_b not in self._aot_predict:
            with watchdog.phase("compile", detail=f"serve_predict{q_b}"):
                self._adopt_exec("predict", q_b)
        predict = self._aot_predict.get(q_b, self._predict_body)
        t0 = time.perf_counter()
        with numerics_policy(self.cfg.compute_dtype, deterministic=False,
                             options=self.cfg.xla_compiler_options_dict):
            logits = predict(state.params, stack([e.fast for e in padded]),
                             stack([e.bn_state for e in padded]),
                             self._to_device(qx))
            logits = logits.cpu().numpy()
        self.predict_runs += 1
        if record:
            dt = time.perf_counter() - t0
            self.predict_seconds.append(dt)
            self.registry.histogram("serve/predict_seconds").observe(dt)
            self.predict_invocations += 1
        return logits

    # -- hot-swap (model registry + canary) -------------------------------
    def pin_rejected(self, version: int) -> None:
        """Never canary or swap to ``version`` (a fleet-wide rejection the
        rollout controller publishes; a local canary fail pins too)."""
        self._rejected_versions.add(int(version))

    def adopt_version(self, rec: Dict[str, Any],
                      state: MetaTrainState) -> None:
        """Flip the live state, cache context and version together,
        between steps. Old cache entries die by key."""
        self.state = state
        self._fp_context = self._context(
            f"ckpt:{rec['tag']}:{rec.get('fingerprint')}")
        self._state_fingerprint = rec.get("fingerprint")
        self._model_version = int(rec.get("version") or 0)

    def load_registry_version(self, rec: Dict[str, Any]) -> MetaTrainState:
        """Load a registry version through the resume chain (for fleet
        callers)."""
        return self._load_version(rec)

    def maybe_hot_swap(self, now: Optional[float] = None,
                       force: bool = False) -> Optional[Dict[str, Any]]:
        """Poll the model registry; canary + swap a newly published
        version. Call between ``step`` calls: queued requests are served
        by whichever version is live when their group dequeues, never
        dropped.

        Returns None when there is nothing to do (no registry, poll
        interval not elapsed, no newer live version, version rejected,
        or the published version is the bytes already served); otherwise
        a dict with ``swapped`` and the canary verdict. ``force`` skips
        the poll's rate limit."""
        if self._registry_dir is None:
            return None
        t = time.monotonic() if now is None else now
        if (not force and self._last_registry_poll is not None
                and t - self._last_registry_poll
                < self.cfg.serve_registry_poll_s):
            return None
        self._last_registry_poll = t
        try:
            rec = ModelRegistry(self._registry_dir).latest()
        except Exception:  # noqa: BLE001 — a torn read retries next poll
            self.registry.counter("serve/registry_errors").inc()
            return None
        if rec is None:
            return None
        version = int(rec.get("version") or 0)
        if (self._model_version is not None
                and version <= self._model_version) \
                or version in self._rejected_versions:
            return None
        if (rec.get("fingerprint") is not None
                and rec["fingerprint"] == self._state_fingerprint):
            # The published version is the bytes already served: adopt
            # its number, no swap.
            self._model_version = version
            return None
        # A hang in the swap's compute is a hung request; the load and
        # each version's warm-up run under the larger compile deadline
        # inside (_decide_swap, _canary_eval).
        with watchdog.phase("serve_request", detail=f"hot_swap:{version}"):
            return self._decide_swap(rec, version)

    def _decide_swap(self, rec: Dict[str, Any],
                     version: int) -> Optional[Dict[str, Any]]:
        try:
            with watchdog.phase("compile", detail=f"load:{version}"):
                candidate = self._load_version(rec)
        except Exception as e:  # noqa: BLE001
            # Only provably bad bytes (a CRC-failed frame) pin the
            # version; anything else retries on the next poll.
            permanent = isinstance(e, CorruptCheckpointError)
            if permanent:
                self._rejected_versions.add(version)
            self.registry.counter("serve/hot_swap_load_errors").inc()
            flightrec.record("hot_swap_load_error", version=version,
                             permanent=permanent,
                             error=f"{type(e).__name__}: {e}"[:200])
            return {"version": version, "swapped": False,
                    "reason": f"load failed: {type(e).__name__}: {e}"}
        verdict = self._run_canary(candidate)
        if verdict["pass"]:
            self.adopt_version(dict(rec, version=version), candidate)
            self.registry.counter("serve/hot_swaps").inc()
            flightrec.record("hot_swap", version=version, tag=rec["tag"])
            return {"version": version, "swapped": True, "canary": verdict}
        self._rejected_versions.add(version)
        self.registry.counter("serve/hot_swap_rollbacks").inc()
        flightrec.record("hot_swap_rollback", version=version,
                         reason=verdict["reason"])
        return {"version": version, "swapped": False, "canary": verdict}

    def _load_version(self, rec: Dict[str, Any]) -> MetaTrainState:
        directory = rec.get("directory") or self._registry_dir
        tag = rec["tag"]
        tag = int(tag) if str(tag).isdigit() else tag
        return _load_state(self.cfg, self.model_init, directory, tag,
                           self.device)[0]

    def _probe_episodes(self) -> List[FewShotRequest]:
        """Pinned canary probes: seeded synthetic episodes at the first
        bucket's geometry and the wire dtype, built once per engine, so
        every candidate is judged on the same episodes."""
        if self._canary_probes is not None:
            return self._canary_probes
        cfg = self.cfg
        s_b, q_b = self.batcher.buckets[0]
        h, w, c = cfg.image_shape
        n = cfg.num_classes_per_set
        rng = np.random.RandomState(cfg.seed)
        count = max(1, min(cfg.serve_canary_episodes,
                           cfg.serve_batch_tasks))
        probes = []
        for _ in range(count):
            if cfg.transfer_images_uint8:
                sx = rng.randint(0, 256, (s_b, h, w, c)).astype(np.uint8)
                qx = rng.randint(0, 256, (q_b, h, w, c)).astype(np.uint8)
            else:
                sx = rng.randn(s_b, h, w, c).astype(np.float32)
                qx = rng.randn(q_b, h, w, c).astype(np.float32)
            sy = np.arange(s_b, dtype=np.int32) % n
            probes.append(FewShotRequest(
                support_x=sx, support_y=sy, query_x=qx,
                deadline=float("inf")))
        self._canary_probes = probes
        return probes

    def _canary_eval(self, state: MetaTrainState) -> Dict[str, Any]:
        """Adapt + predict the pinned probes under ``state``: probe
        accuracy (labels are the query positions modulo N, the same for
        both versions), adapt latency, finiteness.

        The version is warmed on the probes' bucket first, untimed and
        under the compile deadline, as ``warmup`` does: a first call at
        a shape can carry cuDNN's setup, which would otherwise count
        against the candidate in the latency gate."""
        probes = self._probe_episodes()
        bucket = self.batcher.buckets[0]
        batch = pad_group(probes, bucket, self.cfg.serve_batch_tasks,
                          self.cfg.image_shape)
        with watchdog.phase("compile", detail="canary_warm"):
            self._run_adapt(batch, record=False, state=state)
        t0 = time.perf_counter()
        adapted = self._run_adapt(batch, record=False, state=state)
        adapt_seconds = time.perf_counter() - t0
        entries = [self._entry(adapted, j) for j in range(len(probes))]
        logits = self._run_predict(entries, probes, bucket, record=False,
                                   state=state)
        n = self.cfg.num_classes_per_set
        correct = total = 0
        finite = bool(torch.isfinite(adapted.support_loss).all())
        for i, req in enumerate(probes):
            lg = logits[i, :req.num_query]
            finite = finite and bool(np.isfinite(lg).all())
            labels = np.arange(req.num_query) % n
            correct += int((np.argmax(lg, axis=-1) == labels).sum())
            total += req.num_query
        return {"accuracy": correct / max(total, 1),
                "adapt_seconds": adapt_seconds, "finite": finite}

    def _run_canary(self, candidate: MetaTrainState) -> Dict[str, Any]:
        """The swap gate, candidate against live on the pinned probes:
        fails on a non-finite candidate output, an accuracy drop beyond
        ``serve_canary_acc_drop`` (only when the live version beats
        chance by more than that, else the probes carry no accuracy
        signal), or adapt latency beyond ``serve_canary_latency_factor``
        x live + 5 ms."""
        cfg = self.cfg
        live = self._canary_eval(self.state)
        cand = self._canary_eval(candidate)
        verdict = {"live": live, "candidate": cand, "pass": False,
                   "reason": "ok"}
        chance = 1.0 / cfg.num_classes_per_set
        acc_signal = live["accuracy"] > chance + cfg.serve_canary_acc_drop
        if not cand["finite"]:
            verdict["reason"] = "candidate produced non-finite outputs"
        elif (acc_signal and cand["accuracy"]
                < live["accuracy"] - cfg.serve_canary_acc_drop):
            verdict["reason"] = (
                f"probe accuracy dropped {live['accuracy']:.4f} -> "
                f"{cand['accuracy']:.4f} (> {cfg.serve_canary_acc_drop})")
        elif cand["adapt_seconds"] > (live["adapt_seconds"]
                                      * cfg.serve_canary_latency_factor
                                      + 0.005):
            verdict["reason"] = (
                f"adapt latency {cand['adapt_seconds']:.4f}s vs live "
                f"{live['adapt_seconds']:.4f}s (> x"
                f"{cfg.serve_canary_latency_factor})")
        else:
            verdict["pass"] = True
        return verdict

    # -- telemetry -------------------------------------------------------
    def export_trace(self, path: Optional[str] = None) -> Optional[str]:
        """The engine's recent phases and batches from the process's
        flight recorder as a Chrome-trace timeline (telemetry/trace.py);
        None when no recorder is installed. Default path:
        ``<experiment_root>/<name>/logs/trace_serve.json``."""
        rec = flightrec.get()
        if rec is None:
            return None
        if path is None:
            path = os.path.join(self.cfg.experiment_root,
                                self.cfg.experiment_name, "logs",
                                "trace_serve.json")
        from howtotrainyourmamlpytorch_tpu_torch.telemetry import trace
        trace.write_trace(path, flight=rec.events())
        return path

    def write_profile_json(self, path: Optional[str] = None
                           ) -> Optional[str]:
        """Copy the warm-start store's cost cards (``parallel/aot.py §
        AOTStore.record_cost_card``: one per adapt and predict extent
        captured) next to the serve logs, default
        ``<experiment_root>/<name>/logs/PROFILE.json``, as the JAX engine
        does. Returns the written path, or None when the store is off or
        holds no cards yet."""
        if self._aot_store is None:
            return None
        from howtotrainyourmamlpytorch_tpu_torch.telemetry import (
            profiler as profiler_mod)
        doc = profiler_mod.load_profile(self._aot_store.profile_path())
        if doc is None or not doc["cards"]:
            return None
        if path is None:
            path = os.path.join(self.cfg.experiment_root,
                                self.cfg.experiment_name, "logs",
                                profiler_mod.PROFILE_FILE)
        profiler_mod.merge_profile(
            path, list(doc["cards"].values()),
            device_kind=doc.get("device_kind", ""),
            fingerprint=self._aot_store.fingerprint)
        return path

    def _mirror_cache_counters(self) -> None:
        """LRU and assembler tallies -> registry counters (delta-mirrored)
        and the cache gauges."""
        reg = self.registry
        h, m, e = self.cache.hits, self.cache.misses, self.cache.evictions
        ph, pm, pe = self._cache_mirrored
        reg.counter("serve/cache_hits").inc(h - ph)
        reg.counter("serve/cache_misses").inc(m - pm)
        reg.counter("serve/cache_evictions").inc(e - pe)
        self._cache_mirrored = (h, m, e)
        reg.gauge("serve/cache_size").set(len(self.cache))
        reg.gauge("serve/cache_bytes").set(self.cache.approx_bytes)
        if h + m:
            reg.gauge("serve/cache_hit_frac").set(h / (h + m))
        asm = self.batcher.assembler
        if asm is not None:
            g, fd, ld = (asm.groups_dispatched, asm.fill_dispatches,
                         asm.linger_dispatches)
            pg, pfd, pld = self._cb_mirrored
            reg.counter("serve/cb_groups").inc(g - pg)
            reg.counter("serve/cb_fill_dispatch").inc(fd - pfd)
            reg.counter("serve/cb_linger_dispatch").inc(ld - pld)
            self._cb_mirrored = (g, fd, ld)

    def alerts_firing_summary(self) -> Optional[Dict[str, Any]]:
        """``{"count", "max_severity"}`` of the firing alerts, or None
        when alerting is off (replica leases carry it)."""
        return (None if self._alerts is None
                else self._alerts.firing_summary())

    def flush_metrics(self, jsonl: JsonlLogger,
                      **extra: Any) -> Dict[str, Any]:
        """One ``metrics`` row with the full serve/* snapshot (the row the
        telemetry report's "serving" section reads). With tracing on, the
        span ring drains into the same stream first, stamped with the
        same ``extra``; with alert rules, they are evaluated before the
        row is written."""
        self._mirror_cache_counters()
        self.registry.gauge("serve/queue_depth").set(self.batcher.depth)
        if self._reqtrace_ring is not None:
            self._reqtrace_ring.flush(jsonl, **extra)
        if self._alerts is not None:
            self._alerts.evaluate(snapshot=self.registry.snapshot(),
                                  jsonl=jsonl, registry=self.registry)
        extra.setdefault("meta_algorithm", self.cfg.meta_algorithm)
        return self.registry.flush_jsonl(jsonl, **extra)


def _load_state(cfg: MAMLConfig, model_init, directory: str, tag,
                device: torch.device) -> Tuple[MetaTrainState, int]:
    """A checkpoint through the trainer's resume chain (template from a
    fresh init, migrate, reconcile) on ``device``, and its file's
    fingerprint. Read-only: it neither quarantines nor sweeps the
    directory, which may belong to a live training run. A missing
    checkpoint raises before anything touches the device, so a replica
    booted on one fails without paying for a CUDA context."""
    ckpt = CheckpointManager(directory, max_to_keep=cfg.max_models_to_save,
                             quarantine=False)
    if not ckpt.has_checkpoint(tag):
        raise FileNotFoundError(ckpt.path(tag))
    template = init_train_state(cfg, model_init, seed=cfg.seed,
                                device=device)
    template_shapes = state_leaf_shapes(template)
    state, _meta = ckpt.load(template, tag)
    state = migrate_lslr_rows(cfg, state)
    return (reconcile_loaded_shapes(cfg, state, template_shapes),
            ckpt.fingerprint(tag))
