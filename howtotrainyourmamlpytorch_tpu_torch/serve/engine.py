"""ServingEngine: batcher → adapted-params cache → adapt → predict
(counterpart of the JAX ``serve/engine.py``).

The request lifecycle:

1. ``submit`` buckets the request (BucketError if nothing fits or the
   wire dtype / image shape / labels are off) and enqueues it
   (QueueFullError past ``serve_max_queue_depth``).
2. ``step`` dequeues one same-bucket group and answers requests whose
   deadline already passed with a ``failed`` response.
3. Each request's support set is fingerprinted; cache hits skip
   adaptation. Misses are padded into one ``(serve_batch_tasks, bucket)``
   batch and adapted together (serve/adapt.py), then cached.
4. One batched predict over the whole group (hits + fresh) gives the
   query logits; padding is sliced off and responses carry argmax
   predictions + logits.

The engine runs on one device: the card unless the caller passes
``device="cpu"``. Adapt and predict run f32 configs with TF32 off
(``device.numerics_policy``; cuDNN's algorithm choice is left free).

Watchdog (``resilience/watchdog.py``): a serving process hangs the ways a
training one does (a wedged kernel, a stuck transfer). With
``watchdog_serve_timeout_s > 0`` and no beacon installed in the process
(a training-owned watchdog wins), the engine installs its own beacon,
flight recorder and watchdog, writing to
``<experiment_root>/<experiment_name>/logs/crash_bundle_serve``. Every
``submit`` and ``step`` runs under a ``serve_request`` scope and
``warmup`` under ``compile``; each scope restores the previous phase on
exit, so an idle engine sits in ``idle`` and never trips. The engine's
own watchdog enforces only the phases the engine stamps
(``serve_request``, ``compile``): a stamp another layer leaves on the
shared beacon (a loader's ``feed``) cannot arm it while it idles.
``close`` (or the engine's collection) stops it and restores the
process's previous beacon and recorder.

Ported so far: the request path above with the L1 cache, and the
watchdog. The L2 tier, AOT warm start, hot-swap/canary, request tracing,
alerts, admission control, continuous batching, the metrics registry and
``from_checkpoint`` are later work (ROADMAP.md, Queue 1: the engine's
deferred parts); the config knobs that would turn on one of the
behaviour-changing ones raise here.
"""

from __future__ import annotations

import os
import time
import weakref
from collections import Counter
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.device import (DeviceLike,
                                                        numerics_policy,
                                                        resolve_device,
                                                        synchronize)
from howtotrainyourmamlpytorch_tpu_torch.meta.outer import MetaTrainState
from howtotrainyourmamlpytorch_tpu_torch.models import make_model
from howtotrainyourmamlpytorch_tpu_torch.resilience import (flightrec,
                                                            watchdog)
from howtotrainyourmamlpytorch_tpu_torch.serve.adapt import (
    AdaptedTask, adapt_task, predict_tasks)
from howtotrainyourmamlpytorch_tpu_torch.serve.batcher import (
    FewShotRequest, QueueFullError, RequestBatcher, pad_group)
from howtotrainyourmamlpytorch_tpu_torch.serve.cache import (
    AdaptedParamsLRU, support_fingerprint)
from howtotrainyourmamlpytorch_tpu_torch.tree import index, stack


# The phases the engine stamps, which its own watchdog enforces.
SERVE_PHASES = ("serve_request", "compile")


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
    over the request's real query rows. ``status`` is ``"ok"`` or
    ``"failed"`` (deadline miss after queueing; ``error`` says why and the
    arrays are None). ``cache_tier`` is ``"l1"`` on a cache hit."""
    request_id: int
    predictions: Optional[np.ndarray]
    logits: Optional[np.ndarray]
    cache_hit: bool
    latency_seconds: float
    error: Optional[str] = None
    cache_tier: Optional[str] = None
    status: str = "ok"


def _check_ported(cfg: MAMLConfig) -> None:
    """Refuse config knobs whose serving behaviour is not ported yet."""
    deferred = {"fleet_shed_policy": cfg.fleet_shed_policy != "off",
                "serve_continuous_batching": bool(
                    cfg.serve_continuous_batching),
                "serve_l2_dir": bool(cfg.serve_l2_dir)}
    on = [k for k, v in deferred.items() if v]
    if on:
        raise NotImplementedError(
            f"{', '.join(on)} not ported to the PyTorch engine yet "
            f"(ROADMAP.md, port queue: the engine's deferred parts)")


class ServingEngine:
    """Batched few-shot inference from a meta-initialization."""

    def __init__(self, cfg: MAMLConfig, state: MetaTrainState,
                 device: DeviceLike = None, state_context: str = ""):
        _check_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model_init, self.model_apply = make_model(cfg)
        self.num_adapt_steps = cfg.effective_serve_adapt_steps
        self.state = state.to(self.device)
        # Cache entries die with the weights that produced them: the
        # fingerprint folds in this context.
        self._fp_context = f"algo={cfg.meta_algorithm};{state_context}"
        self.batcher = RequestBatcher(
            cfg.serve_bucket_shapes,
            max_queue_depth=cfg.serve_max_queue_depth,
            default_deadline_ms=cfg.serve_default_deadline_ms,
            wire_dtype=(np.uint8 if cfg.transfer_images_uint8
                        else np.float32),
            image_shape=cfg.image_shape,
            num_classes=cfg.num_classes_per_set)
        self.cache = AdaptedParamsLRU(cfg.serve_cache_capacity)
        # Plain counters (requests_total, rejected_total, responses_total,
        # deadline_misses) and per-batch device-synchronized timings.
        self.counters: Counter = Counter()
        self.adapt_invocations = 0
        self.predict_invocations = 0
        self.adapt_seconds: List[float] = []
        self.predict_seconds: List[float] = []
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
                poll_interval_s=cfg.watchdog_poll_interval_s).start()
            self._release = weakref.finalize(
                self, _release_watchdog, self._watchdog, beacon,
                prev_beacon, recorder, prev_recorder)

    def close(self) -> None:
        """Stop the engine-owned watchdog and restore the process's
        previous beacon and recorder (idempotent)."""
        if self._release is not None:
            self._release()
            self._watchdog = None

    # -- request path ----------------------------------------------------
    def submit(self, req: FewShotRequest,
               now: Optional[float] = None) -> Tuple[int, int]:
        """Enqueue one request; returns its shape bucket. Raises
        BucketError/QueueFullError before any side effect; both
        rejections are counted."""
        with watchdog.phase("serve_request", detail="submit"):
            try:
                bucket = self.batcher.submit(req, now=now)
            except (QueueFullError, ValueError):
                self.counters["rejected_total"] += 1
                raise
            self.counters["requests_total"] += 1
            return bucket

    def warmup(self) -> None:
        """Run every configured bucket once on zero requests (builds the
        kernel and lets cuDNN pick its algorithms off the request path).
        Not recorded in the counters or timings."""
        h, w, c = self.cfg.image_shape
        dtype = np.uint8 if self.cfg.transfer_images_uint8 else np.float32
        for s_b, q_b in self.batcher.buckets:
            # The first call per bucket pays for the kernel's build and
            # cuDNN's setup: the compile budget, not the request's.
            with watchdog.phase("compile", detail=f"serve{(s_b, q_b)}"):
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
        previous phase (an engine-owned beacon's 'idle', or a training
        run's own phase) on exit."""
        with watchdog.phase("serve_request", detail=self.batcher.depth):
            return self._step(now)

    def _step(self, now: Optional[float]) -> List[FewShotResponse]:
        bucket, group, expired = self.batcher.next_group(
            self.cfg.serve_batch_tasks, now=now)
        responses: List[FewShotResponse] = []
        t_now = time.monotonic() if now is None else now
        for req in expired:
            self.counters["deadline_misses"] += 1
            responses.append(FewShotResponse(
                request_id=req.request_id, predictions=None, logits=None,
                cache_hit=False, latency_seconds=t_now - req.arrival_time,
                error="deadline_exceeded", status="failed"))
        if not group:
            return responses

        keys = [support_fingerprint(r.support_x, r.support_y,
                                    self.num_adapt_steps,
                                    context=self._fp_context)
                for r in group]
        entries: Dict[int, AdaptedTask] = {}
        misses: List[int] = []
        for i, key in enumerate(keys):
            cached = self.cache.get(key)
            if cached is not None:
                entries[i] = cached
            else:
                misses.append(i)

        if misses:
            batch = pad_group([group[i] for i in misses], bucket,
                              self.cfg.serve_batch_tasks,
                              self.cfg.image_shape)
            adapted = self._run_adapt(batch)
            for j, i in enumerate(misses):
                entries[i] = self._entry(adapted, j)
                self.cache.put(keys[i], entries[i])

        logits = self._run_predict([entries[i] for i in range(len(group))],
                                   group, bucket)
        t_done = time.monotonic()
        for i, req in enumerate(group):
            lg = logits[i, :req.num_query]
            self.counters["responses_total"] += 1
            responses.append(FewShotResponse(
                request_id=req.request_id,
                predictions=np.argmax(lg, axis=-1), logits=lg,
                cache_hit=i not in misses,
                latency_seconds=t_done - req.arrival_time,
                cache_tier=None if i in misses else "l1"))
        return responses

    def drain(self) -> List[FewShotResponse]:
        """Serve until the queue is empty."""
        out: List[FewShotResponse] = []
        while self.batcher.depth:
            out.extend(self.step())
        return out

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

    def _run_adapt(self, batch: Dict[str, Any],
                   record: bool = True) -> AdaptedTask:
        """Adapt one padded miss batch; timed to the device's completion."""
        t0 = time.perf_counter()
        with numerics_policy(self.cfg.compute_dtype, deterministic=False):
            adapted = adapt_task(
                self.cfg, self.model_apply, self.state.params,
                self.state.lslr, self.state.bn_state,
                self._to_device(batch["support_x"]),
                self._to_device(batch["support_y"], torch.long),
                self._to_device(batch["support_w"]),
                num_steps=self.num_adapt_steps)
            synchronize(self.device)
        if record:
            self.adapt_seconds.append(time.perf_counter() - t0)
            self.adapt_invocations += 1
        return adapted

    def _run_predict(self, entries: List[AdaptedTask],
                     group: List[FewShotRequest], bucket: Tuple[int, int],
                     record: bool = True) -> np.ndarray:
        """One batched predict over the group's adapted params (the batch
        padded by replicating entry 0); returns ``(B, q_b, N)`` logits."""
        b = self.cfg.serve_batch_tasks
        q_b = bucket[1]
        h, w, c = self.cfg.image_shape
        padded = entries + [entries[0]] * (b - len(entries))
        qx = np.zeros((b, q_b, h, w, c), group[0].query_x.dtype)
        for i, req in enumerate(group):
            qx[i, :req.num_query] = req.query_x
        for i in range(len(group), b):
            qx[i] = qx[0]
        t0 = time.perf_counter()
        with numerics_policy(self.cfg.compute_dtype, deterministic=False):
            logits = predict_tasks(
                self.cfg, self.model_apply, self.state.params,
                stack([e.fast for e in padded]),
                stack([e.bn_state for e in padded]), self._to_device(qx),
                num_steps=self.num_adapt_steps)
            logits = logits.cpu().numpy()
        if record:
            self.predict_seconds.append(time.perf_counter() - t0)
            self.predict_invocations += 1
        return logits
