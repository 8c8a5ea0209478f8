"""Request batcher: pad/bucket to static shapes, backpressure, deadlines.

The port's own copy of the JAX package's ``serve/batcher.py`` (numpy only);
the port imports nothing of that package.

Steady-state serving must never recompile: XLA executables are compiled
per static shape, so a request stream with arbitrary (support, query)
sizes would retrace on every novel geometry. The batcher maps every
request onto a SMALL fixed set of shape buckets (``cfg.serve_buckets``):

* the support set is padded up to the bucket's support size with
  zero-WEIGHT rows (the adapt loss is a weighted mean — pad rows
  contribute nothing to the loss or its gradients; ops/losses.py §
  weighted_cross_entropy);
* the query set is padded up to the bucket's query size (pad query rows
  cost compute but their predictions are sliced off before the
  response);
* a partially-filled batch is padded up to ``serve_batch_tasks`` by
  replicating a real task (its outputs are discarded; tasks are
  vmapped, so batch neighbors never affect each other's results) — the
  occupancy histogram records the waste.

Padding EXACTNESS depends on the norm layer. Under ``layer_norm``
(per-example normalization) pad rows are fully invisible: a padded
request adapts and predicts identically to an unpadded one (pinned in
tests/test_serve.py). Under ``batch_norm`` — the default, and the
reference's semantics — normalization uses the BATCH statistics of the
whole support (resp. query) set, transductively, so zero pad rows
shift the mean/var every real row is normalized with: a request that
exactly fills its bucket is exact (the tests/test_inner.py parity
test), a smaller one is a controlled approximation — the same
transductive batch-composition sensitivity the reference model itself
has. Deployments that need exactness for several geometries configure
one bucket per served (support, query) size; ``bucket_for`` picks the
smallest fit, so exact-size buckets win automatically
(docs/SERVING.md § Bucketing).

Admission control is queue-depth backpressure (``QueueFullError`` at
``serve_max_queue_depth`` — the caller sheds load instead of the queue
growing unboundedly) plus per-request deadlines: a request whose
deadline passes while queued is dropped at dequeue time and answered
with a ``deadline_exceeded`` error response (adapting for a caller
that already gave up wastes a batch slot someone else could use).

**Deadline-aware shedding** (``cfg.fleet_shed_policy``) moves that
drop to the DOOR: an :class:`AdmissionController` — installed on the
batcher only when the policy is on, the structural zero-cost pin
discipline — estimates the new request's queue wait from a rolling
per-bucket batch service time (:func:`estimate_queue_wait`, pure) and
raises :class:`ShedError` when the estimate already dooms the
deadline. A shed request is refused before any queueing side effect
(distinct ``shed`` response status), never timed out after the engine
spent a batch slot on it. The ``fair`` policy adds per-tenant
fairness: under queue pressure a tenant holding more than its fair
share of the queue sheds first, so one hot tenant cannot starve the
rest (docs/SERVING.md § Self-healing fleet).

**Continuous batching** (``cfg.serve_continuous_batching``) replaces
the head-of-line dequeue with per-bucket in-flight FORMING groups
(:class:`GroupAssembler` — installed only when the knob is on, the
same zero-cost pin as admission): a submit admits the request straight
into its bucket's partially-filled group, and the group dispatches
when it FILLS (``serve_batch_tasks`` members) or when its oldest admit
has lingered past ``serve_batch_linger_ms`` — whichever comes first,
oldest group first across buckets. Under load the linger budget buys
batch occupancy (one nearly-full batch instead of several one-task
batches each paying the full serial adapt cost), which is where the
queue-shaped p95 of FLEET_r01 went; at low load the linger bounds the
latency a lone request pays waiting for company. Dispatch rule table
in docs/SERVING.md § Traffic lab. The padding contract is untouched —
a partial group dispatched on linger pads exactly like a partial
head-of-line group always has.

Pure host-side code (numpy only) — unit-testable without compiles.
"""

from __future__ import annotations

import itertools
import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np


class QueueFullError(RuntimeError):
    """Backpressure: the request queue is at serve_max_queue_depth."""


class BucketError(ValueError):
    """The request fits no configured shape bucket (or violates the
    deployment's wire dtype)."""


class ShedError(RuntimeError):
    """Deadline-aware admission shed: the queue-wait estimate already
    dooms this request's deadline (or the tenant is over its fair
    share under pressure), so it is refused at the DOOR — before any
    queueing side effect — instead of timing out after the engine
    spent work on it. Distinct from :class:`QueueFullError`: a shed is
    a policy decision the caller must not blindly retry."""


_ids = itertools.count()


def estimate_queue_wait(queued_ahead: int, batch_tasks: int,
                        service_time_s: float) -> float:
    """Expected seconds until a newly admitted request's OWN batch
    completes: the engine drains the queue in groups of up to
    ``batch_tasks`` at ``service_time_s`` per batch, so a request with
    ``queued_ahead`` requests in front of it rides batch
    ``queued_ahead // batch_tasks`` and completes when that batch does.
    Pure (pinned in tier-1 tests); deliberately simple — a rolling
    mean feeds it, and admission only needs the estimate to be honest
    about ORDER of magnitude, not scheduling-exact."""
    if queued_ahead < 0:
        raise ValueError(f"queued_ahead must be >= 0, got {queued_ahead}")
    if batch_tasks < 1:
        raise ValueError(f"batch_tasks must be >= 1, got {batch_tasks}")
    if service_time_s < 0:
        raise ValueError(
            f"service_time_s must be >= 0, got {service_time_s}")
    return (queued_ahead // batch_tasks + 1) * service_time_s


class AdmissionController:
    """Shed-at-admission policy state (``cfg.fleet_shed_policy``).

    Installed on a :class:`RequestBatcher` ONLY when the policy is on
    (``"deadline"`` or ``"fair"``); the default ``"off"`` installs
    nothing and every submit pays one ``is None`` check — the
    reqtrace/watchdog structural zero-cost discipline, pinned in
    tests. Thread-safe: the engine loop records service times while
    frontend threads admit.

    * ``record_service(bucket, seconds)`` — rolling per-bucket EWMA of
      batch service time (dequeue -> responses ready), fed by the
      engine after every served group, normalized by the caller to
      FULL-batch cost (adapts are serial, so a small batch's raw time
      understates the loaded drain rate). Until a bucket has a sample,
      deadline admission for it is permissive (no estimate, no shed —
      never guess).
    * ``admit(...)`` — raises :class:`ShedError` when the queue-wait
      estimate says the deadline cannot be met, or (``fair``) when the
      queue is under pressure and this tenant already holds more than
      its fair share ``ceil(depth / distinct queued tenants)``.
    """

    def __init__(self, batch_tasks: int, max_queue_depth: int,
                 policy: str = "deadline", *, ewma_alpha: float = 0.3,
                 pressure_frac: float = 0.5, headroom: float = 1.5):
        if policy not in ("deadline", "fair"):
            raise ValueError(
                f"policy must be 'deadline' or 'fair' (use no controller "
                f"at all for 'off'), got {policy!r}")
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got "
                             f"{ewma_alpha}")
        if headroom < 1.0:
            raise ValueError(
                f"headroom must be >= 1.0, got {headroom}")
        self.batch_tasks = int(batch_tasks)
        self.max_queue_depth = int(max_queue_depth)
        self.policy = policy
        self.ewma_alpha = float(ewma_alpha)
        self.headroom = float(headroom)
        self.pressure_depth = max(1, int(pressure_frac * max_queue_depth))
        self.sheds = 0
        self._service_s: Dict[Tuple[int, int], float] = {}
        self._tenant_queued: Dict[object, int] = {}
        self._lock = threading.Lock()

    def record_service(self, bucket: Tuple[int, int],
                       seconds: float) -> None:
        if seconds < 0:
            return  # a clock anomaly must not poison the estimate
        with self._lock:
            prev = self._service_s.get(bucket)
            self._service_s[bucket] = (
                seconds if prev is None
                else prev + self.ewma_alpha * (seconds - prev))

    def service_time_s(self, bucket: Tuple[int, int]) -> Optional[float]:
        with self._lock:
            return self._service_s.get(bucket)

    def admit(self, bucket: Tuple[int, int], deadline: Optional[float],
              now: float, depth: int, tenant: object = None) -> None:
        """Shed verdict for one request about to enqueue (raises
        :class:`ShedError`; returns None on admit). Called by the
        batcher under its queue lock, so ``depth`` and the tenant
        counts are consistent with the queue state."""
        with self._lock:
            svc = self._service_s.get(bucket)
            # Liveness floor: never deadline-shed into an (almost) idle
            # engine. With fewer than one full batch queued the engine
            # starts this request's batch next, and serving it is the
            # ONLY way the EWMA refreshes — shedding at depth 0 on a
            # stale-high estimate (one slow batch, e.g. a compile)
            # would starve the estimator forever.
            if (svc is not None and deadline is not None
                    and depth >= self.batch_tasks
                    and math.isfinite(deadline)):
                # ``headroom`` inflates the estimate: a request whose
                # PREDICTED completion sits exactly on the deadline
                # would miss it on any positive variance, and a miss
                # after queueing is the failure shedding exists to
                # prevent — shed the boundary, not just the excess.
                eta = now + self.headroom * estimate_queue_wait(
                    depth, self.batch_tasks, svc)
                if eta > deadline:
                    self.sheds += 1
                    raise ShedError(
                        f"queue-wait estimate {eta - now:.3f}s puts "
                        f"completion past the deadline "
                        f"({deadline - now:.3f}s away) at depth {depth}")
            if (self.policy == "fair" and tenant is not None
                    and depth + 1 > self.pressure_depth):
                active = len(self._tenant_queued)
                if tenant not in self._tenant_queued:
                    active += 1
                share = max(1, math.ceil((depth + 1) / max(active, 1)))
                held = self._tenant_queued.get(tenant, 0)
                if held + 1 > share:
                    self.sheds += 1
                    raise ShedError(
                        f"tenant {tenant!r} holds {held} of {depth} "
                        f"queued requests (fair share {share} across "
                        f"{active} tenants) under queue pressure")

    def note_enqueued(self, tenant: object) -> None:
        if tenant is None:
            return
        with self._lock:
            self._tenant_queued[tenant] = (
                self._tenant_queued.get(tenant, 0) + 1)

    def note_removed(self, tenant: object) -> None:
        if tenant is None:
            return
        with self._lock:
            n = self._tenant_queued.get(tenant, 0)
            if n <= 1:
                self._tenant_queued.pop(tenant, None)
            else:
                self._tenant_queued[tenant] = n - 1


class GroupAssembler:
    """Per-bucket in-flight forming groups: fill-or-linger dispatch.

    Installed on a :class:`RequestBatcher` ONLY when
    ``serve_continuous_batching`` is on; the default off leaves
    ``batcher.assembler`` None and every submit/dequeue pays one
    ``is None`` check — the admission/reqtrace structural zero-cost
    discipline, pinned in tests/test_traffic_lab.py.

    State is plain per-bucket FIFO deques (same-bucket order is strict
    FIFO; CROSS-bucket order deliberately is not — that head-of-line
    coupling is what continuous batching removes). Dispatch readiness,
    oldest group first across buckets:

    * **fill** — a bucket's forming group reached ``batch_tasks``
      members; lingering longer buys nothing.
    * **linger** — the group's oldest admit is older than
      ``linger_ms``; waiting longer for company would start charging
      the lone requests real latency.

    Not thread-safe on its own: the owning batcher calls every method
    under ITS queue lock (the admission-controller calling contract).
    Dispatch counters are plain ints (registry-agnostic, the LRU-cache
    discipline); the engine delta-mirrors them into telemetry.
    """

    def __init__(self, batch_tasks: int, linger_ms: float):
        if batch_tasks < 1:
            raise ValueError(
                f"batch_tasks must be >= 1, got {batch_tasks}")
        if linger_ms < 0:
            raise ValueError(f"linger_ms must be >= 0, got {linger_ms}")
        self.batch_tasks = int(batch_tasks)
        self.linger_s = float(linger_ms) / 1e3
        self._groups: Dict[Tuple[int, int], Deque[FewShotRequest]] = {}
        self.fill_dispatches = 0
        self.linger_dispatches = 0
        self.groups_dispatched = 0

    @property
    def pending(self) -> int:
        return sum(len(g) for g in self._groups.values())

    def admit(self, req: FewShotRequest, bucket: Tuple[int, int]) -> None:
        self._groups.setdefault(bucket, deque()).append(req)

    def sweep_expired(self, now: float) -> List[FewShotRequest]:
        """Remove deadline-expired requests from every forming group
        (they are answered with errors exactly like queue-expired ones;
        an empty bucket entry is dropped so its linger clock dies)."""
        expired: List[FewShotRequest] = []
        for bucket in list(self._groups):
            kept = deque(r for r in self._groups[bucket]
                         if r.deadline is None or now <= r.deadline)
            expired.extend(r for r in self._groups[bucket]
                           if not (r.deadline is None
                                   or now <= r.deadline))
            if kept:
                self._groups[bucket] = kept
            else:
                del self._groups[bucket]
        return expired

    def pop_ready(self, now: float, max_tasks: int
                  ) -> Optional[Tuple[Tuple[int, int],
                                      List[FewShotRequest]]]:
        """The oldest dispatch-ready group, or None while every forming
        group is still within both its fill and linger budgets."""
        best: Optional[Tuple[int, int]] = None
        best_ts = math.inf
        for bucket, grp in self._groups.items():
            oldest = grp[0].enqueue_time or 0.0
            full = len(grp) >= min(max_tasks, self.batch_tasks)
            lingered = now - oldest >= self.linger_s
            if (full or lingered) and oldest < best_ts:
                best, best_ts = bucket, oldest
        if best is None:
            return None
        grp = self._groups[best]
        group = [grp.popleft()
                 for _ in range(min(max_tasks, self.batch_tasks,
                                    len(grp)))]
        if not grp:
            del self._groups[best]
        if len(group) >= min(max_tasks, self.batch_tasks):
            self.fill_dispatches += 1
        else:
            self.linger_dispatches += 1
        self.groups_dispatched += 1
        return best, group


@dataclass
class FewShotRequest:
    """One few-shot task: support set + query images.

    ``support_x``: (S, H, W, C) uint8 or f32; ``support_y``: (S,) int in
    [0, N-way); ``query_x``: (Q, H, W, C). ``deadline`` is an ABSOLUTE
    ``time.monotonic()`` instant (None = the engine applies the config
    default). ``arrival_time`` defaults to construction time so latency
    measurements include queueing. ``enqueue_time`` is stamped by the
    batcher at ADMISSION (None until then) — bucket wait is measured
    from there, not from dequeue. ``trace`` is the optional request-
    trace context (telemetry/reqtrace.py); None = unsampled.
    ``tenant`` is an opaque caller identity used ONLY by fair shedding
    (``fleet_shed_policy='fair'``); None opts out of fairness.
    """
    support_x: np.ndarray
    support_y: np.ndarray
    query_x: np.ndarray
    deadline: Optional[float] = None
    request_id: int = field(default_factory=lambda: next(_ids))
    arrival_time: float = field(default_factory=time.monotonic)
    enqueue_time: Optional[float] = None
    trace: Optional[dict] = None
    tenant: Optional[object] = None

    def __post_init__(self) -> None:
        self.support_x = np.asarray(self.support_x)
        self.support_y = np.asarray(self.support_y)
        self.query_x = np.asarray(self.query_x)
        if self.support_x.ndim != 4 or self.query_x.ndim != 4:
            raise ValueError(
                f"support_x/query_x must be (n, H, W, C), got "
                f"{self.support_x.shape} / {self.query_x.shape}")
        if self.support_y.shape != (self.support_x.shape[0],):
            raise ValueError(
                f"support_y shape {self.support_y.shape} does not match "
                f"support_x count {self.support_x.shape[0]}")

    @property
    def num_support(self) -> int:
        return int(self.support_x.shape[0])

    @property
    def num_query(self) -> int:
        return int(self.query_x.shape[0])


class RequestBatcher:
    """FIFO queue of requests, grouped by shape bucket at dequeue time.

    ``submit`` is O(1) and thread-safe (a frontend thread enqueues while
    the engine loop dequeues). ``next_group`` returns up to
    ``max_tasks`` queued requests sharing the HEAD-of-line request's
    bucket (strict-FIFO head start, so no bucket starves) plus the
    expired requests it skipped over.
    """

    def __init__(self, buckets: Sequence[Tuple[int, int]],
                 max_queue_depth: int,
                 default_deadline_ms: float = 0.0,
                 wire_dtype: Optional[np.dtype] = None,
                 image_shape: Optional[Tuple[int, int, int]] = None,
                 num_classes: Optional[int] = None):
        if not buckets:
            raise ValueError("need at least one shape bucket")
        self.buckets: Tuple[Tuple[int, int], ...] = tuple(
            sorted((int(s), int(q)) for s, q in buckets))
        self.max_queue_depth = int(max_queue_depth)
        self.default_deadline_ms = float(default_deadline_ms)
        # Admission-control contracts (None = unchecked). Everything the
        # compiled steps assume about a request is validated at submit,
        # where a violation is one rejected request — not at batch
        # assembly, where it would crash the engine loop and lose the
        # whole dequeued group:
        # * wire_dtype — the image dtype is part of the executables'
        #   signature (off-dtype traffic would recompile) and of batch
        #   assembly (a mixed-dtype group would silently numpy-cast the
        #   minority request's pixels);
        # * image_shape — (H, W, C) of the deployment;
        # * num_classes — labels must lie in [0, N): out-of-range labels
        #   don't error under jit (the gather clamps), they silently
        #   corrupt the adaptation AND the cache entry for that support
        #   set.
        self.wire_dtype = None if wire_dtype is None else np.dtype(
            wire_dtype)
        self.image_shape = (None if image_shape is None
                            else tuple(int(v) for v in image_shape))
        self.num_classes = None if num_classes is None else int(num_classes)
        # Shed-at-admission policy (fleet_shed_policy): None — the
        # default — installs NOTHING; submit pays one `is None` check
        # (the structural zero-cost pin). The engine installs an
        # AdmissionController when the policy is on.
        self.admission: Optional[AdmissionController] = None
        # Continuous batching (serve_continuous_batching): same pin —
        # None routes every request through the head-of-line queue
        # below, bitwise identical to pre-assembler serving; the engine
        # installs a GroupAssembler when the knob is on.
        self.assembler: Optional[GroupAssembler] = None
        self._queue: Deque[Tuple[FewShotRequest, Tuple[int, int]]] = deque()
        self._lock = threading.Lock()

    def bucket_for(self, num_support: int,
                   num_query: int) -> Tuple[int, int]:
        """Smallest configured bucket that fits (support-major order —
        support padding costs adaptation compute on every inner step,
        query padding only one forward)."""
        for s, q in self.buckets:
            if num_support <= s and num_query <= q:
                return (s, q)
        raise BucketError(
            f"no serve bucket fits a request with {num_support} support "
            f"/ {num_query} query examples (buckets: {self.buckets})")

    @property
    def depth(self) -> int:
        if self.assembler is not None:
            return len(self._queue) + self.assembler.pending
        return len(self._queue)

    def submit(self, req: FewShotRequest,
               now: Optional[float] = None) -> Tuple[int, int]:
        """Enqueue; returns the bucket the request resolved to. Raises
        :class:`BucketError` (no fitting shape) or
        :class:`QueueFullError` (backpressure) — both BEFORE the request
        enters the queue, so a rejected submit has no side effects."""
        for name, arr in (("support_x", req.support_x),
                          ("query_x", req.query_x)):
            if (self.wire_dtype is not None
                    and arr.dtype != self.wire_dtype):
                raise BucketError(
                    f"request {name} dtype {arr.dtype} does not match "
                    f"the serving wire dtype {self.wire_dtype} (the "
                    f"image dtype is part of the compiled executable "
                    f"signature and of batch assembly)")
            if (self.image_shape is not None
                    and tuple(arr.shape[1:]) != self.image_shape):
                raise BucketError(
                    f"request {name} images are {tuple(arr.shape[1:])} "
                    f"but this deployment serves {self.image_shape}")
        if self.num_classes is not None and req.support_y.size:
            lo, hi = int(req.support_y.min()), int(req.support_y.max())
            if lo < 0 or hi >= self.num_classes:
                raise BucketError(
                    f"support_y labels span [{lo}, {hi}] but this "
                    f"deployment is {self.num_classes}-way (labels must "
                    f"lie in [0, {self.num_classes})); out-of-range "
                    f"labels would silently corrupt the adaptation)")
        bucket = self.bucket_for(req.num_support, req.num_query)
        stamp_deadline = (req.deadline is None
                          and self.default_deadline_ms > 0)
        with self._lock:
            depth = len(self._queue) + (self.assembler.pending
                                        if self.assembler is not None
                                        else 0)
            if depth >= self.max_queue_depth:
                raise QueueFullError(
                    f"serve queue at max depth {self.max_queue_depth}")
            now = time.monotonic() if now is None else now
            if self.admission is not None:
                # Shed verdict BEFORE any side effect (same contract as
                # the rejections above): the deadline judged is the one
                # the request would carry once stamped. Forming-group
                # members count as queued (``depth``) — a lingering
                # batch is work the drain rate has not paid yet.
                deadline = req.deadline
                if deadline is None and stamp_deadline:
                    deadline = now + self.default_deadline_ms / 1e3
                self.admission.admit(bucket, deadline, now,
                                     depth, tenant=req.tenant)
            # Stamped only once admission is certain: a rejected submit
            # must leave the request untouched (the caller may retry it
            # later, and the deadline clock must not have been running
            # while it was never queued). enqueue_time marks the same
            # instant — queue wait is measured from ADMISSION, not from
            # dequeue, or bucket wait would be invisibly attributed to
            # whatever phase dequeues the request.
            if stamp_deadline:
                req.deadline = now + self.default_deadline_ms / 1e3
            req.enqueue_time = now
            if self.assembler is not None:
                # Continuous batching: straight into the bucket's
                # forming group — the group IS the queue position.
                self.assembler.admit(req, bucket)
            else:
                self._queue.append((req, bucket))
            if self.admission is not None:
                self.admission.note_enqueued(req.tenant)
        return bucket

    def next_group(self, max_tasks: int, now: Optional[float] = None
                   ) -> Tuple[Tuple[int, int],
                              List[FewShotRequest],
                              List[FewShotRequest]]:
        """Dequeue up to ``max_tasks`` same-bucket requests.

        Returns ``(bucket, group, expired)``. The bucket is the oldest
        live request's; younger requests of OTHER buckets stay queued in
        order (they'll head the next group). Expired requests — from any
        bucket encountered while scanning — are removed and returned
        separately for error responses + the deadline-miss metric.

        Under continuous batching (``assembler`` installed) the group
        is instead the oldest DISPATCH-READY forming group — full, or
        past its linger budget — and an empty group with pending depth
        means every forming group is still lingering for company (the
        engine loop just polls again).
        """
        now = time.monotonic() if now is None else now
        group: List[FewShotRequest] = []
        expired: List[FewShotRequest] = []
        if self.assembler is not None:
            with self._lock:
                expired = self.assembler.sweep_expired(now)
                ready = self.assembler.pop_ready(now, max_tasks)
                if self.admission is not None:
                    for req in (ready[1] if ready else []):
                        self.admission.note_removed(req.tenant)
                    for req in expired:
                        self.admission.note_removed(req.tenant)
            if ready is not None:
                return ready[0], ready[1], expired
            return self.buckets[0], [], expired
        with self._lock:
            kept: Deque[Tuple[FewShotRequest, Tuple[int, int]]] = deque()
            bucket: Optional[Tuple[int, int]] = None
            for req, b in self._queue:
                if req.deadline is not None and now > req.deadline:
                    expired.append(req)
                    continue
                if bucket is None and len(group) == 0:
                    bucket = b
                if b == bucket and len(group) < max_tasks:
                    group.append(req)
                else:
                    kept.append((req, b))
            self._queue = kept
            if self.admission is not None:
                for req in group:
                    self.admission.note_removed(req.tenant)
                for req in expired:
                    self.admission.note_removed(req.tenant)
        return (bucket or self.buckets[0]), group, expired


def pad_group(group: Sequence[FewShotRequest], bucket: Tuple[int, int],
              batch_tasks: int, image_shape: Tuple[int, int, int]
              ) -> Dict[str, np.ndarray]:
    """Assemble a group into the static (batch_tasks, bucket) arrays.

    Support rows are padded with zeros at WEIGHT 0 (invisible to the
    weighted adapt loss; exactness under batch_norm's transductive
    statistics is bucket-fit-dependent — module docstring); query rows
    with zeros (their predictions are sliced off); missing TASKS
    replicate task 0 (their outputs are discarded). Returns
    support_x/support_y/support_w/query_x plus ``occupancy`` (real
    tasks / batch slots).
    """
    if not group:
        raise ValueError("empty group")
    if len(group) > batch_tasks:
        raise ValueError(f"group of {len(group)} exceeds batch_tasks "
                         f"{batch_tasks}")
    s_b, q_b = bucket
    h, w, c = image_shape
    x_dtype = group[0].support_x.dtype
    sx = np.zeros((batch_tasks, s_b, h, w, c), x_dtype)
    sy = np.zeros((batch_tasks, s_b), np.int32)
    sw = np.zeros((batch_tasks, s_b), np.float32)
    qx = np.zeros((batch_tasks, q_b, h, w, c), x_dtype)
    for i, req in enumerate(group):
        s, q = req.num_support, req.num_query
        sx[i, :s] = req.support_x
        sy[i, :s] = req.support_y
        sw[i, :s] = 1.0
        qx[i, :q] = req.query_x
    for i in range(len(group), batch_tasks):
        # Replica of task 0, NOT zero-weight rows: an all-zero weight
        # vector would divide by zero inside the weighted loss.
        sx[i], sy[i], sw[i], qx[i] = sx[0], sy[0], sw[0], qx[0]
    return {"support_x": sx, "support_y": sy, "support_w": sw,
            "query_x": qx,
            "occupancy": len(group) / float(batch_tasks)}
