"""Fleet request tracing: end-to-end spans across router → replica → engine.

The port's own copy of the JAX package's ``telemetry/reqtrace.py`` (the
same span rows, so the JAX package's ``scripts/slo_report.py`` reads a
port fleet's traces). It imports nothing of that package.

Every other observability surface in this repo is process-centric (the
registry's counters, the flight ring, the perf-lab cost cards).  A fleet
request crosses FOUR processes — frontend, router (in-frontend), replica
socket reader, engine worker — and until now left no causal record, so
"the p95 is queue-shaped" was an inference, not a measurement.  This
module is the causal record:

* :func:`mint` creates a trace context at ingress (frontend/router) with
  HEAD-BASED deterministic sampling: the sampling decision is a pure
  function of the trace id, so every process that sees the request makes
  the same decision without coordination, and a rerun with the same
  tenant/sequence stream samples the same requests.
* The context — ``{"trace_id", "span_id", "tenant"}`` — rides the framed
  pickle wire protocol as an optional ``"trace"`` key and the in-process
  path as ``FewShotRequest.trace``.  Unsampled requests carry NOTHING
  (the key is omitted), so rate=0 wire bytes are identical to pre-trace
  builds.
* :func:`record_span` buffers one row per hop in a per-process
  lock-protected ring (the flightrec idiom: bounded memory, oldest rows
  drop first, a crash loses at most the ring).  Rows are flushed as
  ``request_trace`` events.jsonl rows by the owning process's normal
  flush point (engine/replica shutdown, bench epilogue).

Zero-cost discipline (the health/profiler pin): when no ring is
installed — the ``reqtrace_sample_rate=0`` default — every hook is ONE
``get() is None`` check and nothing else exists: no ring, no rows, no
wire bytes, bitwise-identical serving.

Span tree is deliberately FLAT (two levels): the root ``request`` span
minted at ingress, and every hop span parented directly to it.  Cross-
process parenting deeper than that would need span-id propagation on
every hop response path for no analytical gain — tier attribution only
needs (root, hops).

This file is stdlib-only and file-path loadable: the torch-free fleet
frontend (scripts/torch_fleet_bench.py) and the JAX package's
scripts/slo_report.py load it without importing a package.  Keep it
that way.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import socket
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

# Event name for one flushed span row (scripts/telemetry_report.py's v14
# "requests" section and telemetry/trace.py's request lane read these).
REQUEST_TRACE_EVENT = "request_trace"

# Span names — one per hop a request crosses.  The root span ("request")
# is minted at ingress and closed when the response lands back there.
SPAN_REQUEST = "request"            # root: frontend send → response seen
SPAN_ROUTE = "route"                # router ring lookup + spill scan
SPAN_WIRE_SEND = "wire_send"        # pickle + sendall (either direction)
SPAN_WIRE_RECV = "wire_recv"        # payload recv + unpickle (NOT the
#                                     blocking head read — reader threads
#                                     park there between requests)
SPAN_SOCKET_QUEUE = "socket_queue"  # replica reader: recv → engine submit
SPAN_ADMIT = "admit"                # batcher admission (validate + enqueue)
SPAN_BATCH_WAIT = "batch_wait"      # admission → dequeue into a group
SPAN_CACHE_PROBE = "cache_probe"    # L1+L2 probe; "tier" arg: l1|l2|miss
SPAN_ADAPT = "adapt"                # inner-loop adaptation (batch-level
#                                     duration, attributed to each member)
SPAN_PREDICT = "predict"            # forward pass (batch-level, ditto)
SPAN_RESPOND = "respond"            # replica: response pickle + send

# Tier attribution: which hop spans fold into which latency tier.  The
# residual ("other") is root duration minus the sum — engine step
# scheduling, frontend loop latency, clock skew.
QUEUE_SPANS = (SPAN_SOCKET_QUEUE, SPAN_ADMIT, SPAN_BATCH_WAIT)
WIRE_SPANS = (SPAN_WIRE_SEND, SPAN_WIRE_RECV)
TIERS = ("queue", "wire", "adapt", "predict", "other")

# Sampling is a modulus test over the leading 64 bits of the trace id;
# 2^24 buckets give rate granularity of ~6e-8 — far below any rate a
# human would configure.
_SAMPLE_MOD = 1 << 24

_HOST = socket.gethostname()

# Per-process span-id mint: pid-prefixed so ids from different processes
# in one trace can never collide.  itertools.count is atomic in CPython.
_span_seq = itertools.count(1)


def next_span_id() -> str:
    return f"{os.getpid():x}.{next(_span_seq):x}"


def mint(tenant: Any, seq: Any,
         sample_rate: float) -> Optional[Dict[str, Any]]:
    """Trace context for request ``seq`` of ``tenant``, or None when the
    request is not sampled (head-based: the decision is deterministic in
    (tenant, seq, rate) — reruns sample the same requests, and tests can
    predict the sampled set)."""
    if sample_rate <= 0.0:
        return None
    trace_id = hashlib.sha256(
        f"{tenant}:{seq}".encode()).hexdigest()[:16]
    if sample_rate < 1.0:
        threshold = int(sample_rate * _SAMPLE_MOD)
        if int(trace_id, 16) % _SAMPLE_MOD >= threshold:
            return None
    return {"trace_id": trace_id, "span_id": next_span_id(),
            "tenant": str(tenant)}


class SpanRing:
    """Bounded lock-protected span buffer (flightrec idiom).

    Oldest rows drop first when full (``dropped`` counts them — loss is
    visible, never silent).  ``registry`` is an optional metrics-registry
    duck (anything with ``.counter(name).inc()``) for the
    ``reqtrace/spans`` / ``reqtrace/dropped`` counters.
    """

    def __init__(self, capacity: int = 4096, registry: Any = None):
        if capacity < 1:
            raise ValueError(f"SpanRing capacity must be >= 1 "
                             f"(got {capacity})")
        self.capacity = int(capacity)
        self._lock = threading.RLock()
        self._rows: deque = deque(maxlen=self.capacity)
        self.dropped = 0
        self._registry = registry

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def record(self, row: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._rows) == self.capacity:
                self.dropped += 1
                if self._registry is not None:
                    self._registry.counter("reqtrace/dropped").inc()
            self._rows.append(row)
        if self._registry is not None:
            self._registry.counter("reqtrace/spans").inc()

    def drain(self) -> List[Dict[str, Any]]:
        with self._lock:
            rows = list(self._rows)
            self._rows.clear()
            return rows

    def flush(self, jsonl: Any, **extra: Any) -> int:
        """Drain into ``jsonl`` (a JsonlLogger duck), one
        ``request_trace`` row per span.  ``extra`` fields (e.g. the
        replica id, which the engine does not know) fill in under the
        span's own keys — a span never loses what it recorded."""
        rows = self.drain()
        for row in rows:
            jsonl.log(REQUEST_TRACE_EVENT, **{**extra, **row})
        return len(rows)


# -- module-global install point (one ring per process) -------------------
_ring: Optional[SpanRing] = None


def install(ring: Optional[SpanRing]) -> Optional[SpanRing]:
    """Install ``ring`` as the process's span sink; returns the previous
    sink so owners can restore it on close (the compile-listener /
    watchdog discipline — engines stack cleanly in tests)."""
    global _ring
    prev = _ring
    _ring = ring
    return prev


def get() -> Optional[SpanRing]:
    """The installed ring, or None — the ONE check every hook makes
    before doing any tracing work at all."""
    return _ring


def record_span(ctx: Optional[Dict[str, Any]], name: str, t_start: float,
                dur_s: float, **fields: Any) -> Optional[Dict[str, Any]]:
    """Record one hop span parented to ``ctx``'s root.  No-op (and
    allocation-free) when no ring is installed or the request is
    unsampled (``ctx is None``) — callers never branch themselves.

    ``t_start`` is ``time.monotonic()`` at span start; the row carries
    both the monotonic start (same-process ordering) and a derived epoch
    start ``ts_start`` (cross-process alignment, trace viewers)."""
    ring = _ring
    if ring is None or ctx is None:
        return None
    row = {"trace_id": ctx["trace_id"], "span_id": next_span_id(),
           "parent_id": ctx.get("span_id"), "name": name,
           "t_mono": float(t_start),
           "ts_start": time.time() - (time.monotonic() - t_start),
           "dur_s": float(dur_s), "host": _HOST, "pid": os.getpid(),
           "tenant": ctx.get("tenant")}
    row.update(fields)
    ring.record(row)
    return row


def record_root(ctx: Optional[Dict[str, Any]], t_start: float,
                dur_s: float, **fields: Any) -> Optional[Dict[str, Any]]:
    """Record the root ``request`` span — span_id is the context's own id
    (every hop span points at it), parent is None."""
    ring = _ring
    if ring is None or ctx is None:
        return None
    row = {"trace_id": ctx["trace_id"], "span_id": ctx["span_id"],
           "parent_id": None, "name": SPAN_REQUEST,
           "t_mono": float(t_start),
           "ts_start": time.time() - (time.monotonic() - t_start),
           "dur_s": float(dur_s), "host": _HOST, "pid": os.getpid(),
           "tenant": ctx.get("tenant")}
    row.update(fields)
    ring.record(row)
    return row


def flush(jsonl: Any, **extra: Any) -> int:
    """Flush the installed ring (0 when none — callers never branch)."""
    ring = _ring
    return ring.flush(jsonl, **extra) if ring is not None else 0


# -- trace assembly + attribution (shared by fleet_bench's linked-trace
#    gate, scripts/slo_report.py and the tests — ONE definition of
#    "linked" and "dominant tier") --------------------------------------

def assemble(rows: Iterable[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Group flushed ``request_trace`` rows by trace id →
    ``{"root": row|None, "spans": [hop rows], "tenant": str|None}``."""
    traces: Dict[str, Dict[str, Any]] = {}
    for row in rows:
        tid = row.get("trace_id")
        if not tid:
            continue
        t = traces.setdefault(tid, {"trace_id": tid, "root": None,
                                    "spans": [], "tenant": None})
        if row.get("name") == SPAN_REQUEST and row.get("parent_id") is None:
            t["root"] = row
        else:
            t["spans"].append(row)
        if row.get("tenant"):
            t["tenant"] = row["tenant"]
    return traces


def linked(trace: Dict[str, Any]) -> bool:
    """A trace is fully linked when the root span exists, the request
    demonstrably completed (a respond or predict span arrived from the
    far side), and every hop span parents to the root — one broken
    parent means the causal chain is not trustworthy."""
    root = trace.get("root")
    spans = trace.get("spans") or []
    if root is None or not spans:
        return False
    names = {s.get("name") for s in spans}
    if SPAN_RESPOND not in names and SPAN_PREDICT not in names:
        return False
    return all(s.get("parent_id") == root["span_id"] for s in spans)


def attribute(trace: Dict[str, Any]) -> Dict[str, Any]:
    """Tier-split latency attribution for one trace: seconds in queue
    (socket queue + admission + bucket wait), wire (send + recv), adapt,
    predict, and the unattributed residual ("other": engine scheduling,
    frontend loop latency, clock skew — floored at 0 because hop clocks
    are per-process).  ``dominant`` names the largest tier."""
    sums = {"queue": 0.0, "wire": 0.0, "adapt": 0.0, "predict": 0.0}
    for s in trace.get("spans") or []:
        name, dur = s.get("name"), float(s.get("dur_s") or 0.0)
        if name in QUEUE_SPANS:
            sums["queue"] += dur
        elif name in WIRE_SPANS:
            sums["wire"] += dur
        elif name == SPAN_ADAPT:
            sums["adapt"] += dur
        elif name == SPAN_PREDICT:
            sums["predict"] += dur
    root = trace.get("root")
    total = float(root["dur_s"]) if root else sum(sums.values())
    sums["other"] = max(0.0, total - sum(sums.values()))
    sums["total"] = total
    sums["dominant"] = max(TIERS, key=lambda k: sums[k])
    return sums
