"""Chrome ``trace_event`` timeline export: the run's last hours as a
picture you can scrub.

The experiment loop logs epoch/heartbeat/checkpoint rows; a flight
recorder rings the last N events. This module synthesizes them into the Chrome
``trace_event`` JSON format (the JSON Array/Object format documented by
the Trace Event Profiling Tool spec), loadable in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``:

* **flight-ring phase rows** (``resilience/flightrec.py``) become
  complete-duration ``"X"`` spans: consecutive ``phase`` transitions
  bound each span, so the step/feed/collective/compile/serve_request
  cadence of the final seconds is directly visible. Non-phase ring
  events (fault injections, serve batches, watchdog trips) become
  instant ``"i"`` markers.
* **events.jsonl rows** become the coarse, whole-run layer: one ``"X"``
  span per ``train_epoch`` (the row carries ``epoch_seconds``), per-host
  ``"i"`` markers from each ``heartbeat`` row (one track per host — a
  straggler's rising progress age is visible at a glance), and ``"i"``
  markers for checkpoints, rewinds, preemptions, watchdog trips and
  grad-norm warnings.
* **request_trace rows** (``telemetry/reqtrace.py``) become the request
  lane: per-hop ``"X"`` spans on :data:`REQUEST_TID` keyed by the
  REAL OS pid (router and replicas render as distinct processes), plus
  one Chrome flow ``"s"``/``"f"`` arrow per trace stitching the
  router-side ``wire_send`` end to the replica-side ``socket_queue``
  start — following one request across processes is a click.

Track layout: ``pid`` = host (process index), ``tid`` = phase class
(:data:`PHASE_TIDS`), so a pod renders as one row of phase lanes per
host. All timestamps are unix-epoch microseconds (the ``ts`` field both
sources already carry), so flight and JSONL layers align on one clock.

Consumers: the port's ``ExperimentBuilder`` flushes ``logs/trace.json``
per epoch from the tail of its ``events.jsonl``. The flight-ring input
stays empty until the resilience slice ports the flight recorder
(ROADMAP.md, Queue 1). A copy of the JAX package's ``telemetry/trace.py``
(stdlib-only): the same events give the same JSON.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

# tid per phase class — one lane per phase kind within a host's track.
PHASE_TIDS: Dict[str, int] = {
    "epoch": 0,
    "step": 1,
    "feed": 2,
    "collective": 3,
    "compile": 4,
    "serve_request": 5,
    "idle": 6,
    "init": 7,
}
HEARTBEAT_TID = 8   # per-host heartbeat markers
MARKER_TID = 9      # instant markers (checkpoints, trips, faults, ...)
_UNKNOWN_TID = 10   # future phase names degrade here, never crash
PROFILE_TID = 11    # perf-lab sampled windows (telemetry/profiler.py)
REQUEST_TID = 12    # request-trace spans (telemetry/reqtrace.py)

# events.jsonl rows rendered as instant markers on the marker lane.
_INSTANT_EVENTS = (
    "checkpoint", "preempt_checkpoint", "rewind", "watchdog_trip",
    "validation", "health_grad_norm_warn",
)

_VALID_PH = {"B", "E", "X", "i", "s", "f"}


def _us(ts: Any) -> int:
    return int(float(ts) * 1e6)


def _args(row: Dict[str, Any], skip: tuple) -> Dict[str, Any]:
    return {k: v for k, v in row.items()
            if k not in skip and isinstance(v, (str, int, float, bool))}


def spans_from_flight(flight: List[Dict[str, Any]],
                      process_index: int = 0) -> List[Dict[str, Any]]:
    """Trace events from a flight-recorder ring (oldest-first rows as
    ``FlightRecorder.dump_jsonl``/``events()`` produce them).

    Each ``phase`` row opens a span that the NEXT ring event closes (a
    stamp is the claim "I am now doing <phase>", so the following event
    bounds it); the final still-open phase closes at the last event's
    timestamp with a minimum 1 µs width — it is the state the ring was
    dumped in. Non-phase rows (faults, serve batches, trips) are instant
    markers carrying their payload as ``args``.
    """
    out: List[Dict[str, Any]] = []
    open_phase: Optional[tuple] = None  # (phase, detail, ts)
    last_ts: Optional[float] = None

    def close(end_ts: float) -> None:
        phase, detail, start_ts = open_phase
        out.append({
            "name": str(phase), "cat": "phase", "ph": "X",
            "ts": _us(start_ts),
            "dur": max(_us(end_ts) - _us(start_ts), 1),
            "pid": process_index,
            "tid": PHASE_TIDS.get(str(phase), _UNKNOWN_TID),
            "args": {"detail": detail} if detail is not None else {},
        })

    for row in flight:
        ts = row.get("ts")
        if ts is None:
            continue
        last_ts = ts
        if row.get("kind") == "phase":
            if open_phase is not None:
                close(ts)
            open_phase = (row.get("phase", "?"), row.get("detail"), ts)
        else:
            out.append({
                "name": str(row.get("kind")), "cat": "flight", "ph": "i",
                "ts": _us(ts), "pid": process_index, "tid": MARKER_TID,
                "s": "t",  # thread-scoped instant
                "args": _args(row, skip=("t", "ts", "kind")),
            })
    if open_phase is not None and last_ts is not None:
        close(last_ts)
    return out


def spans_from_events(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Trace events from an ``events.jsonl`` stream: whole-run epoch
    spans, per-host heartbeat markers (``pid`` = host index from the
    gathered vectors), and instant markers for the run-lifecycle rows."""
    out: List[Dict[str, Any]] = []
    # Flow anchors for the request lane: per trace_id, the router-side
    # wire_send END and the replica-side socket_queue START. One s/f
    # pair per trace draws the cross-process arrow in Perfetto. Each
    # anchor keeps the EARLIEST such span (keyed on start ts): the
    # request-direction wire_send precedes the response-direction one,
    # and rows arrive in whatever order the events files concatenate.
    flow_send: Dict[str, tuple] = {}    # trace_id -> (start, ts_us, pid)
    flow_recv: Dict[str, tuple] = {}    # trace_id -> (start, ts_us, pid)
    for row in events:
        event = row.get("event")
        ts = row.get("ts")
        if ts is None:
            continue
        if (event == "request_trace"
                and isinstance(row.get("ts_start"), (int, float))
                and isinstance(row.get("dur_s"), (int, float))
                and row["dur_s"] >= 0):
            # Request-trace spans keep their REAL OS pid: the router and
            # each replica render as distinct process tracks, and the
            # flow arrows below stitch one request across them. The
            # span's epoch start rides in ts_start (NOT ts — the logger
            # stamps ts at write time, i.e. at ring flush).
            span_ts = _us(row["ts_start"])
            span_pid = int(row.get("pid") or 0)
            out.append({
                "name": str(row.get("name") or "span"), "cat": "request",
                "ph": "X", "ts": span_ts,
                "dur": max(_us(row["dur_s"]), 1),
                "pid": span_pid, "tid": REQUEST_TID,
                "args": _args(row, skip=("ts", "event", "ts_start",
                                         "dur_s", "t_mono", "pid",
                                         "name")),
            })
            tid_ = row.get("trace_id")
            if isinstance(tid_, str) and tid_:
                if row.get("name") == "wire_send":
                    cur = flow_send.get(tid_)
                    if cur is None or span_ts < cur[0]:
                        flow_send[tid_] = (
                            span_ts,
                            span_ts + max(_us(row["dur_s"]), 1),
                            span_pid)
                elif row.get("name") == "socket_queue":
                    cur = flow_recv.get(tid_)
                    if cur is None or span_ts < cur[0]:
                        flow_recv[tid_] = (span_ts, span_ts, span_pid)
            continue
        if (event == "train_epoch"
                and isinstance(row.get("epoch_seconds"), (int, float))
                and row["epoch_seconds"] >= 0):
            dur = float(row["epoch_seconds"])
            out.append({
                "name": f"epoch {row.get('epoch')}", "cat": "epoch",
                "ph": "X", "ts": _us(ts - dur), "dur": max(_us(dur), 1),
                "pid": int(row.get("process_index") or 0),
                "tid": PHASE_TIDS["epoch"],
                "args": _args(row, skip=("ts", "event")),
            })
        elif event == "heartbeat":
            means = row.get("host_mean_step_seconds") or [None]
            ages = row.get("host_progress_age_seconds") or []
            for host, mean in enumerate(means):
                args: Dict[str, Any] = {"epoch": row.get("epoch"),
                                        "iter": row.get("iter")}
                if mean is not None:
                    args["mean_step_seconds"] = mean
                if host < len(ages):
                    args["progress_age_seconds"] = ages[host]
                if row.get("progress_phase") is not None:
                    args["progress_phase"] = row["progress_phase"]
                out.append({
                    "name": "heartbeat", "cat": "heartbeat", "ph": "i",
                    "ts": _us(ts), "pid": host, "tid": HEARTBEAT_TID,
                    "s": "t", "args": args,
                })
        elif (event == "perf_profile"
                and isinstance(row.get("wall_seconds"), (int, float))
                and row["wall_seconds"] > 0):
            # Perf-lab sample windows get their own lane: each span is
            # one profiled dispatch-sync window, ending at the row's
            # timestamp (the row is logged as the window closes), with
            # the attribution fractions riding as args — scrubbing the
            # timeline shows WHEN the device-time picture was measured.
            dur = float(row["wall_seconds"])
            out.append({
                "name": "perf_sample", "cat": "perf", "ph": "X",
                "ts": _us(ts - dur), "dur": max(_us(dur), 1),
                "pid": int(row.get("process_index") or 0),
                "tid": PROFILE_TID,
                "args": _args(row, skip=("ts", "event",
                                         "per_executable_seconds",
                                         "per_region_seconds",
                                         "roofline")),
            })
        elif event in _INSTANT_EVENTS:
            out.append({
                "name": str(event), "cat": "event", "ph": "i",
                "ts": _us(ts),
                "pid": int(row.get("process_index") or 0),
                "tid": MARKER_TID, "s": "t",
                "args": _args(row, skip=("ts", "event")),
            })
    # One flow arrow per trace: wire_send end (router pid) ->
    # socket_queue start (replica pid). Emitted only when BOTH anchors
    # exist in different processes — an arrow inside one pid is noise.
    for trace_id, (_, s_ts, s_pid) in flow_send.items():
        anchor = flow_recv.get(trace_id)
        if anchor is None or anchor[2] == s_pid:
            continue
        _, f_ts, f_pid = anchor
        out.append({"name": "request", "cat": "request", "ph": "s",
                    "id": trace_id, "ts": s_ts, "pid": s_pid,
                    "tid": REQUEST_TID, "args": {}})
        out.append({"name": "request", "cat": "request", "ph": "f",
                    "bp": "e", "id": trace_id, "ts": f_ts, "pid": f_pid,
                    "tid": REQUEST_TID, "args": {}})
    return out


def build_trace(events: Optional[List[Dict[str, Any]]] = None,
                flight: Optional[List[Dict[str, Any]]] = None,
                process_index: int = 0) -> Dict[str, Any]:
    """Assemble one Chrome-trace object from either or both sources.
    Events are globally ts-sorted, which makes every (pid, tid) track
    monotone — the invariant viewers assume and tests pin."""
    trace_events: List[Dict[str, Any]] = []
    if flight:
        trace_events += spans_from_flight(flight, process_index)
    if events:
        trace_events += spans_from_events(events)
    # Stable sort on (ts, pid) ONLY: each source emits its spans in
    # chronological order, and two spans recorded within the same
    # microsecond must keep that order — tie-breaking on tid reordered
    # same-µs phase transitions (feed→step flips on a fast box, seen
    # as a tier-1 flake). Per-track monotonicity (what validate_trace
    # pins) holds under any ts-sorted order.
    trace_events.sort(key=lambda e: (e["ts"], e["pid"]))
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def trace_stats(trace: Dict[str, Any]) -> Dict[str, Any]:
    """Span/instant/host counts of a built trace (the CLI artifact's
    payload)."""
    rows = trace.get("traceEvents", [])
    return {
        "events": len(rows),
        "spans": sum(1 for e in rows if e.get("ph") == "X"),
        "instants": sum(1 for e in rows if e.get("ph") == "i"),
        "hosts": len({e.get("pid") for e in rows}) if rows else 0,
    }


def validate_trace(trace: Dict[str, Any]) -> None:
    """Raise ValueError unless ``trace`` is schema-valid: every event
    has ``ph`` ∈ {B, E, X, i, s, f} with int ``ts``/``pid``/``tid``, X
    spans carry positive ``dur``, flow events (s/f) carry an ``id`` and
    no ``dur``, and each (pid, tid) track's timestamps are monotone.
    The test suite's (and CI's) single validity gate."""
    rows = trace.get("traceEvents")
    if not isinstance(rows, list):
        raise ValueError("trace has no traceEvents list")
    last_ts: Dict[tuple, int] = {}
    for i, e in enumerate(rows):
        if e.get("ph") not in _VALID_PH:
            raise ValueError(f"event {i}: bad ph {e.get('ph')!r}")
        for field in ("ts", "pid", "tid"):
            if not isinstance(e.get(field), int):
                raise ValueError(f"event {i}: non-int {field}")
        if e["ph"] == "X" and not (isinstance(e.get("dur"), int)
                                   and e["dur"] > 0):
            raise ValueError(f"event {i}: X span without positive dur")
        if e["ph"] in ("s", "f"):
            if not isinstance(e.get("id"), (str, int)):
                raise ValueError(f"event {i}: flow event without id")
            if "dur" in e:
                raise ValueError(f"event {i}: flow event carries dur")
        if not e.get("name"):
            raise ValueError(f"event {i}: missing name")
        track = (e["pid"], e["tid"])
        if e["ts"] < last_ts.get(track, e["ts"]):
            raise ValueError(
                f"event {i}: ts not monotone on track pid={e['pid']} "
                f"tid={e['tid']}")
        last_ts[track] = e["ts"]


def write_trace(path: str,
                events: Optional[List[Dict[str, Any]]] = None,
                flight: Optional[List[Dict[str, Any]]] = None,
                process_index: int = 0) -> Dict[str, Any]:
    """Build and atomically write ``trace.json``; returns the stats dict
    (plus ``path``). Atomic rename so a viewer/scraper never loads a
    torn file — the metrics.prom discipline."""
    trace = build_trace(events=events, flight=flight,
                        process_index=process_index)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(trace, f)
    os.replace(tmp, path)
    return {**trace_stats(trace), "path": path}
