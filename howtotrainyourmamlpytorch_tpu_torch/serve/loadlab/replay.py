"""Open-loop trace replay: arrivals fire off the trace clock.

The port's own copy of the JAX package's ``serve/loadlab/replay.py``
(the same replay clock). It imports nothing of that package.

The one rule that makes a load test honest (the serve_bench
coordinated-omission rule, generalized to shaped traffic): a request
is submitted when the TRACE says it arrives — ``start + t/warp`` —
never when the previous response lands. A fleet that falls behind
accumulates queueing the way production would; a replayer that waited
on responses would silently throttle the offered load and report
fantasy latencies exactly when the numbers matter most.

* ``replay`` — the drive loop: walks the (sorted) records, sleeps the
  gap to each scheduled instant (pumping the caller's housekeeping —
  router refresh, controller/supervisor ticks — while waiting), then
  calls ``submit``. The time-warp factor compresses trace time into
  wall time (warp 60 plays an hour of trace in a minute) without
  changing the SHAPE: relative rates, ramps and bursts survive warping
  exactly.
* ``submit`` must not block on the response. Latency is the caller's
  to measure FROM THE SCHEDULED INSTANT the replay log records — the
  replayer hands back every record's scheduled wall time for exactly
  that.
* **Replay lag** — how far behind schedule each submit actually fired
  — is measured and reported. A lagging replayer is under-offering
  load; the proof frontends gate on it instead of trusting the replay
  blindly.
* ``split_phases`` / ``phase_stats`` — per-phase bookkeeping: a phase
  plan names trace-time windows (ramp / peak / rollout / ...) and each
  record, response latency and SLO assertion is attributed to the
  phase its ARRIVAL falls in.

Stdlib only, no package imports — loadable by file path (the
``router.py`` discipline) so the torch-free fleet frontends run the
replayer without an accelerator runtime.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence


def phase_of(phases: Sequence[Dict[str, Any]], t: float) -> str:
    """The phase a trace instant belongs to: phases are contiguous
    windows ``{"name": ..., "until_s": ...}`` in order; an instant past
    the last boundary belongs to the last phase (drain tails count
    against the final phase rather than vanishing)."""
    if not phases:
        raise ValueError("empty phase plan")
    for ph in phases:
        if t < float(ph["until_s"]):
            return str(ph["name"])
    return str(phases[-1]["name"])


def split_phases(records: Sequence[Dict[str, Any]],
                 phases: Sequence[Dict[str, Any]]
                 ) -> Dict[str, List[int]]:
    """{phase name: [record indices]} — every phase present even when
    empty, so downstream stats stay schema-stable."""
    out: Dict[str, List[int]] = {str(p["name"]): [] for p in phases}
    for i, rec in enumerate(records):
        out[phase_of(phases, float(rec["t"]))].append(i)
    return out


def phase_stats(records: Sequence[Dict[str, Any]],
                phases: Sequence[Dict[str, Any]],
                latency_ms: Dict[int, float],
                quantile: Callable[[List[float], float], float]
                ) -> Dict[str, Dict[str, Any]]:
    """Per-phase latency summary over completed requests.

    ``latency_ms`` maps record index -> e2e latency measured from the
    SCHEDULED arrival (the open-loop rule); an index absent from it is
    counted incomplete. ``quantile`` is the caller's pinned definition
    (utils/tracing.py § nearest_rank in this repo — passed in so this
    module stays import-free)."""
    out: Dict[str, Dict[str, Any]] = {}
    for name, idxs in split_phases(records, phases).items():
        vals = sorted(latency_ms[i] for i in idxs if i in latency_ms)
        out[name] = {
            "offered": len(idxs),
            "completed": len(vals),
            "p50_ms": round(quantile(vals, 0.50), 3) if vals else None,
            "p95_ms": round(quantile(vals, 0.95), 3) if vals else None,
        }
    return out


def replay(records: Sequence[Dict[str, Any]],
           submit: Callable[[int, Dict[str, Any], float], None], *,
           warp: float = 1.0,
           pump: Optional[Callable[[float], None]] = None,
           now: Callable[[], float] = time.monotonic,
           sleep: Callable[[float], None] = time.sleep,
           max_sleep_s: float = 0.005) -> Dict[str, Any]:
    """Drive every record at its scheduled instant; never wait on a
    response.

    ``submit(index, record, scheduled_wall_t)`` fires at (or as soon
    as possible after) ``scheduled_wall_t = start + t/warp``. ``pump``
    runs on every wait slice — the caller's refresh/tick housekeeping
    lives there, NOT between submits of a burst (a burst must land
    back-to-back). ``now``/``sleep`` are injectable for deterministic
    tests.

    Returns ``{"start": wall start, "scheduled": [wall instant per
    record], "lag_ms": [submit delay behind schedule per record],
    "max_lag_ms": ..., "wall_seconds": ...}``.
    """
    if warp <= 0:
        raise ValueError(f"warp must be > 0, got {warp}")
    start = now()
    scheduled: List[float] = []
    lag_ms: List[float] = []
    for i, rec in enumerate(records):
        target = start + float(rec["t"]) / warp
        scheduled.append(target)
        while True:
            t_now = now()
            if t_now >= target:
                break
            if pump is not None:
                pump(t_now)
            sleep(min(max_sleep_s, target - t_now))
        submit(i, rec, target)
        lag_ms.append(max(now() - target, 0.0) * 1e3)
    return {"start": start, "scheduled": scheduled, "lag_ms": lag_ms,
            "max_lag_ms": round(max(lag_ms), 3) if lag_ms else None,
            "wall_seconds": round(now() - start, 3)}
