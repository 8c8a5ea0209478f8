"""Heartbeats, per-host skew, and the events-file collector (the port's
copy of the JAX package's ``telemetry/aggregate.py``).

* **In-run**: :func:`emit_heartbeat` logs one ``heartbeat`` row per
  call, carrying :func:`host_step_skew`'s per-process step-time vector,
  gathered over the process group (``parallel/multihost.py §
  gather_host_floats``; the local value alone with one process). Every
  rank calls it at the same point: it is a collective.
* **Offline**: :func:`collect_fleet_events` merges ``events*.jsonl``
  files into one time-ordered timeline with each row stamped by its
  source file, and :func:`fleet_counter_totals` folds the interleaved
  counter streams reset-aware per ``(source, metric)``. Copies of the
  JAX functions.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, List, Optional

from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import (
    read_jsonl_rotated)

HEARTBEAT_EVENT = "heartbeat"
METRICS_EVENT = "metrics"


def _gather_host_floats(value: float) -> List[float]:
    """The per-process vector of ``value``, ordered by rank."""
    # Imported here: parallel/ imports the step code, which imports
    # this package.
    from howtotrainyourmamlpytorch_tpu_torch.parallel import multihost
    return multihost.gather_host_floats(value)


def host_step_skew(local_mean_step_seconds: float) -> Dict[str, Any]:
    """Per-host step-time vector + straggler summary.

    ``skew_frac`` is
    ``(max - mean) / mean`` over hosts — 0.0 when perfectly balanced;
    0.2 means the slowest host (which paces every collective) runs 20%
    behind the fleet average.
    """
    values = _gather_host_floats(local_mean_step_seconds)
    finite = [v for v in values if v > 0]
    if not finite:
        return {"hosts": len(values), "host_mean_step_seconds": values,
                "skew_frac": 0.0, "slowest_host": 0}
    mean = sum(finite) / len(finite)
    worst = max(values)
    return {
        "hosts": len(values),
        "host_mean_step_seconds": values,
        "skew_frac": (worst - mean) / mean if mean > 0 else 0.0,
        "slowest_host": int(values.index(worst)),
    }


def emit_heartbeat(jsonl: Any, *, epoch: int, iteration: int,
                   local_mean_step_seconds: float,
                   process_index: Optional[int] = None,
                   progress_age_seconds: Optional[float] = None,
                   progress_phase: Optional[str] = None,
                   **extra: Any) -> Dict[str, Any]:
    """One heartbeat row per call. Extra payload (memory stats, feed
    stall, the ``alerts_firing`` summary) is merged into the row.

    ``progress_age_seconds`` is the caller's watchdog-beacon age (now −
    last beacon stamp); when passed, the row carries the per-host ages
    and their max. ``process_index`` defaults to 0 (one process).
    """
    if process_index is None:
        process_index = 0
    skew = host_step_skew(local_mean_step_seconds)
    if progress_age_seconds is not None:
        ages = _gather_host_floats(progress_age_seconds)
        skew["host_progress_age_seconds"] = ages
        skew["progress_age_seconds"] = max(ages)
    if progress_phase is not None:
        skew["progress_phase"] = progress_phase
    return jsonl.log(HEARTBEAT_EVENT, epoch=epoch, iter=iteration,
                     process_index=process_index, **skew, **extra)


def heartbeat_rows(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return [e for e in events if e.get("event") == HEARTBEAT_EVENT]


# ---------------------------------------------------------------------------
# Offline fleet collector
# ---------------------------------------------------------------------------


def resolve_fleet_files(paths: List[str]) -> List[str]:
    """Expand args into event files: a ``.jsonl`` file stands for
    itself; a directory stands for every ``*.jsonl`` directly under it
    and under ``logs/`` (the slo_report.py rule — the layout a
    fleet_bench/chaos_fleet out dir and an experiment dir both leave
    behind). Rotated spares (``*.jsonl.1``) are NOT listed — readers
    fold them in per live segment."""
    files: List[str] = []
    for path in paths:
        if os.path.isdir(path):
            found = sorted(glob.glob(os.path.join(path, "*.jsonl")))
            found += sorted(glob.glob(os.path.join(path, "logs",
                                                   "*.jsonl")))
            files += found
        else:
            files.append(path)
    return files


def collect_fleet_events(paths: List[str]) -> List[Dict[str, Any]]:
    """Merge trainer + replica + supervisor + driver event files into
    one time-ordered timeline.

    Each row gains a ``source`` key (the file's basename stem, e.g.
    ``events_replica_0``) unless the row already names one (supervisor
    metric rows carry ``replica="supervisor"``; those win — they are
    the writer's own identity). The sort is stable on ``ts`` so rows
    from one file keep their write order even with equal stamps; a row
    without a finite ``ts`` sorts to the front rather than being
    dropped (half-written logs from a live fleet must still render).
    Unreadable files contribute nothing — the console's job includes
    rendering a half-dead fleet.
    """
    rows: List[Dict[str, Any]] = []
    for path in resolve_fleet_files(paths):
        stem = os.path.basename(path)
        if stem.endswith(".jsonl"):
            stem = stem[:-len(".jsonl")]
        try:
            file_rows = read_jsonl_rotated(path)
        except (OSError, ValueError):
            continue
        for row in file_rows:
            if not isinstance(row, dict):
                continue
            row.setdefault("source", str(row.get("replica", "")) or stem)
            rows.append(row)
    rows.sort(key=lambda r: (
        float(r["ts"]) if isinstance(r.get("ts"), (int, float))
        else float("-inf")))
    return rows


def fleet_counter_totals(rows: List[Dict[str, Any]],
                         prefixes: tuple = ("fleet/", "serve/")
                         ) -> Dict[str, float]:
    """Reset-aware fleet-wide counter totals over a merged timeline.

    Accumulation is per ``(source, metric)`` — the timeline interleaves
    several processes, and each restarts independently — then summed
    across sources per metric: the Prometheus ``rate()`` rule
    report.py's fleet section applies, lifted to the merged stream.
    Gauges are not meaningful to sum this way; callers wanting "latest
    gauge" read the last ``metrics`` row of the relevant source.
    """
    totals: Dict[str, float] = {}
    prev: Dict[str, float] = {}
    for row in rows:
        if row.get("event") != METRICS_EVENT:
            continue
        metrics = row.get("metrics")
        if not isinstance(metrics, dict):
            continue
        source = str(row.get("source", ""))
        for key, value in metrics.items():
            if not key.startswith(prefixes) \
                    or not isinstance(value, (int, float)):
                continue
            pkey = f"{source}:{key}"
            p = prev.get(pkey, 0.0)
            totals[key] = totals.get(key, 0.0) + (
                float(value) if float(value) < p else float(value) - p)
            prev[pkey] = float(value)
    return totals


def latest_gauges(rows: List[Dict[str, Any]],
                  names: List[str]) -> Dict[str, Any]:
    """Last observed value per named metric across the merged timeline
    (whatever source wrote it last — the console's 'current fleet
    state' read for gauges like ``fleet/canary_weight``)."""
    out: Dict[str, Any] = {name: None for name in names}
    for row in rows:
        if row.get("event") != METRICS_EVENT:
            continue
        metrics = row.get("metrics")
        if not isinstance(metrics, dict):
            continue
        for name in names:
            if isinstance(metrics.get(name), (int, float)):
                out[name] = metrics[name]
    return out
