"""Rebuild a Chrome-trace timeline offline from a port run's logs (the
port's counterpart of ``scripts/trace_export.py``).

Usage:
    python scripts/torch_trace_export.py <experiment_dir | logs_dir | events.jsonl>
        [--flight FLIGHT_JSONL] [--out TRACE_JSON] [--process-index N]

Synthesizes ``telemetry/trace.py``'s Chrome ``trace_event`` JSON —
loadable in Perfetto or ``chrome://tracing`` — from whichever timeline
sources the run left behind:

* ``events.jsonl`` (always written): whole-run epoch spans, per-host
  heartbeat markers, checkpoint/rewind/preemption/trip/warn markers;
* ``flight.jsonl`` (the experiment loop's per-epoch ring dump, or the
  copy inside a crash bundle): fine-grained step/feed/serve phase spans
  for the most recent ring window.

When given a directory, the flight ring is auto-discovered next to the
events log (``flight.jsonl``), falling back to the newest crash
bundle's copy. Either source alone suffices; having neither is an
error.

The LAST stdout line is the JSON artifact, with the JAX script's keys:
``{"metric": "trace_export", "spans": N, "instants": I, "hosts": H,
"events_rows": E, "flight_rows": F, "out": PATH}``. Exit 0 on success,
1 on any failure. Reads through the port's ``telemetry/trace.py`` and
``utils/tracing.py``; imports nothing of JAX and touches no device.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from howtotrainyourmamlpytorch_tpu_torch.telemetry import (  # noqa: E402
    trace as _trace)
# Rotation-aware: the spare segment (events.jsonl.1) reads first.
from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import (  # noqa: E402
    read_jsonl_rotated as read_jsonl)


def resolve_paths(path: str):
    """(events_path_or_None, flight_path_or_None, out_dir) for a CLI
    argument that may be an events.jsonl, a logs dir, or an experiment
    dir. Flight auto-discovery: next to the events log, else the newest
    crash bundle's copy (``crash_bundle*/flight.jsonl``)."""
    if os.path.isdir(path):
        logs = path
        for candidate in (path, os.path.join(path, "logs")):
            if os.path.exists(os.path.join(candidate, "events.jsonl")) \
                    or glob.glob(os.path.join(candidate, "crash_bundle*")):
                logs = candidate
                break
        events = os.path.join(logs, "events.jsonl")
        events = events if os.path.exists(events) else None
    else:
        events = path if os.path.exists(path) else None
        logs = os.path.dirname(path) or "."
    flight = os.path.join(logs, "flight.jsonl")
    if not os.path.exists(flight):
        bundles = sorted(
            glob.glob(os.path.join(logs, "crash_bundle*", "flight.jsonl")),
            key=os.path.getmtime)
        flight = bundles[-1] if bundles else None
    return events, flight, logs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Rebuild a Chrome-trace timeline from a run's "
                    "events.jsonl + flight.jsonl.")
    ap.add_argument("path", help="events.jsonl, a logs/ dir, or an "
                                 "experiment dir containing logs/")
    ap.add_argument("--flight", default=None, metavar="JSONL",
                    help="explicit flight.jsonl (default: auto-discover "
                         "next to the events log, then the newest crash "
                         "bundle's copy)")
    ap.add_argument("--out", default=None, metavar="JSON",
                    help="output trace path (default: trace.json next to "
                         "the inputs)")
    ap.add_argument("--process-index", type=int, default=0,
                    help="pid to assign the flight ring's phase spans "
                         "(a per-host crash bundle from host N renders "
                         "on track N)")
    args = ap.parse_args(argv)

    try:
        events_path, flight_path, out_dir = resolve_paths(args.path)
        if args.flight is not None:
            flight_path = args.flight
        events = read_jsonl(events_path) if events_path else None
        flight = read_jsonl(flight_path) if flight_path else None
        if not events and not flight:
            raise FileNotFoundError(
                f"no timeline source under {args.path!r}: need an "
                f"events.jsonl and/or a flight.jsonl")
        out = args.out or os.path.join(out_dir, "trace.json")
        stats = _trace.write_trace(out, events=events, flight=flight,
                                   process_index=args.process_index)
    except (OSError, ValueError) as e:
        print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
        return 1

    # The LAST stdout line is the machine-readable artifact.
    print(json.dumps({
        "metric": "trace_export",
        "spans": stats["spans"],
        "instants": stats["instants"],
        "hosts": stats["hosts"],
        "events_rows": len(events) if events else 0,
        "flight_rows": len(flight) if flight else 0,
        "out": out,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
