"""Run-summary CLI over a run's ``events.jsonl`` telemetry stream (the
PyTorch port's counterpart of ``scripts/telemetry_report.py``, over the
port's own ``telemetry/report.py``; the same table and the same last
line for the same log).

Usage:
    python scripts/torch_telemetry_report.py <logs/events.jsonl> [--json]
    python scripts/torch_telemetry_report.py <experiment_root/name> [--json]

Reads the structured event log the experiment loop writes (train_epoch,
telemetry, heartbeat rows — docs/PERF.md § Observability) and prints:

* a human table: step-time p50/p95, meta-tasks/sec/chip, XLA compile
  count/seconds, feed-stall fraction, peak device memory, per-host
  step-time skew — each fail-soft metric that never reported prints an
  explicit "unavailable" marker (measured-zero and not-measured are
  different diagnoses);
* one machine-readable JSON line (the LAST stdout line, matching the
  bench.py artifact discipline) for CI consumption, schema pinned by
  tests/test_telemetry_report.py.

Exit codes: 0 ok, 1 unreadable/empty log, 2 bad usage.
No torch import — the CLI must run on a login node without accelerators:
the two modules it needs (telemetry/report.py, utils/tracing.py) are
stdlib-only, but importing them through the package would execute
``__init__`` chains that import torch, so they are loaded by file path
under the port's own aliases.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_module(name: str, relpath: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_report = _load_module(
    "_maml_torch_telemetry_report",
    os.path.join("howtotrainyourmamlpytorch_tpu_torch", "telemetry",
                 "report.py"))
_tracing = _load_module(
    "_maml_torch_telemetry_tracing",
    os.path.join("howtotrainyourmamlpytorch_tpu_torch", "utils",
                 "tracing.py"))
format_table = _report.format_table
summarize_events = _report.summarize_events
# Rotation-aware (utils/tracing.py § JsonlLogger rotation): the
# capped spare segment (events.jsonl.1) is read first, so a report
# over a rotated log keeps the oldest surviving rows.
read_jsonl = _tracing.read_jsonl_rotated


def resolve_events_path(path: str) -> str:
    """Accept the events.jsonl itself, a logs dir, or an experiment dir."""
    if os.path.isdir(path):
        for candidate in (os.path.join(path, "events.jsonl"),
                          os.path.join(path, "logs", "events.jsonl")):
            if os.path.exists(candidate):
                return candidate
        raise FileNotFoundError(
            f"no events.jsonl under {path!r} (looked in . and logs/)")
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Summarize a run's telemetry event log.")
    ap.add_argument("events", help="events.jsonl, a logs/ dir, or an "
                                   "experiment dir containing logs/")
    ap.add_argument("--json", action="store_true",
                    help="emit ONLY the JSON summary line (CI mode)")
    args = ap.parse_args(argv)

    try:
        path = resolve_events_path(args.events)
        events = read_jsonl(path)
    except (OSError, ValueError) as e:
        print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
        return 1
    if not events:
        print(json.dumps({"error": f"{path}: empty event log"}))
        return 1

    summary = summarize_events(events)
    if not args.json:
        print(format_table(summary))
    # The LAST stdout line is the machine-readable artifact (the same
    # contract bench.py establishes for its JSON output).
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
