"""Per-tenant SLO + request-trace attribution CLI of the PyTorch port
(the port's counterpart of ``scripts/slo_report.py``).

Usage:
    python scripts/torch_slo_report.py <fleet_out_dir> [--json]
    python scripts/torch_slo_report.py events_a.jsonl events_b.jsonl [--json]

Reads every ``request_trace`` row (``telemetry/reqtrace.py``) from the
given ``events.jsonl`` files — or from all ``*.jsonl`` under a
directory, the shape a traced fleet run leaves behind (one driver log +
one per replica) — assembles them into traces, and prints:

* a per-tenant table: request count, p50/p95/p99 end-to-end latency
  (exact nearest-rank over the sampled roots), SLO-bad fraction against
  ``--slo-p95-ms``, and the burn rate (bad_frac / (1 - target): 1.0 =
  burning the error budget exactly as fast as the SLO allows — the
  convention ``serve/fleet/controller.py``'s ledger feeds the
  autoscaler);
* tier-split latency attribution (queue vs wire vs adapt vs predict vs
  other) summed across linked traces, with the dominant tier named;
* worst-trace exemplars: the slowest sampled requests with their
  per-tier breakdown.

One machine-readable JSON line (the LAST stdout line) with
``{"metric": "slo_report", ...}`` and the JAX script's keys. Exit codes:
0 ok, 1 missing/empty input, 2 bad usage. Reads through the port's
``telemetry/reqtrace.py`` and ``utils/tracing.py``; imports nothing of
JAX and touches no device.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, List

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from howtotrainyourmamlpytorch_tpu_torch.telemetry import (  # noqa: E402
    reqtrace as _reqtrace)
# Rotation-aware: the spare segment (events.jsonl.1) reads first.
from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import (  # noqa: E402
    nearest_rank, read_jsonl_rotated as read_jsonl)


def resolve_event_files(paths: List[str]) -> List[str]:
    """Expand each arg: a .jsonl file stands for itself; a directory
    stands for every ``*.jsonl`` directly under it (and under logs/)."""
    files: List[str] = []
    for path in paths:
        if os.path.isdir(path):
            found = sorted(glob.glob(os.path.join(path, "*.jsonl")))
            found += sorted(glob.glob(os.path.join(path, "logs",
                                                   "*.jsonl")))
            if not found:
                raise FileNotFoundError(
                    f"no *.jsonl files under {path!r}")
            files += found
        else:
            files.append(path)
    return files


def summarize_traces(rows: List[Dict[str, Any]], *, slo_p95_ms: float,
                     slo_target_frac: float,
                     worst_n: int = 3) -> Dict[str, Any]:
    """Assemble request_trace rows into the slo_report artifact dict."""
    traces = _reqtrace.assemble(rows)
    n_linked = sum(1 for t in traces.values() if _reqtrace.linked(t))
    tier_seconds = {tier: 0.0 for tier in _reqtrace.TIERS}
    per_tenant: Dict[str, List[float]] = {}
    scored: List[Dict[str, Any]] = []
    for t in traces.values():
        attr = _reqtrace.attribute(t)
        if _reqtrace.linked(t):
            for tier in _reqtrace.TIERS:
                tier_seconds[tier] += attr[tier]
        if t["root"] is not None:
            ms = float(t["root"]["dur_s"]) * 1e3
            per_tenant.setdefault(t["tenant"] or "?", []).append(ms)
            scored.append({
                "trace_id": t["trace_id"], "tenant": t["tenant"],
                "total_ms": ms, "dominant": attr["dominant"],
                "tiers_ms": {tier: attr[tier] * 1e3
                             for tier in _reqtrace.TIERS},
            })
    tenants: Dict[str, Dict[str, Any]] = {}
    for tenant, vals in sorted(per_tenant.items()):
        vals = sorted(vals)
        bad = sum(1 for v in vals if v > slo_p95_ms)
        bad_frac = bad / len(vals)
        tenants[tenant] = {
            "count": len(vals),
            "p50_ms": nearest_rank(vals, 0.50),
            "p95_ms": nearest_rank(vals, 0.95),
            "p99_ms": nearest_rank(vals, 0.99),
            "bad_frac": bad_frac,
            "burn_rate": bad_frac / (1.0 - slo_target_frac),
        }
    scored.sort(key=lambda s: -s["total_ms"])
    dominant = (max(_reqtrace.TIERS, key=lambda k: tier_seconds[k])
                if n_linked else None)
    return {
        "metric": "slo_report",
        "traces": len(traces),
        "linked": n_linked,
        "linked_frac": (n_linked / len(traces)) if traces else 0.0,
        "spans": sum(len(t["spans"]) + (t["root"] is not None)
                     for t in traces.values()),
        "slo_p95_ms": slo_p95_ms,
        "slo_target_frac": slo_target_frac,
        "tenants": tenants,
        "tier_seconds": tier_seconds,
        "dominant_tier": dominant,
        "worst": scored[:worst_n],
    }


def format_table(s: Dict[str, Any]) -> str:
    lines = [
        "slo_report",
        f"  traces {s['traces']}  linked {s['linked']} "
        f"({s['linked_frac']:.1%})  spans {s['spans']}",
        f"  SLO: p95 <= {s['slo_p95_ms']:.0f} ms for "
        f">= {s['slo_target_frac']:.0%} of requests",
        "",
        f"  {'tenant':<16} {'count':>6} {'p50_ms':>9} {'p95_ms':>9} "
        f"{'p99_ms':>9} {'bad%':>7} {'burn':>7}",
    ]
    for tenant, row in s["tenants"].items():
        lines.append(
            f"  {tenant:<16} {row['count']:>6} {row['p50_ms']:>9.1f} "
            f"{row['p95_ms']:>9.1f} {row['p99_ms']:>9.1f} "
            f"{row['bad_frac']:>6.1%} {row['burn_rate']:>7.2f}")
    lines.append("")
    tiers = s["tier_seconds"]
    total = sum(tiers.values()) or 1.0
    lines.append("  latency attribution (linked traces):")
    for tier in _reqtrace.TIERS:
        mark = "  <- dominant" if tier == s["dominant_tier"] else ""
        lines.append(f"    {tier:<8} {tiers[tier] * 1e3:>10.1f} ms "
                     f"({tiers[tier] / total:.1%}){mark}")
    if s["worst"]:
        lines.append("")
        lines.append("  worst traces:")
        for w in s["worst"]:
            tiers_ms = w["tiers_ms"]
            split = " ".join(f"{tier}={tiers_ms[tier]:.1f}"
                             for tier in _reqtrace.TIERS)
            lines.append(
                f"    {w['trace_id']}  tenant={w['tenant']}  "
                f"{w['total_ms']:.1f} ms  dominant={w['dominant']}  "
                f"[{split}]")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Per-tenant SLO + trace-attribution report over "
                    "request_trace events.")
    ap.add_argument("paths", nargs="+",
                    help="events.jsonl file(s) and/or directories "
                         "containing them (a fleet harness's --out dir)")
    ap.add_argument("--slo-p95-ms", type=float, default=2000.0,
                    help="per-request latency SLO threshold (ms)")
    ap.add_argument("--slo-target-frac", type=float, default=0.95,
                    help="fraction of requests that must meet the SLO")
    ap.add_argument("--worst", type=int, default=3,
                    help="number of worst-trace exemplars to show")
    ap.add_argument("--json", action="store_true",
                    help="emit ONLY the JSON artifact line (CI mode)")
    args = ap.parse_args(argv)
    if not (args.slo_p95_ms > 0 and 0 < args.slo_target_frac < 1):
        print(json.dumps({"error": "need --slo-p95-ms > 0 and "
                                   "0 < --slo-target-frac < 1"}))
        return 2

    rows: List[Dict[str, Any]] = []
    try:
        for path in resolve_event_files(args.paths):
            rows += [r for r in read_jsonl(path)
                     if r.get("event") == _reqtrace.REQUEST_TRACE_EVENT]
    except (OSError, ValueError) as e:
        print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
        return 1
    if not rows:
        print(json.dumps({"error": "no request_trace rows found (was "
                                   "the run traced? reqtrace_sample_"
                                   "rate=0 writes none)"}))
        return 1

    summary = summarize_traces(rows, slo_p95_ms=args.slo_p95_ms,
                               slo_target_frac=args.slo_target_frac,
                               worst_n=args.worst)
    if not args.json:
        print(format_table(summary))
    # The LAST stdout line is the machine-readable artifact.
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
