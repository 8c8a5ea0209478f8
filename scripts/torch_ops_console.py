"""Live fleet status console of the PyTorch port — the ops plane's
one-table view (the port's counterpart of ``scripts/ops_console.py``).

Usage:
    python scripts/torch_ops_console.py <out_dir | events.jsonl ...>
        [--fleet-dir DIR] [--watch SECONDS [--refreshes N]] [--json]
        [--stalled-s S] [--dead-s S] [--slo-p95-ms MS]
        [--slo-target-frac F]

Renders the whole fleet in one screen from its on-disk exhaust — no
RPC to any process, so it works on a live fleet, a dead one, and a
finished chaos/bench out dir alike:

* **replicas** — every membership lease with its verdict
  (live/stalled/dead, draining), model version, queue depth, p95 and
  the peer's own ``alerts_firing`` summary from the lease payload;
* **rollout** — ROLLOUT.json state + stage and the last observed
  ``fleet/canary_weight``;
* **SLO** — per-tenant p95 / bad% / burn rate over sampled
  ``request_trace`` roots, plus the fleet burn-rate gauge;
* **alerts** — the active set by severity, from ``ALERTS*.json``
  snapshots when present, else reconstructed from ``alert`` event rows
  (last transition per (source, rule, labels) wins).

``--watch S`` re-renders every S seconds (``--refreshes N`` bounds the
loop; Ctrl-C exits cleanly). The LAST stdout line is always the
machine-readable ``{"metric": "ops_console", ...}`` artifact, with the
JAX script's keys. Exit codes: 0 ok, 1 nothing to render, 2 bad usage.

Reads through the port's ``telemetry/alerts.py``,
``telemetry/aggregate.py``, ``utils/tracing.py`` and
``serve/fleet/router.py``; imports nothing of JAX and touches no device.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import sys
import time
from typing import Any, Dict, List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from howtotrainyourmamlpytorch_tpu_torch.serve.fleet import (  # noqa: E402
    controller as _controller, router as _router)
from howtotrainyourmamlpytorch_tpu_torch.telemetry import (  # noqa: E402
    aggregate as _aggregate, alerts as _alerts)
from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import (  # noqa: E402
    nearest_rank)

_GAUGES = ("fleet/canary_weight", "fleet/slo_burn_rate",
           "fleet/queue_depth_total", "fleet/replicas_live",
           "fleet/replicas_desired")
# Lifetime counters worth totalling fleet-wide (reset-aware). Explicit
# list on purpose: a metrics row does not distinguish counters from
# gauges, and reset-aware accumulation of a gauge is nonsense.
_COUNTERS = ("fleet/restarts", "fleet/crash_loops", "fleet/scale_ups",
             "fleet/scale_downs", "fleet/failovers",
             "fleet/router_spills", "fleet/slo_good_total",
             "fleet/slo_bad_total", "serve/shed_total",
             "serve/requests_total", "serve/responses_total")


def discover_fleet_dir(paths: List[str]) -> Optional[str]:
    """First directory holding membership leases: each input dir
    itself, its ``fleet/`` child, then any immediate subdirectory
    (chaos_fleet keeps one fleet dir per phase)."""
    candidates: List[str] = []
    for path in paths:
        if not os.path.isdir(path):
            continue
        candidates.append(path)
        candidates += sorted(
            d for d in glob.glob(os.path.join(path, "*"))
            if os.path.isdir(d))
    for cand in candidates:
        if glob.glob(os.path.join(
                cand, f"{_router.LEASE_PREFIX}*{_router.LEASE_SUFFIX}")):
            return cand
    return None


def replica_table(fleet_dir: Optional[str], *, stalled_s: float,
                  dead_s: float) -> List[Dict[str, Any]]:
    if not fleet_dir:
        return []
    members = _router.read_members(fleet_dir)
    rows = []
    for rid in sorted(members):
        rec = members[rid]
        payload = rec.get("payload") or {}
        stats = payload.get("stats") or {}
        verdict = _router.classify(rec["age"], stalled_s, dead_s)
        firing = payload.get("alerts_firing") or {}
        rows.append({
            "replica": rid,
            "verdict": verdict,
            "draining": bool(rec.get("draining")),
            "age_s": (round(rec["age"], 2)
                      if math.isfinite(rec["age"]) else None),
            "version": payload.get("version"),
            "queue_depth": stats.get("queue_depth"),
            "p95_ms": stats.get("p95_ms"),
            "alerts_firing": firing.get("count"),
            "alerts_max_severity": firing.get("max_severity"),
        })
    return rows


def slo_table(rows: List[Dict[str, Any]], *, slo_p95_ms: float,
              slo_target_frac: float) -> Dict[str, Any]:
    """Per-tenant burn over sampled request roots (slo_report.py's
    convention, minus the trace assembly — the console only needs the
    root latencies)."""
    per_tenant: Dict[str, List[float]] = {}
    for row in rows:
        if row.get("event") != "request_trace":
            continue
        if row.get("name") != "request" or row.get("parent_id") is not None:
            continue
        dur = row.get("dur_s")
        if isinstance(dur, (int, float)) and math.isfinite(float(dur)):
            per_tenant.setdefault(str(row.get("tenant") or "?"),
                                  []).append(float(dur) * 1e3)
    tenants: Dict[str, Dict[str, Any]] = {}
    for tenant in sorted(per_tenant):
        vals = sorted(per_tenant[tenant])
        bad_frac = sum(1 for v in vals if v > slo_p95_ms) / len(vals)
        tenants[tenant] = {
            "count": len(vals),
            "p95_ms": round(nearest_rank(vals, 0.95), 2),
            "bad_frac": round(bad_frac, 4),
            "burn_rate": round(bad_frac / (1.0 - slo_target_frac), 3),
        }
    return tenants


def active_alerts(paths: List[str],
                  rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The firing set: ALERTS*.json snapshots win (they are the
    evaluators' own word); without any, replay the ``alert`` event rows
    — last transition per (source, rule, labels) wins."""
    snap_paths: List[str] = []
    for path in paths:
        if os.path.isdir(path):
            snap_paths += sorted(glob.glob(os.path.join(path,
                                                        "ALERTS*.json")))
            snap_paths += sorted(glob.glob(os.path.join(path, "logs",
                                                        "ALERTS*.json")))
    docs = _alerts.read_snapshots(snap_paths)
    if docs:
        firing = [dict(r) for d in docs for r in d["firing"]]
    else:
        last: Dict[tuple, Dict[str, Any]] = {}
        for row in rows:
            if row.get("event") != _alerts.ALERT_EVENT:
                continue
            key = (row.get("source"), row.get("rule"),
                   json.dumps(row.get("labels") or {}, sort_keys=True))
            last[key] = row
        firing = [dict(r) for r in last.values()
                  if r.get("state") == "firing"]
    firing.sort(key=lambda r: (
        -_alerts.severity_rank(r.get("severity", "info")),
        str(r.get("rule"))))
    return firing


def summarize(paths: List[str], *, fleet_dir: Optional[str],
              stalled_s: float, dead_s: float, slo_p95_ms: float,
              slo_target_frac: float) -> Dict[str, Any]:
    rows = _aggregate.collect_fleet_events(paths)
    fleet_dir = fleet_dir or discover_fleet_dir(paths)
    replicas = replica_table(fleet_dir, stalled_s=stalled_s,
                             dead_s=dead_s)
    gauges = _aggregate.latest_gauges(rows, list(_GAUGES))
    totals = _aggregate.fleet_counter_totals(rows)
    rollout: Dict[str, Any] = {}
    if fleet_dir:
        try:
            with open(os.path.join(fleet_dir,
                                   _controller.ROLLOUT_FILE)) as f:
                doc = json.load(f)
            if isinstance(doc, dict):
                rollout = {"state": doc.get("state"),
                           "stage": doc.get("stage")}
        except (OSError, ValueError):
            pass
    alerts = active_alerts(paths, rows)
    by_sev = {sev: 0 for sev in _alerts.SEVERITIES}
    for a in alerts:
        if a.get("severity") in by_sev:
            by_sev[a["severity"]] += 1
    return {
        "metric": "ops_console",
        "events_rows": len(rows),
        "sources": sorted({str(r.get("source", "")) for r in rows
                           if r.get("source")}),
        "fleet_dir": fleet_dir,
        "replicas": replicas,
        "replicas_live": sum(1 for r in replicas
                             if r["verdict"] == _router.LIVE
                             and not r["draining"]),
        "rollout_state": rollout.get("state"),
        "rollout_stage": rollout.get("stage"),
        "canary_weight": gauges["fleet/canary_weight"],
        "slo_burn_rate": gauges["fleet/slo_burn_rate"],
        "tenants": slo_table(rows, slo_p95_ms=slo_p95_ms,
                             slo_target_frac=slo_target_frac),
        "counters": {k: totals[k] for k in sorted(totals)
                     if k in _COUNTERS},
        "alerts_firing": len(alerts),
        "alerts_by_severity": by_sev,
        "alerts": alerts,
    }


def format_console(s: Dict[str, Any]) -> str:
    lines = [
        "ops_console",
        f"  sources {len(s['sources'])}  rows {s['events_rows']}"
        + (f"  fleet_dir {s['fleet_dir']}" if s["fleet_dir"] else ""),
        "",
        f"  {'replica':>7} {'verdict':<9} {'age_s':>7} {'version':<22} "
        f"{'queue':>5} {'p95_ms':>8} {'alerts':>6}",
    ]
    for r in s["replicas"]:
        verdict = r["verdict"] + ("*" if r["draining"] else "")
        firing = ("-" if r["alerts_firing"] is None else
                  f"{r['alerts_firing']}"
                  + (f"!{r['alerts_max_severity'][0]}"
                     if r["alerts_max_severity"] else ""))
        lines.append(
            f"  {r['replica']:>7} {verdict:<9} "
            f"{'-' if r['age_s'] is None else format(r['age_s'], '.2f'):>7} "
            f"{str(r['version'] or '-'):<22.22} "
            f"{'-' if r['queue_depth'] is None else r['queue_depth']:>5} "
            f"{'-' if r['p95_ms'] is None else format(r['p95_ms'], '.1f'):>8}"
            f" {firing:>6}")
    if not s["replicas"]:
        lines.append("  (no membership leases found)")
    lines.append("")
    lines.append(
        f"  rollout: state={s['rollout_state'] or '-'} "
        f"stage={'-' if s['rollout_stage'] is None else s['rollout_stage']}"
        f"  canary_weight="
        f"{'-' if s['canary_weight'] is None else s['canary_weight']}"
        f"  slo_burn="
        f"{'-' if s['slo_burn_rate'] is None else s['slo_burn_rate']}")
    if s["tenants"]:
        lines.append("")
        lines.append(f"  {'tenant':<16} {'count':>6} {'p95_ms':>9} "
                     f"{'bad%':>7} {'burn':>7}")
        for tenant, row in s["tenants"].items():
            lines.append(
                f"  {tenant:<16} {row['count']:>6} {row['p95_ms']:>9.1f} "
                f"{row['bad_frac']:>6.1%} {row['burn_rate']:>7.2f}")
    lines.append("")
    if s["alerts"]:
        lines.append(f"  ALERTS FIRING ({s['alerts_firing']}):")
        for a in s["alerts"]:
            labels = a.get("labels") or {}
            label_s = " ".join(f"{k}={v}" for k, v in
                               sorted(labels.items()))
            lines.append(
                f"    [{a.get('severity', '?'):<8}] {a.get('rule')}"
                + (f"  {label_s}" if label_s else "")
                + (f"  value={a.get('value')}"
                   if a.get("value") is not None else ""))
    else:
        lines.append("  alerts: none firing")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="One-table fleet status console over events.jsonl "
                    "exhaust, membership leases and ALERTS.json.")
    ap.add_argument("paths", nargs="+",
                    help="events.jsonl file(s) and/or out/experiment "
                         "directories")
    ap.add_argument("--fleet-dir", default=None,
                    help="membership-lease directory (default: "
                         "auto-discover under the given dirs)")
    ap.add_argument("--watch", type=float, default=0.0, metavar="S",
                    help="re-render every S seconds (0 = one shot)")
    ap.add_argument("--refreshes", type=int, default=0,
                    help="stop --watch after N renders (0 = until ^C)")
    ap.add_argument("--stalled-s", type=float, default=10.0,
                    help="lease age beyond which a replica renders "
                         "stalled")
    ap.add_argument("--dead-s", type=float, default=30.0,
                    help="lease age beyond which a replica renders dead")
    ap.add_argument("--slo-p95-ms", type=float, default=2000.0)
    ap.add_argument("--slo-target-frac", type=float, default=0.95)
    ap.add_argument("--json", action="store_true",
                    help="emit ONLY the JSON artifact line (CI mode)")
    args = ap.parse_args(argv)
    if args.watch < 0 or args.refreshes < 0 \
            or not (args.slo_p95_ms > 0 and 0 < args.slo_target_frac < 1):
        print(json.dumps({"error": "need --watch/--refreshes >= 0, "
                                   "--slo-p95-ms > 0 and 0 < "
                                   "--slo-target-frac < 1"}))
        return 2

    summary: Dict[str, Any] = {}
    renders = 0
    try:
        while True:
            summary = summarize(
                args.paths, fleet_dir=args.fleet_dir,
                stalled_s=args.stalled_s, dead_s=args.dead_s,
                slo_p95_ms=args.slo_p95_ms,
                slo_target_frac=args.slo_target_frac)
            renders += 1
            if not args.json:
                if args.watch > 0 and sys.stdout.isatty():
                    print("\x1b[2J\x1b[H", end="")
                print(format_console(summary))
            if args.watch <= 0 or (args.refreshes
                                   and renders >= args.refreshes):
                break
            time.sleep(args.watch)
    except KeyboardInterrupt:
        pass

    if not summary:
        print(json.dumps({"error": "nothing rendered"}))
        return 1
    if not (summary["events_rows"] or summary["replicas"]
            or summary["alerts"]):
        print(json.dumps({"error": "no events rows, membership leases "
                                   "or ALERTS.json found under the "
                                   "given paths"}))
        return 1
    # The LAST stdout line is the machine-readable artifact.
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
