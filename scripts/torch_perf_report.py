"""Where does the device time go? Ranked perf report over a port run's
``PROFILE.json`` cost cards and ``perf_profile`` telemetry rows (the
PyTorch/CUDA port's counterpart of ``scripts/perf_report.py``, over the
port's ``telemetry/profiler.py``; the same table, last line and exit
codes).

Usage:
    python scripts/torch_perf_report.py <PROFILE.json | logs dir | experiment dir>
                                        [--events PATH] [--json]

Reads the two artifacts the port's trainer writes with its perf sampler
(``profile_every_n_steps``) or its warm-start store (``aot_store_dir``)
on:

* ``PROFILE.json`` — one cost card per executable: each train phase
  (``train_so{0,1}_msl{0,1}``), and with the warm-start store the eval
  step and the serve adapt/predict extents. A card carries the FLOPs
  ``FlopCounterMode`` counted and the bytes accessed a byte-counting
  dispatch mode counted on a real step, the memory, the arithmetic
  intensity and the compute-vs-memory verdict against the device's
  peaks, in the JAX package's schema;
* ``events.jsonl`` ``perf_profile`` rows — sampled device-time windows
  (per-phase and per-region seconds, device-compute vs dispatch-gap,
  achieved FLOP/s against the card's ceiling).

and prints the executables ranked by measured device time (cards by
FLOPs when the run never sampled), each with its bound and the fraction
of its ceiling achieved, the window split and the regions.

A bound reads "unknown" for a card without bytes accessed (a
``PROFILE.json`` written before the port counted them), or where no peak
is known for the device (a CPU run without ``MAML_PEAK_FLOPS`` /
``MAML_HBM_GBPS``). The table says which; it never invents a number.

The LAST stdout line is the JSON artifact ``{"metric": "perf_report",
...}``. Exit 0 ok, 1 when neither a PROFILE.json nor any perf_profile
rows are readable, 2 bad usage.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from howtotrainyourmamlpytorch_tpu_torch.telemetry import (  # noqa: E402
    profiler as _profiler)
from howtotrainyourmamlpytorch_tpu_torch.utils import (  # noqa: E402
    tracing as _tracing)

REPORT_SCHEMA = "maml_perf_report_v1"
UNKNOWN_NOTE = ("bound 'unknown': a card without bytes accessed (written "
                "before the port counted them) has no arithmetic "
                "intensity, so there is no roofline verdict")
NO_PEAKS_NOTE = ("bound 'unknown': no peak FLOP/s or HBM bandwidth is known "
                 "for this device (set MAML_PEAK_FLOPS / MAML_HBM_GBPS)")


def match_card(module: str, cards: Dict[str, Dict[str, Any]]
               ) -> Optional[Dict[str, Any]]:
    """Module -> card: a unique substring hit in either direction (the
    JAX report's rule; the port's rows name the cards exactly)."""
    norm = module.lower()
    if norm.startswith("jit_"):
        norm = norm[len("jit_"):]
    hits = [c for n, c in cards.items()
            if n.lower() in module.lower() or norm in n.lower()]
    return hits[0] if len(hits) == 1 else None


def resolve_profile_path(path: str) -> Optional[str]:
    """Accept PROFILE.json itself, a logs dir, or an experiment dir."""
    if os.path.isfile(path):
        return path
    if os.path.isdir(path):
        for candidate in (
                os.path.join(path, _profiler.PROFILE_FILE),
                os.path.join(path, "logs", _profiler.PROFILE_FILE)):
            if os.path.exists(candidate):
                return candidate
    return None


def resolve_events_path(path: str) -> Optional[str]:
    if os.path.isfile(path) and path.endswith(".jsonl"):
        return path
    base = os.path.dirname(path) if os.path.isfile(path) else path
    for candidate in (os.path.join(base, "events.jsonl"),
                      os.path.join(base, "logs", "events.jsonl")):
        if os.path.exists(candidate):
            return candidate
    return None


def accumulate_rows(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold a log's perf_profile rows: per-executable/region seconds
    SUM across samples (total observed device time — more samples in an
    executable means more weight, which is the ranking the MFU campaign
    wants); the window-split fractions take the most recent row (the
    current shape of the step)."""
    per_exec: Dict[str, float] = {}
    per_region: Dict[str, float] = {}
    roofline: Dict[str, Dict[str, Any]] = {}
    last: Dict[str, Any] = {}
    samples = 0
    for e in events:
        if e.get("event") != "perf_profile":
            continue
        samples += 1
        last = e
        for k, v in (e.get("per_executable_seconds") or {}).items():
            if isinstance(v, (int, float)):
                per_exec[k] = per_exec.get(k, 0.0) + float(v)
        for k, v in (e.get("per_region_seconds") or {}).items():
            if isinstance(v, (int, float)):
                per_region[k] = per_region.get(k, 0.0) + float(v)
        # Achieved-vs-ceiling was computed live per sample
        # (profiler.attach_roofline); the newest row's rates win —
        # the current shape of each executable.
        for k, v in (e.get("roofline") or {}).items():
            if isinstance(v, dict):
                roofline[k] = v
    return {"samples": samples, "per_executable_seconds": per_exec,
            "per_region_seconds": per_region, "roofline": roofline,
            "last": last}


def build_report(profile: Optional[Dict[str, Any]],
                 acc: Dict[str, Any]) -> Dict[str, Any]:
    cards: Dict[str, Dict[str, Any]] = dict(
        (profile or {}).get("cards") or {})
    per_exec = acc["per_executable_seconds"]
    ranked: List[Dict[str, Any]] = []
    if per_exec:
        order = sorted(per_exec.items(), key=lambda kv: -kv[1])
        total = sum(per_exec.values()) or 1.0
        for module, secs in order:
            card = cards.get(module) or match_card(module, cards)
            row = {"executable": module,
                   "device_seconds": round(secs, 6),
                   "share": round(secs / total, 4),
                   "bound": (card or {}).get("bound"),
                   "flops": (card or {}).get("flops"),
                   "arithmetic_intensity":
                       (card or {}).get("arithmetic_intensity")}
            ceiling = (card or {}).get("ceiling_flops_per_s")
            if ceiling:
                row["ceiling_flops_per_s"] = ceiling
            # Achieved FLOP/s vs ceiling, from the newest sample's
            # live attach_roofline computation.
            rl = acc.get("roofline", {}).get(module) or {}
            if rl.get("achieved_flops_per_s") is not None:
                row["achieved_flops_per_s"] = rl["achieved_flops_per_s"]
            if rl.get("frac_of_ceiling") is not None:
                row["frac_of_ceiling"] = round(rl["frac_of_ceiling"], 4)
            ranked.append(row)
    else:
        # Never-sampled run: rank the cost cards by FLOPs — the static
        # half of the story still names the heaviest executable.
        for name, card in sorted(cards.items(),
                                 key=lambda kv: -(kv[1].get("flops")
                                                  or 0.0)):
            ranked.append({
                "executable": name, "device_seconds": None,
                "share": None, "bound": card.get("bound"),
                "flops": card.get("flops"),
                "arithmetic_intensity":
                    card.get("arithmetic_intensity")})
    last = acc["last"]
    top = ranked[0] if ranked else None
    return {
        "schema": REPORT_SCHEMA,
        "peak_flops": (profile or {}).get("peak_flops"),
        "hbm_bytes_per_s": (profile or {}).get("hbm_bytes_per_s"),
        "peak_flops_source": (profile or {}).get("peak_flops_source"),
        "device_kind": (profile or {}).get("device_kind"),
        "cards": len(cards),
        "samples": acc["samples"],
        "ranked": ranked,
        "per_region_seconds": {
            k: round(v, 6)
            for k, v in sorted(acc["per_region_seconds"].items(),
                               key=lambda kv: -kv[1])},
        "device_compute_frac": last.get("device_compute_frac"),
        "dispatch_gap_frac": last.get("dispatch_gap_frac"),
        "top_executable": top["executable"] if top else None,
        "top_executable_bound": top["bound"] if top else None,
    }


def format_report(report: Dict[str, Any]) -> str:
    lines = [f"perf report ({report['cards']} cost card(s), "
             f"{report['samples']} profile sample(s); device "
             f"{report['device_kind'] or '?'}, peaks "
             f"{report['peak_flops_source'] or 'unknown'})"]
    if report.get("device_compute_frac") is not None:
        lines.append(
            f"  window split: device compute "
            f"{report['device_compute_frac']:.1%}, dispatch gap "
            f"{report['dispatch_gap_frac']:.1%}")
    if report["ranked"]:
        lines.append(f"  {'executable':<28} {'device s':>10} "
                     f"{'share':>7} {'bound':>8} {'GFLOP':>10} "
                     f"{'%ceil':>7}")
        for row in report["ranked"][:12]:
            secs = (f"{row['device_seconds']:.4f}"
                    if row["device_seconds"] is not None else "-")
            share = (f"{row['share']:.1%}"
                     if row["share"] is not None else "-")
            gflop = (f"{row['flops'] / 1e9:.2f}"
                     if row.get("flops") else "-")
            ceil = (f"{row['frac_of_ceiling']:.1%}"
                    if row.get("frac_of_ceiling") is not None else "-")
            lines.append(f"  {row['executable']:<28} {secs:>10} "
                         f"{share:>7} {str(row['bound'] or '-'):>8} "
                         f"{gflop:>10} {ceil:>7}")
    unknown = [row for row in report["ranked"]
               if row.get("bound") == "unknown"]
    if any(row.get("arithmetic_intensity") is None for row in unknown):
        lines.append(f"  {UNKNOWN_NOTE}")
    if any(row.get("arithmetic_intensity") is not None for row in unknown):
        lines.append(f"  {NO_PEAKS_NOTE}")
    regions = report["per_region_seconds"]
    if regions:
        lines.append("  named regions (device s): " + ", ".join(
            f"{k}={v:.4f}" for k, v in list(regions.items())[:8]))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Ranked device-time / roofline report over "
                    "PROFILE.json + events.jsonl.")
    ap.add_argument("path", help="PROFILE.json, a logs/ dir, or an "
                                 "experiment dir")
    ap.add_argument("--events", default=None,
                    help="events.jsonl override (default: discovered "
                         "next to the profile)")
    ap.add_argument("--json", action="store_true",
                    help="emit ONLY the JSON artifact line (CI mode)")
    args = ap.parse_args(argv)

    profile_path = resolve_profile_path(args.path)
    profile = (_profiler.load_profile(profile_path)
               if profile_path else None)
    events_path = (args.events if args.events
                   else resolve_events_path(args.path))
    if args.events and not os.path.exists(args.events):
        # An EXPLICIT events override that doesn't exist is an error,
        # not a silent cards-only report — "samples: 0" must mean the
        # run never sampled, never a typo'd path.
        print(json.dumps({"error": f"--events {args.events!r} does "
                                   f"not exist"}))
        return 1
    events: List[Dict[str, Any]] = []
    if events_path and os.path.exists(events_path):
        try:
            events = _tracing.read_jsonl_rotated(events_path)
        except (OSError, ValueError) as e:
            print(json.dumps(
                {"error": f"{type(e).__name__}: {e}",
                 "events": events_path}))
            return 1
    acc = accumulate_rows(events)
    if profile is None and acc["samples"] == 0:
        print(json.dumps({
            "error": f"no readable {_profiler.PROFILE_FILE} under "
                     f"{args.path!r} and no perf_profile rows "
                     f"(profile_every_n_steps=0 run, or wrong path?)"}))
        return 1
    report = build_report(profile, acc)
    if not args.json:
        print(format_report(report))
    artifact = {"metric": "perf_report", **{
        k: report[k] for k in (
            "schema", "cards", "samples", "top_executable",
            "top_executable_bound", "device_compute_frac",
            "dispatch_gap_frac", "peak_flops_source")},
        "profile_path": profile_path, "events_path": events_path,
        "ok": True}
    print(json.dumps(artifact), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
