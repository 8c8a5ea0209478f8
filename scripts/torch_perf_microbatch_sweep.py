"""``task_microbatches`` sweep of the PyTorch/CUDA port over the
non-flagship configs (the port's counterpart of
``scripts/perf_microbatch_sweep.py``): at each config's per-chip batch,
every divisor of it as the microbatch count, the steady-state train step
timed eager and through its CUDA graph (``tune/points.py``).

    python scripts/torch_perf_microbatch_sweep.py [--steps 12] \\
        [--configs a.json b.json ...] [--max-mb 16] [--points mb1,mb2] \\
        [--quick --device cpu]

One JSON line per point (``config``, ``mb``, ``tasks_per_sec_per_chip``
and the leg keys, the graph leg's as ``graph``; a point that fails is a
row with ``error``), then one line per config naming the winner beside
the shipped value (``per_chip_batch``, ``shipped_mb``, ``rows``,
``best_mb``, ``best_rate``, ``shipped_rate``, ``gain_vs_shipped``; the
same from the graph legs under ``graph``), then ``{"summary": {config:
best_mb}}``. Exit 1 when no point of any config ran. Run it alone on
the card: concurrent work contaminates the timings.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from howtotrainyourmamlpytorch_tpu_torch.device import resolve_device  # noqa: E402
from howtotrainyourmamlpytorch_tpu_torch.tune import points, trial  # noqa: E402

RATE = "tasks_per_sec_per_chip"
# The non-flagship family members: the four Omniglot MAML++ configs,
# both mini-ImageNet 1-shot configs, and the canonical plain-MAML point.
DEFAULT_TARGETS = [
    "omniglot_maml++_5-way_1-shot.json",
    "omniglot_maml++_5-way_5-shot.json",
    "omniglot_maml++_20-way_1-shot.json",
    "omniglot_maml++_20-way_5-shot.json",
    "mini-imagenet_maml++_5-way_1-shot.json",
    "mini-imagenet_maml_5-way_1-shot.json",
    "mini-imagenet_maml_5-way_1-shot_canonical.json",
]


def divisors(n: int, cap: int) -> list:
    return [d for d in range(1, min(n, cap) + 1) if n % d == 0]


def grid(name: str, max_mb: int, n_dev: int = 1):
    """``(base config, points)`` of one target config."""
    base = trial.load_workload(os.path.join(points.CONFIGS, name), n_dev)
    per_chip = max(base.batch_size // n_dev, 1)
    return base, [{"point": f"mb{mb}", "config": name, "mb": mb,
                   "cfg": base.replace(task_microbatches=mb)}
                  for mb in divisors(per_chip, max_mb)]


def verdict(rates: dict, shipped_mb: int) -> dict:
    """The winner of ``{mb: rate}`` beside the shipped value."""
    if not rates:
        return {}
    best = max(rates, key=rates.get)
    shipped = rates.get(shipped_mb)
    return {"best_mb": best, "best_rate": rates[best],
            "shipped_rate": shipped,
            "gain_vs_shipped": (round(rates[best] / shipped, 3)
                                if shipped else None)}


def sweep_config(name: str, args, device) -> dict:
    base, pts = grid(name, args.max_mb)
    rows = [points.run_point(p, device, lambda cfg: points.time_train(
        points.on_device(cfg, device, args.quick), device, args.steps))
        for p in points.select(pts, args.points)]
    eager = {r["mb"]: r[RATE] for r in rows if RATE in r}
    graph = {r["mb"]: r["graph"][RATE] for r in rows
             if points.graph_ran(r)}
    out = {"config": name, "per_chip_batch": base.batch_size,
           "shipped_mb": base.task_microbatches, "rows": eager,
           **verdict(eager, base.task_microbatches),
           "graph": {"rows": graph,
                     **verdict(graph, base.task_microbatches)}}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    points.add_common_args(ap, steps=12)
    ap.add_argument("--configs", nargs="*", default=DEFAULT_TARGETS)
    ap.add_argument("--max-mb", type=int, default=16)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    verdicts = []
    for name in args.configs:
        try:
            verdicts.append(sweep_config(name, args, device))
        except Exception:  # noqa: BLE001 — one bad config must not lose
            # the rest of the sweep
            print(json.dumps({"config": name, "rows": {},
                              "error": traceback.format_exc(limit=1)}),
                  flush=True)
            verdicts.append({"config": name, "rows": {}})
    print(json.dumps({"summary": {v["config"]: v.get("best_mb")
                                  for v in verdicts}}), flush=True)
    return 0 if any(v["rows"] for v in verdicts) else 1


if __name__ == "__main__":
    sys.exit(main())
