"""The serving cell's knee: the highest offered rate the program sustains
without a growing backlog (on the card, once, when a serving cell's
rate is chosen).

    python3 portbench/tools/knee.py --workload <serving cell> \\
        --rates 100,150,200 --seconds 10 --seed <n>

One engine, built as the cell's driver builds it, serves each rate's
open loop in turn; one JSON line per rate: offered and completed rates,
latency percentiles from the scheduled instants, failures, the
generator's lateness, and ``backlog_growth`` (the p95 of the last third
of the requests over that of the first third: well above 1 when the
queue grows through the run).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO_DIR not in sys.path:
    sys.path.insert(0, REPO_DIR)

import torch  # noqa: E402

from portbench import run as bench_run  # noqa: E402
from portbench.lib import episodes, port, weights  # noqa: E402
from portbench.lib.spec import Bench  # noqa: E402
from portbench.reference.model import hyper  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("knee: needs the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = Bench()
    cell = bench.cell(args.workload)
    traffic = bench.traffic(cell["traffic"])
    drv = bench.driver(traffic["driver"])
    sub = weights.sub_seed
    maml_config = bench.config(cell["config"])["maml_config"]
    hp = hyper(maml_config)
    cfg = port.config(maml_config, {
        **traffic["engine"], **port.cache_dirs(bench_run.CACHE_DIR),
        "experiment_root": f"{bench_run.CACHE_DIR}/experiments"})
    params, lslr, bn = weights.make(hp, sub(args.seed, 1), device)
    engine = port.serving_engine(cfg, params, lslr, bn, device)
    engine.warmup()
    rates = [float(r) for r in args.rates.split(",")]
    plans = [episodes.arrivals(r, args.seconds, sub(args.seed, 3))
             for r in rates]
    per = hp.num_classes * (hp.shots + hp.targets)
    pool_size = int(traffic["image_pool"])
    requests = drv.Requests(hp, episodes.image_pool(
        hp.image_shape, pool_size, sub(args.seed, 2), device),
        episodes.request_plan(pool_size, per,
                              sum(len(p) for p in plans),
                              sub(args.seed, 4)))
    first = 0
    for rate, times in zip(rates, plans):
        res = drv.open_loop(engine, requests, first, times,
                            float(traffic["drain_timeout_s"]))
        first += len(times)
        lat = drv.latencies(res) * 1e3
        third = max(len(lat) // 3, 1)
        finite = lat[np.isfinite(lat)]
        window_end = res["start"] + args.seconds
        late = (res["sent"] - res["scheduled"]) * 1e3
        print(json.dumps({
            "rate": rate, "requests": len(lat),
            "completed_per_s": float((res["ok"] & (res["done"] <= window_end)
                                      ).sum() / args.seconds),
            "failed": int((~np.isfinite(lat)).sum()),
            "p50_ms": episodes.percentile(finite.tolist(), 0.5),
            "p95_ms": episodes.percentile(lat.tolist(), 0.95),
            "p99_ms": episodes.percentile(lat.tolist(), 0.99),
            "backlog_growth": (episodes.percentile(lat[-third:].tolist(),
                                                   0.95)
                               / episodes.percentile(lat[:third].tolist(),
                                                     0.95)),
            "drain_s": res["end"] - window_end,
            "gen_late_p99_ms": episodes.percentile(
                late[np.isfinite(late)].tolist(), 0.99),
            "adapt_ms_p50": 1e3 * float(np.median(engine.adapt_seconds[-50:]))
        }), flush=True)
    engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
