"""Validation-sweep timing of the PyTorch/CUDA port: a full evaluation
sweep at several eval meta-batch sizes (the port's counterpart of
``scripts/perf_eval.py``).

    python scripts/torch_perf_eval.py [--episodes 600] \\
        [--points eb12,eb24,...] [--quick --device cpu]

Times a 600-episode sweep (the per-epoch validation and the test
protocol's cost) on the flagship JSON at eval batches 12 (the train
batch), 24, 48, 96, 120 and 200: ceil(episodes / batch) batches resident
on the device, a warm-up batch, the median of 3 sweeps
(``tune/points.py § time_eval_sweep``), eager and through the eval
step's CUDA graph. One JSON line per batch size: ``eval_batch``,
``sweep_seconds``, ``speedup_vs_train_batch`` (against the first batch
size run) and the leg keys (``step_ms`` is per batch), the graph leg's
under ``graph``; a batch size that fails (e.g. out of memory) is a row
with ``error``.
"""

from __future__ import annotations

import argparse
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig  # noqa: E402
from howtotrainyourmamlpytorch_tpu_torch.device import resolve_device  # noqa: E402
from howtotrainyourmamlpytorch_tpu_torch.tune import points  # noqa: E402

EVAL_BATCHES = (12, 24, 48, 96, 120, 200)
SECONDS = "sweep_seconds"


def grid() -> list:
    cfg = MAMLConfig.from_json_file(points.FLAGSHIP_JSON)
    return [{"point": f"eb{eb}", "eval_batch": eb,
             "cfg": cfg.replace(eval_batch_size=eb)}
            for eb in EVAL_BATCHES]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    points.add_common_args(ap, steps=None)
    ap.add_argument("--episodes", type=int, default=600)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    base = {}

    def speedup(leg: dict, key: str) -> None:
        base.setdefault(key, leg[SECONDS])
        leg["speedup_vs_train_batch"] = round(base[key] / leg[SECONDS], 3)

    def finish(row: dict) -> None:
        speedup(row, "eager")
        if points.graph_ran(row):
            speedup(row["graph"], "graph")

    def timed(cfg):
        # quick_shrink sets a tiny train batch; the eval batch is the
        # point's.
        eb = cfg.eval_batch_size
        cfg = points.on_device(cfg, device, args.quick)
        return points.time_eval_sweep(cfg, device, eb, args.episodes)

    for point in points.select(grid(), args.points):
        points.run_point(point, device, timed, finish)
    return 0


if __name__ == "__main__":
    sys.exit(main())
