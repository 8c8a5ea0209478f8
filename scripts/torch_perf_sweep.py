"""Perf sweep of the PyTorch/CUDA port over remat x batch on the flagship
bench workload (the port's counterpart of ``scripts/perf_sweep.py``,
the sweep that picked ``bench.py``'s defaults).

    python scripts/torch_perf_sweep.py [--steps 10] \\
        [--points b16_remat_nothing,...] [--quick --device cpu]

Each point is the flagship bench workload (``tune/points.py §
flagship_config``) at a per-chip batch with ``remat_inner_steps`` and
``remat_policy`` set, its MSL second-order step (phase key
``(True, True)``) at epoch 20, timed eager and through its CUDA graph
(``tune/points.py``). One JSON line per point: the JAX keys
(``batch_per_chip``, ``remat``, ``policy``, ``unroll``,
``tasks_per_sec_per_chip``) from the eager leg, its ``step_ms``,
``bn_launches``, ``peak_memory_bytes``, ``mfu`` and ``device_kind``, and
the graph leg's as ``graph``; a point that fails (e.g. out of memory) is
a row with ``error`` and the sweep goes on.

The JAX grid's two ``unroll=5`` points are not in this one:
``inner_unroll`` is a ``lax.scan`` unroll factor, and the port's inner
loop is an eager Python loop that no config field unrolls
(``config.py`` carries the field; nothing reads it). Each would time
its ``unroll=1`` twin's program again under another name.
"""

from __future__ import annotations

import argparse
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from howtotrainyourmamlpytorch_tpu_torch.device import resolve_device  # noqa: E402
from howtotrainyourmamlpytorch_tpu_torch.tune import points  # noqa: E402

PHASE_KEY = (True, True)
EPOCH = 20
# (batch/chip, remat, policy, unroll): the JAX grid without its unroll=5
# points, in its order.
GRID = ((16, True, "nothing", 1), (16, True, "conv_outs", 1),
        (16, True, "dots", 1), (16, False, "nothing", 1),
        (32, True, "nothing", 1), (32, False, "nothing", 1),
        (32, True, "conv_outs", 1), (64, True, "nothing", 1))


def grid(n_dev: int = 1) -> list:
    return [{"point": f"b{batch}_{'remat' if remat else 'noremat'}_"
                      f"{policy}",
             "batch_per_chip": batch, "remat": remat, "policy": policy,
             "unroll": unroll,
             "cfg": points.flagship_config(batch * n_dev, n_dev).replace(
                 remat_inner_steps=remat, remat_policy=policy,
                 inner_unroll=unroll)}
            for batch, remat, policy, unroll in GRID]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    points.add_common_args(ap, steps=10)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    selected = points.select(grid(), args.points)
    for point in selected:
        points.run_point(point, device, lambda cfg: points.time_train(
            points.on_device(cfg, device, args.quick), device, args.steps,
            epoch=EPOCH, phase_key=PHASE_KEY))
    return 0


if __name__ == "__main__":
    sys.exit(main())
