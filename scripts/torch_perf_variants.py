"""Full-train-step timing across optimization variants of the PyTorch/CUDA
port: ``bn_fast_math`` on/off x remat policy (the port's counterpart of
``scripts/perf_variants.py``, the sweep that picked the shipped
defaults).

    python scripts/torch_perf_variants.py [--steps 20] [--batch 16] \\
        [--points nothing_fm0,...] [--quick --device cpu]

Each point is the flagship bench workload (``tune/points.py §
flagship_config``) at ``--batch`` tasks, its MSL second-order step
(phase key ``(True, True)``) at epoch 20, timed eager and through its
CUDA graph (``tune/points.py``). One JSON line per point: the JAX keys
(``bn_fast_math``, ``remat_policy``, ``tasks_per_sec_per_chip``), the
eager leg's ``step_ms``, ``bn_launches``, ``peak_memory_bytes``, ``mfu``
and ``device_kind``, and the graph leg's as ``graph``; a point that
fails is a row with ``error``. The card by default (the hand-written BN
kernel); ``--device cpu`` for the CPU, where the graph leg is reported
as not run.
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


def grid(batch: int) -> list:
    """The JAX script's grid, in its order."""
    out = []
    for over in (dict(bn_fast_math=False, remat_policy="nothing"),
                 dict(bn_fast_math=True, remat_policy="nothing"),
                 dict(bn_fast_math=False, remat_policy="block_outs"),
                 dict(bn_fast_math=True, remat_policy="block_outs")):
        out.append({"point": f"{over['remat_policy']}_fm"
                             f"{int(over['bn_fast_math'])}", **over,
                    "cfg": points.flagship_config(batch, 1).replace(**over)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    points.add_common_args(ap, steps=20)
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    selected = points.select(grid(args.batch), args.points)
    for point in selected:
        points.run_point(point, device, lambda cfg: points.time_train(
            points.on_device(cfg, device, args.quick), device, args.steps,
            epoch=EPOCH, phase_key=PHASE_KEY))
    return 0


if __name__ == "__main__":
    sys.exit(main())
