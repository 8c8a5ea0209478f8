"""ResNet-12 pod-step sweep of the PyTorch/CUDA port on one card (the
port's counterpart of ``scripts/perf_resnet12_sweep.py``): the execution
knobs that do not change the science, on the pod JSON's second-order
train step mapped onto one card (mesh (1, 1), the per-chip batch of 8).

    python scripts/torch_perf_resnet12_sweep.py [--steps 12] \\
        [--phase base|micro|batch|all] [--points mb4,...] \\
        [--quick --device cpu]

Phases (the JAX script's grids):

  - ``base``: remat_policy block_outs | nothing | dots | conv_outs x
    bn_fast_math on | off at mb=2 (the operating point the JAX grid was
    measured at), then compute_dtype float32 at mb=2;
  - ``micro``: task_microbatches 1 | 2 | 4 | 8 with bn_fast_math on;
  - ``batch``: per-chip batch 1 | 2 | 4 | 8 | 12 at mb=1, bn_fast_math on;
  - ``all``: the three in that order.

Every point times the steady-state epoch's step (second order from epoch
0 for this config) eager and through its CUDA graph (``tune/points.py``).
One JSON line per point: ``variant``, the overrides,
``tasks_per_sec_per_chip``, ``warmup_s`` and the leg keys, the graph leg
as ``graph``. A point that fails (a chunk too large for the card's
memory) is a row with ``error``; the sweep goes on.
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

PHASES = ("base", "micro", "batch")


def pod_cfg(n_dev: int = 1, **overrides) -> MAMLConfig:
    """The pod JSON at its per-chip batch on ``n_dev`` devices."""
    base = MAMLConfig.from_json_file(points.POD_JSON)
    per_chip = max(base.batch_size // (base.mesh_shape[0]
                                       * base.mesh_shape[1]), 1)
    cfg = base.replace(batch_size=per_chip * n_dev, mesh_shape=(1, n_dev))
    return cfg.replace(**overrides)


def _point(name: str, tag: str, n_dev: int, **overrides) -> dict:
    return {"point": name, "variant": tag, **overrides,
            "cfg": pod_cfg(n_dev, **overrides)}


def grid(phase: str, n_dev: int = 1) -> list:
    if phase == "base":
        out = [_point(f"{policy}_fm{int(fast)}", "remat_x_fastmath", n_dev,
                      remat_policy=policy, bn_fast_math=fast,
                      task_microbatches=2)
               for policy in ("block_outs", "nothing", "dots", "conv_outs")
               for fast in (True, False)]
        return out + [_point("compute_f32", "compute_f32", n_dev,
                             compute_dtype="float32", task_microbatches=2)]
    if phase == "micro":
        return [_point(f"mb{mb}", "microbatch", n_dev, task_microbatches=mb,
                       bn_fast_math=True) for mb in (1, 2, 4, 8)]
    if phase == "batch":
        return [_point(f"b{b}", "per_chip_batch", n_dev,
                       batch_size=b * n_dev, task_microbatches=1,
                       bn_fast_math=True) for b in (1, 2, 4, 8, 12)]
    raise ValueError(f"unknown phase {phase!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    points.add_common_args(ap, steps=12)
    ap.add_argument("--phase", default="base", choices=PHASES + ("all",))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    phases = PHASES if args.phase == "all" else (args.phase,)
    selected = points.select([p for ph in phases for p in grid(ph)],
                             args.points)
    for point in selected:
        points.run_point(point, device, lambda cfg: points.time_train(
            points.on_device(cfg, device, args.quick), device, args.steps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
