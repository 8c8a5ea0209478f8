"""MSL-window step timing of the PyTorch/CUDA port: serial target forwards
against the batched form (config ``msl_target_batching``), plus the
steady-state (non-MSL) step for context (the port's counterpart of
``scripts/perf_msl.py``).

    python scripts/torch_perf_msl.py [--steps 10] [--batch 12] \\
        [--points steady_state_non_msl,...] [--quick --device cpu]

The MSL window is epochs 0..multi_step_loss_num_epochs-1 of every MAML++
run; its step computes a target-set forward after every inner step
instead of only the last. Each variant is the flagship bench workload
(``tune/points.py § flagship_config``): the steady state at the last
epoch (phase key ``(True, False)``), the two MSL forms at epoch 0
(``(True, True)``), each timed eager and through its CUDA graph
(``tune/points.py``). One JSON line per variant (``variant``,
``tasks_per_sec_per_chip`` and the leg keys, the graph leg as
``graph``), then one line of ratios (``batched_vs_serial_speedup``,
``msl_penalty_serial``, ``msl_penalty_batched``), the graph legs' under
``graph``, when the variants they need ran.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from howtotrainyourmamlpytorch_tpu_torch.device import resolve_device  # noqa: E402
from howtotrainyourmamlpytorch_tpu_torch.tune import points  # noqa: E402

RATE = "tasks_per_sec_per_chip"


def grid(batch: int) -> list:
    """(name, config, MSL) of the JAX script, in its order."""
    base = points.flagship_config(batch, 1)
    return [{"point": name, "variant": name, "msl": msl, "cfg": cfg}
            for name, cfg, msl in (
                ("steady_state_non_msl", base, False),
                ("msl_serial_in_scan",
                 base.replace(msl_target_batching="off"), True),
                ("msl_batched_out_of_scan",
                 base.replace(msl_target_batching="on"), True))]


def ratios(rates: dict) -> dict:
    """The JAX script's closing ratios of ``{variant: rate}``."""
    serial = rates["msl_serial_in_scan"]
    return {"batched_vs_serial_speedup": round(
                rates["msl_batched_out_of_scan"] / serial, 4),
            "msl_penalty_serial": round(
                1 - serial / rates["steady_state_non_msl"], 4),
            "msl_penalty_batched": round(
                1 - rates["msl_batched_out_of_scan"]
                / rates["steady_state_non_msl"], 4)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    points.add_common_args(ap, steps=10)
    ap.add_argument("--batch", type=int, default=12)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows = []
    for point in points.select(grid(args.batch), args.points):
        msl = point.pop("msl")
        rows.append(points.run_point(
            point, device, lambda cfg: points.time_train(
                points.on_device(cfg, device, args.quick), device,
                args.steps,
                epoch=0 if msl else max(cfg.total_epochs - 1, 0),
                phase_key=(True, msl))))
    eager = {r["variant"]: r[RATE] for r in rows if RATE in r}
    if len(eager) == 3:
        graph = {r["variant"]: r["graph"][RATE] for r in rows
                 if points.graph_ran(r)}
        print(json.dumps({**ratios(eager), "graph": (
            ratios(graph) if len(graph) == 3 else None)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
