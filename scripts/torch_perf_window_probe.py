"""Probe of the port's perf sampler on the card: how often the CUDA tracer
drops a sampled window's records, and whether the sampler reports it.

    python scripts/torch_perf_window_probe.py [--windows N] \
        [--config JSON] [--root DIR] [--key value ...]

Runs the port's CLI once, cut short, with a perf sample every 2 steps
(as ``chip_smoke.py`` phase 7 samples), so that the process has traced
before; then samples ``N`` windows of one train step of the run's last
phase card on its final state, each in a session of its own. A window
is one of:

* ``whole``: no loss reported, every label of the step and as many
  BN-kernel records as the step launched;
* ``counted``: the sampler reported lost records
  (``device_records_lost`` > 0);
* ``uncounted``: none reported, yet a label or BN-kernel records are
  missing.

The last stdout line is ``{"metric": "perf_window_probe", "whole": n,
"counted": n, "uncounted": n, "windows": [...], "device": ...}``; exit 0
iff no window is ``uncounted``. Needs the card. Trailing ``--key value``
pairs are CLI overrides.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

FLAGSHIP = os.path.join(_REPO, "experiment_config",
                        "mini-imagenet_maml++_5-way_5-shot_DA_b12.json")
# A short run with the telemetry plane sampling (``chip_smoke.py``
# phases 5 and 7).
CLI_ARGS = ["--bn_backend", "pallas", "--total_epochs", "2",
            "--total_iter_per_epoch", "3",
            "--first_order_to_second_order_epoch", "0",
            "--multi_step_loss_num_epochs", "1",
            "--num_evaluation_tasks", "48", "--max_models_to_save", "2",
            "--profile_every_n_steps", "2"]


def step_regions(name: str) -> set:
    """The labels a train step of phase card ``name`` runs kernels
    under."""
    return {"episode_normalize", "task_adapt", "inner_support_forward",
            "inner_support_grad", "inner_lslr_update", "meta_update",
            "inner_msl_target_forward" if name.endswith("msl1")
            else "final_target_forward"}


def classify(row: dict, bn_launched: int) -> dict:
    """One window's disposition (``whole``, ``counted``, ``uncounted``)
    with what it lacks."""
    missing = sorted(step_regions(row["top_executable"])
                     - set(row["per_region_seconds"]))
    bn = row["per_family_kernels"].get("bn_act", 0)
    if row["device_records_lost"]:
        kind = "counted"
    elif missing or bn != bn_launched:
        kind = "uncounted"
    else:
        kind = "whole"
    return {"kind": kind, "lost": row["device_records_lost"],
            "missing": missing, "bn_records": bn,
            "bn_launched": bn_launched}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=20)
    ap.add_argument("--config", default=FLAGSHIP)
    ap.add_argument("--root", default=None,
                    help="experiment root (a temp directory by default)")
    args, overrides = ap.parse_known_args(argv)
    import torch
    if not torch.cuda.is_available():
        print(json.dumps({"metric": "perf_window_probe", "ok": False,
                          "status": "needs a CUDA card"}))
        return 1
    from howtotrainyourmamlpytorch_tpu_torch import train_maml_system
    from howtotrainyourmamlpytorch_tpu_torch.data import (
        MetaLearningDataLoader)
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import profiler

    root = args.root or tempfile.mkdtemp(prefix="perf_window_probe_")
    try:
        builders = []
        rc = train_maml_system.main(
            ["--name_of_args_json_file", args.config, "--experiment_root",
             root] + CLI_ARGS + overrides, builders=builders)
        if rc != 0:
            print(json.dumps({"metric": "perf_window_probe", "ok": False,
                              "status": f"the CLI exited {rc}"}))
            return 1
        builder = builders[0]
        cfg, state = builder.cfg, builder.state
        epoch = cfg.total_epochs - 1
        phase = dict(second_order=cfg.use_second_order(epoch),
                     use_msl=cfg.use_msl(epoch))
        name = profiler.phase_card_name(**phase)
        loader = MetaLearningDataLoader(cfg, device="cuda")
        batches = loader.get_train_batches(builder.current_iter, 1)
        batch = next(batches)
        batches.close()

        def step():
            return builder.train_step(state, batch, epoch, **phase)

        step()
        costs = profiler.count_costs(step)[1]
        windows = []
        for i in range(args.windows):
            sampler = profiler.PerfSampler(1, device="cuda")
            sampler.register_card(name, profiler.build_cost_card(
                name, **costs, kind=sampler.kind, peaks=sampler.peaks))
            if not sampler.start_window(i):
                raise RuntimeError("the sampler did not start")
            before = bn_act.launches
            step()
            launched = bn_act.launches - before
            row = sampler.end_window(i, executable=name)
            if row is None:
                raise RuntimeError("a sample window failed")
            windows.append(classify(row, launched))
            print(json.dumps(windows[-1]), flush=True)
    finally:
        if args.root is None:
            shutil.rmtree(root, ignore_errors=True)
    counts = {k: sum(w["kind"] == k for w in windows)
              for k in ("whole", "counted", "uncounted")}
    print(json.dumps({"metric": "perf_window_probe",
                      "ok": counts["uncounted"] == 0, **counts,
                      "executable": name, "windows": windows,
                      "device": torch.cuda.get_device_name(0)}))
    return 0 if counts["uncounted"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
