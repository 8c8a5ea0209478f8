"""Readings that the limits of ``correct`` are set from (on the card).

    python3 portbench/tools/calibrate.py --workload <cell> \\
        --seeds s1,s2,... [--control-seeds ...] [--fault-seeds ...]

For each seed one JSON line per side: ``program`` (the timed path, as a
run drives it), ``control`` (the reference in fp8 in the program's
place) and, for a training cell, ``fault_half_batch`` (the reference
taking the mean over half of the batch in the program's place). A state
left unchanged reads 1 on ``change_gap`` by construction and is not run.

A training cell captures its step once and drives it from each seed's
tables and batches; a serving cell runs the cell's driver for
``--seconds`` per seed and reads the control on the same sampled
requests. Nothing here is part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO_DIR not in sys.path:
    sys.path.insert(0, REPO_DIR)

import torch  # noqa: E402

from portbench import run as bench_run  # noqa: E402
from portbench.lib import compare, episodes, port, weights  # noqa: E402
from portbench.lib.spec import Bench  # noqa: E402
from portbench.reference import maml  # noqa: E402
from portbench.reference.model import Numerics, hyper  # noqa: E402


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s.strip()]


def train(bench: Bench, cell, seeds, control, faults, device) -> None:
    drv = bench.driver("train_step")
    traffic = bench.traffic(cell["traffic"])
    maml_config = bench.config(cell["config"])["maml_config"]
    hp = hyper(maml_config)
    cfg = port.config(maml_config, port.cache_dirs(bench_run.CACHE_DIR))
    epoch = drv.epoch_of(traffic, hp)
    checks = int(traffic["check_steps"])
    step = None
    for seed in seeds:
        t0 = time.perf_counter()
        params, lslr, bn = weights.make(hp, weights.sub_seed(seed, 1), device)
        pool = episodes.train_pool(
            hp.image_shape, hp.num_classes, hp.shots, hp.targets,
            cfg.batch_size, int(traffic["pool_batches"]),
            weights.sub_seed(seed, 2), device)[:checks]
        state = port.train_state(params, lslr, bn)
        if step is None:
            step, phase = port.train_step(cfg, state, pool[0], epoch, device)
        losses = []
        for i in range(checks):
            state, m = step(state, pool[i])
            losses.append(float(m.loss))
            if i == 0:
                mu, first_bn = state.opt_state.mu, drv.row0(state.bn_state)
        prog_first = {k: {n: {l: t / (1 - hp.beta1) for l, t in s.items()}
                          for n, s in mu[k].items()}
                      for k in ("params", "lslr")}
        prog_final = {"params": state.params, "lslr": state.lslr}
        t1 = time.perf_counter()
        ref = drv.reference_steps(hp, params, lslr, bn, pool, phase, epoch,
                                  Numerics())
        t2 = time.perf_counter()
        start = {"params": params, "lslr": lslr, "bn_state": bn}

        def numbers(*side):
            return drv.numbers_against(ref, start, *side)
        emit(seed=seed, side="program",
             **numbers(losses, prog_first, prog_final, first_bn),
             program_s=round(t1 - t0, 3), reference_s=round(t2 - t1, 3))
        if seed in control:
            emit(seed=seed, side="control", **numbers(*drv.reference_steps(
                hp, params, lslr, bn, pool, phase, epoch,
                Numerics(fp8=True))))
        if seed in faults:
            half = list(range(cfg.batch_size // 2))
            emit(seed=seed, side="fault_half_batch",
                 **numbers(*drv.reference_steps(
                     hp, params, lslr, bn, pool, phase, epoch, Numerics(),
                     tasks=half)))
        del state, m, mu, first_bn, prog_first, prog_final, pool


def serve(bench: Bench, cell, seeds, control, seconds, device) -> None:
    drv = bench.driver("serve_open_loop")
    traffic = bench.traffic(cell["traffic"])
    maml_config = bench.config(cell["config"])["maml_config"]
    hp = hyper(maml_config)
    for seed in seeds:
        t0 = time.perf_counter()
        out = bench_run.outcome(cell["name"], seed, seconds, False, device,
                                bench, t0=t0)
        emit(seed=seed, side="program", **out.readings["numbers"],
             p95_ms=out.end_to_end["serve_p95_ms"],
             run_s=round(time.perf_counter() - t0, 3))
    sub = weights.sub_seed
    for seed in control:
        params, lslr, _ = weights.make(hp, sub(seed, 1), device)
        per = hp.num_classes * (hp.shots + hp.targets)
        pool_size = int(traffic["image_pool"])
        count = int(traffic["sample_requests"])
        plan = episodes.request_plan(pool_size, per, count, sub(seed, 4))
        requests = drv.Requests(hp, episodes.image_pool(
            hp.image_shape, pool_size, sub(seed, 2), device), plan)
        pairs = []
        with maml.TF32Off():
            for i in range(count):
                sx, sy, qx = (torch.from_numpy(a).to(device)
                              for a in requests.arrays(i))
                ref = maml.adapt_predict(hp, params, lslr, sx, sy, qx,
                                         Numerics())
                low = maml.adapt_predict(hp, params, lslr, sx, sy, qx,
                                         Numerics(fp8=True))
                pairs.append((low.cpu(), ref.cpu()))
        emit(seed=seed, side="control",
             **compare.serve_numbers(pairs))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0,
                    help="a serving cell's window per program seed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = Bench()
    cell = bench.cell(args.workload)
    driver = bench.traffic(cell["traffic"])["driver"]
    if driver == "train_step":
        train(bench, cell, _seeds(args.seeds), _seeds(args.control_seeds),
              _seeds(args.fault_seeds), device)
    else:
        serve(bench, cell, _seeds(args.seeds), _seeds(args.control_seeds),
              args.seconds, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
