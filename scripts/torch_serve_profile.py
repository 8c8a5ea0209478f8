#!/usr/bin/env python3
"""Where the PyTorch/CUDA port's flagship serving batch spends its time.

    python3 scripts/torch_serve_profile.py [--batches 3] [--bn kernel|composite]

Needs a CUDA card. Builds a ServingEngine at the flagship's full width
(experiment_config/mini-imagenet_maml++_5-way_5-shot_DA_b12.json with
bn_backend='pallas', seeded random weights, 8 tasks x 25 support + 25
query, 5 first-order adapt steps, bf16), warms it up, then serves
``--batches`` full batches of fresh uint8 requests under
``torch.profiler``. Prints one JSON line: host wall time per batch, the
device time and device kernels per batch split by kernel family (the BN
kernel, cuDNN convolutions, pooling, matrix products, everything else),
the device's idle share, the top kernels by device time, and the card's
name and power limit. ``--bn composite`` serves with bn_backend='composite' (plain
PyTorch BN, no hand-written kernel) for comparison.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "experiment_config",
                        "mini-imagenet_maml++_5-way_5-shot_DA_b12.json")
sys.path.insert(0, REPO)

# The kernel families of the port's perf sampler (one table).
from howtotrainyourmamlpytorch_tpu_torch.telemetry.profiler import (  # noqa: E402
    kernel_family as family)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--bn", choices=("kernel", "composite"),
                    default="kernel")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device available",
              file=sys.stderr)
        return 2
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
        init_train_state)
    from howtotrainyourmamlpytorch_tpu_torch.models import make_model
    from howtotrainyourmamlpytorch_tpu_torch.serve import (FewShotRequest,
                                                           ServingEngine)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = MAMLConfig.from_json_file(FLAGSHIP).replace(
        bn_backend="composite" if args.bn == "composite" else "pallas",
        serve_default_deadline_ms=0.0)
    model_init, _ = make_model(cfg)
    state = init_train_state(cfg, model_init, seed=cfg.seed, device="cuda")
    engine = ServingEngine(cfg, state, device="cuda")
    engine.warmup()

    h, w, c = cfg.image_shape
    n, k = cfg.num_classes_per_set, cfg.num_samples_per_class
    q = cfg.num_target_per_task
    rng = np.random.default_rng(cfg.seed)

    def submit_batch():
        for _ in range(cfg.serve_batch_tasks):
            engine.submit(FewShotRequest(
                support_x=rng.integers(0, 256, (n * k, h, w, c),
                                       dtype=np.uint8),
                support_y=np.repeat(np.arange(n, dtype=np.int32), k),
                query_x=rng.integers(0, 256, (q, h, w, c), dtype=np.uint8)))

    submit_batch()          # one unprofiled batch past warmup
    engine.step()
    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.batches):
            submit_batch()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)

    by_family = defaultdict(float)
    family_launches = defaultdict(int)
    by_kernel = defaultdict(float)
    launches = defaultdict(int)
    for evt in prof.events():
        # The serve_adapt/serve_predict labels also show as device spans.
        if (evt.device_type != DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)
                or "annotation" in str(getattr(evt, "activity_type", ""))):
            continue
        us = evt.time_range.elapsed_us()
        by_family[family(evt.name)] += us
        family_launches[family(evt.name)] += 1
        by_kernel[evt.name] += us
        launches[evt.name] += 1
    nb = args.batches
    device_ms = sum(by_family.values()) / 1e3 / nb
    wall_ms = sum(walls) * 1e3 / nb
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "metric": "torch_serve_profile", "bn": args.bn, "card": card,
        "batches": nb, "tasks_per_batch": cfg.serve_batch_tasks,
        "wall_ms_per_batch": wall_ms,
        "adapt_ms_per_batch": engine.adapt_seconds[-1] * 1e3,
        "predict_ms_per_batch": engine.predict_seconds[-1] * 1e3,
        "device_ms_per_batch": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "family_ms_per_batch": {f: v / 1e3 / nb
                                for f, v in sorted(by_family.items(),
                                                   key=lambda kv: -kv[1])},
        "family_launches_per_batch": {f: n / nb for f, n in
                                      sorted(family_launches.items())},
        "top_kernels": [{"name": name[:120], "ms_per_batch": v / 1e3 / nb,
                         "launches_per_batch": launches[name] / nb}
                        for name, v in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
