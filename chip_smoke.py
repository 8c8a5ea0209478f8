#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit. Imports nothing of JAX. Phases, each of which raises on
failure:

1. Build every hand-written kernel (``csrc/*.cu``, nvcc for sm_90a) and
   turn TF32 off for convolutions and matrix products.
2. Hold each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it (the flagship's four VGG stages at 8
   tasks x 25 images x 48 channels), the training path's (1 task: 48
   channels) and at ragged shapes: forward outputs, statistics, and
   gradients of the autograd.Function against autograd of the plain
   version; forward outputs and statistics at the eval step's four stages
   (24 tasks: 1152 channels); the same at ResNet-12's shapes and slopes
   (0.1 and 1.0): gradients too at its training shapes (one task:
   64/160/320/640 channels at 84/42/21/10; and the batched MSL target
   forward's five instances: 5 x 48 and 5 x 64/160/320/640 channels),
   forward outputs and statistics
   at its eval (16 tasks) and serving (8 tasks) shapes; forward outputs
   at one row, fewer rows than SMs, rows not a multiple of the SM count
   and an unaligned view; two
   launches on the same x bitwise equal. Time kernel, plain version and
   the library yardstick (``F.batch_norm(training=True)`` + ``relu_``,
   ``leaky_relu_`` or nothing, by slope; timed only, never called by the
   port) after warm-up: wall (CUDA events around one call, median) and
   device (the profiler's kernel time per call, which must be one kernel
   for the BN kernel), at the serving, training and eval shapes of both
   conv backbones.
3. Serve at the flagship's full width through ``ServingEngine``
   (experiment_config/mini-imagenet_maml++_5-way_5-shot_DA_b12.json with
   bn_backend='pallas', seeded random weights): 16 uint8 requests plus a
   repeat of one support set, which must be a cache hit. Every kernel's
   launch count over that run must match the path (20 per adapt batch, 4
   per predict batch). One batch is then run again with the plain
   version selected explicitly and the logits compared.
4. Meta-train at the flagship's full width (same config, batch 12 in 12
   one-task microbatches, K=5, LSLR, clamp ±10, remat 'block_outs') from
   ``init_train_state`` on batches of the port's
   ``MetaLearningDataLoader`` (synthetic source: the dataset is not in the
   repo): steps of each phase the flagship runs — epoch 0 (first order +
   MSL) and epoch 41 (second order, no MSL) — then one eval batch of 24
   tasks. Every loss and metric must be finite, the step counter must
   advance, and the BN kernel's launches over each phase must equal the
   count derived for the path. Then the kernel against its plain version
   on the same state: the eval batch's logits in bf16 and f32 (cosine
   floors ``LOGITS_COSINE``, ``EVAL_F32_COSINE``) and one second-order
   meta-gradient (loss, whole-vector and per-leaf cosines; floors
   ``F32_FLOORS``, ``BF16_FLOORS``), each read beside witnesses that
   change only the BN backward or only the statistics' rounding and
   beside the control, bf16 against f32; then a profiled second-order
   step split by kernel family, and one second-order step per remat
   variant ('block_outs', off, 'nothing', 'conv_outs', 'dots': time, peak
   memory, launches as derived; each variant's f32 meta-gradient against
   'block_outs' under deterministic cuDNN, bitwise expected, else held
   to ``F32_FLOORS``); then one first-order MSL step under
   ``msl_target_batching`` 'auto' and 'on' (launches 180 and 72 per BN
   layer, time, peak memory, the sampler's idle share; the f32
   meta-gradient 'on' against 'auto' held to ``F32_FLOORS``).
5. The trainer's CLI at the flagship's full width, in process:
   ``train_maml_system.main`` on the flagship JSON with ``--bn_backend
   pallas`` and overrides that cut only the run's length (``CLI_ARGS``: 2
   epochs x 3 iterations, epoch 0 first order + MSL, epoch 1 second
   order; 48 evaluation tasks; the top 2 checkpoints). It must exit 0
   with two finite CSV rows, a ``test_summary.csv`` of 2 models over 48
   episodes, ``train_model_{0,1,latest}.ckpt``, ``state.json``, a
   committed ``MANIFEST.json`` whose records' CRCs verify,
   ``REGISTRY.json``, checkpoints that load back (the latest bitwise into
   the state the builder holds), and exactly the BN kernel launches
   derived for that path (3360). Then the same run paused after epoch 0
   and resumed with ``--continue_from_epoch latest`` must agree with it.
   The entry point runs cuDNN's deterministic algorithms
   (``device.numerics_policy``), so the resumed run is expected to be
   bitwise the uninterrupted one; it is held by per-leaf update cosines
   (``RESUME_COSINE``) and the epoch-1 train loss (``RESUME_LOSS_RTOL``),
   and whether it is bitwise is printed.
6. The other backbones at full width (``other_backbones``): the CLI on
   the ResNet-12 pod JSON mapped onto one card and cut in length
   (``R12_CLI_ARGS``: 1 epoch x 3 iterations of 8 tasks, 32 evaluation
   tasks, the top checkpoint), with exactly the BN-kernel launches derived
   for that path (6144) and the checks of phase 5; on its state, timed and
   profiled second-order steps and eval batches, one second-order
   meta-gradient kernel vs plain (f32 held to ``R12_F32_FLOORS``, bf16 and
   the bf16-vs-f32 control read), one second-order MSL step under
   ``msl_target_batching`` 'auto' and 'on' (launches as derived, time,
   peak memory, the bf16 meta-gradients' cosine), 8 requests through
   ``ServingEngine``
   (launches held, logits kernel vs plain held to ``R12_SERVE_COSINE``
   beside the f32 control); then the sinusoid JSON (the MLP, regression:
   a finite ``test_mse_mean``) and the omniglot JSON with layer norm
   through the CLI, each launching the BN kernel 0 times.
7. Phase 5's CLI run again with the telemetry plane on (``cli_telemetry``:
   training health every step, a perf sample every 2 steps, a device
   trace of epoch 1, alert rules): its rows, ``metrics.prom``,
   ``trace.json``, the Chrome trace and alerts checked, the BN-kernel
   launches of phase 5, and final weights and Adam state bitwise phase
   5's. Then what health and a sample window add to a step, what the
   profiler labels cost with the profiler off, and the port's sampler
   beside this script's own profile of one step (phases 4 and 6 print
   the same pair for their profiled steps).
8. The trainer's fault path at the flagship's full width (``fault_path``):
   ``scripts/torch_chaos_run.py``'s phases in process on the card (its
   verdict must be ``recovered``; the ckpt_kill and hang restarts resume
   from the last committed manifest entry and end bitwise the baseline;
   every in-process phase launches the BN kernel as derived for what it
   ran); a hang on the device (a ``torch.cuda._sleep`` spin kernel after
   the second step of a flagship CLI child with a 6 s step deadline) and
   the ``hang_step`` fault, each exiting 74 within the deadline + 2 polls
   + 5 s with a full crash bundle (the device hang's ``stacks.txt`` with
   the main thread at the loss fetch, its ``events.jsonl`` read by
   ``scripts/telemetry_report.py`` with one trip), as the chaos run's
   ``hang_feed`` child does; an async run's checkpoints byte-identical
   the sync baseline's, the train thread's time in a ResNet-12 save sync
   against async; three steps with the watchdog on against off, bitwise;
   and a cold ``bn_act`` build under a 1 s step deadline without a trip.
9. The serving plane at the flagship's full width (``serving_plane``),
   from phase 5's checkpoints through ``ServingEngine.from_checkpoint``:
   an L1 repeat; the L2 tier (writer-thread publishes, get and put
   timed, a second engine serving a repeat from it with no adapt, every
   request traced at rate 1.0 and linked); predict timed with the L2
   tier on and off on the same requests; a burst past the queue bound
   with the deadline shed policy and continuous batching on (every
   request shed, rejected or answered; ``serve/shed_total`` and
   ``serve/cb_*`` counted); the flush row read by the JAX package's
   ``scripts/telemetry_report.py``; a hot-swap to a perturbed v2 at the
   default canary gates (the cache misses after it) and a rollback from
   a NaN v3 (pinned; v2 still serves); BN-kernel launches equal to the
   engines' adapt and predict batches. Then
   ``scripts/torch_fleet_bench.py`` with 2 replica processes on the card
   (``FLEET_ARGS``): zero dropped through a rolling swap, the rollout
   ``done``, the migration served from L2 with 0 adapts on its target,
   each replica's launches equal to its own batches' count, and one
   fleet answer held against the plain version in process
   (``LOGITS_COSINE``).
10. The data path (``data_path``): MAMLPACK1 shards at mini-ImageNet's
   split geometry (64/16/20 classes x 600 images of 84x84x3, seeded
   uint8, ~1.27 GB) written with the port's ``write_shard`` under
   ``.smoke_runs/``, every class CRC verified, the open timed, the first
   train batch from the pack bitwise the one from an ``ArraySource`` over
   the same arrays; the flagship CLI in process on the shards under
   ``msl_target_batching='on'`` and ``remat_policy='conv_outs'``
   (``PACK_CLI_ARGS``, phase 5's length cuts) with exactly the derived
   launches, the pack's metrics in ``metrics.prom`` and
   ``feed_stall_frac`` reported; ``scripts/torch_telemetry_report.py``
   over the run counting its steps.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Exits non-zero without a result
when no CUDA device is available or the port's package is missing.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(REPO, "experiment_config",
                        "mini-imagenet_maml++_5-way_5-shot_DA_b12.json")

# HBM bandwidth by card (NVIDIA data sheets), for each kernel's bound.
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12,
                   "H100": 3.35e12, "H200": 4.8e12}
# Peak f32 rate outside the tensor cores (H100 SXM data sheet); the
# kernel's arithmetic is f32.
F32_FLOP_PER_S = 67e12

# Serving-path shapes of the BN kernel at the flagship's full width:
# (R, P) = (25 images x H x W, 8 tasks x 48 channels), one per VGG stage.
TASKS, SHOTS, FILTERS = 8, 25, 48
STAGE_HW = (84, 42, 21, 10)
SHAPES = [(SHOTS * hw * hw, TASKS * FILTERS) for hw in STAGE_HW]
RAGGED = ((1001, 7), (3001, 97))
# ((R, P), element offset of x in its buffer): one row, fewer rows than
# SMs, rows not a multiple of the SM count, and an unaligned view.
SMALL = (((1, 384), 0), ((100, 384), 0), ((1000, 384), 0), ((3001, 384), 1))
# Training-path shapes: one task per microbatch (task_microbatches 12 over
# batch 12), so (25 x H x W, 48) at every stage of the support and target
# forwards; the eval step's 24 tasks at once at every stage.
TRAIN_SHAPES = [(SHOTS * hw * hw, FILTERS) for hw in STAGE_HW]
EVAL_TASKS = 24
EVAL_SHAPES = [(SHOTS * hw * hw, EVAL_TASKS * FILTERS) for hw in STAGE_HW]
# Batched MSL targets (msl_target_batching='on'): one target forward over
# K=5 instances per one-task microbatch, so P = K x 48 at every VGG stage.
MSL_STEPS = 5
MSL_SHAPES = [(SHOTS * hw * hw, MSL_STEPS * FILTERS) for hw in STAGE_HW]
# Outer steps timed per training phase, after one warm-up step.
TRAIN_STEPS = 3
# Phase 5: the CLI's overrides of the flagship JSON (length only), and the
# floors that hold the paused-and-resumed run against the uninterrupted
# one: per weight leaf, the cosine of the two runs' updates from the
# seeded init; the epoch-1 train loss, relative.
CLI_ARGS = ["--bn_backend", "pallas", "--total_epochs", "2",
            "--total_iter_per_epoch", "3",
            "--first_order_to_second_order_epoch", "0",
            "--multi_step_loss_num_epochs", "1",
            "--num_evaluation_tasks", "48", "--max_models_to_save", "2"]
RESUME_COSINE = 0.999
RESUME_LOSS_RTOL = 1e-3

# ResNet-12 (the tiered-ImageNet pod JSON): blocks of widths 64/160/320/640
# at 84/42/21/10, 25 images per task, every BN at slope 0.1 (the first two
# norms of a block) or 1.0 (the third and the skip's). Its BN kernel
# shapes: one task per microbatch in training, 16 tasks at once in eval,
# 8 in serving.
RESNET12 = os.path.join(REPO, "experiment_config",
                        "tiered-imagenet_maml++_5-way_5-shot_resnet12_pod.json")
SINUSOID = os.path.join(REPO, "experiment_config", "sinusoid_maml_5-shot.json")
OMNIGLOT = os.path.join(REPO, "experiment_config",
                        "omniglot_maml++_5-way_1-shot.json")
R12_BLOCKS = ((84, 64), (42, 160), (21, 320), (10, 640))
R12_SLOPES = (0.1, 1.0)
R12_EVAL_TASKS = 16
R12_TRAIN_SHAPES = [(SHOTS * hw * hw, c) for hw, c in R12_BLOCKS]
R12_EVAL_SHAPES = [(SHOTS * hw * hw, R12_EVAL_TASKS * c)
                   for hw, c in R12_BLOCKS]
R12_SERVE_SHAPES = [(SHOTS * hw * hw, TASKS * c) for hw, c in R12_BLOCKS]
# ResNet-12's batched MSL target forward: K=5 instances of one task.
R12_MSL_SHAPES = [(SHOTS * hw * hw, MSL_STEPS * c) for hw, c in R12_BLOCKS]
# Phase 6: overrides of the pod JSON that only map the pod onto one card
# (each chip's share of the pod's 256 tasks in 8 microbatches is 8 tasks,
# one per chunk) and cut the run's length; the BN-kernel launches that
# run makes (derived in _train_path_launches).
R12_CLI_ARGS = ["--bn_backend", "pallas", "--mesh_shape", "1", "1",
                "--require_mesh", "0", "--cluster_collective_timeout_s", "0",
                "--batch_size", "8", "--task_microbatches", "8",
                "--total_epochs", "1", "--total_iter_per_epoch", "3",
                "--num_evaluation_tasks", "32", "--max_models_to_save", "1"]
R12_CLI_LAUNCHES = 6144
SINUSOID_ARGS = ["--total_epochs", "1", "--total_iter_per_epoch", "20",
                 "--num_evaluation_tasks", "48"]
LAYER_NORM_ARGS = ["--norm_layer", "layer_norm", "--bn_backend", "composite",
                   "--total_epochs", "1", "--total_iter_per_epoch", "3",
                   "--num_evaluation_tasks", "32", "--max_models_to_save",
                   "1"]


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _bandwidth(name: str) -> float:
    for key, bw in HBM_BYTES_PER_S.items():   # most specific key first
        if key in name:
            return bw
    raise RuntimeError(f"no HBM bandwidth on record for {name!r}")


def _median_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Wall time of one call: CUDA events around each call, median. It
    includes the host's launch cost whenever the device waits on it."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_events(prof):
    """``[(name, ms)]`` of the device activity (kernels, copies, sets) a
    finished profiler window recorded, read from its raw records: the
    events ``prof.events()`` would list as CUDA, without building its
    Python event tree (over a minute for a ResNet-12 step's ~1M host
    ops). The profiler also lists each ``record_function`` label's span
    on the device; those are not activity and are left out."""
    from torch.autograd import DeviceType
    return [(e.name(), e.duration_ns() / 1e6)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not getattr(e, "is_hidden_event", lambda: False)()
            and not e.is_user_annotation()
            and "annotation" not in getattr(e, "activity_type",
                                            lambda: "")()]


def _device_ms(fn, iters: int = 20, attempts: int = 3):
    """Device time of one call: the profiler's kernel durations summed over
    ``iters`` calls, per call, and the device kernels per call; (None, None)
    when the profiler records no device activity. A window with no kernel
    records or a kernel count that is not a multiple of ``iters`` lost
    records (the tracer can drop some) and is measured again, up to
    ``attempts`` windows."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = _device_events(prof)
        if kernels and len(kernels) % iters == 0:
            break
    if not kernels:
        return None, None
    return sum(ms for _, ms in kernels) / iters, len(kernels) / iters


def _close(name: str, got, want, rtol: float, atol: float) -> float:
    """Assert |got − want| <= atol + rtol·|want| elementwise; returns the
    max absolute error."""
    got, want = got.float(), want.float()
    if want.numel() == 0:
        return 0.0
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {err.numel()} elements off "
            f"(max abs err {err.max().item():.3e}, rtol {rtol}, atol {atol})")
    return float(err.max().item())


def _small_shapes_and_determinism(gen) -> None:
    """Forward-only checks of the BN kernel against its plain version where
    the launch plan is at its edges: one row, fewer rows than SMs, rows not
    a multiple of the SM count, and an unaligned view (the scalar path);
    then bitwise equality of two launches on the same x."""
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act

    for (r, p), offset in SMALL:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.empty(r * p + offset, dtype=dtype,
                            device="cuda")[offset:].view(r, p)
            x.copy_(torch.randn(r, p, device="cuda", generator=gen) * 2.0
                    + 0.3)
            gamma = torch.rand(p, device="cuda", generator=gen) + 0.5
            beta = torch.randn(p, device="cuda", generator=gen) * 0.1
            rtol, atol = ((1.6e-2, 1e-2) if dtype == torch.bfloat16
                          else (1e-4, 1e-5))
            if r == 1:
                # One row: var is 0, scale = gamma/sqrt(eps) ~ 316 gamma,
                # and y = x*scale + shift cancels two terms of size
                # |x*scale|; a last-bit difference of 1/sqrt(eps) (the
                # plain version's rsqrt, the kernel's rounded 1/sqrt)
                # shows at that size, so atol is rtol of it.
                atol = rtol * float((x.float().abs().max()
                                     * gamma.max() / 1e-5 ** 0.5).item())
            for slope in (0.0, 0.1, 1.0):
                tag = (f"bn_act {(r, p)} {dtype} slope={slope}"
                       f"{' unaligned' if offset else ''}")
                with torch.no_grad():
                    k = bn_act.bn_act(x, gamma, beta, 1e-5, slope)
                    ref = bn_act.bn_act(x, gamma, beta, 1e-5, slope,
                                        plain=True)
                _close(tag + " y", k[0], ref[0], rtol, atol)
                _close(tag + " mean", k[1], ref[1], 1e-5, 1e-5)
                _close(tag + " var", k[2], ref[2], 1e-4, 1e-5)
    for r, p in SHAPES + [(100, 384)]:
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(r, p, device="cuda", generator=gen) * 2.0
                 + 0.3).to(dtype)
            gamma = torch.rand(p, device="cuda", generator=gen) + 0.5
            beta = torch.randn(p, device="cuda", generator=gen) * 0.1
            with torch.no_grad():
                first = bn_act.bn_act(x, gamma, beta, 1e-5, 0.0)
                second = bn_act.bn_act(x, gamma, beta, 1e-5, 0.0)
            for name, u, v in zip(("y", "mean", "var"), first, second):
                if not torch.equal(u, v):
                    raise AssertionError(f"bn_act {(r, p)} {dtype}: two "
                                         f"launches differ in {name}")
    torch.cuda.synchronize()
    print(f"bn_act small/unaligned checks passed: {len(SMALL)} shapes x 2 "
          f"dtypes x 3 slopes; bitwise equal reruns at "
          f"{len(SHAPES) + 1} shapes x 2 dtypes", flush=True)


def check_bn_act(device_name: str, card: str) -> dict:
    """Phase 2 for the BN+activation kernel; returns its kernels entry
    (``launches`` filled in by phase 3)."""
    import torch
    import torch.nn.functional as F
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act

    gen = torch.Generator(device="cuda").manual_seed(0)
    bw = _bandwidth(device_name)
    max_err = {torch.bfloat16: 0.0, torch.float32: 0.0}
    stages = []
    grad_cases = ([(sh, (0.0, 0.1, 1.0))
                   for sh in SHAPES + TRAIN_SHAPES + list(RAGGED)]
                  + [(sh, R12_SLOPES) for sh in R12_TRAIN_SHAPES]
                  + [(sh, (0.0,)) for sh in MSL_SHAPES]
                  + [(sh, R12_SLOPES) for sh in R12_MSL_SHAPES])
    for (r, p), slopes in grad_cases:
        for dtype in (torch.bfloat16, torch.float32):
            for slope in slopes:
                x = (torch.randn(r, p, device="cuda", generator=gen) * 2.0
                     + 0.3).to(dtype)
                gamma = torch.rand(p, device="cuda", generator=gen) + 0.5
                beta = torch.randn(p, device="cuda", generator=gen) * 0.1
                gy = torch.randn(r, p, device="cuda", generator=gen).to(dtype)
                gm = torch.randn(p, device="cuda", generator=gen)
                gv = torch.randn(p, device="cuda", generator=gen)
                tag = f"bn_act {(r, p)} {dtype} slope={slope}"
                # bf16: 2 ulp (rtol 1.6e-2) — the kernel repeats the plain
                # version's roundings; only the f32 sum order differs.
                # f32: sum order only.
                rtol, atol = ((1.6e-2, 1e-2) if dtype == torch.bfloat16
                              else (1e-4, 1e-5))
                with torch.no_grad():
                    y_k = bn_act.bn_act(x, gamma, beta, 1e-5, slope)[0]
                    y_p = bn_act.bn_act(x, gamma, beta, 1e-5, slope,
                                        plain=True)[0]
                if slope != 1.0:
                    # Where the two forwards sit on opposite sides of the
                    # activation's kink (|y| within the forward
                    # tolerance of 0) the derivatives differ by design:
                    # zero the cotangent there so both sides agree.
                    kink = (y_k > 0) != (y_p > 0)
                    _close(tag + " y at the kink", y_k[kink], y_p[kink],
                           0.0, atol)
                    gy = gy.masked_fill(kink, 0)
                outs = {}
                for plain in (False, True):
                    xs = x.clone().requires_grad_(True)
                    gs = gamma.clone().requires_grad_(True)
                    bs = beta.clone().requires_grad_(True)
                    y, mean, var = bn_act.bn_act(xs, gs, bs, 1e-5, slope,
                                                 plain=plain)
                    loss = ((y.float() * gy.float()).sum()
                            + (mean * gm).sum() + (var * gv).sum())
                    grads = torch.autograd.grad(loss, (xs, gs, bs))
                    torch.cuda.synchronize()
                    outs[plain] = (y.detach(), mean.detach(), var.detach(),
                                   *grads)
                k, ref = outs[False], outs[True]
                max_err[dtype] = max(max_err[dtype], _close(
                    tag + " y", k[0], ref[0], rtol, atol))
                _close(tag + " mean", k[1], ref[1], 1e-5, 1e-5)
                _close(tag + " var", k[2], ref[2], 1e-4, 1e-5)
                # Gradients: hand-written VJP (f32 math) vs autograd of the
                # plain version. In bf16 autograd rounds the per-column
                # sums behind dscale/dshift to bf16 before dgamma =
                # inv·dscale − mean·inv·dshift cancels them, so its error
                # is ~1 bf16 ulp of the largest entry: 2 ulp (1.6e-2) of
                # max|ref|. In f32 only the order differs: 1e-3.
                grtol = 1.6e-2 if dtype == torch.bfloat16 else 1e-3
                for name, a, b in zip(("dx", "dgamma", "dbeta"), k[3:],
                                      ref[3:]):
                    scale = float(b.abs().max().item()) or 1.0
                    _close(f"{tag} {name}", a, b, grtol, grtol * scale)
    n_cases = 2 * sum(len(slopes) for _, slopes in grad_cases)
    print(f"bn_act checks passed: {len(grad_cases)} shapes, {n_cases} "
          f"(shape, dtype, slope) cases (forward, statistics, gradients; "
          f"ResNet-12's training shapes {R12_TRAIN_SHAPES} at slopes "
          f"{R12_SLOPES}; batched-MSL shapes VGG {MSL_SHAPES} at slope 0 "
          f"and ResNet-12 {R12_MSL_SHAPES} at slopes {R12_SLOPES}), "
          f"forward max abs err bf16 "
          f"{max_err[torch.bfloat16]:.3e}, f32 {max_err[torch.float32]:.3e}",
          flush=True)
    fwd_cases = ([(sh, (0.0, 0.1, 1.0)) for sh in EVAL_SHAPES]
                 + [(sh, R12_SLOPES)
                    for sh in R12_EVAL_SHAPES + R12_SERVE_SHAPES])
    for (r, p), slopes in fwd_cases:
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(r, p, device="cuda", generator=gen) * 2.0
                 + 0.3).to(dtype)
            gamma = torch.rand(p, device="cuda", generator=gen) + 0.5
            beta = torch.randn(p, device="cuda", generator=gen) * 0.1
            rtol, atol = ((1.6e-2, 1e-2) if dtype == torch.bfloat16
                          else (1e-4, 1e-5))
            for slope in slopes:
                tag = f"bn_act {(r, p)} {dtype} slope={slope}"
                with torch.no_grad():
                    k = bn_act.bn_act(x, gamma, beta, 1e-5, slope)
                    ref = bn_act.bn_act(x, gamma, beta, 1e-5, slope,
                                        plain=True)
                max_err[dtype] = max(max_err[dtype], _close(
                    tag + " y", k[0], ref[0], rtol, atol))
                _close(tag + " mean", k[1], ref[1], 1e-5, 1e-5)
                _close(tag + " var", k[2], ref[2], 1e-4, 1e-5)
                del k, ref
            del x
    torch.cuda.empty_cache()
    print(f"bn_act eval/serving-shape checks passed (forward, "
          f"statistics): VGG eval {EVAL_SHAPES} x 2 dtypes x 3 slopes; "
          f"ResNet-12 eval {R12_EVAL_SHAPES} and serving "
          f"{R12_SERVE_SHAPES} x 2 dtypes x slopes {R12_SLOPES}",
          flush=True)
    _small_shapes_and_determinism(gen)

    # Timing. VGG rows at the serving dtype (bf16) and activation (relu);
    # ResNet-12 rows in bf16 at both its slopes, and its widest eval stage
    # in f32 too (2560 16-byte groups per row: the normalize pass stages
    # fewest rows per piece there). Wall: one call between CUDA events
    # (host launch cost included where the device waits on it). Device:
    # the profiler's kernel time per call. Yardstick: F.batch_norm, then
    # relu_ (slope 0), leaky_relu_ (0.1) or nothing (1.0).
    bf16 = torch.bfloat16
    rows = ([("vgg", "serve", sh, 0.0, bf16) for sh in SHAPES]
            + [("vgg", "train", sh, 0.0, bf16) for sh in TRAIN_SHAPES]
            + [("vgg", "eval", sh, 0.0, bf16) for sh in EVAL_SHAPES]
            + [("resnet12", path, sh, slope, bf16)
               for path, shapes in (("train", R12_TRAIN_SHAPES),
                                    ("eval", R12_EVAL_SHAPES),
                                    ("serve", R12_SERVE_SHAPES))
               for sh in shapes for slope in R12_SLOPES]
            + [("resnet12", "eval", R12_EVAL_SHAPES[-1], 0.1,
                torch.float32)]
            + [("vgg", "train msl on", sh, 0.0, bf16) for sh in MSL_SHAPES]
            + [("resnet12", "train msl on", sh, slope, bf16)
               for sh in R12_MSL_SHAPES for slope in R12_SLOPES])
    for model, path, (r, p), slope, dtype in rows:
        x = (torch.randn(r, p, device="cuda", generator=gen) * 2.0
             + 0.3).to(dtype)
        gamma = torch.rand(p, device="cuda", generator=gen) + 0.5
        beta = torch.randn(p, device="cuda", generator=gen) * 0.1
        hw = int(round((r // SHOTS) ** 0.5))
        x4 = x.view(SHOTS, hw, hw, p).permute(0, 3, 1, 2)  # channels_last

        def kernel():
            return bn_act.bn_act(x, gamma, beta, 1e-5, slope)

        def library():
            y = F.batch_norm(x4, None, None, gamma, beta, training=True,
                             eps=1e-5)
            if slope == 0.0:
                return y.relu_()
            return y if slope == 1.0 else F.leaky_relu_(y, slope)

        with torch.no_grad():
            ms = _median_ms(kernel)
            plain_ms = _median_ms(lambda: bn_act.bn_act(
                x, gamma, beta, 1e-5, slope, plain=True))
            lib_ms = _median_ms(library)
            dev_ms, per_call = _device_ms(kernel)
            lib_dev_ms, lib_per_call = _device_ms(library)
        if per_call is not None and per_call != 1:
            raise AssertionError(f"bn_act {r}x{p}: {per_call} device "
                                 f"kernels per call, want 1")
        nbytes = 2 * r * p * x.element_size() + 4 * p * 4
        flops = 8 * r * p   # stats 3/elem, normalize+act 5/elem
        bound_s = max(nbytes / bw, flops / F32_FLOP_PER_S)
        dname = "bf16" if dtype == bf16 else "f32"
        stages.append({"model": model, "path": path, "shape": [r, p],
                       "slope": slope, "dtype": dname, "ms": ms,
                       "device_ms": dev_ms,
                       "kernels_per_call": per_call,
                       "plain_ms": plain_ms, "library_ms": lib_ms,
                       "library_device_ms": lib_dev_ms,
                       "library_kernels_per_call": lib_per_call,
                       "bound_ms": bound_s * 1e3,
                       "bound_by": ("bytes" if nbytes / bw
                                    >= flops / F32_FLOP_PER_S
                                    else "operations")})
        print(f"bn_act {model} {path} {r}x{p} {dname} slope={slope}: "
              f"kernel wall {ms:.4f} ms, device {dev_ms} ms ({per_call} "
              f"kernels/call); plain {plain_ms:.4f} ms; library wall "
              f"{lib_ms:.4f} ms, device {lib_dev_ms} ms ({lib_per_call} "
              f"kernels/call); bound {bound_s * 1e3:.4f} ms ({card})",
              flush=True)
        del x, x4
    torch.cuda.empty_cache()
    top = stages[0]
    return {"name": "bn_act", "route": "cuda",
            "source": "howtotrainyourmamlpytorch_tpu_torch/csrc/bn_act.cu",
            "replaces": "howtotrainyourmamlpytorch_tpu/ops/pallas_fused.py:67",
            "launches": None, "max_abs_err": max(max_err.values()),
            "ms": top["ms"], "device_ms": top["device_ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "library_device_ms": top["library_device_ms"],
            "shape": top["shape"], "dtype": "bfloat16", "stages": stages}


def _cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float((a @ b) / (a.norm() * b.norm()))


# Floors of the cosine between the kernel's and the plain version's
# logits after adaptation: bf16 (serving batch, eval batch) and f32 (eval
# batch).
LOGITS_COSINE = 0.999
EVAL_F32_COSINE = 0.9999


def _logits_agreement(k, p):
    """Kernel logits ``k`` against the plain version's ``p`` (``(...,
    classes)``): ``(cosine, argmax flips, near-tie rows)``. Near-ties are
    rows whose top-2 margin in the plain run is within 2 bf16 ulps
    (1.6e-2) of the logit scale, bf16's resolution of the output:
    last-bit differences of the batch statistics, carried through 5 adapt
    steps, may flip their argmax."""
    k, p = k.float(), p.float()
    top2 = p.topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) <= 1.6e-2 * p.abs().max()
    return _cosine(k, p), k.argmax(-1) != p.argmax(-1), tie


def serve_flagship(entry: dict, card: str) -> None:
    """Phase 3: flagship-width serving through the ServingEngine; fills
    the BN kernel's ``launches`` in its kernels ``entry``."""
    import numpy as np
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
        init_train_state)
    from howtotrainyourmamlpytorch_tpu_torch.models import make_model
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.serve import (
        FewShotRequest, ServingEngine, pad_group)
    from howtotrainyourmamlpytorch_tpu_torch.serve.adapt import (
        adapt_task, predict_tasks)

    cfg = MAMLConfig.from_json_file(FLAGSHIP).replace(
        bn_backend="pallas", serve_default_deadline_ms=0.0)
    model_init, _ = make_model(cfg)
    state = init_train_state(cfg, model_init, seed=cfg.seed, device="cuda")
    engine = ServingEngine(cfg, state, device="cuda")
    t0 = time.perf_counter()
    engine.warmup()
    print(f"serve: warmup {time.perf_counter() - t0:.2f} s "
          f"(buckets {engine.batcher.buckets}, {cfg.serve_batch_tasks} "
          f"tasks/batch, {engine.num_adapt_steps} adapt steps, "
          f"{cfg.compute_dtype})", flush=True)

    h, w, c = cfg.image_shape
    n, k = cfg.num_classes_per_set, cfg.num_samples_per_class
    q = cfg.num_target_per_task
    rng = np.random.default_rng(cfg.seed)

    def request(support=None):
        sx = (support if support is not None
              else rng.integers(0, 256, (n * k, h, w, c), dtype=np.uint8))
        return FewShotRequest(
            support_x=sx, support_y=np.repeat(np.arange(n, dtype=np.int32), k),
            query_x=rng.integers(0, 256, (q, h, w, c), dtype=np.uint8))

    requests = [request() for _ in range(2 * cfg.serve_batch_tasks)]
    torch.cuda.reset_peak_memory_stats()
    bn_act.reset_launches()
    t0 = time.perf_counter()
    for req in requests:
        engine.submit(req)
    responses = engine.drain()
    serve_s = time.perf_counter() - t0
    adapts_before = engine.adapt_invocations
    repeat = request(support=requests[0].support_x)
    engine.submit(repeat)
    (hit,) = engine.drain()
    launches = bn_act.launches

    if len(responses) != len(requests):
        raise AssertionError(f"{len(responses)} responses to "
                             f"{len(requests)} requests")
    for resp in responses + [hit]:
        if resp.status != "ok" or resp.logits is None:
            raise AssertionError(f"request {resp.request_id}: {resp.status}"
                                 f" {resp.error}")
        if resp.logits.shape != (q, n) or not np.isfinite(resp.logits).all():
            raise AssertionError(f"request {resp.request_id}: logits "
                                 f"{resp.logits.shape}, finite="
                                 f"{np.isfinite(resp.logits).all()}")
    if not hit.cache_hit or engine.adapt_invocations != adapts_before:
        raise AssertionError("repeated support set was not a cache hit")
    want = (20 * engine.adapt_invocations + 4 * engine.predict_invocations)
    if launches != want:
        raise AssertionError(
            f"bn_act launched {launches} times, the path needs "
            f"{want} (20 x {engine.adapt_invocations} adapts + 4 x "
            f"{engine.predict_invocations} predicts)")
    entry["launches"] = launches
    peak = torch.cuda.max_memory_allocated()
    adapt_ms = statistics.median(engine.adapt_seconds) * 1e3
    predict_ms = statistics.median(engine.predict_seconds) * 1e3
    print(f"serve: {len(requests)} requests in {serve_s:.3f} s = "
          f"{len(requests) / serve_s:.2f} req/s; adapt {adapt_ms:.2f} "
          f"ms/batch, predict {predict_ms:.2f} ms/batch (medians of "
          f"{len(engine.adapt_seconds)}/{len(engine.predict_seconds)}); "
          f"cache hit ok; bn_act launches {launches} = 20 x "
          f"{engine.adapt_invocations} + 4 x {engine.predict_invocations}; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB ({card})",
          flush=True)

    # The first batch again, with the kernel and with the plain version
    # selected explicitly; timed per variant (device-synchronized).
    group = requests[:cfg.serve_batch_tasks]
    batch = pad_group(group, engine.batcher.buckets[0],
                      cfg.serve_batch_tasks, cfg.image_shape)
    dev = torch.device("cuda")
    sx = torch.from_numpy(batch["support_x"]).to(dev)
    sy = torch.from_numpy(batch["support_y"]).to(dev, torch.long)
    sw = torch.from_numpy(batch["support_w"]).to(dev)
    qx = torch.from_numpy(batch["query_x"]).to(dev)
    st = engine.state
    composite = cfg.replace(bn_backend="composite")
    _, composite_apply = make_model(composite)
    variants = {"kernel": (cfg, engine.model_apply, False),
                "plain": (cfg, engine.model_apply, True),
                "composite": (composite, composite_apply, False)}
    logits = {}
    for name in ("kernel", "plain", "composite", "composite", "plain",
                 "kernel"):
        vcfg, apply_fn, plain = variants[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ad = adapt_task(vcfg, apply_fn, st.params, st.lslr, st.bn_state,
                        sx, sy, sw, num_steps=engine.num_adapt_steps,
                        plain=plain)
        lg = predict_tasks(vcfg, apply_fn, st.params, ad.fast, ad.bn_state,
                           qx, num_steps=engine.num_adapt_steps,
                           plain=plain)
        torch.cuda.synchronize()
        print(f"serve: one batch adapt+predict, {name} BN "
              f"(bn_backend={vcfg.bn_backend}, plain={plain}): "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms ({card})",
              flush=True)
        logits[name] = lg
    k, p = logits["kernel"], logits["plain"]
    cos, flips, tie = _logits_agreement(k, p)
    served = torch.from_numpy(np.stack([r.logits for r in responses[
        :cfg.serve_batch_tasks]]))
    print(f"serve: kernel vs plain logits cosine {cos:.6f}, max abs diff "
          f"{(k - p).abs().max().item():.3e} (max |logit| "
          f"{p.abs().max().item():.3e}); argmax flips {int(flips.sum())} "
          f"of {flips.numel()} rows, {int((flips & ~tie).sum())} outside "
          f"the {int(tie.sum())} near-tie rows; kernel vs composite cosine "
          f"{_cosine(k, logits['composite']):.6f}; engine vs rerun max abs "
          f"diff {(served - k[:len(group)].cpu()).abs().max().item():.3e}",
          flush=True)
    if cos < LOGITS_COSINE or bool((flips & ~tie).any()):
        raise AssertionError("kernel and plain-version logits disagree")
    # The serving above ran under the engine's own watchdog at the
    # config's serve_request deadline, and did not trip.
    dog = engine._watchdog
    if dog is None or dog.tripped is not None:
        raise AssertionError(f"serve: engine watchdog {dog} tripped "
                             f"{getattr(dog, 'tripped', None)}")
    print(f"serve: under the engine's watchdog (serve_request deadline "
          f"{dog.deadline_for('serve_request'):.0f} s, poll "
          f"{dog.poll_interval_s:.1f} s): no trip", flush=True)
    engine.close()


def _leaf_vectors(grads):
    """``{name: flat f32 tensor}`` over a ``{"params", "lslr"}`` tree."""
    return {f"{top}/{layer}/{leaf}": t.detach().float().flatten()
            for top in ("params", "lslr")
            for layer, sub in grads[top].items()
            for leaf, t in sub.items()}


# Floors of the kernel-vs-plain second-order meta-gradient comparison, in
# f32 (only the sum order and the BN backward's formulation differ): loss
# rel, whole-vector cosine, per-leaf cosine. Tightened from 1e-2 / 0.99 /
# 0.95 after the first chip runs read 4.0e-4 / 0.99992 / 0.9938 (NVIDIA
# H100 80GB HBM3, 700 W).
F32_FLOORS = (2e-3, 0.999, 0.98)
# In bf16 (the flagship's dtype) each floor lies between what sound bf16
# pairs read (the witnesses of train_flagship against the plain version
# and the kernel: loss rel up to 7.0e-3, whole cosine down to 0.9983,
# worst leaf 0.925) and what bf16 precision itself costs (plain bf16
# against plain f32: 1.08e-2, 0.9958, 0.865); bf16 readings repeat
# bitwise from run to run (NVIDIA H100 80GB HBM3, 700 W; PERF.md § 6).
BF16_FLOORS = (9e-3, 0.997, 0.90)


def _plain_f64_statistics(x, gamma, beta, eps: float, slope: float):
    """The plain version with mean and var summed in f64 and rounded once
    to f32: the same function with another rounding of the statistics."""
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    xd = x.double()
    mean = xd.mean(0)
    var = torch.clamp(xd.square().mean(0) - mean.square(), min=0.0).float()
    mean = mean.float()
    inv = torch.rsqrt(var + eps)
    scale = (inv * gamma).to(x.dtype)
    shift = (beta - mean * inv * gamma).to(x.dtype)
    return bn_act._act(x * scale + shift, slope), mean, var


@contextlib.contextmanager
def _swapped(module, name: str, fn):
    """``module.name`` replaced by ``fn`` for the block."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def _profiled(label: str, fn, card: str) -> dict:
    """Run ``fn`` once under the profiler: wall (synchronized), device
    time by the port's kernel families (``telemetry/profiler.py §
    FAMILIES``), idle share (1 − summed kernel time / wall); printed and
    returned. Read here, apart from the port's own sampler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from howtotrainyourmamlpytorch_tpu_torch.telemetry.profiler import (
        kernel_family as family)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fam_ms, fam_n = {}, {}  # ms and kernels per family
    for name, ms in _device_events(prof):
        f = family(name)
        fam_ms[f] = fam_ms.get(f, 0.0) + ms
        fam_n[f] = fam_n.get(f, 0) + 1
    device_ms = sum(fam_ms.values())
    by_family = {f: [round(v, 3), fam_n[f]]
                 for f, v in sorted(fam_ms.items(), key=lambda kv: -kv[1])}
    idle = max(0.0, 1 - device_ms / wall_ms)
    print(f"{label}: wall {wall_ms:.1f} ms under the profiler, device "
          f"{device_ms:.1f} ms, idle share {idle:.3f}; by family (ms, "
          f"kernels) {json.dumps(by_family)} ({card})", flush=True)
    return {"wall_ms": wall_ms, "device_ms": device_ms, "idle": idle,
            "by_family": by_family}


def _deterministic_cost(label: str, fn, card: str,
                        turns=("on", "off")) -> None:
    """Wall time of ``fn`` (synchronized) with cuDNN's deterministic
    algorithms on and off, in ``turns`` after one warm-up call of each,
    ``cudnn.benchmark`` off throughout (the trainer's policy against
    torch's default); printed."""
    import torch
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    ms = {"off": [], "on": []}
    try:
        cudnn.benchmark = False
        for turn in ("off", "on") + tuple(turns):
            cudnn.deterministic = turn == "on"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms[turn].append((time.perf_counter() - t0) * 1e3)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    on, off = (statistics.median(ms[k][1:]) for k in ("on", "off"))
    print(f"{label}: cudnn.deterministic on {on:.1f} ms, off {off:.1f} ms "
          f"(on/off {on / off:.3f}; medians after a warm-up, runs "
          f"{json.dumps({k: [round(x, 1) for x in v] for k, v in ms.items()})}"
          f") ({card})", flush=True)


def _print_sample(label: str, row: dict, card: str) -> None:
    """One ``perf_profile`` summary of the port's sampler, printed."""
    fams = {f: [round(s * 1e3, 3), row["per_family_kernels"][f]]
            for f, s in row["per_family_seconds"].items()}
    regions = {r: round(s * 1e3, 3)
               for r, s in row["per_region_seconds"].items()}
    mfu = row["mfu"]
    print(f"{label}: the port's sampler: wall "
          f"{row['wall_seconds'] * 1e3:.1f} ms, device (union) "
          f"{row['device_compute_seconds'] * 1e3:.1f} ms, compute / idle / "
          f"host gap {row['device_compute_frac']:.4f} / "
          f"{row['device_idle_frac']:.4f} / {row['dispatch_gap_frac']:.4f} "
          f"(idle share {1 - row['device_compute_frac']:.3f}); by family "
          f"(ms, kernels) {json.dumps(fams)}; by region (ms) "
          f"{json.dumps(regions)}; FLOPs {row['flops']}, MFU "
          f"{'n/a' if mfu is None else f'{mfu:.5f}'} against "
          f"{row['peak_flops']:.3g} FLOP/s ({row['peak_flops_source']}); "
          f"device records lost {row['device_records_lost']} ({card})",
          flush=True)


def _sample_window(fn, name: str) -> dict:
    """One window of the port's perf sampler around ``fn`` (one train
    step of phase card ``name``), with its FLOPs counted first; the
    summary row. Fails if the sampler counts an error."""
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import (
        MetricsRegistry)
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import profiler
    _, flops = profiler.count_flops(fn)
    reg = MetricsRegistry()
    sampler = profiler.PerfSampler(1, registry=reg, device="cuda")
    sampler.register_card(name, profiler.build_cost_card(
        name, flops=flops, kind=sampler.kind, peaks=sampler.peaks))
    if not sampler.start_window(0):
        raise AssertionError(f"{name}: the sampler did not start")
    try:
        fn()
    except BaseException:
        sampler.abort_window()
        raise
    row = sampler.end_window(0, executable=name)
    errors = reg.counter(profiler.ERRORS_COUNTER).value
    if row is None or errors:
        raise AssertionError(f"{name}: the sampler failed ({errors} "
                             f"errors)")
    return row


def _sampled(label: str, name: str, fn, card: str, bn_kernels: int) -> dict:
    """Run ``fn`` (one train step of phase card ``name``) under the port's
    own perf sampler, after counting the same call's FLOPs, as the
    trainer does with ``profile_every_n_steps``; printed and returned.
    Fails if the sampler counts an error, its fractions do not sum to 1,
    or it holds other than the step's ``bn_kernels`` BN-kernel records
    (it lost device records)."""
    row = _sample_window(fn, name)
    total = (row["device_compute_frac"] + row["device_idle_frac"]
             + row["dispatch_gap_frac"])
    if abs(total - 1) > 1e-6:
        raise AssertionError(f"{label}: fractions sum to {total}")
    _print_sample(label, row, card)
    got = row["per_family_kernels"].get("bn_act")
    if got != bn_kernels or row["device_records_lost"]:
        raise AssertionError(f"{label}: {got} bn_act records, the step "
                             f"launches {bn_kernels}; "
                             f"{row['device_records_lost']} lost")
    return row


def _dead_bias(name: str) -> bool:
    """Conv biases sit before a batch-statistics BN (every conv of the VGG
    and of ResNet-12, skips included): their meta-gradient, and their
    LSLR vectors', is analytically zero and holds noise only
    (docs/PARITY.md, the dead-bias degeneracy)."""
    return "conv" in name.split("/")[1] and name.endswith("/b")


def _compare_meta_gradients(label: str, a, b, floors, card: str,
                            what: str = "one second-order meta-gradient"):
    """Print loss, whole-vector and per-leaf cosines of two ``(loss,
    {leaf: vector})`` meta-gradients; returns the floors missed.
    ``floors`` is ``(loss rtol, whole cosine, leaf cosine)``, or None for
    a reading only. Dead biases are printed, never held."""
    (la, ga), (lb, gb) = a, b
    whole = _cosine(_cat(ga), _cat(gb))
    leaf_cos = {n: _cosine(ga[n], gb[n]) for n in ga
                if float(gb[n].abs().max()) > 0}
    held = {n: v for n, v in leaf_cos.items() if not _dead_bias(n)}
    worst = min((v, n) for n, v in held.items())
    rel = abs(la - lb) / abs(lb)
    print(f"train {label}, {what}: loss {la:.6f} "
          f"vs {lb:.6f} (rel {rel:.2e}), whole-vector cosine {whole:.6f}, "
          f"worst held leaf {worst[1]} {worst[0]:.6f}; leaves "
          f"{json.dumps({n: round(v, 6) for n, v in leaf_cos.items()})} "
          f"({card})", flush=True)
    if floors is None:
        return []
    loss_rtol, whole_cos, leaf_floor = floors
    out = []
    if rel > loss_rtol:
        out.append(f"{label}: loss rel {rel:.2e} > {loss_rtol}")
    if whole < whole_cos:
        out.append(f"{label}: whole cosine {whole:.6f} < {whole_cos}")
    out += [f"{label}: {n} cosine {v:.6f} < {leaf_floor}"
            for n, v in held.items() if v < leaf_floor]
    return out


def _cat(vectors: dict):
    import torch
    return torch.cat(list(vectors.values()))


def train_flagship(entry: dict, card: str) -> None:
    """Phase 4: flagship-width meta-training through the port's entry
    points; adds the BN kernel's training launches to ``entry``."""
    import numpy as np
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    from howtotrainyourmamlpytorch_tpu_torch.data import (
        MetaLearningDataLoader)
    from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
        init_train_state, make_eval_step, make_meta_gradients,
        make_train_step)
    from howtotrainyourmamlpytorch_tpu_torch.models import make_model
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.tree import tree_leaves

    cfg = MAMLConfig.from_json_file(FLAGSHIP).replace(bn_backend="pallas")
    model_init, apply = make_model(cfg)
    state = init_train_state(cfg, model_init, seed=cfg.seed, device="cuda")
    loader = MetaLearningDataLoader(cfg, device="cuda")
    train_step = make_train_step(cfg, apply)
    micro = cfg.effective_task_microbatches()
    s, k = cfg.num_stages, cfg.number_of_training_steps_per_iter
    print(f"train: {cfg.batch_size} tasks/step in {micro} microbatches, "
          f"K={k}, {cfg.compute_dtype}, bn_fast_math={cfg.bn_fast_math}, "
          f"clamp {cfg.clamp_meta_grad_value}, remat "
          f"{cfg.remat_inner_steps}/{cfg.remat_policy}, source "
          f"{loader.sampler('train').source.kind}", flush=True)

    batches = loader.get_train_batches(0, 2 * (TRAIN_STEPS + 1) + 1)
    launches = 0
    for epoch in (0, 41):
        so, msl = cfg.use_second_order(epoch), cfg.use_msl(epoch)
        # Every forward launches the kernel once per stage: K support
        # forwards, K target forwards under MSL (else 1), and remat
        # 'block_outs' recomputes each target forward once in the
        # backward (_forwards_per_chunk). Flagship: 12 x 4 x (5 + 5 x 2)
        # = 720 (first order + MSL), 12 x 4 x (5 + 1 x 2) = 336 (second
        # order).
        per_step = micro * s * _forwards_per_chunk(cfg, so, msl)
        torch.cuda.reset_peak_memory_stats()
        bn_act.reset_launches()
        times, metrics = [], []
        for i in range(TRAIN_STEPS + 1):
            batch = next(batches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, m = train_step(state, batch, epoch, second_order=so,
                                use_msl=msl)
            torch.cuda.synchronize()
            if i:
                times.append(time.perf_counter() - t0)
            if new.step != state.step + 1:
                raise AssertionError(f"step counter {state.step} -> "
                                     f"{new.step}")
            state = new
            metrics.append(m)
        got = bn_act.launches
        launches += got
        peak = torch.cuda.max_memory_allocated()
        want = per_step * (TRAIN_STEPS + 1)
        if got != want:
            raise AssertionError(
                f"epoch {epoch}: bn_act launched {got} times over "
                f"{TRAIN_STEPS + 1} steps, the path needs {want} "
                f"({per_step} per step)")
        for m in metrics:
            vals = [m.loss, m.accuracy, m.support_loss]
            if not all(bool(torch.isfinite(v)) for v in vals) or not (
                    np.isfinite(m.learning_rate)):
                raise AssertionError(f"epoch {epoch}: non-finite metrics "
                                     f"{m}")
        if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(
                {"p": state.params, "l": state.lslr, "b": state.bn_state})):
            raise AssertionError(f"epoch {epoch}: non-finite state")
        step_ms = statistics.median(times) * 1e3
        print(f"train epoch {epoch} (second_order={so}, msl={msl}): "
              f"{step_ms:.1f} ms/step (median of {len(times)}, "
              f"synchronized), {cfg.batch_size / (step_ms / 1e3):.2f} "
              f"tasks/s; losses {[round(float(m.loss), 4) for m in metrics]}"
              f", accuracy {[round(float(m.accuracy), 3) for m in metrics]}"
              f", lr {metrics[-1].learning_rate:.3e}; bn_act launches {got}"
              f" = {TRAIN_STEPS + 1} x {per_step}; max_memory_allocated "
              f"{peak / 2**30:.2f} GiB; step {state.step} ({card})",
              flush=True)
    spare = next(batches)
    batches.close()

    # One eval batch at the effective eval batch size: 24 tasks at once.
    eval_step = make_eval_step(cfg, apply)
    val = loader.get_val_batches()
    eval_batch = next(val)
    val.close()
    torch.cuda.reset_peak_memory_stats()
    bn_act.reset_launches()
    eval_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eval_step(state, eval_batch)
        torch.cuda.synchronize()
        eval_ms.append((time.perf_counter() - t0) * 1e3)
    got = bn_act.launches
    launches += got
    b = cfg.effective_eval_batch_size
    want = 2 * s * (cfg.number_of_evaluation_steps_per_iter + 1)
    if got != want:
        raise AssertionError(f"eval: bn_act launched {got} times, the path "
                             f"needs {want}")
    q, n = cfg.num_target_per_task, cfg.num_classes_per_set
    if (res.target_logits.shape != (b, q, n) or res.loss.shape != (b,)
            or not bool(torch.isfinite(res.target_logits).all())
            or not bool(torch.isfinite(res.loss).all())
            or not bool(((res.accuracy >= 0) & (res.accuracy <= 1)).all())):
        raise AssertionError(f"eval: logits {tuple(res.target_logits.shape)}"
                             f", loss {res.loss}")
    print(f"eval: {b} tasks in {eval_ms[0]:.1f} ms (first call), "
          f"{eval_ms[1]:.1f} ms (second), loss "
          f"{float(res.loss.mean()):.4f}, accuracy "
          f"{float(res.accuracy.mean()):.3f}; bn_act launches {got}; "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})",
          flush=True)
    entry["launches"] += launches

    # Variants of the BN function, each as (config, apply, plain, swap):
    # the kernel and its plain version in bf16 and f32, and two bf16
    # witnesses that change one thing each. "vjp witness" runs the plain
    # forward under the kernel's autograd.Function (the hand-written VJP,
    # f32 sums), so it differs from "plain bf16" in the BN backward only
    # and from "kernel bf16" in the statistics' sum order only; "f64
    # witness" is the plain version with its statistics summed in f64
    # (in bf16 and in f32).
    cfg32 = cfg.replace(compute_dtype="float32")
    _, apply32 = make_model(cfg32)
    variants = {
        "kernel bf16": (cfg, apply, False, None),
        "plain bf16": (cfg, apply, True, None),
        "vjp witness bf16": (cfg, apply, False,
                             ("_launch", bn_act.bn_act_plain)),
        "f64 witness bf16": (cfg, apply, True,
                             ("bn_act_plain", _plain_f64_statistics)),
        "kernel f32": (cfg32, apply32, False, None),
        "plain f32": (cfg32, apply32, True, None),
        "f64 witness f32": (cfg32, apply32, True,
                            ("bn_act_plain", _plain_f64_statistics))}

    def run(name, fn):
        vcfg, vapply, plain, swap = variants[name]
        with (_swapped(bn_act, *swap) if swap else contextlib.nullcontext()):
            return fn(vcfg, vapply, plain)

    # The eval batch with every variant but the vjp witness (no backward):
    # the kernel at every eval stage (25·hw² x 1152) through 5 adapt
    # steps. Those steps carry last-bit differences of the statistics to
    # a few % of the logit scale in bf16, and to ~1 % in f32, enough to
    # flip argmaxes outside the 2-ulp near-ties; so the cosine is held,
    # and the flips are read beside the f64 witnesses' and the control's.
    failures = []
    logits = {name: run(name, lambda c, a, plain: make_eval_step(c, a)(
        state, eval_batch, plain=plain).target_logits)
        for name in variants if name != "vjp witness bf16"}
    for a, b, floor in (("kernel bf16", "plain bf16", LOGITS_COSINE),
                        ("f64 witness bf16", "plain bf16", None),
                        ("kernel f32", "plain f32", EVAL_F32_COSINE),
                        ("f64 witness f32", "plain f32", None),
                        ("plain bf16", "plain f32", None)):
        cos, flips, tie = _logits_agreement(logits[a], logits[b])
        la, lb = logits[a].float(), logits[b].float()
        print(f"eval: {a} vs {b} logits cosine {cos:.7f}, max abs diff "
              f"{(la - lb).abs().max().item():.3e} (max |logit| "
              f"{lb.abs().max().item():.3e}); argmax flips "
              f"{int(flips.sum())} of {flips.numel()} rows, "
              f"{int((flips & ~tie).sum())} outside the {int(tie.sum())} "
              f"near-tie rows ({card})", flush=True)
        if floor is not None and cos < floor:
            failures.append(f"eval {a} vs {b}: cosine {cos:.7f} < {floor}")

    # The kernel against its plain version: one second-order
    # meta-gradient from the same state on the same batch, in bf16 and
    # f32, read beside the witnesses and the control "plain bf16 vs plain
    # f32" (what bf16 precision costs).
    grads = {}
    for name in variants:
        loss, _, _, _, g = run(name, lambda c, a, plain: make_meta_gradients(
            c, a)(state, spare, 41, second_order=True, use_msl=False,
                  plain=plain))
        grads[name] = (float(loss), _leaf_vectors(g))
    for a, b, floors in (("kernel f32", "plain f32", F32_FLOORS),
                         ("kernel bf16", "plain bf16", BF16_FLOORS),
                         ("vjp witness bf16", "plain bf16", None),
                         ("kernel bf16", "vjp witness bf16", None),
                         ("f64 witness bf16", "plain bf16", None),
                         ("f64 witness f32", "plain f32", None),
                         ("plain bf16", "plain f32", None),
                         ("kernel bf16", "plain f32", None)):
        failures += _compare_meta_gradients(f"{a} vs {b}", grads[a],
                                            grads[b], floors, card)

    # One profiled second-order step, split by kernel family.
    so_step = dict(second_order=True, use_msl=False)
    train_step(state, spare, 41, **so_step)
    torch.cuda.synchronize()
    _profiled("train profile, one second-order step",
              lambda: train_step(state, spare, 41, **so_step), card)
    _sampled("train profile, one second-order step", "train_so1_msl0",
             lambda: train_step(state, spare, 41, **so_step), card,
             bn_kernels=micro * s * _forwards_per_chunk(cfg, True, False))
    _deterministic_cost("train, one second-order step",
                        lambda: train_step(state, spare, 41, **so_step),
                        card, turns=("off", "on", "on", "off"))

    # Remat: one second-order step, timed and its peak memory, per
    # variant, in turns, its launches held to the derived count; then
    # each variant's f32 meta-gradient against 'block_outs' under the
    # trainer's numerics policy (deterministic cuDNN).
    launches, missed = _remat_variants("flagship", cfg, apply, state,
                                       spare, 41, so_step, card, F32_FLOORS)
    entry["launches"] += launches
    failures += missed

    # Batched MSL targets: one first-order MSL step under 'auto' and 'on'
    # on the same state and batch.
    launches, missed = _msl_batching("flagship", cfg, apply, state, spare,
                                     0, card, F32_FLOORS)
    entry["launches"] += launches
    failures += missed
    if failures:
        raise AssertionError("kernel and plain version disagree: "
                             + "; ".join(failures))


REMAT_VARIANTS = ("block_outs", "off", "nothing", "conv_outs", "dots")


def _remat_variants(label: str, cfg, apply, state, batch, epoch, phase,
                    card: str, floors):
    """One train step per remat variant (``REMAT_VARIANTS``), timed in
    turns with its peak memory, each launching the BN kernel as
    :func:`_forwards_per_chunk` derives; then every variant's f32
    meta-gradient against 'block_outs' under the trainer's numerics
    policy (TF32 off, deterministic cuDNN): bitwise equal is expected,
    ``floors`` gate it otherwise. Returns (launches, failures)."""
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.device import numerics_policy
    from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
        make_meta_gradients, make_train_step)
    from howtotrainyourmamlpytorch_tpu_torch.models import make_model
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import profiler

    def variant(c, name):
        return (c.replace(remat_inner_steps=False) if name == "off"
                else c.replace(remat_inner_steps=True, remat_policy=name))
    steps = {n: make_train_step(variant(cfg, n), apply)
             for n in REMAT_VARIANTS}
    want = {n: cfg.effective_task_microbatches() * _bn_per_forward(cfg)
            * _forwards_per_chunk(variant(cfg, n), **phase)
            for n in REMAT_VARIANTS}
    found = {n: ([], []) for n in REMAT_VARIANTS}
    launches, failures = 0, []
    for name in REMAT_VARIANTS + REMAT_VARIANTS[::-1]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bn_act.reset_launches()
        t0 = time.perf_counter()
        steps[name](state, batch, epoch, **phase)
        torch.cuda.synchronize()
        found[name][0].append((time.perf_counter() - t0) * 1e3)
        found[name][1].append(torch.cuda.max_memory_allocated() / 2**30)
        launches += bn_act.launches
        if bn_act.launches != want[name]:
            failures.append(f"{label} remat {name}: bn_act launched "
                            f"{bn_act.launches} times, derived {want[name]}")
    print(f"{label} remat, one {profiler.phase_card_name(**phase)} step: "
          + "; ".join(
        f"{n} {min(ms):.1f} ms (runs {[round(v, 1) for v in ms]}), peak "
        f"{max(gib):.2f} GiB, bn_act {want[n]} launches"
        for n, (ms, gib) in found.items()) + f" ({card})", flush=True)
    cfg32 = cfg.replace(compute_dtype="float32")
    _, apply32 = make_model(cfg32)
    grads = {}
    with numerics_policy("float32", deterministic=True):
        for name in REMAT_VARIANTS:
            loss, _, _, _, g = make_meta_gradients(
                variant(cfg32, name), apply32)(state, batch, epoch, **phase)
            grads[name] = (float(loss), _leaf_vectors(g))
    ref_loss, ref = grads["block_outs"]
    for name in REMAT_VARIANTS[1:]:
        loss, got = grads[name]
        bitwise = loss == ref_loss and all(
            torch.equal(got[n], ref[n]) for n in ref)
        diff = max(float((got[n] - ref[n]).abs().max()) for n in ref)
        print(f"{label} remat {name} vs block_outs, f32 meta-gradient "
              f"under deterministic cuDNN: bitwise {bitwise}, largest "
              f"difference {diff:.3e}, whole cosine "
              f"{_cosine(_cat(got), _cat(ref)):.9f} ({card})", flush=True)
        if not bitwise:
            failures += _compare_meta_gradients(
                f"{label} remat {name} vs block_outs f32", grads[name],
                grads["block_outs"], floors, card)
    return launches, failures


def _msl_batching(label: str, cfg, apply, state, batch, epoch, card: str,
                  floors, second_order: bool = False, sample: bool = True):
    """One MSL train step under ``msl_target_batching`` 'auto' and 'on' on
    the same state and batch: launches held to the derived counts, time
    (in turns), peak memory and, with ``sample``, the idle share of the
    port's sampler for each; then the meta-gradient 'on' against 'auto',
    in f32 held to ``floors`` (None: the step's dtype, read only).
    Returns (launches, failures)."""
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
        make_meta_gradients, make_train_step)
    from howtotrainyourmamlpytorch_tpu_torch.models import make_model
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import profiler

    phase = dict(second_order=second_order, use_msl=True)
    modes = ("auto", "on")
    cfgs = {m: cfg.replace(msl_target_batching=m) for m in modes}
    steps = {m: make_train_step(cfgs[m], apply) for m in modes}
    layers = _bn_per_forward(cfg)
    want = {m: cfg.effective_task_microbatches() * layers
            * _forwards_per_chunk(cfgs[m], **phase) for m in modes}
    ms = {m: [] for m in modes}
    peak = {m: 0.0 for m in modes}
    launches, failures = 0, []
    for m in modes + modes[::-1] + (modes if sample else ()):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bn_act.reset_launches()
        t0 = time.perf_counter()
        steps[m](state, batch, epoch, **phase)
        torch.cuda.synchronize()
        ms[m].append((time.perf_counter() - t0) * 1e3)
        peak[m] = max(peak[m], torch.cuda.max_memory_allocated() / 2**30)
        launches += bn_act.launches
        if bn_act.launches != want[m]:
            failures.append(f"{label} msl {m}: bn_act launched "
                            f"{bn_act.launches} times, derived {want[m]}")
    name = profiler.phase_card_name(**phase)
    idle = {m: float("nan") for m in modes}
    for m in modes if sample else ():
        row = _sample_window(lambda: steps[m](state, batch, epoch, **phase),
                             name)
        idle[m] = 1 - row["device_compute_frac"]
        _print_sample(f"{label} msl_target_batching={m!r}, one {name} step",
                      row, card)
    print(f"{label} msl_target_batching, one {name} step: " + "; ".join(
        f"{m!r} {statistics.median(ms[m][1:]):.1f} ms (median after a "
        f"warm-up, runs {[round(v, 1) for v in ms[m]]}), peak "
        f"{peak[m]:.2f} GiB, idle share {idle[m]:.4f}, bn_act {want[m]} "
        f"launches ({want[m] // cfg.effective_task_microbatches() // layers}"
        f" forwards per microbatch; {want[m] // layers} per BN layer)"
        for m in modes) + f" ({card})", flush=True)
    if floors is None:
        mcfgs, mapply = cfgs, apply
    else:
        c32 = cfg.replace(compute_dtype="float32")
        _, mapply = make_model(c32)
        mcfgs = {m: c32.replace(msl_target_batching=m) for m in modes}
    grads = {}
    for m in modes:
        bn_act.reset_launches()
        loss, _, _, _, g = make_meta_gradients(mcfgs[m], mapply)(
            state, batch, epoch, **phase)
        launches += bn_act.launches
        grads[m] = (float(loss), _leaf_vectors(g))
    dtype = mcfgs["on"].compute_dtype
    failures += _compare_meta_gradients(
        f"{label} msl 'on' vs 'auto' {dtype}", grads["on"], grads["auto"],
        floors, card, what=f"one {name} meta-gradient")
    return launches, failures


def _bn_per_forward(cfg) -> int:
    """BN-kernel launches of one forward: one per batch-norm layer on
    ``bn_backend='pallas'`` (the VGG's ``num_stages``, ResNet-12's 4
    blocks x (3 + the skip's)); none on the composite BN, layer norm or
    the MLP."""
    from howtotrainyourmamlpytorch_tpu_torch.models.resnet12 import (
        NORMS_PER_FORWARD)
    if cfg.bn_backend != "pallas" or cfg.backbone == "mlp":
        return 0
    return NORMS_PER_FORWARD if cfg.backbone == "resnet12" else (
        cfg.num_stages)


def _forwards_per_chunk(cfg, second_order: bool, use_msl: bool) -> int:
    """Forwards of one task microbatch of a train step (each launches
    every BN layer once), derived from the config alone:

    * support: K; 3K when a checkpoint segment is the whole inner step
      (second order under 'nothing', 'conv_outs' or 'dots'): the inner
      ``autograd.grad`` in the forward recomputes the support forward
      once, the outer backward the whole step once more;
    * targets under ``msl_target_batching='on'`` where it is exact (MSL,
      per-step BN statistics, batch norm): ONE forward over K·T
      instances, outside remat; else K under MSL (1 without), each
      recomputed once in the outer backward by 'block_outs', by the
      other policies' segments (a target forward under first order, the
      step under second order), except the final target forward after
      second-order step segments."""
    k = cfg.number_of_training_steps_per_iter
    policy = cfg.remat_policy if cfg.remat_inner_steps else None
    step_segment = second_order and policy in ("nothing", "conv_outs",
                                               "dots")
    support = 3 * k if step_segment else k
    if (use_msl and cfg.msl_target_batching == "on"
            and cfg.per_step_bn_statistics
            and cfg.norm_layer == "batch_norm"):
        return support + 1
    if use_msl:
        return support + k * (2 if policy else 1)
    return support + (2 if policy and not step_segment else 1)


def _train_path_launches(cfg, epochs, iters, val_sweeps,
                         test_models) -> int:
    """BN-kernel launches a builder run makes: per train step, microbatches
    x BN layers x :func:`_forwards_per_chunk`; per eval batch, BN layers x
    (eval steps + 1); the batches of a sweep pad the evaluation tasks up
    to a full last batch. ``iters`` is the steps of each of epochs ``0 ..
    epochs-1``, or a ``{epoch: steps}`` dict for a run that did not train
    every epoch alike (a rewind, a resume)."""
    s = _bn_per_forward(cfg)
    micro = cfg.effective_task_microbatches()
    steps = (iters if isinstance(iters, dict)
             else {e: iters for e in range(epochs)})
    train = sum(n * micro * s * _forwards_per_chunk(
        cfg, cfg.use_second_order(e), cfg.use_msl(e))
        for e, n in steps.items())
    batches = -(-cfg.num_evaluation_tasks // cfg.effective_eval_batch_size)
    per_sweep = batches * s * (cfg.number_of_evaluation_steps_per_iter + 1)
    return train + (val_sweeps + test_models) * per_sweep


def _state_leaves(state) -> dict:
    """``{name: tensor}`` over params, LSLR, BN state and Adam's moments."""
    trees = {"params": state.params, "lslr": state.lslr,
             "bn_state": state.bn_state, "mu": state.opt_state.mu,
             "nu": state.opt_state.nu}
    out = {}

    def walk(prefix, tree):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(f"{prefix}/{key}", value)
            else:
                out[f"{prefix}/{key}"] = value
    walk("", trees)
    return out


def _cli_run(argv, root, config=FLAGSHIP, base_args=CLI_ARGS):
    """One in-process CLI run of ``config`` with ``base_args + argv``;
    returns (exit code, builder, seconds)."""
    import torch
    from howtotrainyourmamlpytorch_tpu_torch import train_maml_system
    builders = []
    t0 = time.perf_counter()
    rc = train_maml_system.main(
        ["--name_of_args_json_file", config, "--experiment_root", root]
        + base_args + argv, builders=builders)
    torch.cuda.synchronize()
    return rc, builders[0], time.perf_counter() - t0


def _verify_run(tag: str, builder, n_epochs: int, n_models: int,
                n_episodes: int):
    """What a finished builder run leaves, checked: one finite CSV row per
    epoch, a finite ``test_summary.csv`` of ``n_models`` over
    ``n_episodes``, every epoch's checkpoint and ``latest`` (committed
    manifest records whose CRCs verify), ``state.json``, ``REGISTRY.json``
    when the run publishes, and checkpoints that load back, the last
    epoch's and ``latest`` bitwise into the state the builder holds.
    Returns the two CSVs and the events' timings."""
    import numpy as np
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.ckpt.manifest import (
        COMMITTED, Manifest, verify_record)
    from howtotrainyourmamlpytorch_tpu_torch.utils.checkpoint import (
        LATEST, CheckpointManager)
    from howtotrainyourmamlpytorch_tpu_torch.utils.storage import (
        load_statistics)
    from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import read_jsonl

    logs, models = builder.paths["logs"], builder.paths["saved_models"]
    stats = load_statistics(logs)
    test = load_statistics(logs, "test_summary.csv")
    epochs = [str(e) for e in range(n_epochs)]
    if stats["epoch"] != epochs or not all(
            np.isfinite(float(v)) for col in stats.values() for v in col):
        raise AssertionError(f"{tag}: summary_statistics.csv {stats}")
    if (test["num_models"] != [str(n_models)]
            or test["num_episodes"] != [str(n_episodes)]
            or not all(np.isfinite(float(v)) for k, col in test.items()
                       if k != "per_model_accuracy" for v in col)):
        raise AssertionError(f"{tag}: test_summary.csv {test}")
    tags = epochs + [LATEST]
    need = ({f"train_model_{t}.ckpt" for t in tags}
            | {"state.json", "MANIFEST.json"}
            | ({"REGISTRY.json"} if builder.cfg.ckpt_publish else set()))
    if not need <= set(os.listdir(models)):
        raise AssertionError(f"{tag}: {sorted(os.listdir(models))}")
    records = Manifest(models).records
    if (set(records) != set(tags)
            or any(r["status"] != COMMITTED for r in records.values())
            or not all(verify_record(models, r)["ok"]
                       for r in records.values())):
        raise AssertionError(f"{tag}: manifest {records}")
    mgr = CheckpointManager(models, quarantine=False)
    for t in tags:
        loaded, _ = mgr.load(builder.state, t if t == LATEST else int(t))
        if t not in (epochs[-1], LATEST):
            continue
        held, got = _state_leaves(builder.state), _state_leaves(loaded)
        if not all(torch.equal(held[n], got[n]) for n in held) or (
                loaded.step != builder.state.step):
            raise AssertionError(f"{tag}: checkpoint {t} does not reload "
                                 f"bitwise")
    rows = read_jsonl(os.path.join(logs, "events.jsonl"))
    events = {
        "checkpoint_bytes": [r["bytes"] for r in rows
                             if r["event"] == "checkpoint"],
        "save_ms": [round(r["seconds"] * 1e3, 1) for r in rows
                    if r["event"] == "checkpoint"],
        "val_ms": [round(r["seconds"] * 1e3, 1) for r in rows
                   if r["event"] == "validation"],
        "test_ms": [round(r["seconds"] * 1e3, 1) for r in rows
                    if r["event"] == "test_protocol"]}
    return stats, test, events


def cli_flagship(entry: dict, card: str) -> dict:
    """Phase 5: the trainer's CLI at flagship width; adds the BN kernel's
    launches over the uninterrupted run to ``entry``. Returns that run's
    final state leaves (on the host), epoch seconds and launches, which
    phase 7 holds its telemetry run against."""
    import shutil
    import tempfile
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
        init_train_state)
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.utils.storage import (
        load_statistics)

    runs_dir = os.path.join(REPO, ".smoke_runs")
    os.makedirs(runs_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="cli_", dir=runs_dir)
    try:
        bn_act.reset_launches()
        rc, builder, run_s = _cli_run([], os.path.join(tmp, "full"))
        launches = bn_act.launches
        cfg = builder.cfg
        if rc != 0:
            raise AssertionError(f"cli: exit code {rc}")
        want = _train_path_launches(cfg, cfg.total_epochs,
                                    cfg.total_iter_per_epoch,
                                    val_sweeps=cfg.total_epochs,
                                    test_models=cfg.max_models_to_save)
        if launches != want or want != 3360:
            raise AssertionError(f"cli: bn_act launched {launches} times, "
                                 f"the path needs {want} (3360 expected)")
        stats, test, events = _verify_run("cli", builder, 2, 2, 48)
        per_epoch = {k: [round(float(v), 2) for v in stats[k]]
                     for k in ("epoch_seconds", "meta_tasks_per_sec")}
        print(f"cli: exit 0 in {run_s:.1f} s; epoch seconds "
              f"{per_epoch['epoch_seconds']}, tasks/s "
              f"{per_epoch['meta_tasks_per_sec']} (CSV; epoch 0 first order"
              f" + MSL, epoch 1 second order); "
              f"train loss {stats['train_loss']}, val accuracy "
              f"{stats['val_accuracy']}; test {test['test_accuracy_mean']} "
              f"over {test['num_episodes']} episodes, {test['num_models']} "
              f"models; bn_act launches {launches} = {want}; cudnn "
              f"deterministic {torch.backends.cudnn.deterministic} after "
              f"the run (the entry point's policy restores it) ({card})",
              flush=True)
        print(f"cli: checkpoint bytes {events['checkpoint_bytes']}, save ms "
              f"{events['save_ms']}; validation sweep ms {events['val_ms']} "
              f"(the first caches the episodes on the card); test protocol "
              f"ms {events['test_ms']} (2 models x 48 episodes) ({card})",
              flush=True)
        entry["launches"] += launches

        # Paused after epoch 0, then resumed: held against the run above.
        pause_root = os.path.join(tmp, "paused")
        rc, paused, _ = _cli_run(["--total_epochs_before_pause", "1"],
                                 pause_root)
        if rc != 0 or paused.current_iter != cfg.total_iter_per_epoch:
            raise AssertionError(f"cli pause: exit {rc} at iter "
                                 f"{paused.current_iter}")
        del paused
        rc, resumed, _ = _cli_run(["--continue_from_epoch", "latest"],
                                  pause_root)
        if rc != 0 or resumed.current_iter != builder.current_iter:
            raise AssertionError(f"cli resume: exit {rc} at iter "
                                 f"{resumed.current_iter}")
        init = init_train_state(cfg, builder.model_init, seed=cfg.seed,
                                device="cuda")
        start = _state_leaves(init)
        a, b = _state_leaves(builder.state), _state_leaves(resumed.state)
        bitwise = all(torch.equal(a[n], b[n]) for n in a)
        max_diff = max(float((a[n] - b[n]).abs().max()) for n in a)
        cosines = {n: _cosine(a[n] - start[n], b[n] - start[n])
                   for n in a if n.startswith("/params/")
                   and not (n.split("/")[2].startswith("conv")
                            and n.endswith("/b"))}
        worst = min((v, n) for n, v in cosines.items())
        loss_a = float(stats["train_loss"][1])
        loss_b = float(load_statistics(resumed.paths["logs"])[
            "train_loss"][1])
        rel = abs(loss_a - loss_b) / abs(loss_a)
        print(f"cli pause + resume vs uninterrupted: bitwise {bitwise}, max "
              f"abs diff {max_diff:.3e}, worst update cosine {worst[1]} "
              f"{worst[0]:.7f}, epoch-1 train loss {loss_b} vs {loss_a} "
              f"(rel {rel:.2e}) ({card})", flush=True)
        if worst[0] < RESUME_COSINE or rel > RESUME_LOSS_RTOL:
            raise AssertionError("cli: the resumed run disagrees with the "
                                 "uninterrupted one")
        # Phase 9 serves this run's checkpoints: kept beside the runs.
        kept = tempfile.mkdtemp(prefix="serve_src_", dir=runs_dir)
        shutil.copytree(builder.paths["saved_models"],
                        os.path.join(kept, "saved_models"))
        return {"leaves": {n: t.cpu() for n, t in a.items()},
                "step": builder.state.step, "launches": launches,
                "epoch_seconds": per_epoch["epoch_seconds"],
                "saved_models": os.path.join(kept, "saved_models")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


# Floors of the kernel-vs-plain f32 second-order meta-gradient through
# ResNet-12 (loss rel, whole-vector cosine, per-leaf cosine), set from the
# chip readings on the run's 8 tasks: f32 kernel vs plain 2.29e-4-3.63e-4
# / 0.999310-0.999330 / 0.997724-0.998553, bf16 kernel vs plain 2.18e-2 /
# 0.987565 / 0.806, plain bf16 vs plain f32 (the control) 6.3e-3 / 0.948
# / 0.770 (NVIDIA H100 80GB HBM3, 700 W; PERF.md § 6).
R12_F32_FLOORS = (2e-3, 0.998, 0.99)
# Floor of the cosine between the kernel's and the plain version's served
# ResNet-12 logits (bf16): read 0.999687, the control plain bf16 vs plain
# f32 0.997132 (same card).
R12_SERVE_COSINE = 0.999


def _r12_serve(cfg, state, card: str):
    """Phase 6 (d): 8 uint8 requests through ``ServingEngine`` on the
    ResNet-12 state, launches held to the path (16 BN x K per adapt
    batch, 16 per predict batch); then the batch again with the plain
    version, the logits compared. Returns (launches, failures)."""
    import numpy as np
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.models import make_model
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.serve import (
        FewShotRequest, ServingEngine, pad_group)
    from howtotrainyourmamlpytorch_tpu_torch.serve.adapt import (
        adapt_task, predict_tasks)

    cfg = cfg.replace(serve_default_deadline_ms=0.0)
    engine = ServingEngine(cfg, state, device="cuda")
    engine.warmup()
    h, w, c = cfg.image_shape
    n, k = cfg.num_classes_per_set, cfg.num_samples_per_class
    q = cfg.num_target_per_task
    rng = np.random.default_rng(cfg.seed)
    requests = [FewShotRequest(
        support_x=rng.integers(0, 256, (n * k, h, w, c), dtype=np.uint8),
        support_y=np.repeat(np.arange(n, dtype=np.int32), k),
        query_x=rng.integers(0, 256, (q, h, w, c), dtype=np.uint8))
        for _ in range(cfg.serve_batch_tasks)]
    torch.cuda.reset_peak_memory_stats()
    bn_act.reset_launches()
    t0 = time.perf_counter()
    for req in requests:
        engine.submit(req)
    responses = engine.drain()
    serve_s = time.perf_counter() - t0
    launches = bn_act.launches
    norms = _bn_per_forward(cfg)
    want = (norms * engine.num_adapt_steps * engine.adapt_invocations
            + norms * engine.predict_invocations)
    if launches != want:
        raise AssertionError(f"resnet12 serve: bn_act launched {launches} "
                             f"times, the path needs {want}")
    for resp in responses:
        if (resp.status != "ok" or resp.logits.shape != (q, n)
                or not np.isfinite(resp.logits).all()):
            raise AssertionError(f"resnet12 serve: request "
                                 f"{resp.request_id} {resp.status} "
                                 f"{resp.error}")
    print(f"resnet12 serve: {len(requests)} requests in {serve_s:.3f} s; "
          f"adapt {statistics.median(engine.adapt_seconds) * 1e3:.2f} ms, "
          f"predict {statistics.median(engine.predict_seconds) * 1e3:.2f} "
          f"ms per batch; bn_act launches {launches} = {norms} x "
          f"{engine.num_adapt_steps} x {engine.adapt_invocations} + {norms}"
          f" x {engine.predict_invocations}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})",
          flush=True)
    batch = pad_group(requests, engine.batcher.buckets[0],
                      cfg.serve_batch_tasks, cfg.image_shape)
    dev = torch.device("cuda")
    sx = torch.from_numpy(batch["support_x"]).to(dev)
    sy = torch.from_numpy(batch["support_y"]).to(dev, torch.long)
    sw = torch.from_numpy(batch["support_w"]).to(dev)
    qx = torch.from_numpy(batch["query_x"]).to(dev)
    st = engine.state
    cfg32 = cfg.replace(compute_dtype="float32")
    _, apply32 = make_model(cfg32)
    logits = {}
    # The kernel and its plain version in bf16, and the control: the
    # plain version in f32 (what bf16 precision itself costs).
    for name, vcfg, vapply, plain in (
            ("kernel", cfg, engine.model_apply, False),
            ("plain", cfg, engine.model_apply, True),
            ("plain f32", cfg32, apply32, True)):
        ad = adapt_task(vcfg, vapply, st.params, st.lslr, st.bn_state, sx,
                        sy, sw, num_steps=engine.num_adapt_steps,
                        plain=plain)
        logits[name] = predict_tasks(vcfg, vapply, st.params, ad.fast,
                                     ad.bn_state, qx,
                                     num_steps=engine.num_adapt_steps,
                                     plain=plain)
    served = torch.from_numpy(np.stack([r.logits for r in sorted(
        responses, key=lambda r: r.request_id)]))
    print(f"resnet12 serve: engine vs rerun max abs diff "
          f"{(served - logits['kernel'].cpu()).abs().max().item():.3e}",
          flush=True)
    for a, b in (("kernel", "plain"), ("plain", "plain f32")):
        c, flips, tie = _logits_agreement(logits[a], logits[b])
        print(f"resnet12 serve: {a} vs {b} logits cosine {c:.6f}; argmax "
              f"flips {int(flips.sum())} of {flips.numel()} rows, "
              f"{int((flips & ~tie).sum())} outside the {int(tie.sum())} "
              f"near-tie rows ({card})", flush=True)
    cos = _logits_agreement(logits["kernel"], logits["plain"])[0]
    engine.close()
    failures = []
    if cos < R12_SERVE_COSINE:
        failures.append(f"resnet12 serve: kernel vs plain logits cosine "
                        f"{cos:.6f} < {R12_SERVE_COSINE}")
    return launches, failures


def _small_cli(tag: str, config: str, args, root: str, card: str,
               n_episodes: int):
    """Phase 6 (e), (f): a one-epoch CLI run of ``config`` that runs no BN
    kernel (its launches must stay 0), checked by :func:`_verify_run`.
    Returns its test summary."""
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    bn_act.reset_launches()
    rc, builder, run_s = _cli_run(args, root, config=config, base_args=[])
    if rc != 0 or bn_act.launches != 0:
        raise AssertionError(f"{tag}: exit {rc}, bn_act launches "
                             f"{bn_act.launches} (want 0)")
    stats, test, events = _verify_run(tag, builder, 1, 1, n_episodes)
    cfg = builder.cfg
    print(f"{tag}: exit 0 in {run_s:.1f} s ({cfg.backbone}, norm "
          f"{cfg.norm_layer}, bn_backend {cfg.bn_backend}, "
          f"{cfg.batch_size} tasks/step, {cfg.compute_dtype}); epoch "
          f"seconds {stats['epoch_seconds']}, tasks/s "
          f"{stats['meta_tasks_per_sec']}; train loss {stats['train_loss']}"
          f", val {stats['val_loss']}; test "
          f"{ {k: v for k, v in test.items() if k != 'per_model_accuracy'} }"
          f"; validation ms {events['val_ms']}, test ms {events['test_ms']};"
          f" checkpoints reload bitwise; bn_act launches 0 ({card})",
          flush=True)
    return test


def other_backbones(entry: dict, card: str) -> None:
    """Phase 6: the other backbones at full width. (a) The CLI on the
    ResNet-12 pod JSON mapped onto one card (``R12_CLI_ARGS``), with
    exactly the derived BN-kernel launches; (c) on its state, timed and
    profiled second-order steps and eval batches; (b) the kernel against
    its plain version in one f32 second-order meta-gradient, beside the
    bf16-vs-f32 control; (d) serving; (e) the sinusoid JSON (MLP,
    regression) and (f) the omniglot JSON with layer norm through the
    CLI; (g) one second-order MSL step under ``msl_target_batching``
    'auto' and 'on'. Adds the launches of (a), (c), (d), (g) to
    ``entry``."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.data import (
        MetaLearningDataLoader)
    from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
        make_meta_gradients)
    from howtotrainyourmamlpytorch_tpu_torch.models import make_model
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act

    runs_dir = os.path.join(REPO, ".smoke_runs")
    os.makedirs(runs_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="backbones_", dir=runs_dir)
    failures = []
    marks = [("start", time.perf_counter())]
    try:
        # (a) the CLI on the pod JSON.
        bn_act.reset_launches()
        rc, builder, run_s = _cli_run([], os.path.join(tmp, "resnet12"),
                                      config=RESNET12,
                                      base_args=R12_CLI_ARGS)
        launches = bn_act.launches
        cfg = builder.cfg
        if rc != 0:
            raise AssertionError(f"resnet12 cli: exit code {rc}")
        want = _train_path_launches(cfg, cfg.total_epochs,
                                    cfg.total_iter_per_epoch,
                                    val_sweeps=cfg.total_epochs,
                                    test_models=cfg.max_models_to_save)
        if launches != want or want != R12_CLI_LAUNCHES:
            raise AssertionError(
                f"resnet12 cli: bn_act launched {launches} times, the path "
                f"needs {want} ({R12_CLI_LAUNCHES} expected)")
        stats, test, events = _verify_run("resnet12 cli", builder, 1, 1,
                                          cfg.num_evaluation_tasks)
        entry["launches"] += launches
        print(f"resnet12 cli: exit 0 in {run_s:.1f} s ({cfg.backbone} "
              f"widths {cfg.cnn_num_filters}x(1, 2.5, 5, 10), "
              f"{cfg.image_shape}, {cfg.batch_size} tasks/step in "
              f"{cfg.effective_task_microbatches()} microbatches, "
              f"second order {cfg.use_second_order(0)}, MSL "
              f"{cfg.use_msl(0)}, {cfg.compute_dtype}, remat "
              f"{cfg.remat_policy}); epoch seconds {stats['epoch_seconds']},"
              f" tasks/s {stats['meta_tasks_per_sec']}; train loss "
              f"{stats['train_loss']}, val accuracy {stats['val_accuracy']};"
              f" test {test['test_accuracy_mean']} over "
              f"{test['num_episodes']} episodes; validation sweep ms "
              f"{events['val_ms']}, test protocol ms {events['test_ms']}, "
              f"checkpoint bytes {events['checkpoint_bytes']} saved in "
              f"{events['save_ms']} ms; bn_act launches {launches} = {want} "
              f"({card})", flush=True)

        marks.append(("a", time.perf_counter()))

        # (c) steps and eval batches on the run's state, timed; one step
        # profiled.
        state, apply = builder.state, builder.model_apply
        loader = MetaLearningDataLoader(cfg, device="cuda")
        batches = loader.get_train_batches(
            cfg.total_epochs * cfg.total_iter_per_epoch, 5)
        phase = dict(second_order=cfg.use_second_order(0),
                     use_msl=cfg.use_msl(0))
        per_step = _train_path_launches(cfg, 1, 1, 0, 0)
        torch.cuda.reset_peak_memory_stats()
        bn_act.reset_launches()
        times = []
        for i in range(3):
            batch = next(batches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = builder.train_step(state, batch, 0, **phase)
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
            if not bool(torch.isfinite(m.loss)):
                raise AssertionError(f"resnet12 step: loss {m.loss}")
        if bn_act.launches != 3 * per_step:
            raise AssertionError(f"resnet12 step: bn_act launched "
                                 f"{bn_act.launches} times, want 3 x "
                                 f"{per_step}")
        entry["launches"] += bn_act.launches
        step_ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated()
        print(f"resnet12 train: {step_ms:.1f} ms per second-order MSL step "
              f"(median of {times}), {cfg.batch_size / step_ms * 1e3:.2f} "
              f"tasks/s, max_memory_allocated {peak / 2**30:.2f} GiB; "
              f"bn_act {per_step} launches per step ({card})", flush=True)
        batch = next(batches)
        _profiled("resnet12 train profile, one second-order MSL step",
                  lambda: builder.train_step(state, batch, 0, **phase), card)
        _sampled("resnet12 train profile, one second-order MSL step",
                 "train_so1_msl1",
                 lambda: builder.train_step(state, batch, 0, **phase), card,
                 bn_kernels=per_step)
        _deterministic_cost(
            "resnet12 train, one second-order MSL step",
            lambda: builder.train_step(state, batch, 0, **phase), card)
        val = loader.get_val_batches()
        eval_batch = next(val)
        val.close()
        torch.cuda.reset_peak_memory_stats()
        bn_act.reset_launches()
        eval_ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = builder.eval_step(state, eval_batch)
            torch.cuda.synchronize()
            eval_ms.append((time.perf_counter() - t0) * 1e3)
        want = 2 * _bn_per_forward(cfg) * (
            cfg.number_of_evaluation_steps_per_iter + 1)
        if bn_act.launches != want or not bool(
                torch.isfinite(res.target_logits).all()):
            raise AssertionError(f"resnet12 eval: bn_act launched "
                                 f"{bn_act.launches} times (want {want})")
        entry["launches"] += bn_act.launches
        print(f"resnet12 eval: {res.loss.shape[0]} tasks in "
              f"{eval_ms[0]:.1f} ms (first call), {eval_ms[1]:.1f} ms "
              f"(second); accuracy {float(res.accuracy.mean()):.3f}; "
              f"max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; bn_act "
              f"launches {want} ({card})", flush=True)

        marks.append(("c", time.perf_counter()))

        # (b) the kernel against its plain version: one second-order
        # meta-gradient on the run's state, f32 held, bf16 and the control
        # (plain bf16 vs plain f32) read.
        spare = next(batches)
        batches.close()
        cfg32 = cfg.replace(compute_dtype="float32")
        _, apply32 = make_model(cfg32)
        grads = {}
        for name, vcfg, vapply, plain in (
                ("kernel f32", cfg32, apply32, False),
                ("plain f32", cfg32, apply32, True),
                ("kernel bf16", cfg, apply, False),
                ("plain bf16", cfg, apply, True)):
            loss, _, _, _, g = make_meta_gradients(vcfg, vapply)(
                state, spare, 0, second_order=True, use_msl=False,
                plain=plain)
            grads[name] = (float(loss), _leaf_vectors(g))
            del g
        for a, b, floors in (("kernel f32", "plain f32", R12_F32_FLOORS),
                             ("kernel bf16", "plain bf16", None),
                             ("plain bf16", "plain f32", None)):
            failures += _compare_meta_gradients(f"resnet12 {a} vs {b}",
                                                grads[a], grads[b], floors,
                                                card)
        del grads

        marks.append(("b", time.perf_counter()))

        # (g) batched MSL targets: one second-order MSL step under 'auto'
        # and 'on' on the run's state (launches, time, peak memory; the
        # bf16 meta-gradients' cosine read).
        launches, missed = _msl_batching(
            "resnet12", cfg, apply, state, spare, 0, card, None,
            second_order=True, sample=False)
        entry["launches"] += launches
        failures += missed
        marks.append(("g", time.perf_counter()))

        # (d) serving the run's state.
        launches, missed = _r12_serve(cfg, state, card)
        entry["launches"] += launches
        failures += missed
        del builder, state
        torch.cuda.empty_cache()

        marks.append(("d", time.perf_counter()))

        # (e) the sinusoid workload, (f) layer norm: the CLI, no BN kernel.
        test = _small_cli("sinusoid cli", SINUSOID, SINUSOID_ARGS,
                          os.path.join(tmp, "sinusoid"), card, 48)
        mse = float(test["test_mse_mean"][0])
        if not (np.isfinite(mse) and mse > 0):
            raise AssertionError(f"sinusoid cli: test_mse_mean {mse}")
        _small_cli("layer-norm cli", OMNIGLOT, LAYER_NORM_ARGS,
                   os.path.join(tmp, "layer_norm"), card, 32)
        marks.append(("e, f", time.perf_counter()))
        print("phase 6 seconds per part: " + json.dumps(
            {name: round(t - marks[i][1], 1)
             for i, (name, t) in enumerate(marks[1:])}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("phase 6: " + "; ".join(failures))


# Phase 7: phase 5's CLI run with the telemetry plane on. Health every
# step (at a dispatch sync every step), a perf sample every 2 steps, a
# device trace of epoch 1's first step and two alert rules: one that
# must fire (every epoch reports a train loss above 0) and one that must
# not (no perf sample fails).
TELEMETRY_ARGS = ["--dispatch_sync_every", "1",
                  "--health_metrics_every_n_steps", "1",
                  "--profile_every_n_steps", "2", "--profile_epoch", "1",
                  "--profile_num_steps", "1"]
ALERT_RULES = {"rules": [
    {"name": "train_loss_reported", "type": "threshold",
     "metric": "train/train_loss", "op": ">", "value": 0.0,
     "severity": "info"},
    {"name": "perf_sample_failed", "type": "threshold",
     "metric": "perf/errors", "op": ">", "value": 0.0,
     "severity": "critical"}]}


def _expected_regions(name: str) -> set:
    """The labels a train step of phase card ``name`` runs kernels under."""
    msl = name.endswith("msl1")
    return {"episode_normalize", "task_adapt", "inner_support_forward",
            "inner_support_grad", "inner_lslr_update", "meta_update",
            "inner_msl_target_forward" if msl else "final_target_forward"}


def _check_perf_row(r: dict, bn_per_step) -> None:
    """One ``perf_profile`` row that lost no device records: fractions
    summing to 1, every label of its step, the step's BN-kernel records
    and an MFU in (0, 1]."""
    total = (r["device_compute_frac"] + r["device_idle_frac"]
             + r["dispatch_gap_frac"])
    missing = _expected_regions(r["top_executable"]) - set(
        r["per_region_seconds"])
    bn = r["per_family_kernels"].get("bn_act")
    if (abs(total - 1) > 1e-6 or bn != bn_per_step(r["top_executable"])
            or missing or r["device_records_lost"] or r["mfu"] is None
            or not 0 < r["mfu"] <= 1):
        raise AssertionError(f"telemetry: perf row (fractions sum "
                             f"{total}, regions missing {missing}) {r}")


def _check_telemetry_rows(rows, n_epochs: int, n_steps: int,
                          bn_per_step) -> list:
    """Phase 7's checks of a run's ``events.jsonl``; returns the
    ``perf_profile`` rows. ``bn_per_step(name)`` is the BN-kernel
    launches of one step of phase card ``name``: a sample holds them all
    unless it lost device records. A row whose ``device_records_lost``
    is not 0 is left to the caller, which takes that window again."""
    import math
    tele = [r for r in rows if r["event"] == "telemetry"]
    beats = [r for r in rows if r["event"] == "heartbeat"]
    if [r["epoch"] for r in tele] != list(range(n_epochs)) or (
            [r["epoch"] for r in beats] != list(range(n_epochs))):
        raise AssertionError(f"telemetry: {len(tele)} telemetry and "
                             f"{len(beats)} heartbeat rows for {n_epochs} "
                             f"epochs")
    for r in tele:
        frac = r["feed_stall_frac"]
        if frac is None or not 0.0 <= frac <= 1.0 or not r["memory"]:
            raise AssertionError(f"telemetry row {r}")
    health = [r for r in rows if r["event"] == "health"]
    if [r["iter"] for r in health] != list(range(1, n_steps + 1)):
        raise AssertionError(f"telemetry: health rows at iterations "
                             f"{[r['iter'] for r in health]}")
    for r in health:
        values = [v for k, v in r.items() if k not in ("ts", "event")]
        flat = [x for v in values
                for x in (v if isinstance(v, list) else [v])]
        if not all(isinstance(x, (int, float)) and math.isfinite(x)
                   for x in flat):
            raise AssertionError(f"telemetry: non-finite health row {r}")
    perf = [r for r in rows if r["event"] == "perf_profile"]
    if not perf:
        raise AssertionError("telemetry: no perf_profile row")
    for r in perf:
        if not r["device_records_lost"]:
            _check_perf_row(r, bn_per_step)
    return perf


def _parse_prometheus(path: str) -> dict:
    """``{name: value}`` of a Prometheus text file; raises on a line that
    is neither a comment nor ``name value``."""
    out = {}
    for line in open(path).read().splitlines():
        if not line or line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        out[name] = float(value)
    return out


def cli_telemetry(entry: dict, card: str, ref: dict) -> None:
    """Phase 7: phase 5's CLI run with the telemetry plane on
    (``TELEMETRY_ARGS``, a device trace, ``ALERT_RULES``): a ``telemetry``
    and a ``heartbeat`` row per epoch, a finite ``health`` row per step,
    ``perf_profile`` rows whose fractions sum to 1 with the BN kernel's
    family, the step's labels and an MFU in (0, 1], no sampler error, a
    ``metrics.prom`` that parses, a ``trace.json`` that validates, the
    Chrome trace, exactly one firing alert, the derived BN-kernel
    launches, and final weights and Adam state bitwise phase 5's. Then
    what health and a sample window add to a step, and what the labels
    cost with the profiler off. Adds the run's launches to ``entry``."""
    import shutil
    import tempfile
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.data import (
        MetaLearningDataLoader)
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import profiler
    from howtotrainyourmamlpytorch_tpu_torch.telemetry.trace import (
        validate_trace)
    from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import read_jsonl

    runs_dir = os.path.join(REPO, ".smoke_runs")
    os.makedirs(runs_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="telemetry_", dir=runs_dir)
    try:
        rules = os.path.join(tmp, "rules.json")
        with open(rules, "w") as f:
            json.dump(ALERT_RULES, f)
        prof_dir = os.path.join(tmp, "trace")
        bn_act.reset_launches()
        rc, builder, run_s = _cli_run(
            TELEMETRY_ARGS + ["--profile_dir", prof_dir,
                              "--alert_rules_path", rules],
            os.path.join(tmp, "run"))
        launches = bn_act.launches
        cfg = builder.cfg
        if rc != 0 or launches != ref["launches"]:
            raise AssertionError(f"telemetry cli: exit {rc}, bn_act "
                                 f"launched {launches} times (phase 5: "
                                 f"{ref['launches']})")
        entry["launches"] += launches
        got = _state_leaves(builder.state)
        diff = [n for n, t in ref["leaves"].items()
                if not torch.equal(got[n].cpu(), t)]
        if diff or builder.state.step != ref["step"]:
            raise AssertionError(f"telemetry cli: final state differs "
                                 f"from phase 5's in {diff}")
        logs = builder.paths["logs"]
        rows = read_jsonl(os.path.join(logs, "events.jsonl"))
        k = cfg.number_of_training_steps_per_iter

        def bn_per_step(name):
            return cfg.effective_task_microbatches() * _bn_per_forward(
                cfg) * _forwards_per_chunk(cfg, "_so1_" in name,
                                           name.endswith("msl1"))
        perf = _check_telemetry_rows(rows, cfg.total_epochs,
                                     cfg.total_epochs
                                     * cfg.total_iter_per_epoch, bn_per_step)
        prom = _parse_prometheus(os.path.join(logs, "metrics.prom"))
        if prom.get("perf_errors") != 0.0 or not prom.get("perf_samples"):
            raise AssertionError(f"telemetry: perf/errors "
                                 f"{prom.get('perf_errors')}, samples "
                                 f"{prom.get('perf_samples')}")
        with open(os.path.join(logs, "trace.json")) as f:
            validate_trace(json.load(f))
        with open(os.path.join(prof_dir, "epoch1", "trace.json")) as f:
            chrome = json.load(f)["traceEvents"]
        firing = [r for r in rows if r["event"] == "alert"]
        if ([(r["rule"], r["state"]) for r in firing]
                != [("train_loss_reported", "firing")]):
            raise AssertionError(f"telemetry: alert rows {firing}")
        stats = _epoch_seconds(logs)
        stall = [r["feed_stall_frac"] for r in rows
                 if r["event"] == "telemetry"]
        print(f"telemetry cli: exit 0 in {run_s:.1f} s; epoch seconds "
              f"{stats} with telemetry on, {ref['epoch_seconds']} in phase "
              f"5; feed stall per epoch {stall}; {len(rows)} events "
              f"({len(perf)} perf samples, health "
              f"every step), metrics.prom {len(prom)} series, trace.json "
              f"valid, Chrome trace of epoch 1 {len(chrome)} events, one "
              f"alert firing; bn_act launches {launches}; final weights and "
              f"Adam state bitwise phase 5's ({card})", flush=True)
        for r in perf:
            _print_sample(f"telemetry cli sample at iter {r['iter']} "
                          f"({r['top_executable']})", r, card)

        # What health and a sample window add to one step, and the
        # program's reading beside _profiled's, on the run's final state.
        loader = MetaLearningDataLoader(cfg, device="cuda")
        batches = loader.get_train_batches(builder.current_iter, 1)
        batch = next(batches)
        batches.close()
        state = builder.state

        def phase_of(name):
            for e in range(cfg.total_epochs):
                p = dict(second_order=cfg.use_second_order(e),
                         use_msl=cfg.use_msl(e))
                if profiler.phase_card_name(**p) == name:
                    return e, p
            raise AssertionError(f"telemetry: no epoch runs {name}")

        # A sample that lost device records (the tracer dropped part of
        # the window) is taken again on a step of the same phase card, at
        # most twice; a window that lost nothing must pass every check.
        for r in perf:
            if not r["device_records_lost"]:
                continue
            ep, ph = phase_of(r["top_executable"])
            for attempt in (1, 2):
                again = _sample_window(
                    lambda: builder.train_step(state, batch, ep, **ph),
                    r["top_executable"])
                _print_sample(f"telemetry cli sample at iter {r['iter']} "
                              f"taken again, attempt {attempt}", again, card)
                if not again["device_records_lost"]:
                    _check_perf_row(again, bn_per_step)
                    break
            else:
                raise AssertionError(
                    f"telemetry: the sample at iter {r['iter']} lost "
                    f"device records three times")

        epoch = cfg.total_epochs - 1
        phase = dict(second_order=cfg.use_second_order(epoch),
                     use_msl=cfg.use_msl(epoch))
        name = profiler.phase_card_name(**phase)

        def step(health=False):
            return builder.train_step(state, batch, epoch, health=health,
                                      **phase)

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        step()
        ms = {"off": [], "health": [], "window": []}
        sampler = profiler.PerfSampler(1, device="cuda")
        sampler.register_card(name, profiler.build_cost_card(
            name, flops=profiler.count_flops(step)[1], kind=sampler.kind,
            peaks=sampler.peaks))

        def window():
            sampler.start_window(0)
            step()
            if sampler.end_window(0, executable=name) is None:
                raise AssertionError("telemetry: a sample window failed")
        for kind in ("off", "health", "window", "window", "health", "off"):
            ms[kind].append(timed({"off": step,
                                   "health": lambda: step(health=True),
                                   "window": window}[kind]))
        med = {k: statistics.median(v) for k, v in ms.items()}
        runs = {k: [round(x, 1) for x in v] for k, v in ms.items()}
        n_calls = 100_000
        t0 = time.perf_counter()
        for _ in range(n_calls):
            with profiler.region("inner_support_forward"):
                pass
        label_us = (time.perf_counter() - t0) / n_calls * 1e6
        labels = cfg.effective_task_microbatches() * (
            1 + 3 * k + (k if phase["use_msl"] else 1)) + 2
        print(f"telemetry costs, one {name} step (median of 2, in turns): "
              f"plain {med['off']:.1f} ms, health on {med['health']:.1f} ms "
              f"(+{med['health'] - med['off']:.1f}), in a sample window "
              f"with its attribution {med['window']:.1f} ms "
              f"(+{med['window'] - med['off']:.1f}); runs "
              f"{json.dumps(runs)}"
              f"; record_function labels {labels} per step, "
              f"{label_us:.3f} us each with the profiler off "
              f"({labels * label_us / 1e3:.4f} ms per step) ({card})",
              flush=True)
        _profiled(f"telemetry, one {name} step", step, card)
        _sampled(f"telemetry, one {name} step", name, step, card,
                 bn_kernels=bn_per_step(name))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


# Phase 8: the trainer's fault path at the flagship's full width
# (bf16 + fast-math BN, bn_backend=pallas, phase 5's length cuts), through
# scripts/torch_chaos_run.py's functions in process, plus the hangs on the
# card, async against sync checkpoints, the watchdog on against off and
# a cold kernel build under a tight step deadline.
CHAOS_SCRIPT = os.path.join(REPO, "scripts", "torch_chaos_run.py")
# The trip children's step deadline ("a few seconds": a flagship step
# takes ~1-2 s of host time) and poll; a trip must exit 74 within the
# deadline + 2 polls + 5 s of the hang's start.
HANG_STEP_DEADLINE = 6.0
HANG_POLL = 0.5
HANG_SLACK = 5.0
# The device hang's spin kernel: 4e10 cycles, 20 s at 2 GHz, past the
# deadline and bounded if the watchdog fails to end the process.
SPIN_CYCLES = 4 * 10**10
# A flagship child that launches the spin kernel after its second train
# step, on the step's stream: the loss fetch then waits behind it.
DEVICE_HANG_CHILD = """
import sys
import torch
sys.path.insert(0, sys.argv[1])
from howtotrainyourmamlpytorch_tpu_torch import experiment, train_maml_system
real = experiment.make_train_step
def make(cfg, apply):
    step, calls = real(cfg, apply), []
    def spun(*args, **kwargs):
        out = step(*args, **kwargs)
        calls.append(1)
        if len(calls) == 2:
            torch.cuda._sleep(int(sys.argv[2]))
        return out
    return spun
experiment.make_train_step = make
sys.exit(train_maml_system.main(sys.argv[3:]))
"""
TRIP_ARGS = ["--dispatch_sync_every", "1", "--watchdog_step_timeout_s",
             str(HANG_STEP_DEADLINE), "--watchdog_poll_interval_s",
             str(HANG_POLL)]


def _load_script(path: str):
    """A script of the repo as a module (scripts/ is not a package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        os.path.splitext(os.path.basename(path))[0], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trip_latency(bundle: dict, t_exit: float) -> float:
    """Seconds from the hang's start (the tripped phase's last stamp in
    the flight ring) to the process's exit."""
    phase = bundle["crash"]["phase"]
    stamps = [r["ts"] for r in bundle["flight"]
              if r.get("kind") == "phase" and r.get("phase") == phase]
    return t_exit - stamps[-1]


def _tripped_child(tag: str, argv, root: str, chaos, phase: str,
                   deadline: float, card: str, code=None, env=None) -> dict:
    """One flagship CLI child that must trip the watchdog in ``phase``:
    exit 74 within ``deadline`` + 2 polls + 5 s of the hang's start, a
    bundle with stacks, the flight ring, its trace and ``crash.json``,
    and one ``watchdog_trip`` row. Returns the bundle's view."""
    run = ["--name_of_args_json_file", FLAGSHIP, "--experiment_root", root,
           "--experiment_name", tag] + CLI_ARGS + TRIP_ARGS + argv
    cmd = ([sys.executable, "-c", code, REPO, str(SPIN_CYCLES)] + run
           if code else [sys.executable, "-m",
                         "howtotrainyourmamlpytorch_tpu_torch."
                         "train_maml_system"] + run)
    child_env = dict(os.environ)
    child_env.pop("MAML_FAULTS", None)
    child_env.update(env or {})
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=child_env, capture_output=True,
                          text=True, timeout=300)
    t_exit = time.time()
    logs = os.path.join(root, tag, "logs")
    bundle = chaos.bundle_view(os.path.join(logs, "crash_bundle"))
    trips = [e for e in chaos.read_events(logs)
             if e.get("event") == "watchdog_trip"]
    need = {"stacks.txt", "flight.jsonl", "trace.json", "crash.json"}
    if (proc.returncode != 74 or not need <= set(bundle["files"])
            or bundle["crash"].get("reason") != f"hung_{phase}"
            or len(trips) != 1):
        raise AssertionError(
            f"{tag}: exit {proc.returncode}, bundle {bundle['files']}, "
            f"crash {bundle['crash'].get('reason')}, {len(trips)} trip "
            f"rows; stderr {proc.stderr[-1500:]}")
    latency = _trip_latency(bundle, t_exit)
    bound = deadline + 2 * HANG_POLL + HANG_SLACK
    print(f"{tag}: exit 74 in {time.perf_counter() - t0:.1f} s, "
          f"{latency:.2f} s after the hang began (bound {bound:.1f} s: "
          f"deadline {deadline:.1f} + 2 polls of {HANG_POLL} + "
          f"{HANG_SLACK:.0f}); crash.json {bundle['crash']['reason']}, "
          f"age {bundle['crash']['age_seconds']:.2f} s at the trip; bundle "
          f"{bundle['files']}, {len(bundle['flight'])} flight rows "
          f"({card})", flush=True)
    if latency > bound:
        raise AssertionError(f"{tag}: exit {latency:.2f} s after the hang "
                             f"began, over {bound:.1f} s")
    return bundle


def _main_thread_in_loss_fetch(stacks: str) -> bool:
    """Whether a thread of ``stacks.txt`` stands innermost at the train
    loop's loss fetch (where the host waits for the card)."""
    from howtotrainyourmamlpytorch_tpu_torch import experiment
    src = open(experiment.__file__).read().splitlines()
    line = next(i + 1 for i, text in enumerate(src)
                if "loss_now = float(metrics.loss)" in text)
    for block in stacks.split("\n\n"):
        frames = [f.strip() for f in block.splitlines()
                  if f.strip().startswith("File ")]
        if frames and frames[0].endswith(f"line {line} in _train_epoch"):
            return True
    return False


def _save_bytes(models: str) -> dict:
    """The checkpoint files, manifest and bookkeeping of a run."""
    names = sorted(n for n in os.listdir(models)
                   if n.endswith(".ckpt") or n in ("MANIFEST.json",
                                                   "state.json"))
    return {n: open(os.path.join(models, n), "rb").read() for n in names}


def _r12_save_costs(root: str, card: str) -> None:
    """The train thread's time in ``CheckpointWriter.save`` for one
    ResNet-12 one-card state, sync against async, in turns; the two
    directories' files byte-identical."""
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.ckpt.writer import (
        CheckpointWriter)
    from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
        init_train_state)
    from howtotrainyourmamlpytorch_tpu_torch.models import make_model
    from howtotrainyourmamlpytorch_tpu_torch.train_maml_system import (
        get_args)
    from howtotrainyourmamlpytorch_tpu_torch.tree import tree_leaves
    from howtotrainyourmamlpytorch_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    cfg = get_args(["--name_of_args_json_file", RESNET12] + R12_CLI_ARGS)
    state = init_train_state(cfg, make_model(cfg)[0], seed=cfg.seed,
                             device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    writers = {mode: CheckpointWriter(
        CheckpointManager(os.path.join(root, mode), max_to_keep=2),
        async_saves=mode == "async") for mode in ("sync", "async")}
    ms = {"sync": [], "async": []}
    for mode, epoch in (("sync", 0), ("async", 0), ("async", 1),
                        ("sync", 1)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        writers[mode].save(state, epoch, 100 * (epoch + 1), 0.5)
        ms[mode].append((time.perf_counter() - t0) * 1e3)
        writers[mode].drain()
    for w in writers.values():
        w.close()
    a, b = (_save_bytes(os.path.join(root, m)) for m in ("sync", "async"))
    size = len(next(v for k, v in a.items() if k.endswith(".ckpt")))
    print(f"resnet12 save, {n_params / 1e6:.2f} M params with Adam's "
          f"moments ({size / 2**20:.1f} MiB per file): the train thread "
          f"spends {[round(x, 1) for x in ms['sync']]} ms in a sync save, "
          f"{[round(x, 1) for x in ms['async']]} ms in an async one "
          f"(encode + enqueue; in turns) ({card})", flush=True)
    if a != b:
        raise AssertionError("resnet12 save: sync and async files differ")


def _watchdog_on_off(cfg, card: str) -> int:
    """Three flagship train steps from one seeded state with the watchdog
    on (beacon, ring and thread installed, 'step' stamped per step) and
    three with it off, in turns: the final states bitwise equal. Returns
    the BN-kernel launches of the six steps."""
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.data import (
        MetaLearningDataLoader)
    from howtotrainyourmamlpytorch_tpu_torch.device import numerics_policy
    from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
        init_train_state, make_train_step)
    from howtotrainyourmamlpytorch_tpu_torch.models import make_model
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.resilience import (flightrec,
                                                                watchdog)
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import profiler

    init, apply = make_model(cfg)
    step = make_train_step(cfg, apply)
    epoch = cfg.total_epochs - 1
    phase = dict(second_order=cfg.use_second_order(epoch),
                 use_msl=cfg.use_msl(epoch))
    loader = MetaLearningDataLoader(cfg, device="cuda")
    batches = list(loader.get_train_batches(0, 3))
    states = {k: init_train_state(cfg, init, seed=cfg.seed, device="cuda")
              for k in ("on", "off")}
    beacon = watchdog.ProgressBeacon()
    prev_rec = flightrec.install(flightrec.FlightRecorder())
    dog = watchdog.Watchdog(beacon, watchdog.deadlines_from_config(cfg),
                            bundle_dir=os.path.join(REPO, ".smoke_runs",
                                                    "on_off_bundle"),
                            on_trip=lambda info: None).start()
    ms = {"on": [], "off": []}
    bn_act.reset_launches()
    try:
        with numerics_policy(cfg.compute_dtype, deterministic=True):
            for i, order in enumerate((("off", "on"), ("on", "off"),
                                       ("off", "on"))):
                for arm in order:
                    prev = watchdog.install_beacon(
                        beacon if arm == "on" else None)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    watchdog.stamp("step", detail=i)
                    states[arm], metrics = step(states[arm], batches[i],
                                                epoch, **phase)
                    float(metrics.loss)
                    ms[arm].append((time.perf_counter() - t0) * 1e3)
                    watchdog.install_beacon(prev)
    finally:
        dog.stop()
        flightrec.install(prev_rec)
    launches = bn_act.launches
    a, b = (_state_leaves(states[k]) for k in ("on", "off"))
    diff = [n for n in a if not torch.equal(a[n], b[n])]
    print(f"watchdog on vs off, 3 {profiler.phase_card_name(**phase)} "
          f"steps each (in "
          f"turns): median {statistics.median(ms['on']):.1f} ms on, "
          f"{statistics.median(ms['off']):.1f} ms off (on "
          f"{[round(x, 1) for x in ms['on']]}, off "
          f"{[round(x, 1) for x in ms['off']]}); final state bitwise "
          f"{not diff}; trips {dog.tripped} ({card})", flush=True)
    if diff or dog.tripped is not None:
        raise AssertionError(f"watchdog on vs off: states differ in {diff}")
    return launches


def _cold_build_under_deadline(card: str) -> None:
    """``bn_act`` built cold (an empty build directory) while a watchdog
    enforces a 1 s step deadline and the default compile one, with
    'step' stamped, as at a run's first train step: the build runs under
    'compile' and nothing trips; then one launch on the new library."""
    import shutil
    import tempfile
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act, build
    from howtotrainyourmamlpytorch_tpu_torch.resilience import (flightrec,
                                                                watchdog)

    deadlines = {**watchdog.deadlines_from_config(MAMLConfig()),
                 "step": 1.0}
    rec = flightrec.FlightRecorder()
    prev_rec = flightrec.install(rec)
    beacon = watchdog.ProgressBeacon()
    prev_beacon = watchdog.install_beacon(beacon)
    tmp = tempfile.mkdtemp(prefix="cold_build_",
                           dir=os.path.join(REPO, ".smoke_runs"))
    dog = watchdog.Watchdog(beacon, deadlines, bundle_dir=tmp,
                            poll_interval_s=0.1,
                            on_trip=lambda info: None).start()
    old_dir, old_built = build.BUILD_DIR, build._built.pop("bn_act")
    try:
        build.BUILD_DIR = os.path.join(tmp, "_build")
        beacon.stamp("step", detail=0)
        built = build.load("bn_act")
        x = torch.randn(SHOTS * 84 * 84, FILTERS, device="cuda")
        g = torch.ones(FILTERS, device="cuda")
        before = bn_act.launches
        y, _, _ = bn_act.bn_act(x, g, torch.zeros_like(g), 1e-5, 0.0)
        torch.cuda.synchronize()
        launched = bn_act.launches - before
        beacon.stamp("step", detail=1)
    finally:
        dog.stop()
        build.BUILD_DIR = old_dir
        build._built["bn_act"] = old_built
        watchdog.install_beacon(prev_beacon)
        flightrec.install(prev_rec)
        shutil.rmtree(tmp, ignore_errors=True)
    compiles = [r for r in rec.events() if r.get("kind") == "phase"
                and r.get("phase") == "compile"]
    print(f"cold build: nvcc {built.seconds:.2f} s under a 1 s step "
          f"deadline (poll 0.1 s) and a {deadlines['compile']:.0f} s "
          f"compile deadline, in phase {[r['detail'] for r in compiles]}; "
          f"trips {dog.tripped}; one launch after it ({card})", flush=True)
    if (dog.tripped is not None or built.seconds <= 1.0 or launched != 1
            or [r["detail"] for r in compiles] != ["nvcc:bn_act"]
            or not torch.isfinite(y.float()).all()):
        raise AssertionError(f"cold build: trip {dog.tripped}, nvcc "
                             f"{built.seconds:.2f} s, launches {launched}")


def fault_path(entry: dict, card: str) -> None:
    """Phase 8: the port's chaos run at the flagship's width (verdict
    recovered; the ckpt_kill and hang restarts from the last committed
    entry and bitwise the baseline; the BN kernel's launches of every
    in-process phase as derived), a hang on the device, ``hang_step``
    and ``hang_feed`` each exiting 74 with a bundle in time, async and
    sync runs' checkpoints byte-identical, the watchdog on against off,
    and a cold kernel build under a 1 s step deadline. Adds the main
    path's launches to ``entry``."""
    import shutil
    import tempfile
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.resilience import faults

    chaos = _load_script(CHAOS_SCRIPT)
    runs_dir = os.path.join(REPO, ".smoke_runs")
    os.makedirs(runs_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="faults_", dir=runs_dir)
    marks = [("start", time.perf_counter())]
    try:
        art = chaos.chaos(os.path.join(tmp, "chaos"), "cuda", quick=False,
                          log=lambda line: print(f"chaos: {line}",
                                                 flush=True))
        phases = art.pop("_phases")
        print(f"chaos: {json.dumps(art)}", flush=True)
        if art["status"] != "recovered":
            raise AssertionError(
                f"chaos: verdict {art['status']}; ckpt_kill restart differs "
                f"in {art['ckpt_kill_restart_differing_leaves']}, hang "
                f"restart in {art['hang_restart_differing_leaves']}")
        cfg = phases["baseline"]["builder"].cfg
        t = cfg.total_iter_per_epoch
        at = {s.kind: s.at for s in faults.parse_specs(chaos.FAULTED_SPEC)}
        models = {k: p["result"].get("num_models", 0)
                  for k, p in phases.items()}
        # Steps per epoch and eval sweeps of each in-process phase: the
        # faulted run trains epoch 1 to the NaN, rewinds to epoch 0's
        # checkpoint and trains it again to the kill.
        want = {
            "baseline": ({0: t, 1: t}, 2 + models["baseline"]),
            "faulted": ({0: t, 1: (at["nan_loss"] - t)
                         + (at["kill"] - t)}, 1),
            "restart": ({}, models["restart"]),
            "ckpt_kill_restart": ({1: t}, 1 + models["ckpt_kill_restart"]),
            "hang_restart": ({1: t}, 1 + models["hang_restart"]),
        }
        for name, (steps, sweeps) in want.items():
            n = _train_path_launches(cfg, 0, steps, sweeps, 0)
            got = phases[name]["launches"]
            if got != n:
                raise AssertionError(f"chaos {name}: bn_act launched {got} "
                                     f"times, the path needs {n}")
            entry["launches"] += got
        print("chaos: bn_act launches per phase " + json.dumps(
            {k: p["launches"] for k, p in phases.items()}) + " = derived; "
            "seconds " + json.dumps({k: round(p["seconds"], 1)
                                     for k, p in phases.items()})
            + f" ({card})", flush=True)
        hang_latency = art["hang_age_seconds"] + art[
            "hang_exit_after_trip_seconds"]
        hang_bound = (art["hang_deadline_seconds"] + 2 * chaos.HANG_DEADLINES[
            "watchdog_poll_interval_s"] + HANG_SLACK)
        print(f"chaos hang_feed: exit 74 {hang_latency:.2f} s after the "
              f"feed wedged (bound {hang_bound:.1f} s) ({card})", flush=True)
        if hang_latency > hang_bound:
            raise AssertionError("chaos hang_feed: the trip came late")
        marks.append(("chaos", time.perf_counter()))

        # Async against sync: the baseline saved synchronously.
        async_run = chaos.run_phase(chaos.make_cfg(
            os.path.join(tmp, "chaos"), "chaos_async", False, ckpt_async=1),
            "cuda")
        if async_run["launches"] != phases["baseline"]["launches"]:
            raise AssertionError("async run: bn_act launches differ")
        entry["launches"] += async_run["launches"]
        runs = {"sync": phases["baseline"], "async": async_run}
        files = {k: _save_bytes(r["builder"].paths["saved_models"])
                 for k, r in runs.items()}
        same = (set(files["sync"]) == set(files["async"])
                and all(files["sync"][n] == files["async"][n]
                        for n in files["sync"]))
        for k, r in runs.items():
            c = r["counters"]
            print(f"ckpt_async={int(k == 'async')}: epoch seconds "
                  f"{_epoch_seconds(r['builder'].paths['logs'])}; "
                  f"ckpt/save_seconds {c['ckpt/save_seconds']:.4f}, "
                  f"ckpt/blocked_seconds {c['ckpt/blocked_seconds']:.4f} "
                  f"over {c['ckpt/saves']:.0f} saves ({card})", flush=True)
        print(f"async vs sync: {sorted(files['sync'])} byte-identical "
              f"{same}", flush=True)
        if not same:
            raise AssertionError("async and sync runs' checkpoints differ")
        del runs, async_run, phases
        _r12_save_costs(os.path.join(tmp, "r12_saves"), card)
        marks.append(("async", time.perf_counter()))

        # A hang on the device: the spin kernel after the second step.
        bundle = _tripped_child("device_hang", [], os.path.join(tmp, "hang"),
                                chaos, "step", HANG_STEP_DEADLINE, card,
                                code=DEVICE_HANG_CHILD)
        in_fetch = _main_thread_in_loss_fetch(bundle["stacks"])
        report = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts",
                                          "telemetry_report.py"),
             os.path.join(tmp, "hang", "device_hang"), "--json"],
            capture_output=True, text=True, timeout=120, cwd=REPO)
        summary = json.loads(report.stdout.strip().splitlines()[-1])
        print(f"device_hang: main thread in the loss fetch in stacks.txt "
              f"{in_fetch}; telemetry_report watchdog section "
              f"{summary['watchdog']}", flush=True)
        if (not in_fetch or not isinstance(summary["watchdog"], dict)
                or summary["watchdog"]["trips"] != 1):
            raise AssertionError(f"device_hang: stacks\n{bundle['stacks']}")
        _tripped_child("hang_step", ["--fault_spec", "hang_step@2"],
                       os.path.join(tmp, "hang"), chaos, "step",
                       HANG_STEP_DEADLINE, card,
                       env={"MAML_HANG_SECONDS": "60"})
        marks.append(("hangs", time.perf_counter()))

        entry["launches"] += _watchdog_on_off(cfg, card)
        _cold_build_under_deadline(card)
        marks.append(("watchdog", time.perf_counter()))
        print("phase 8 seconds per part: " + json.dumps(
            {b[0]: round(b[1] - a[1], 1) for a, b in zip(marks, marks[1:])}),
            flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


# Phase 9: the serving plane at the flagship's full width (bf16 +
# fast-math BN, bn_backend=pallas), served from phase 5's checkpoints:
# the engine's tiers, tracing, shedding and continuous batching, the
# metrics row read by the JAX package's report, a hot-swap and a
# rollback, then scripts/torch_fleet_bench.py with 2 replica processes
# on the card.
FLEET_SCRIPT = os.path.join(REPO, "scripts", "torch_fleet_bench.py")
FLEET_ARGS = ["--device", "cuda", "--replicas", "2", "--config", FLAGSHIP,
              "--requests", "160", "--tenants", "24", "--l1-capacity", "8"]
# Phase 9's burst: requests submitted at once to an engine with shedding
# on, its queue bound, and their deadline after submission in full-batch
# service times (the shed policy's own estimate): from one queued batch
# on, the policy's estimate (1.5 x 2 service times) is past it.
BURST, BURST_DEPTH, BURST_DEADLINE_BATCHES = 32, 16, 2.0


def _ms_median(values) -> float:
    return statistics.median(values) * 1e3


def serving_plane(entry: dict, card: str, src: str) -> None:
    """Phase 9 (see the module docstring); adds the BN kernel's launches
    in this process and in the fleet's replicas to ``entry``."""
    import dataclasses
    import shutil
    import tempfile
    import numpy as np
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.ckpt.registry import (
        ModelRegistry)
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.serve import (
        FewShotRequest, QueueFullError, ServingEngine, ShedError, pad_group)
    from howtotrainyourmamlpytorch_tpu_torch.serve.adapt import (
        adapt_task, predict_tasks)
    from howtotrainyourmamlpytorch_tpu_torch.serve.cache import (
        support_fingerprint)
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import reqtrace
    from howtotrainyourmamlpytorch_tpu_torch.tree import tree_map
    from howtotrainyourmamlpytorch_tpu_torch.utils.checkpoint import (
        CheckpointManager)
    from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import (
        JsonlLogger, read_jsonl)

    runs_dir = os.path.join(REPO, ".smoke_runs")
    tmp = tempfile.mkdtemp(prefix="serving_", dir=runs_dir)
    marks = [("start", time.perf_counter())]
    engines = []
    try:
        models = os.path.join(tmp, "saved_models")
        shutil.copytree(src, models)
        base = MAMLConfig.from_json_file(FLAGSHIP).replace(
            bn_backend="pallas", serve_default_deadline_ms=0.0,
            experiment_root=tmp, serve_l2_dir=os.path.join(tmp, "l2"),
            serve_registry_poll_s=0.0)
        h, w, c = base.image_shape
        n, k = base.num_classes_per_set, base.num_samples_per_class
        q = base.num_target_per_task
        rng = np.random.default_rng(base.seed + 9)

        def request(support=None, **kw):
            sx = (support if support is not None else
                  rng.integers(0, 256, (n * k, h, w, c), dtype=np.uint8))
            return FewShotRequest(
                support_x=sx,
                support_y=np.repeat(np.arange(n, dtype=np.int32), k),
                query_x=rng.integers(0, 256, (q, h, w, c), dtype=np.uint8),
                **kw)

        def check_ok(responses, what):
            for r in responses:
                if (r.status != "ok" or r.logits is None
                        or r.logits.shape != (q, n)
                        or not np.isfinite(r.logits).all()):
                    raise AssertionError(
                        f"serving plane, {what}: request {r.request_id} "
                        f"{r.status} {r.error}")

        def engine(cfg):
            t0 = time.perf_counter()
            eng = ServingEngine.from_checkpoint(cfg, models, device="cuda")
            engines.append(eng)
            # Adopts the registry's version of these bytes (or swaps to
            # it): every engine of the phase serves the same version.
            eng.maybe_hot_swap(force=True)
            return eng, time.perf_counter() - t0

        # The engine from the trainer's checkpoint, its L1.
        bn_act.reset_launches()
        eng, load_s = engine(base)
        eng.warmup()
        reqs = [request() for _ in range(2 * base.serve_batch_tasks)]
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        served = eng.drain()
        serve_s = time.perf_counter() - t0
        check_ok(served, "from_checkpoint")
        adapts = eng.adapt_invocations
        eng.submit(request(support=reqs[0].support_x))
        (hit,) = eng.drain()
        check_ok([hit], "L1 repeat")
        if hit.cache_tier != "l1" or eng.adapt_invocations != adapts:
            raise AssertionError(f"serving plane: repeat tier "
                                 f"{hit.cache_tier}, adapts {adapts} -> "
                                 f"{eng.adapt_invocations}")
        print(f"serving plane: from_checkpoint {load_s:.2f} s (version "
              f"{eng._model_version}); {len(reqs)} requests in "
              f"{serve_s:.3f} s; adapt "
              f"{_ms_median(eng.adapt_seconds):.2f} ms/batch, predict "
              f"{_ms_median(eng.predict_seconds):.2f} ms/batch (medians of "
              f"{len(eng.adapt_seconds)}/{len(eng.predict_seconds)}, "
              f"{base.serve_batch_tasks} tasks, {base.compute_dtype}); L1 "
              f"repeat served with no adapt ({card})", flush=True)

        # The L2 tier: publishes land, a second engine on the same tier
        # serves a repeat with no adapt, every request of it traced.
        if not eng.l2_flush(60.0):
            raise AssertionError("serving plane: L2 publishes did not land")
        key = support_fingerprint(reqs[1].support_x, reqs[1].support_y,
                                  eng.num_adapt_steps,
                                  context=eng._fp_context)
        cached = eng.cache.get(key)
        get_ms, put_ms = [], []
        for i in range(5):
            t0 = time.perf_counter()
            if eng.l2.get(key) is None:
                raise AssertionError("serving plane: published entry "
                                     "missing from the L2 tier")
            get_ms.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            eng.l2.put(f"{i:064x}",
                       fast=tree_map(lambda t: t.cpu().numpy(),
                                     cached.fast),
                       bn_state=tree_map(lambda t: t.cpu().numpy(),
                                         cached.bn_state))
            put_ms.append(time.perf_counter() - t0)
        eng2, _ = engine(base.replace(reqtrace_sample_rate=1.0))
        traced = [request(support=reqs[1].support_x)] + [
            request() for _ in range(3)]
        roots = []
        for i, r in enumerate(traced):
            r.trace = reqtrace.mint("phase9", i, 1.0)
            roots.append((r.trace, time.monotonic()))
            eng2.submit(r)
            if i == 0:
                (l2_hit,) = eng2.drain()
                if l2_hit.cache_tier != "l2" or eng2.adapt_invocations:
                    raise AssertionError(
                        f"serving plane: second engine's repeat tier "
                        f"{l2_hit.cache_tier}, adapts "
                        f"{eng2.adapt_invocations}")
                check_ok([l2_hit], "L2 repeat")
        check_ok(eng2.drain(), "traced")
        for ctx, t_sub in roots:
            reqtrace.record_root(ctx, t_sub, time.monotonic() - t_sub)
        events = os.path.join(tmp, "events.jsonl")
        eng2.flush_metrics(JsonlLogger(events), phase="serving_plane",
                           replica="traced")
        traces = reqtrace.assemble(
            r for r in read_jsonl(events)
            if r["event"] == reqtrace.REQUEST_TRACE_EVENT)
        if len(traces) != len(traced) or not all(
                reqtrace.linked(t) for t in traces.values()):
            raise AssertionError(f"serving plane: {len(traces)} traces, "
                                 f"linked {[reqtrace.linked(t) for t in traces.values()]}")
        print(f"serving plane: L2 get {_ms_median(get_ms):.3f} ms, put "
              f"{_ms_median(put_ms):.3f} ms (device-to-host copy + fsync'd "
              f"file, medians of 5), publisher queue drops "
              f"{eng.l2_dropped_publishes}; a second engine served the "
              f"repeat from L2 with 0 adapts; {len(traces)} traces at "
              f"sample rate 1.0, all linked ({card})", flush=True)

        # Predict with the L2 tier on and off, on the same requests: the
        # first engine's two miss batches (the writer publishing beside
        # them) against an engine with no L2 tier serving the same two,
        # then three batches of L1 repeats on each (nothing to publish).
        def repeat(r):
            return FewShotRequest(support_x=r.support_x,
                                  support_y=r.support_y, query_x=r.query_x)

        def predict_ms(e, group):
            n0 = len(e.predict_seconds)
            for r in group:
                e.submit(repeat(r))
            check_ok(e.drain(), "L2 on/off")
            return [round(s * 1e3, 3) for s in e.predict_seconds[n0:]]

        hits = reqs[:base.serve_batch_tasks]
        on_miss = [round(s * 1e3, 3) for s in eng.predict_seconds[:2]]
        on_hit = sum((predict_ms(eng, hits) for _ in range(3)), [])
        eng_off, _ = engine(base.replace(serve_l2_dir=""))
        eng_off.warmup()
        off_miss = predict_ms(eng_off, reqs)
        off_hit = sum((predict_ms(eng_off, hits) for _ in range(3)), [])
        print(f"serving plane: predict ms per batch, L2 on: miss batches "
              f"{on_miss}, L1 repeats {on_hit} (writer idle); L2 off: miss "
              f"batches {off_miss}, L1 repeats {off_hit} ({card})",
              flush=True)
        marks.append(("engine_tiers", time.perf_counter()))

        # Shedding and continuous batching: a burst past the queue bound.
        eng3, _ = engine(base.replace(
            serve_l2_dir="", fleet_shed_policy="deadline",
            serve_continuous_batching=1, serve_max_queue_depth=BURST_DEPTH))
        for r in [request() for _ in range(base.serve_batch_tasks)]:
            eng3.submit(r)       # one full batch feeds the shed estimator
        check_ok(eng3.drain(), "shed warm")
        svc = eng3.batcher.admission.service_time_s(
            eng3.batcher.buckets[0])
        shed = rejected = 0
        burst = [request() for _ in range(BURST)]
        deadline = time.monotonic() + BURST_DEADLINE_BATCHES * svc
        for r in burst:
            r.deadline = deadline
            try:
                eng3.submit(r)
            except ShedError:
                shed += 1
            except QueueFullError:
                rejected += 1
        answered = eng3.drain()
        ok = [r for r in answered if r.status == "ok"]
        check_ok(ok, "burst")
        reg3 = eng3.registry
        eng3._mirror_cache_counters()
        cb = {name: reg3.counter(f"serve/{name}").value
              for name in ("cb_groups", "cb_fill_dispatch",
                           "cb_linger_dispatch")}
        if (shed + rejected + len(answered) != BURST or not shed
                or reg3.counter("serve/shed_total").value != shed
                or not cb["cb_groups"]):
            raise AssertionError(
                f"serving plane: burst of {BURST}: shed {shed}, rejected "
                f"{rejected}, answered {len(answered)}; counters "
                f"{reg3.snapshot()}")
        print(f"serving plane: burst of {BURST} (queue bound "
              f"{BURST_DEPTH}, deadline {BURST_DEADLINE_BATCHES} x the "
              f"{svc * 1e3:.1f} ms full-batch service estimate, shed policy "
              f"deadline, continuous batching on): {shed} shed, {rejected} "
              f"rejected, {len(ok)} served, "
              f"{len(answered) - len(ok)} missed their deadline; "
              f"serve/shed_total {reg3.counter('serve/shed_total').value}, "
              f"{json.dumps(cb)} ({card})", flush=True)

        # The metrics row, read by the JAX package's report.
        eng.flush_metrics(JsonlLogger(events), phase="serving_plane")
        report = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts",
                                          "telemetry_report.py"),
             events, "--json"],
            capture_output=True, text=True, timeout=120, cwd=REPO)
        summary = json.loads(report.stdout.strip().splitlines()[-1])
        serving = summary.get("serving")
        if (report.returncode != 0 or not isinstance(serving, dict)
                or serving["responses"] != eng.registry.counter(
                    "serve/responses_total").value):
            raise AssertionError(f"serving plane: telemetry_report "
                                 f"serving section {serving}")
        print(f"serving plane: telemetry_report serving section "
              f"{json.dumps(serving)}", flush=True)
        marks.append(("shed_report", time.perf_counter()))

        # Hot-swap: v2 (a seeded 1e-3 perturbation) passes the canary at
        # the default gates and is adopted; v3 (a NaN weight) rolls back.
        manager = CheckpointManager(models, max_to_keep=10)
        registry = ModelRegistry(models)
        gen = torch.Generator().manual_seed(base.seed)

        def publish(epoch, params):
            state = dataclasses.replace(eng.state, params=params)
            manager.save(state, epoch=epoch, current_iter=epoch,
                         val_acc=0.5)
            return registry.publish(tag=str(epoch), epoch=epoch,
                                    iteration=epoch, val_acc=0.5,
                                    fingerprint=manager.fingerprint(epoch))

        with torch.no_grad():
            v2 = publish(2, tree_map(lambda x: x * (1 + 1e-3 * torch.randn(
                x.shape, generator=gen).to(x.device)), eng.state.params))
        t0 = time.perf_counter()
        swap = eng.maybe_hot_swap(force=True)
        swap_s = time.perf_counter() - t0
        if not swap or not swap["swapped"] or eng._model_version != v2[
                "version"]:
            raise AssertionError(f"serving plane: v2 not adopted: {swap}")
        adapts = eng.adapt_invocations
        eng.submit(request(support=reqs[0].support_x))
        (after,) = eng.drain()
        check_ok([after], "after the swap")
        if after.cache_hit or eng.adapt_invocations != adapts + 1:
            raise AssertionError("serving plane: the cache hit across the "
                                 "swap")
        canary = swap["canary"]
        with torch.no_grad():
            bad = tree_map(lambda x: x.clone(), eng.state.params)
            leaf = next(iter(next(iter(bad.values())).values()))
            leaf.view(-1)[0] = float("nan")
            v3 = publish(3, bad)
        t0 = time.perf_counter()
        roll = eng.maybe_hot_swap(force=True)
        roll_s = time.perf_counter() - t0
        again = eng.maybe_hot_swap(force=True)
        eng.submit(request())
        check_ok(eng.drain(), "after the rollback")
        if (not roll or roll["swapped"]
                or eng.registry.counter("serve/hot_swap_rollbacks").value
                != 1 or v3["version"] not in eng._rejected_versions
                or again is not None
                or eng._model_version != v2["version"]):
            raise AssertionError(f"serving plane: v3 not rolled back: "
                                 f"{roll}, then {again}")
        print(f"serving plane: hot-swap to v{v2['version']} in "
              f"{swap_s * 1e3:.1f} ms poll to adopt (canary adapt live "
              f"{canary['live']['adapt_seconds'] * 1e3:.2f} ms, candidate "
              f"{canary['candidate']['adapt_seconds'] * 1e3:.2f} ms, each "
              f"warmed first; probe accuracy {canary['live']['accuracy']:.3f}"
              f" -> {canary['candidate']['accuracy']:.3f}), the repeat "
              f"missed the cache after it; v{v3['version']} (NaN weight) "
              f"rolled back in {roll_s * 1e3:.1f} ms "
              f"({roll['canary']['reason']}), pinned, v{v2['version']} "
              f"serves finite logits ({card})", flush=True)

        per_forward = _bn_per_forward(base)
        runs = [(e.adapt_runs, e.predict_runs) for e in engines]
        want = sum(per_forward * eng.num_adapt_steps * a + per_forward * p
                   for a, p in runs)
        launches = bn_act.launches
        if launches != want:
            raise AssertionError(
                f"serving plane: bn_act launched {launches} times, the "
                f"engines' batches need {want} ({runs} adapt/predict runs)")
        entry["launches"] += launches
        print(f"serving plane: bn_act launches {launches} = "
              f"{per_forward * eng.num_adapt_steps} x adapt + "
              f"{per_forward} x predict batches over {runs} (warm-ups and "
              f"canaries included) ({card})", flush=True)
        for e in engines:
            e.close()
        engines.clear()
        marks.append(("hot_swap", time.perf_counter()))

        # The fleet: 2 replica processes on this card.
        fleet_out = os.path.join(tmp, "fleet")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, FLEET_SCRIPT, *FLEET_ARGS, "--out", fleet_out],
            capture_output=True, text=True, timeout=600, cwd=REPO)
        fleet_s = time.perf_counter() - t0
        try:
            art = json.loads(proc.stdout.strip().splitlines()[-1])
        except (IndexError, ValueError):
            art = {"status": "no artifact", "stderr": proc.stderr[-3000:]}
        mig = art.get("migration") or {}
        kern = (art.get("bn_act_launches") or {})
        if (proc.returncode != 0 or art.get("status") != "ok"
                or not art.get("zero_dropped")
                or (art.get("rollout") or {}).get("state") != "done"
                or mig.get("second_tier") != "l2"
                or mig.get("target_adapt_delta") != 0):
            logs = ""
            for name in sorted(os.listdir(fleet_out)) if os.path.isdir(
                    fleet_out) else []:
                if name.endswith(".log"):
                    with open(os.path.join(fleet_out, name)) as f:
                        logs += f"--- {name}\n{f.read()[-1500:]}\n"
            raise AssertionError(f"serving plane: fleet bench rc "
                                 f"{proc.returncode}: {json.dumps(art)}\n"
                                 f"{logs}")
        fleet_launches = 0
        for leg in ("single", "fleet"):
            acc = kern.get(leg)
            if acc is None:
                continue
            for rid, k_ in acc["replicas"].items():
                want_r = (per_forward * eng.num_adapt_steps * k_["adapt_runs"]
                          + per_forward * k_["predict_runs"])
                if k_["bn_act_launches"] != want_r:
                    raise AssertionError(
                        f"serving plane: {leg} replica {rid} launched "
                        f"bn_act {k_['bn_act_launches']} times, its "
                        f"batches need {want_r}: {k_}")
                fleet_launches += k_["bn_act_launches"]
                print(f"serving plane: {leg} replica {rid}: bn_act "
                      f"launches {k_['bn_act_launches']} = "
                      f"{per_forward * eng.num_adapt_steps} x "
                      f"{k_['adapt_runs']} adapt + {per_forward} x "
                      f"{k_['predict_runs']} predict batches; peak memory "
                      f"{k_['max_memory_allocated'] / 2**30:.2f} GiB "
                      f"({card})", flush=True)
        entry["launches"] += fleet_launches
        single, fleet = art["single"], art["fleet"]
        print(f"serving plane: fleet bench {fleet_s:.1f} s "
              f"({' '.join(FLEET_ARGS)}): single leg {single['qps']} req/s "
              f"p50 {single['p50_ms']} ms p95 {single['p95_ms']} ms; fleet "
              f"leg {fleet['qps']} req/s p50 {fleet['p50_ms']} ms p95 "
              f"{fleet['p95_ms']} ms (fleet / single "
              f"{art['fleet_speedup_vs_single']} at unequal windows: "
              f"{single['max_outstanding']} requests outstanding in the "
              f"single leg, {fleet['max_outstanding']} in the fleet leg, "
              f"over {single['wall_seconds']} s and {fleet['wall_seconds']} "
              f"s of load; both replicas share the card); L2 hit fraction {art['fleet_l2_hit_frac']}, L1 "
              f"{fleet['l1_hit_frac']}; rolling swaps "
              f"{art['fleet_rolling_swaps']}, halts "
              f"{art['fleet_rolling_swap_halts']}, rollout "
              f"{json.dumps(art['rollout'])}; spills "
              f"{art['fleet_router_spills']}; zero dropped; migration "
              f"{json.dumps(mig)}; replica start-up "
              f"{json.dumps(art['startup_seconds'])} s ({card})",
              flush=True)

        # One fleet answer against the plain version on the same
        # version's checkpoint, in this process.
        probe = np.load(os.path.join(fleet_out, "fleet_probe.npz"))
        fleet_models = os.path.join(fleet_out, "saved_models")
        rec = ModelRegistry(fleet_models).get(int(probe["version"]))
        fcfg = MAMLConfig.from_json_file(os.path.join(
            fleet_out, "cfg_fleet.json")).replace(serve_l2_dir="")
        peng = ServingEngine.from_checkpoint(fcfg, fleet_models,
                                             tag=int(rec["tag"]),
                                             device="cuda")
        engines.append(peng)
        req = FewShotRequest(support_x=probe["support_x"],
                             support_y=probe["support_y"],
                             query_x=probe["query_x"])
        bucket = peng.batcher.buckets[0]
        batch = pad_group([req], bucket, fcfg.serve_batch_tasks,
                          fcfg.image_shape)
        qx = np.zeros((fcfg.serve_batch_tasks, bucket[1], h, w, c),
                      np.uint8)
        qx[:, :req.num_query] = req.query_x
        dev = torch.device("cuda")
        st = peng.state
        ad = adapt_task(fcfg, peng.model_apply, st.params, st.lslr,
                        st.bn_state,
                        torch.from_numpy(batch["support_x"]).to(dev),
                        torch.from_numpy(batch["support_y"]).to(
                            dev, torch.long),
                        torch.from_numpy(batch["support_w"]).to(dev),
                        num_steps=peng.num_adapt_steps, plain=True)
        lg = predict_tasks(fcfg, peng.model_apply, st.params, ad.fast,
                           ad.bn_state, torch.from_numpy(qx).to(dev),
                           num_steps=peng.num_adapt_steps, plain=True)
        plain = lg[0, :req.num_query].float().cpu()
        got = torch.from_numpy(probe["logits"]).float()
        cos = _cosine(got, plain)
        print(f"serving plane: fleet answer (replica "
              f"{mig['to_replica']}, tier l2, version {rec['version']}) vs "
              f"the plain version in process: cosine {cos:.6f}, max abs "
              f"diff {(got - plain).abs().max().item():.3e} (max |logit| "
              f"{plain.abs().max().item():.3e}) ({card})", flush=True)
        if cos < LOGITS_COSINE:
            raise AssertionError("serving plane: the fleet's answer and the "
                                 "plain version disagree")
        marks.append(("fleet", time.perf_counter()))
        print("phase 9 seconds per part: " + json.dumps(
            {b[0]: round(b[1] - a[1], 1) for a, b in zip(marks, marks[1:])}),
            flush=True)
    finally:
        for e in engines:
            e.close()
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(os.path.dirname(src), ignore_errors=True)
        torch.cuda.empty_cache()


# Phase 10: packed shards at mini-ImageNet's split geometry (classes x
# images per class, 84x84x3 uint8, ~1.27 GB in all) from seeded arrays
# (the dataset is not in the repo), and the flagship CLI trained from
# them under batched MSL targets and the 'conv_outs' remat policy at
# phase 5's length cuts.
PACK_SPLITS = {"train": 64, "val": 16, "test": 20}
PACK_IMAGES = 600
PACK_CLI_ARGS = ["--msl_target_batching", "on", "--remat_policy",
                 "conv_outs"]
REPORT_SCRIPT = os.path.join(REPO, "scripts", "torch_telemetry_report.py")


def data_path(entry: dict, card: str) -> None:
    """Phase 10: (1) write MAMLPACK1 shards at mini-ImageNet's split
    geometry with the port's ``write_shard`` (fewer images per class,
    printed, if the disk lacks room); (2) verify every class CRC; (3) time
    the open; (4) the first train batch sampled from the pack against one
    sampled from an ``ArraySource`` over the same arrays, bitwise; (5) the
    flagship CLI in process on the shards (``CLI_ARGS`` +
    ``PACK_CLI_ARGS``): exit 0, the derived BN-kernel launches,
    ``data/pack_open_seconds`` and ``data/pack_bytes_mapped`` in
    ``metrics.prom``, ``feed_stall_frac`` reported; (6)
    ``scripts/torch_telemetry_report.py`` over the run: its last line
    parses and counts the run's steps. Adds (5)'s launches to ``entry``."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    from howtotrainyourmamlpytorch_tpu_torch.data import (
        ArraySource, EpisodeSampler, MetaLearningDataLoader, source_kind)
    from howtotrainyourmamlpytorch_tpu_torch.datastore import (
        PackedSource, write_shard)
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import read_jsonl

    runs_dir = os.path.join(REPO, ".smoke_runs")
    os.makedirs(runs_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="data_", dir=runs_dir)
    marks = [("start", time.perf_counter())]
    try:
        cfg = MAMLConfig.from_json_file(FLAGSHIP)
        shape = cfg.image_shape
        per_class = int(np.prod(shape)) * PACK_IMAGES
        need = sum(PACK_SPLITS.values()) * per_class
        free = shutil.disk_usage(tmp).free
        images = PACK_IMAGES
        if free < 3 * need:   # the shard, its sidecar, headroom
            images = max(2 * (cfg.num_samples_per_class
                              + cfg.num_target_samples),
                         PACK_IMAGES * free // (3 * need))
            print(f"data: {free / 2**30:.2f} GiB free, {need / 2**30:.2f} "
                  f"GiB needed: {images} images per class, not "
                  f"{PACK_IMAGES}", flush=True)
        packs = os.path.join(tmp, "packs")
        rng = np.random.default_rng(0)
        train = {}
        for split, n in PACK_SPLITS.items():
            classes = {f"{split}_{i:03d}": rng.integers(
                0, 256, (images,) + tuple(shape), dtype=np.uint8)
                for i in range(n)}
            write_shard(os.path.join(packs, f"{split}.mamlpack"),
                        classes.items(),
                        provenance={"tool": "chip_smoke.py", "split": split})
            if split == "train":
                train = classes
        sizes = {split: os.path.getsize(os.path.join(packs,
                                                      f"{split}.mamlpack"))
                 for split in PACK_SPLITS}
        marks.append(("write", time.perf_counter()))

        crcs = {split: len(PackedSource(os.path.join(
            packs, f"{split}.mamlpack")).verify()) for split in PACK_SPLITS}
        marks.append(("verify", time.perf_counter()))

        t0 = time.perf_counter()
        src = PackedSource(os.path.join(packs, "train.mamlpack"),
                           expected_image_shape=shape)
        open_ms = (time.perf_counter() - t0) * 1e3
        total_gib = sum(sizes.values()) / 2**30
        print(f"data: shards {json.dumps(sizes)} bytes ({total_gib:.3f} "
              f"GiB; classes {json.dumps(PACK_SPLITS)} x "
              f"{images} images of {tuple(shape)}) written; every class CRC "
              f"verified ({json.dumps(crcs)}); train shard opened in "
              f"{open_ms:.3f} ms, {src.nbytes_mapped} bytes mapped ({card})",
              flush=True)

        pcfg = cfg.replace(bn_backend="pallas", dataset_pack_path=packs)
        loader = MetaLearningDataLoader(pcfg, device="cuda")
        if source_kind(loader.sampler("train").source) != "packed":
            raise AssertionError("data: the loader did not read the pack")
        batches = loader.get_train_batches(0, 1)
        got = [t.cpu() for t in next(batches)]
        batches.close()
        ref = EpisodeSampler(ArraySource(train), pcfg, pcfg.train_seed,
                             augment_classes=pcfg.augment_images)
        eps = [ref.sample(i) for i in range(pcfg.batch_size)]
        want = [np.stack(field) for field in zip(*eps)]
        if not all(np.array_equal(g.numpy(), w) for g, w in zip(got, want)):
            raise AssertionError("data: the first train batch from the pack "
                                 "differs from the ArraySource's")
        print(f"data: first train batch from the pack (through the loader's "
              f"pinned copy to the card) bitwise the ArraySource's: "
              f"{[tuple(g.shape) for g in got]} ({card})", flush=True)
        del train, ref, eps, want, got, loader
        marks.append(("batch", time.perf_counter()))

        bn_act.reset_launches()
        rc, builder, run_s = _cli_run(
            PACK_CLI_ARGS + ["--dataset_pack_path", packs],
            os.path.join(tmp, "run"))
        launches = bn_act.launches
        bcfg = builder.cfg
        want_launches = _train_path_launches(
            bcfg, bcfg.total_epochs, bcfg.total_iter_per_epoch,
            val_sweeps=bcfg.total_epochs,
            test_models=bcfg.max_models_to_save)
        if rc != 0 or launches != want_launches:
            raise AssertionError(f"data cli: exit {rc}, bn_act launched "
                                 f"{launches} times, derived {want_launches}")
        entry["launches"] += launches
        kinds = {split: source_kind(builder.data.sampler(split).source)
                 for split in PACK_SPLITS}
        logs = builder.paths["logs"]
        prom = _parse_prometheus(os.path.join(logs, "metrics.prom"))
        rows = read_jsonl(os.path.join(logs, "events.jsonl"))
        stall = [r["feed_stall_frac"] for r in rows
                 if r["event"] == "telemetry"]
        if (set(kinds.values()) != {"packed"}
                or not prom.get("data_pack_open_seconds", 0) > 0
                or prom.get("data_pack_bytes_mapped") not in {
                    float(n * images * int(np.prod(shape)))
                    for n in PACK_SPLITS.values()}
                or len(stall) != bcfg.total_epochs
                or not all(0 <= v <= 1 for v in stall)):
            raise AssertionError(
                f"data cli: sources {kinds}, metrics.prom "
                f"{ {k: v for k, v in prom.items() if k.startswith('data')} }"
                f", feed_stall_frac {stall}")
        stats, test, _ = _verify_run("data cli", builder, 2, 2, 48)
        print(f"data cli: exit 0 in {run_s:.1f} s from the packed shards "
              f"({kinds}; msl_target_batching={bcfg.msl_target_batching!r}, "
              f"remat_policy={bcfg.remat_policy!r}); epoch seconds "
              f"{stats['epoch_seconds']}, train loss {stats['train_loss']}, "
              f"test {test['test_accuracy_mean']}; feed_stall_frac {stall}; "
              f"metrics.prom data/pack_open_seconds "
              f"{prom['data_pack_open_seconds']:.6f} (three splits), "
              f"data/pack_bytes_mapped {prom['data_pack_bytes_mapped']:.0f} "
              f"(the split opened last); bn_act launches {launches} = "
              f"{want_launches} ({card})", flush=True)
        marks.append(("cli", time.perf_counter()))

        out = subprocess.run([sys.executable, REPORT_SCRIPT,
                              builder.paths["base"]], capture_output=True,
                             text=True, timeout=120, cwd=REPO)
        summary = json.loads(out.stdout.strip().splitlines()[-1])
        steps = bcfg.total_epochs * bcfg.total_iter_per_epoch
        if (out.returncode != 0 or summary.get("steps") != steps
                or summary["data"]["source_kind"] != "packed"):
            raise AssertionError(f"data report: exit {out.returncode}, "
                                 f"{out.stdout[-2000:]} {out.stderr[-2000:]}")
        print(f"data report (scripts/torch_telemetry_report.py): steps "
              f"{summary['steps']}, epochs {summary['epochs']}, step p50 "
              f"{summary['step_seconds_p50']} s, feed_stall_frac "
              f"{summary['feed_stall_frac']}, data "
              f"{json.dumps(summary['data'])} ({card})", flush=True)
        marks.append(("report", time.perf_counter()))
        print("phase 10 seconds per part: " + json.dumps(
            {name: round(t - marks[i][1], 1)
             for i, (name, t) in enumerate(marks[1:])}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


def _epoch_seconds(logs: str) -> list:
    """A run's epoch seconds from its ``summary_statistics.csv``."""
    from howtotrainyourmamlpytorch_tpu_torch.utils.storage import (
        load_statistics)
    return [round(float(v), 2)
            for v in load_statistics(logs)["epoch_seconds"]]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from howtotrainyourmamlpytorch_tpu_torch.ops import build
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e}); run from "
              f"the root of a checkout", file=sys.stderr)
        return 2
    card = _card_line()
    device_name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}",
          flush=True)

    t0 = time.perf_counter()
    built = {"bn_act": build.load("bn_act")}
    print(f"build: {sorted(built)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, b in built.items():
        print(f"build {name}: nvcc {b.seconds:.2f} s\n{b.log.strip()}",
              flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("tf32: cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False",
          flush=True)

    t1 = time.perf_counter()
    entry = check_bn_act(device_name, card)
    seconds = {"bn_act": round(time.perf_counter() - t1, 1)}
    results = {}
    for name, phase in (("serve", serve_flagship), ("train", train_flagship),
                        ("cli", cli_flagship),
                        ("backbones", other_backbones),
                        ("telemetry", lambda e, c: cli_telemetry(
                            e, c, results["cli"])),
                        ("faults", fault_path),
                        ("serving", lambda e, c: serving_plane(
                            e, c, results["cli"]["saved_models"])),
                        ("data", data_path)):
        t1 = time.perf_counter()
        results[name] = phase(entry, card)
        seconds[name] = round(time.perf_counter() - t1, 1)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all, build "
          f"included; seconds per phase {json.dumps(seconds)}", flush=True)

    print(card, flush=True)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
