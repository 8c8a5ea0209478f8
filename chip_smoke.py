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
   conv backbones. Then one call at S0 and one at T0 captured into a
   CUDA graph (``parallel/aot.py § GraphExec``; the cooperative launch
   under stream capture) and replayed: bitwise the eager call, the
   launch counter as derived (the capture's eager warm-up counts, the
   capture does not, each replay adds its one launch), the eager call's
   and the replay's wall times side by side.
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
   5's (a run whose sampled window lacks only a label its step runs,
   every other check of the row met, is printed and taken again, at
   most twice). Then
   what health and a sample window add to a step and what the
   profiler labels cost with the profiler off (the port's sampler beside
   this script's own profile of one step is phase 4's and phase 6's).
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
11. The serving fleet's harnesses and operator tools at the flagship's
   full width, serving phase 5's checkpoint (``fleet_harnesses``):
   ``scripts/torch_serve_bench.py`` in process, at rate 0 and at half
   the throughput it read (every request answered, none past a deadline
   at rate 0, the BN kernel's launches equal to the engine's batches');
   ``scripts/torch_chaos_fleet.py`` with 3 replica processes on this
   card (``CHAOS_ARGS``: a replica SIGKILLed mid-leg with zero lost
   requests, a restart and the fleet back to 3 live; a poisoned slot's
   crash loop tripping the breaker while 2 serve; a burst shed at
   admission with every admitted request inside its deadline; every
   alert fired and resolved and the console showing none firing);
   ``scripts/torch_traffic_replay.py`` (``REPLAY_ARGS``: a 14 s shaped
   trace through the fixed, cb and rollout legs, cb p95 < fixed p95,
   the SLO held, the weighted rollout done, a scale-up), every request
   traced; each replica's launches, the restarted one's included, equal
   to its own batches'; ``scripts/torch_slo_report.py`` counting the
   replay's traces; ``scripts/torch_trace_export.py`` over phase 5's
   run, its ``trace.json`` valid. Prints each replica's boot and restart
   seconds, the kill's restoration seconds, the replay's calibrated
   operating point and "phase 11 seconds per part".

12. The mesh (``mesh_path``), each leg in subprocesses with a time limit
   (a rank that fails, hangs or cannot join its group fails the phase;
   (a)'s and (c)'s ranks run beside (b)'s witness and CLI ranks, the
   CLI's resumed half as soon as its paused half ends, for run time):
   (a) a one-rank NCCL group running a flagship second-order step
   (twice: the second timed warm) at full width through
   ``make_sharded_steps`` (12 one-task microbatches, f32, deterministic
   cuDNN) on phase 4's state and batch: its loss and
   meta-gradient (through the same fused all-reduce) bitwise phase 4's
   unsharded step, else held to ``F32_FLOORS``, its BN-kernel launches
   the derived 336; then the same rank through its graphs on a fresh
   store (``_rank_graph_steps``: the accumulation and the update, the
   NCCL all-reduce run eagerly between them): two steps eager and
   replayed from phase 4's state bitwise (state, Adam moments, metrics,
   counters), launches as derived, one miss, no demotion
   (``aot/exec_fallbacks`` 0); (b) two gloo ranks sharing the card:
   first a witness
   in f32, phase 4's batch split over the ranks, whose reduced
   meta-gradient must meet ``F32_FLOORS`` against phase 4's one-rank one
   and whose rank left unreduced (a planted fault) ``BF16_FLOORS`` must
   refuse; then ``torchrun
   --nproc_per_node 2`` of the port's CLI on the flagship JSON with
   ``--mesh_shape 1 2`` and phase 5's length cuts (``MESH_CLI_ARGS``: 6
   tasks in 6 microbatches per rank), paused after epoch 0 and resumed:
   losses bitwise equal across ranks, per-rank launches as derived, only
   rank 0 writing checkpoints, both ranks resuming at iteration 3, the
   epoch train losses and weight updates held to phase 5's one-rank run
   by ``BF16_FLOORS`` (phase 5 runs bf16); per-rank step ms, all-reduce
   ms and peak memory printed; (c) the ResNet-12 pod JSON at full width
   on (1, 2) over two gloo ranks (``R12_MESH_ARGS``: 8 tasks per rank in
   8 microbatches), one second-order MSL step per rank through the
   train step the builder's loop calls: losses equal across ranks and
   finite, launches as
   derived, the cuts printed on one line; then the same step from the
   same state through each rank's graphs (the builder's plan, a fresh
   store; the gloo all-reduce staged between them): bitwise per rank,
   replayed losses equal across ranks, launches as derived, nothing
   demoted; the graphs' pool memory printed beside the eager peak, and
   one replay's wall and device ms under the profiler (nothing claimed
   from them); the pod JSON's own cluster knobs (600 s budget) stay on,
   as in phase 6.
13. The pod fault domain (``pod_fault_domain``), through
   ``scripts/torch_chaos_pod.py`` (gloo ranks sharing the card, started
   by the harness, on the flagship JSON with phase 5's length cuts and
   ``POD_ARGS``: a 20 s cluster budget and 1 s leases, cut for run time;
   each leg's ranks in a 300 s limit; legs (a)-(b) and (c) in two
   harness processes side by side and (d) in this process beside them,
   for run time): (a) 2 ranks, ``kill_peer`` on
   host 1 mid-epoch 1: rank 0 exits 73 within the budget + 60 s, its
   ``peer_lost`` row and crash bundle name host 1, ``metrics.prom``
   counts 1 peer loss, its launches as derived to the kill (the victim's
   count is unreadable); (b) both restart: the committed epoch file's CRC
   pinned, both resume at its iteration and finish; then rank 1 reads
   the run through a ``MANIFEST.json`` one epoch stale: both log the
   consensus, resume from the older epoch and end on the same final
   checkpoint bytes; (c) 3 ranks with ``elastic_mode 1`` and a
   warm-start store (``aot_store_dir``, filled for the 2-rank survivor
   roster by ``scripts/torch_aot_prewarm.py --degraded 1
   --degraded-only``, run on the leg's config as a phase child beside
   phase 12 and handed to the leg, ``--elastic-prewarm``; run alone,
   the leg runs it first), their steps as CUDA graphs around each rank's gloo
   all-reduce, ``kill_peer`` on host 0 (the writer of the checkpoints and
   of the store, and the process group's host): hosts 1 and 2 agree on
   generation 1, restart in place as ranks 0 and 1 of 2 and finish (exit
   0, one reshard), each reaching its first step with
   ``compiles_before_first_step == 0``, no miss, no ``nvcc`` run and no
   executable demoted; a cold 2-rank run (eager, no store) at the
   survivor geometry from a snapshot of the committed state ends bitwise
   the survivors' final checkpoint; every process's launches as derived
   for its generation, the captures' warm-ups included; the reshard wall
   printed beside PR 12's eager one;
   (d) phase 5's CLI run on one rank with the domain armed (``POD_ARMED``)
   ends bitwise phase 5's final state with the same launches, its lease
   and heartbeat lease ages written. Prints the trip latency, the reshard
   wall, the consensus-resume wall and each rank's step ms.
14. The warm start (``warm_start``; ``parallel/aot.py``), at the
   flagship's full width with both knobs on fresh directories: (a) an
   eager engine, a cold engine on a fresh store (misses, captured and
   recorded) and a second engine on that store (hits, no misses) answer
   the same 16 requests under deterministic cuDNN: logits bitwise, the
   BN kernel's launches 20 per adapt run and 4 per predict run, captures'
   warm-ups and replays included; (b) four train steps (epochs 0, 0, 41,
   41: two ``opt.count`` values per phase key) eagerly and through the
   phase keys' CUDA graphs from one state: state, Adam moments and
   metrics bitwise (else printed and held to ``F32_FLOORS``), one eval
   batch bitwise, launches as derived, step times and one profiled step
   of each printed (nothing claimed from them); (c) the chaos harness's
   warm-restart leg (``scripts/torch_chaos_run.py``): the prewarm script
   as a child (started beside (a) and (b), with ``--serve``), then the
   CLI on the warm store as a child, phase 5's length cuts: exit 0, hits
   > 0, no miss, no ``nvcc`` run; a cold CLI child beside (a) and (b)
   gives the cold time to first step.
15. The autotuner (``tune_sweep``; ``tune/``, ``scripts/torch_autotune.py``)
   on the flagship JSON at full width with the hand-written kernel and
   remat 'dots' (``TUNE_BASE``: the shipped 'block_outs' is then a known
   faster point of the same program), 3 timed steps per trial, over
   ``TUNE_SPEC``: remat 'block_outs' x ``cudnn_deterministic`` false
   and a value no option takes (the baseline and two trials); the
   parity gate at its default tolerance, the accuracy gate skipped
   (recorded) and ``--prove-warm-train``. The unknown value is counted
   ``invalid_flag`` and the sweep goes on; every ``ok`` trial ran on the card with BN-kernel launches (added
   to the kernel's entry); ``TUNED.json`` holds ``adopted`` and a
   reason. The winner is known by construction: ('block_outs', false)
   must be adopted, its parity bitwise, its ``bitwise_resume`` false,
   and its warm train (the prewarmed tuned store, the trainer CLI on it)
   must read ``compiles_before_first_step == 0``; the same command again
   runs no trial; no process of the phase is left. Each trial's rate and
   the winner are printed, not gated.
16. The measurement scripts (``script_sweeps``): each of the seven,
   ``scripts/torch_bf16_drift.py`` and ``scripts/torch_perf_{variants,
   sweep,msl,eval,microbatch_sweep,resnet12_sweep}.py``, once in a
   process of its own at full width (``SCRIPT_RUNS``: the flagship JSON,
   the pod JSON for the ResNet-12 sweep, one point per sweep, two
   trajectory steps for the drift). Each must exit 0 with rows that
   parse and hold no ``error``; every sweep row's graph leg ran; every
   row (both legs) launched the BN kernel (the launches are added to the
   kernel's entry); no process of the script is left. The drift probes
   are held to ``DRIFT_FLOORS``; rates are printed, not gated.

Phase 7's perf-row check also holds the port's sampler to its count of
lost records: a row whose BN-kernel records fall short of the step's
launches must count the shortfall in ``device_records_lost``.

Phases 6, 8, 14, 15 and 16 need nothing of the others: each runs in a
child process (``chip_smoke.py --phase-child <name> <out>``) beside
others, for run time (``PHASE_SCHEDULE``: 6 and 15 beside 3-5 and 7; 8
and 14 beside 9, 10 and 12; 16 beside 3-10 and 12; 13 (c)'s
survivor-roster prewarm beside 12);
phases 2, 11 and 13 run beside nothing.

Every child process starts in a session of its own through one helper
(``_spawn``, ``_finish``, ``_child``), which ends the session (SIGTERM,
then SIGKILL after ``TERM_GRACE_S``) and waits on it on return, error or
time-out; the harnesses reap their own children, SIGTERM included
(``utils/reaper.py``). Before its last lines the script prints the
processes it started that are still alive and the compute processes on
the card other than itself, and fails naming them if either list is not
empty.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Exits non-zero without a result
when no CUDA device is available or the port's package is missing.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
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
                "--require_mesh", "0",
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


# Every process this script starts, as (tag, Popen), each the leader of a
# session of its own (_spawn); main() lists those still alive at the end.
_STARTED: list = []
# Seconds a child has to reap its own children after SIGTERM before its
# session is killed.
TERM_GRACE_S = 10.0


def _spawn(tag: str, cmd, *, env=None, stdout=subprocess.PIPE,
           stderr=subprocess.PIPE, text: bool = True) -> subprocess.Popen:
    """Start ``cmd`` from the repo's root in a session of its own (so its
    whole process group can be reaped, grandchildren included), and
    remember it. Every child of this script starts here."""
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=stdout,
                            stderr=stderr, text=text,
                            start_new_session=True)
    _STARTED.append((tag, proc))
    return proc


def _reap(proc: subprocess.Popen) -> None:
    """End ``proc``'s session: SIGTERM while the leader runs (a harness
    reaps its own children on it), SIGKILL to what is left after
    ``TERM_GRACE_S``, then wait on the leader."""
    def kill(sig) -> None:
        with contextlib.suppress(ProcessLookupError, PermissionError):
            os.killpg(proc.pid, sig)
    if proc.poll() is None:
        kill(signal.SIGTERM)
        with contextlib.suppress(subprocess.TimeoutExpired):
            proc.wait(timeout=TERM_GRACE_S)
    kill(signal.SIGKILL)
    proc.wait()


def _finish(tag: str, proc: subprocess.Popen, timeout: float
            ) -> subprocess.CompletedProcess:
    """Wait for a :func:`_spawn` child (output read), then reap its
    session, whether it exited, raised or outlived ``timeout`` (then
    ``TimeoutError`` with its output's tail). A child that exited while
    processes of its session still hold its output pipes has them
    killed (printed), not waited for."""
    deadline = time.monotonic() + timeout
    try:
        while True:
            try:
                out, err = proc.communicate(timeout=1.0)
                break
            except subprocess.TimeoutExpired:
                if proc.poll() is not None:
                    left = _pgrp_members({proc.pid})
                    print(f"chip_smoke: {tag} exited leaving {left}; "
                          f"killed", flush=True)
                    _reap(proc)
                    out, err = proc.communicate(timeout=10)
                    break
                if time.monotonic() > deadline:
                    _reap(proc)
                    out, err = proc.communicate(timeout=10)
                    raise TimeoutError(
                        f"{tag}: no exit within {timeout} s; its session "
                        f"was killed. Output tail: {(out or '')[-2000:]}"
                        f"{(err or '')[-2000:]}")
    finally:
        _reap(proc)
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def _child(tag: str, cmd, timeout: float, env=None
           ) -> subprocess.CompletedProcess:
    """Run ``cmd`` to its end as a child of its own session
    (:func:`_spawn`, :func:`_finish`); stdout and stderr captured."""
    return _finish(tag, _spawn(tag, cmd, env=env), timeout)


def _reap_all() -> None:
    """Reap every child session this script started (a phase that
    raised may leave one running)."""
    for _, proc in _STARTED:
        _reap(proc)


def _processes() -> list:
    """``(pid, ppid, pgid, command)`` of every live process (read from
    /proc), zombies left out."""
    found = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        fields = stat[stat.rfind(")") + 2:].split()
        if fields[0] != "Z":
            found.append((int(name), int(fields[1]), int(fields[2]),
                          cmd.strip()[:120]))
    return found


def _pgrp_members(pgids) -> list:
    """``(pid, command)`` of the live processes in the groups ``pgids``."""
    return [(pid, cmd) for pid, _, pgid, cmd in _processes()
            if pgid in pgids]


def _survivors() -> list:
    """The processes this script started that are still alive, as
    ``(pid, command)``: every member of a :func:`_spawn` child's session,
    and every descendant of this process (a library's worker, a
    harness's child run in process)."""
    procs = _processes()
    groups = {proc.pid for _, proc in _STARTED}
    kids: dict = {}
    for pid, ppid, _, _ in procs:
        kids.setdefault(ppid, []).append(pid)
    mine, todo = set(), [os.getpid()]
    while todo:
        for pid in kids.get(todo.pop(), []):
            if pid not in mine:
                mine.add(pid)
                todo.append(pid)
    return [(pid, cmd) for pid, _, pgid, cmd in procs
            if (pgid in groups or pid in mine) and pid != os.getpid()]


def _own_pids() -> set:
    """This process's pid in every PID namespace it is in (a card's
    process list may show the host's)."""
    pids = {os.getpid()}
    with contextlib.suppress(OSError):
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("NSpid:"):
                    pids.update(int(v) for v in line.split()[1:])
    return pids


def _card_processes() -> list:
    """Compute processes on the card other than this one, as
    ``nvidia-smi --query-compute-apps=pid`` lists them."""
    out = _child("nvidia-smi compute-apps",
                 ["nvidia-smi", "--query-compute-apps=pid,process_name,"
                  "used_memory", "--format=csv,noheader"], timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi --query-compute-apps failed: "
                           f"{out.stderr.strip()}")
    rows = [[v.strip() for v in line.split(",")]
            for line in out.stdout.strip().splitlines() if line.strip()]
    mine = _own_pids()
    others = [r for r in rows if not (r[0].isdigit() and int(r[0]) in mine)]
    if rows and len(others) == len(rows):
        # No row carries this process's pid: the card reports pids of
        # another PID namespace (in a container, every row may read as
        # pid 1). This process holds a context, so one row is its own:
        # the one holding the most memory is taken as it.
        mib = lambda r: float((r[2].split() or ["0"])[0]) if len(r) > 2 \
            else 0.0
        others.remove(max(rows, key=mib))
    print(f"chip_smoke: compute apps on the card {rows}; this process "
          f"{sorted(mine)}", flush=True)
    return others


def _card_line() -> str:
    out = _child("nvidia-smi", ["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


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


# Profiler windows a device-time measurement may take before it fails,
# and the pause before the n-th retake (n x this, seconds): the tracer's
# record losses come in runs.
DEVICE_WINDOWS = 8
RETAKE_PAUSE_S = 0.5


def _complete_window(names, iters: int) -> bool:
    """Whether a window's kernel records can be those of ``iters`` whole
    calls: the calls run the same kernels, so the count is a multiple of
    ``iters`` and the names in start order repeat with the call's
    period. A window the tracer dropped records from breaks the count or
    the period unless whole calls' worth went (the caller holds the count
    to a complete window's for that), whether or not it also lost the
    launch records."""
    n = len(names)
    if n == 0 or n % iters:
        return False
    k = n // iters
    return all(names[i] == names[i % k] for i in range(n))


def _device_ms(fn, iters: int = 20, attempts: int = DEVICE_WINDOWS,
               label: str = "device time", retakes: list = None,
               required: bool = True, per_call: int = None):
    """Device time of one call: the profiler's kernel durations summed over
    ``iters`` calls, per call, and the device kernels per call. The window
    has the port sampler's guards (``telemetry/profiler.py``): ~50 ms of
    tiny kernels open the session before the window (the tracer drops
    device records early in a session), the calls run inside a
    ``WINDOW_MARKER`` range, and a ``WINDOW_TAIL`` sentinel kernel closes
    it (a dropped tail shows as its missing record). A window is held
    to the record count of a complete one (:func:`_complete_window`):
    ``per_call``, the call's kernel count, where it is known; else the
    count of the first window whole by that rule, which the next window
    must then hold (records are only ever dropped, so two windows at one
    count are whole). A window that falls short, or that lost launch
    records, is printed, appended to ``retakes`` and taken again after a
    pause that grows with each retake, up to ``attempts`` windows: the
    tracer drops kernel records at random, whole windows included, and at
    times in runs of several (PERF.md § 7). When every
    window falls short it raises, or returns (None, None) where the
    reading is not ``required``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from howtotrainyourmamlpytorch_tpu_torch.telemetry.profiler import (
        WINDOW_MARKER, WINDOW_TAIL, window_records)
    fn()
    torch.cuda.synchronize()
    sentinel = torch.zeros(1, device="cuda")
    ref = per_call  # the kernels per call of a complete window
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                sentinel.add_(1.0)
                time.sleep(0.001)
            torch.cuda.synchronize()
            with record_function(WINDOW_MARKER):
                for _ in range(iters):
                    fn()
                with record_function(WINDOW_TAIL):
                    sentinel.add_(1.0)
                torch.cuda.synchronize()
        win = window_records(prof.profiler.kineto_results.events())
        lo, hi = win.span if win.span else (0, 0)
        # A record belongs to the window by its launch or, for a kernel
        # launched outside any torch op (the BN kernel's ctypes launch
        # has no linked host record), by its start: the warm-up's
        # kernels ended before the window opened.
        kernels = [(name, (end - start) / 1e6)
                   for name, start, end, launch in sorted(
                       win.records, key=lambda r: r[1])
                   if lo <= (start if launch is None else launch) <= hi]
        names = [n for n, _ in kernels]
        whole = _complete_window(names, iters) and not win.lost
        if whole and len(names) == (ref or 0) * iters:
            return (sum(ms for _, ms in kernels) / iters,
                    len(kernels) / iters)
        if whole and per_call is None and len(names) > (ref or 0) * iters:
            # The call's kernel count is not known: the fullest window so
            # far sets it, and the next window must hold as many.
            ref = len(names) // iters
            print(f"{label}: window {attempt + 1} holds {len(names)} "
                  f"kernel records ({ref} per call); the next window must "
                  f"hold as many", flush=True)
            continue
        if retakes is not None:
            retakes.append({"label": label, "window": attempt + 1,
                            "records": len(kernels), "lost": win.lost})
        print(f"{label}: window {attempt + 1} of {attempts} holds "
              f"{len(kernels)} kernel records over {iters} calls (a "
              f"complete window: {iters} x "
              f"{ref if ref is not None else 'the call'}'s "
              f"kernels, repeating per call), {win.lost} launches lost "
              f"(tracer-dropped device records)"
              f"{'; taken again' if attempt + 1 < attempts else ''}",
              flush=True)
        if attempt + 1 < attempts:
            time.sleep(RETAKE_PAUSE_S * (attempt + 1))
    if required:
        raise AssertionError(f"{label}: all {attempts} profiler windows "
                             f"lost device records")
    return None, None


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
    retakes = []
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
            dev_ms, per_call = _device_ms(
                kernel, label=f"bn_act {r}x{p} device time",
                retakes=retakes, per_call=1)
            lib_dev_ms, lib_per_call = _device_ms(
                library, label=f"library {r}x{p} device time",
                retakes=retakes, required=False)
        if per_call != 1:
            raise AssertionError(f"bn_act {r}x{p}: {per_call} device "
                                 f"kernels per call, want 1")
        nbytes = bn_act.bn_act_bytes(r, p, x.element_size())
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
    print(f"bn_act timing: {len(retakes)} profiler window(s) retaken for "
          f"lost device records over {2 * len(rows)} device-time "
          f"measurements {json.dumps(retakes)} ({card})", flush=True)
    _bn_act_counted_bytes(gen, bw, card)
    graphs = _bn_act_graphs(card)
    top = stages[0]
    return {"name": "bn_act", "route": "cuda",
            "source": "howtotrainyourmamlpytorch_tpu_torch/csrc/bn_act.cu",
            "replaces": "howtotrainyourmamlpytorch_tpu/ops/pallas_fused.py:67",
            "launches": None, "max_abs_err": max(max_err.values()),
            "ms": top["ms"], "device_ms": top["device_ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "library_device_ms": top["library_device_ms"],
            "shape": top["shape"], "dtype": "bfloat16", "stages": stages,
            "device_window_retakes": len(retakes), "graphs": graphs}


# PERF.md § 6's bound of the BN kernel at S0 (bf16), in ms.
S0_BOUND_MS = 0.0809


def _bn_act_counted_bytes(gen, bw: float, card: str) -> None:
    """The cost database's bytes of one kernel call at S0 (bf16): what
    the byte counter takes from the wrapper's report
    (``telemetry/profiler.py § count_costs``, ``ops/bn_act.py §
    byte_sinks``) must be ``bn_act_bytes``, with and without autograd;
    that rule over the card's HBM rate is printed beside PERF.md's
    bound."""
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import profiler
    r, p = SHAPES[0]
    x = (torch.randn(r, p, device="cuda", generator=gen) * 2.0
         + 0.3).to(torch.bfloat16)
    gamma = torch.rand(p, device="cuda", generator=gen) + 0.5
    beta = torch.randn(p, device="cuda", generator=gen) * 0.1
    rule = bn_act.bn_act_bytes(r, p, 2)
    with torch.no_grad():
        _, plain = profiler.count_costs(
            lambda: bn_act.bn_act(x, gamma, beta, 1e-5, 0.0))
    xs = x.clone().requires_grad_(True)
    _, grad = profiler.count_costs(
        lambda: bn_act.bn_act(xs, gamma, beta, 1e-5, 0.0))
    torch.cuda.synchronize()
    print(f"bn_act bytes at S0 {r}x{p} bf16: counted {plain['bytes_accessed']:.0f}"
          f" (no grad) and {grad['bytes_accessed']:.0f} (autograd) from the "
          f"wrapper's report; rule 2*R*P*2 + 16*P = {rule} B, over "
          f"{bw / 1e12:.2f} TB/s {rule / bw * 1e3:.4f} ms beside PERF.md's "
          f"bound {S0_BOUND_MS} ms (x and y alone "
          f"{2 * r * p * 2 / bw * 1e3:.4f} ms) ({card})", flush=True)
    if plain["bytes_accessed"] != rule or grad["bytes_accessed"] != rule:
        raise AssertionError(f"bn_act at S0: counted bytes {plain}, {grad}"
                             f", the rule {rule}")
    del x, xs


GRAPH_REPLAYS = 3


def _bn_act_graphs(card: str) -> dict:
    """Phase 2's CUDA-graph check of the cooperative launch: one call at
    S0 and one at T0 (bf16, slope 0) captured through
    ``parallel/aot.py § GraphExec``, replayed ``GRAPH_REPLAYS`` times;
    each replay bitwise the eager call, the count as derived (the
    capture's eager warm-up 1, the capture 0, each replay 1); the
    eager call's and the replay's wall times (CUDA events, median of
    20) printed side by side."""
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.parallel import aot

    gen = torch.Generator(device="cuda").manual_seed(1)

    def call(x, gamma, beta):
        with torch.no_grad():
            return bn_act.bn_act(x, gamma, beta, 1e-5, 0.0)

    out = {}
    for label, (r, p) in (("S0", SHAPES[0]), ("T0", TRAIN_SHAPES[0])):
        x = (torch.randn(r, p, device="cuda", generator=gen) * 2.0
             + 0.3).to(torch.bfloat16)
        gamma = torch.rand(p, device="cuda", generator=gen) + 0.5
        beta = torch.randn(p, device="cuda", generator=gen) * 0.1
        want = call(x, gamma, beta)
        before, captured = bn_act.launches, bn_act.captured
        graph = aot.GraphExec(f"bn_act_{label}", call, (x, gamma, beta))
        warm = bn_act.launches - before
        got = [graph(x, gamma, beta) for _ in range(GRAPH_REPLAYS)]
        torch.cuda.synchronize()
        counted = bn_act.launches - before
        bitwise = all(torch.equal(a, b) for g in got
                      for a, b in zip(want, g))
        if (not bitwise or warm != 1 or graph.launches != 1
                or bn_act.captured - captured != 1
                or counted != 1 + GRAPH_REPLAYS):
            raise AssertionError(
                f"bn_act graph {label} {r}x{p}: bitwise {bitwise}, "
                f"warm-up launches {warm} (want 1), captured "
                f"{graph.launches} (want 1), counted {counted} (want "
                f"{1 + GRAPH_REPLAYS})")
        eager_ms = _median_ms(lambda: call(x, gamma, beta))
        replay_ms = _median_ms(graph.graph.replay)
        out[label] = {"shape": [r, p], "eager_ms": eager_ms,
                      "replay_ms": replay_ms,
                      "capture_s": graph.capture_seconds}
        print(f"bn_act graph {label} {r}x{p} bf16: the cooperative launch "
              f"captured (capture {graph.capture_seconds:.3f} s), "
              f"{GRAPH_REPLAYS} replays bitwise the eager call, launches "
              f"counted {counted} = 1 warm-up + {GRAPH_REPLAYS} replays x "
              f"{graph.launches}; wall eager {eager_ms:.4f} ms, replay "
              f"{replay_ms:.4f} ms ({card})", flush=True)
        del graph, x, want, got
    torch.cuda.empty_cache()
    return out


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


def _deterministic_cost(label: str, fn, card: str) -> None:
    """Wall time of ``fn`` (synchronized) with cuDNN's deterministic
    algorithms on and off, one call of each in turns after one warm-up
    call of each, ``cudnn.benchmark`` off throughout (the trainer's
    policy against torch's default); printed."""
    import torch
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    ms = {"off": [], "on": []}
    try:
        cudnn.benchmark = False
        for turn in ("off", "on", "on", "off"):
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
          f"roofline {json.dumps(row.get('roofline'))}; "
          f"device records lost {row['device_records_lost']} ({card})",
          flush=True)


def _sample_window(fn, name: str) -> dict:
    """One window of the port's perf sampler around ``fn`` (one train
    step of phase card ``name``), with its FLOPs and bytes counted first; the
    summary row, with the BN kernel's launches inside the window under
    ``bn_act_launched``. Fails if the sampler counts an error."""
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import (
        MetricsRegistry)
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import profiler
    _, costs = profiler.count_costs(fn)
    reg = MetricsRegistry()
    sampler = profiler.PerfSampler(1, registry=reg, device="cuda")
    sampler.register_card(name, profiler.build_cost_card(
        name, **costs, kind=sampler.kind, peaks=sampler.peaks))
    if not sampler.start_window(0):
        raise AssertionError(f"{name}: the sampler did not start")
    before = bn_act.launches
    try:
        fn()
    except BaseException:
        sampler.abort_window()
        raise
    launched = bn_act.launches - before
    row = sampler.end_window(0, executable=name)
    errors = reg.counter(profiler.ERRORS_COUNTER).value
    if row is None or errors:
        raise AssertionError(f"{name}: the sampler failed ({errors} "
                             f"errors)")
    return dict(row, bn_act_launched=launched)


def _sampled(label: str, name: str, fn, card: str, bn_kernels: int) -> dict:
    """Run ``fn`` (one train step of phase card ``name``) under the port's
    own perf sampler, after counting the same call's FLOPs, as the
    trainer does with ``profile_every_n_steps``; printed and returned.
    Fails if the sampler counts an error, its fractions do not sum to 1,
    or the step launches the BN kernel other than its derived
    ``bn_kernels`` times. A window whose BN-kernel records fall short of
    the step's launches lost device records (the tracer dropped some,
    at its tail or inside it) and is taken again, at most twice."""
    for attempt in range(3):
        row = _sample_window(fn, name)
        total = (row["device_compute_frac"] + row["device_idle_frac"]
                 + row["dispatch_gap_frac"])
        if abs(total - 1) > 1e-6:
            raise AssertionError(f"{label}: fractions sum to {total}")
        _print_sample(label, row, card)
        got, launched = (row["per_family_kernels"].get("bn_act"),
                         row["bn_act_launched"])
        if launched != bn_kernels:
            raise AssertionError(f"{label}: the step launched bn_act "
                                 f"{launched} times, derived {bn_kernels}")
        if got == launched and not row["device_records_lost"]:
            return row
        print(f"{label}: the window holds {got} bn_act records of "
              f"{launched} launches ({row['device_records_lost']} lost at "
              f"its tail): the tracer dropped device records; window "
              f"{attempt + 1} of 3", flush=True)
    raise AssertionError(f"{label}: three windows dropped device records")


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
    step_times = {}
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
        step_times[epoch] = step_ms
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
                        card)

    # Remat: one second-order step, timed and its peak memory, per
    # variant, its launches held to the derived count; then
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
    # Phase 12 runs the mesh's step on this state and batch.
    return {"state": state, "spare": spare, "step_ms": step_times}


REMAT_VARIANTS = ("block_outs", "off", "nothing", "conv_outs", "dots")
# One flagship second-order step per step-segment policy when the segment
# was a non-reentrant checkpoint, whose inner gradient recomputed the
# support forward (three support forwards per step, 768 launches): ms and
# peak GiB on an NVIDIA H100 80GB HBM3 at 700 W, printed beside this
# run's for comparison.
CHECKPOINT_SEGMENT_STEP = {"nothing": (2456.0, 0.52),
                           "conv_outs": (4293.2, 0.60),
                           "dots": (3606.1, 0.63)}


def _remat_variants(label: str, cfg, apply, state, batch, epoch, phase,
                    card: str, floors):
    """One train step per remat variant (``REMAT_VARIANTS``), timed once
    each with its peak memory, each launching the BN kernel as
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
    for name in REMAT_VARIANTS:
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
    def before(n):
        if n not in CHECKPOINT_SEGMENT_STEP or not phase["second_order"]:
            return ""
        ms, gib = CHECKPOINT_SEGMENT_STEP[n]
        return (f" (as a checkpoint segment with three support forwards: "
                f"{ms} ms, peak {gib} GiB)")
    print(f"{label} remat, one {profiler.phase_card_name(**phase)} step: "
          + "; ".join(
        f"{n} {min(ms):.1f} ms, peak "
        f"{max(gib):.2f} GiB, bn_act {want[n]} launches{before(n)}"
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

    * support: K; 2K when a segment is the whole inner step (second
      order under 'nothing', 'conv_outs' or 'dots'): the step's forward
      keeps no graph, and the outer backward runs the whole step once
      more (meta/inner.py § _StepSegment), as ``jax.checkpoint`` does;
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
    support = 2 * k if step_segment else k
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
        # Phases 9 and 11 serve this run's checkpoints, and phase 11
        # exports its logs' timeline: kept beside the runs.
        kept = tempfile.mkdtemp(prefix="serve_src_", dir=runs_dir)
        shutil.copytree(builder.paths["saved_models"],
                        os.path.join(kept, "saved_models"))
        shutil.copytree(builder.paths["logs"], os.path.join(kept, "logs"))
        return {"leaves": {n: t.cpu() for n, t in a.items()},
                "train_loss": [float(v) for v in stats["train_loss"]],
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
        for i in range(2):
            batch = next(batches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = builder.train_step(state, batch, 0, **phase)
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
            if not bool(torch.isfinite(m.loss)):
                raise AssertionError(f"resnet12 step: loss {m.loss}")
        if bn_act.launches != 2 * per_step:
            raise AssertionError(f"resnet12 step: bn_act launched "
                                 f"{bn_act.launches} times, want 2 x "
                                 f"{per_step}")
        next(batches)  # (b) keeps the batch it read with three steps here
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
# Phase 7's telemetry runs: one, and up to two more when no sampled
# window of a run came out whole (``_RecordsDropped``).
TELEMETRY_RUNS = 3
# Windows of the port's sampler taken for one trainer sample that lost
# records, each on a step of the sample's phase card, until one is whole.
SAMPLE_RETAKES = 4
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


class _RecordsDropped(AssertionError):
    """A ``perf_profile`` row whose one defect is records it lacks: it
    counted records lost, or, with every other check met (fractions,
    MFU, no BN-kernel record beyond the step's launches), a label of its
    step or some of its BN-kernel records are missing. The CUDA tracer
    drops device records together with their launch records, at random
    and without counting them (PERF.md § 7): the window is taken again."""


def _check_perf_row(r: dict, bn_per_step) -> None:
    """One ``perf_profile`` row: no records lost, fractions summing to 1,
    every label of its step, the step's BN-kernel records, an MFU in
    (0, 1] and a roofline entry with a known bound and a fraction of its
    ceiling (not bounded: the count is per eager op, PERF.md § 7). Raises :class:`_RecordsDropped` when records are all that is
    missing, AssertionError on any other defect, a shortfall of BN-kernel
    records that ``device_records_lost`` does not count among them."""
    total = (r["device_compute_frac"] + r["device_idle_frac"]
             + r["dispatch_gap_frac"])
    missing = _expected_regions(r["top_executable"]) - set(
        r["per_region_seconds"])
    bn = r["per_family_kernels"].get("bn_act", 0)
    want = bn_per_step(r["top_executable"])
    said = (f"telemetry: perf row (fractions sum {total}, regions missing "
            f"{missing}, bn_act records {bn} of {want}, records lost "
            f"{r['device_records_lost']}) {r}")
    if bn < want and r["device_records_lost"] < want - bn:
        # The sampler knows the window's BN launches: a shortfall of
        # their records is counted lost, at least (telemetry/profiler.py
        # § window_records).
        raise AssertionError(f"the sampler did not count the BN records' "
                             f"shortfall as lost: {said}")
    if r["device_records_lost"]:
        raise _RecordsDropped(said)
    # The cost card's roofline (telemetry/profiler.py § attach_card):
    # a known bound and the fraction of its ceiling, whatever its value.
    rl = (r.get("roofline") or {}).get(r["top_executable"]) or {}
    if (rl.get("bound") not in ("compute", "memory")
            or not isinstance(rl.get("frac_of_ceiling"), float)):
        raise AssertionError(f"telemetry: no known bound or "
                             f"frac_of_ceiling in the roofline entry {rl}"
                             f": {said}")
    sound = (abs(total - 1) <= 1e-6 and bn <= want
             and r["mfu"] is not None and 0 < r["mfu"] <= 1)
    if sound and not missing and bn == want:
        return
    raise (_RecordsDropped if sound else AssertionError)(said)


def _check_telemetry_rows(rows, n_epochs: int, n_steps: int,
                          bn_per_step) -> list:
    """Phase 7's checks of a run's ``events.jsonl``; returns the
    ``perf_profile`` rows and those of them that lack records
    (:class:`_RecordsDropped`), which the caller takes again.
    ``bn_per_step(name)`` is the BN-kernel launches of one step of phase
    card ``name``: a whole sample holds them all. Raises
    :class:`_RecordsDropped` when no row of the run is whole."""
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
    dropped = []
    for r in perf:
        try:
            _check_perf_row(r, bn_per_step)
        except _RecordsDropped:
            dropped.append(r)
    if len(dropped) == len(perf):
        raise _RecordsDropped(f"telemetry: none of the run's {len(perf)} "
                              f"perf rows is whole")
    return perf, dropped


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
        # The tracer can drop a window's device records together with
        # their launch records, so a row does not always report its loss
        # (PERF.md § 7). A row that lacks records, every other check met,
        # is taken again below on a step of its phase card; a run none of
        # whose rows is whole is printed and taken again, at most twice.
        # Any other defect of a row fails the phase at once.
        reruns = []
        for attempt in range(1, TELEMETRY_RUNS + 1):
            prof_dir = os.path.join(tmp, f"trace{attempt}")
            bn_act.reset_launches()
            rc, builder, run_s = _cli_run(
                TELEMETRY_ARGS + ["--profile_dir", prof_dir,
                                  "--alert_rules_path", rules],
                os.path.join(tmp, f"run{attempt}"))
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

            def bn_per_step(name):
                return cfg.effective_task_microbatches() * _bn_per_forward(
                    cfg) * _forwards_per_chunk(cfg, "_so1_" in name,
                                               name.endswith("msl1"))
            try:
                perf, dropped = _check_telemetry_rows(
                    rows, cfg.total_epochs,
                    cfg.total_epochs * cfg.total_iter_per_epoch,
                    bn_per_step)
                break
            except _RecordsDropped as e:
                if attempt == TELEMETRY_RUNS:
                    raise
                reruns.append(str(e)[:160])
                print(f"telemetry cli: run {attempt} of {TELEMETRY_RUNS}: "
                      f"no sampled window is whole, each lacking records "
                      f"with every other check met ({str(e)[:160]}); the "
                      f"run is taken again ({card})", flush=True)
        entry["telemetry_reruns"] = len(reruns)
        print(f"telemetry cli: {len(reruns)} run(s) taken again with no "
              f"whole sampled window, {len(dropped)} of the run's "
              f"{len(perf)} samples lacking records; phase 2 retook "
              f"{entry['device_window_retakes']} profiler window(s) "
              f"({card})", flush=True)
        k = cfg.number_of_training_steps_per_iter
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
        doc = profiler.load_profile(os.path.join(logs,
                                                 profiler.PROFILE_FILE))
        for n, c in sorted(((doc or {}).get("cards") or {}).items()):
            print(f"telemetry cli logs/PROFILE.json card {n} (the phase's "
                  f"first eager step, counted): {_card_text(c)} ({card})",
                  flush=True)

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

        # A sample that lacks records (the tracer dropped part of the
        # window) is taken again on a step of the same phase card, up to
        # SAMPLE_RETAKES windows; one of them must pass every check.
        for r in dropped:
            ep, ph = phase_of(r["top_executable"])
            for attempt in range(1, SAMPLE_RETAKES + 1):
                again = _sample_window(
                    lambda: builder.train_step(state, batch, ep, **ph),
                    r["top_executable"])
                _print_sample(f"telemetry cli sample at iter {r['iter']} "
                              f"taken again, attempt {attempt}", again, card)
                try:
                    _check_perf_row(again, bn_per_step)
                    break
                except _RecordsDropped as e:
                    print(f"telemetry cli: window {attempt} of "
                          f"{SAMPLE_RETAKES} lacks records "
                          f"({str(e)[:160]})", flush=True)
            else:
                raise AssertionError(
                    f"telemetry: the sample at iter {r['iter']} lacked "
                    f"records in {SAMPLE_RETAKES} windows taken again")

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
            name, **profiler.count_costs(step)[1], kind=sampler.kind,
            peaks=sampler.peaks))

        def window():
            sampler.start_window(0)
            step()
            if sampler.end_window(0, executable=name) is None:
                raise AssertionError("telemetry: a sample window failed")
        for kind in ("off", "health", "window"):
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
        print(f"telemetry costs, one {name} step (one call each): "
              f"plain {med['off']:.1f} ms, health on {med['health']:.1f} ms "
              f"(+{med['health'] - med['off']:.1f}), in a sample window "
              f"with its attribution {med['window']:.1f} ms "
              f"(+{med['window'] - med['off']:.1f}); runs "
              f"{json.dumps(runs)}"
              f"; record_function labels {labels} per step, "
              f"{label_us:.3f} us each with the profiler off "
              f"({labels * label_us / 1e3:.4f} ms per step) ({card})",
              flush=True)
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
from howtotrainyourmamlpytorch_tpu_torch import train_maml_system
from howtotrainyourmamlpytorch_tpu_torch.parallel import mesh
real = mesh.make_train_step
def make(cfg, apply, **kw):
    step, calls = real(cfg, apply, **kw), []
    def spun(*args, **kwargs):
        out = step(*args, **kwargs)
        calls.append(1)
        if len(calls) == 2:
            torch.cuda._sleep(int(sys.argv[2]))
        return out
    return spun
mesh.make_train_step = make
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


def _start_tripped_child(tag: str, argv, root: str, code=None,
                         env=None) -> dict:
    """Start one flagship CLI child that must trip the watchdog
    (:func:`_check_tripped_child` holds it); its output goes to a file
    and a thread notes the wall time of its exit."""
    import threading
    run = ["--name_of_args_json_file", FLAGSHIP, "--experiment_root", root,
           "--experiment_name", tag] + CLI_ARGS + TRIP_ARGS + argv
    cmd = ([sys.executable, "-c", code, REPO, str(SPIN_CYCLES)] + run
           if code else [sys.executable, "-m",
                         "howtotrainyourmamlpytorch_tpu_torch."
                         "train_maml_system"] + run)
    child_env = dict(os.environ)
    child_env.pop("MAML_FAULTS", None)
    child_env.update(env or {})
    os.makedirs(root, exist_ok=True)
    log = open(os.path.join(root, f"{tag}.out"), "w")
    proc = _spawn(tag, cmd, env=child_env, stdout=log,
                  stderr=subprocess.STDOUT)
    log.close()
    handle = {"tag": tag, "root": root, "proc": proc, "t0": time.time(),
              "t_exit": []}
    waiter = threading.Thread(
        target=lambda: handle["t_exit"].append((proc.wait(), time.time())),
        daemon=True)
    waiter.start()
    handle["waiter"] = waiter
    return handle


def _check_tripped_child(handle: dict, chaos, phase: str, deadline: float,
                         card: str) -> dict:
    """A :func:`_start_tripped_child` child must have tripped the
    watchdog in ``phase``: exit 74 within ``deadline`` + 2 polls + 5 s of
    the hang's start, a bundle with stacks, the flight ring, its trace
    and ``crash.json``, and one ``watchdog_trip`` row. Returns the
    bundle's view."""
    tag, root, proc = handle["tag"], handle["root"], handle["proc"]
    handle["waiter"].join(timeout=300)
    _reap(proc)
    if not handle["t_exit"]:
        raise AssertionError(f"{tag}: no exit within 300 s; killed")
    t_exit = handle["t_exit"][0][1]
    with open(os.path.join(root, f"{tag}.out")) as f:
        output = f.read()
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
            f"rows; output {output[-1500:]}")
    latency = _trip_latency(bundle, t_exit)
    bound = deadline + 2 * HANG_POLL + HANG_SLACK
    print(f"{tag}: exit 74 in {t_exit - handle['t0']:.1f} s, "
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
    trips = []
    try:
        # The two children that must trip run beside the chaos harness
        # (for run time): a hang on the device, hang_step.
        trips = [_start_tripped_child("device_hang", [],
                                      os.path.join(tmp, "hang"),
                                      code=DEVICE_HANG_CHILD),
                 _start_tripped_child("hang_step",
                                      ["--fault_spec", "hang_step@2"],
                                      os.path.join(tmp, "hang"),
                                      env={"MAML_HANG_SECONDS": "60"})]
        # Phase 13 runs the pod harness's legs and phase 14 the warm
        # restart: not again here.
        art = chaos.chaos(os.path.join(tmp, "chaos"), "cuda", quick=False,
                          log=lambda line: print(f"chaos: {line}",
                                                 flush=True),
                          pod_legs=False, warm_legs=False)
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

        # A hang on the device (the spin kernel after the second step)
        # and the hang_step fault, in the children started above.
        bundle = _check_tripped_child(trips[0], chaos, "step",
                                      HANG_STEP_DEADLINE, card)
        in_fetch = _main_thread_in_loss_fetch(bundle["stacks"])
        report = _child(
            "telemetry_report",
            [sys.executable, os.path.join(REPO, "scripts",
                                          "telemetry_report.py"),
             os.path.join(tmp, "hang", "device_hang"), "--json"],
            timeout=120)
        summary = json.loads(report.stdout.strip().splitlines()[-1])
        print(f"device_hang: main thread in the loss fetch in stacks.txt "
              f"{in_fetch}; telemetry_report watchdog section "
              f"{summary['watchdog']}", flush=True)
        if (not in_fetch or not isinstance(summary["watchdog"], dict)
                or summary["watchdog"]["trips"] != 1):
            raise AssertionError(f"device_hang: stacks\n{bundle['stacks']}")
        _check_tripped_child(trips[1], chaos, "step", HANG_STEP_DEADLINE,
                             card)
        marks.append(("hangs", time.perf_counter()))

        entry["launches"] += _watchdog_on_off(cfg, card)
        _cold_build_under_deadline(card)
        marks.append(("watchdog", time.perf_counter()))
        print("phase 8 seconds per part: " + json.dumps(
            {b[0]: round(b[1] - a[1], 1) for a, b in zip(marks, marks[1:])}),
            flush=True)
    finally:
        for handle in trips:
            _reap(handle["proc"])
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
        report = _child(
            "telemetry_report",
            [sys.executable, os.path.join(REPO, "scripts",
                                          "telemetry_report.py"),
             events, "--json"], timeout=120)
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
        proc = _child(
            "fleet_bench",
            [sys.executable, FLEET_SCRIPT, *FLEET_ARGS, "--out", fleet_out],
            timeout=600)
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

        out = _child("torch_telemetry_report",
                     [sys.executable, REPORT_SCRIPT, builder.paths["base"]],
                     timeout=120)
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


# Phase 11: the serving fleet's harnesses and operator tools at the
# flagship's width, serving phase 5's checkpoint.
SERVE_BENCH_SCRIPT = os.path.join(REPO, "scripts", "torch_serve_bench.py")
CHAOS_FLEET_SCRIPT = os.path.join(REPO, "scripts", "torch_chaos_fleet.py")
REPLAY_SCRIPT = os.path.join(REPO, "scripts", "torch_traffic_replay.py")
SLO_SCRIPT = os.path.join(REPO, "scripts", "torch_slo_report.py")
EXPORT_SCRIPT = os.path.join(REPO, "scripts", "torch_trace_export.py")
SERVE_BENCH_REQUESTS = 96
CHAOS_ARGS = ["--device", "cuda", "--replicas", "3", "--config", FLAGSHIP]
# The replay's trace is cut in duration only (the JAX script's default
# is 60 s); its requests are all traced for the SLO report.
REPLAY_ARGS = ["--device", "cuda", "--config", FLAGSHIP, "--duration", "14",
               "--trace-sample-rate", "1.0"]


def _run_harness(script: str, args, out: str, timeout: float) -> dict:
    """A harness as a subprocess; its last stdout line, or a failure that
    carries the tails of the replicas' logs."""
    proc = _child(os.path.basename(script),
                  [sys.executable, script, *args, "--out", out],
                  timeout=timeout)
    try:
        art = json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        art = {"status": "no artifact", "stderr": proc.stderr[-3000:]}
    if proc.returncode != 0 or art.get("status") != "ok":
        logs = ""
        for name in sorted(os.listdir(out)) if os.path.isdir(out) else []:
            if name.endswith(".log"):
                with open(os.path.join(out, name)) as f:
                    logs += f"--- {name}\n{f.read()[-1500:]}\n"
        raise AssertionError(
            f"fleet: {os.path.basename(script)} rc {proc.returncode}: "
            f"{json.dumps(art)[-6000:]}\n{logs}")
    return art


def _replica_launches(label: str, kernels: dict, per_forward: int,
                      adapt_steps: int, card: str) -> int:
    """Each replica's BN-kernel launches held to its own adapt and
    predict batches; returns their sum."""
    total = 0
    for rid, k in sorted(kernels["replicas"].items()):
        want = per_forward * (adapt_steps * k["adapt_runs"]
                              + k["predict_runs"])
        if k["bn_act_launches"] != want or not want:
            raise AssertionError(
                f"fleet: {label} replica {rid} launched bn_act "
                f"{k['bn_act_launches']} times, its batches need {want}: "
                f"{k}")
        total += want
        print(f"fleet: {label} replica {rid}: bn_act launches "
              f"{k['bn_act_launches']} = {per_forward * adapt_steps} x "
              f"{k['adapt_runs']} adapt + {per_forward} x "
              f"{k['predict_runs']} predict batches; peak memory "
              f"{k['max_memory_allocated'] / 2**30:.2f} GiB ({card})",
              flush=True)
    return total


def fleet_harnesses(entry: dict, card: str, src: str) -> None:
    """Phase 11: the serve bench (in process), the chaos suite, the
    traffic replay (each a subprocess whose replicas serve on this card)
    and the SLO report and trace export over what they wrote, all on
    phase 5's checkpoint at the flagship's width; adds the BN kernel's
    launches in this process and in every replica to ``entry``."""
    import contextlib
    import io
    import shutil
    import tempfile
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import trace

    runs_dir = os.path.join(REPO, ".smoke_runs")
    tmp = tempfile.mkdtemp(prefix="fleet_", dir=runs_dir)
    marks = [("start", time.perf_counter())]
    try:
        models = os.path.join(tmp, "saved_models")
        shutil.copytree(src, models)
        cfg = MAMLConfig.from_json_file(FLAGSHIP).replace(bn_backend="pallas")
        per_forward = _bn_per_forward(cfg)
        steps = cfg.effective_serve_adapt_steps

        # 1. One engine under open-loop load: throughput, then half of it.
        bench = _load_script(SERVE_BENCH_SCRIPT)

        def serve_bench(rate: float) -> dict:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = bench.main(["--device", "cuda", "--config", FLAGSHIP,
                                 "--checkpoint", models, "--requests",
                                 str(SERVE_BENCH_REQUESTS), "--rate",
                                 str(rate)])
            art = json.loads(buf.getvalue().strip().splitlines()[-1])
            kern = art["bn_act_launches"]
            if (rc != 0 or not kern["ok"] or not kern["launches"]
                    or art["responses"] + art["rejected"]
                    != SERVE_BENCH_REQUESTS
                    or (rate == 0 and (art["deadline_misses"]
                                       or art["responses"]
                                       != SERVE_BENCH_REQUESTS))):
                raise AssertionError(f"fleet: serve bench at rate {rate}: "
                                     f"{json.dumps(art)}")
            entry["launches"] += kern["launches"]
            print(f"fleet: serve bench, {SERVE_BENCH_REQUESTS} requests at "
                  f"rate {rate or 'unbounded'}: {art['value']} req/s, p50 "
                  f"{art['serve_latency_p50_ms']} p95 "
                  f"{art['serve_latency_p95_ms']} p99 "
                  f"{art['serve_latency_p99_ms']} ms, tiers "
                  f"{json.dumps(art['tier_latency_ms'])}, cache hit "
                  f"{art['serve_cache_hit_frac']}, {art['rejected']} "
                  f"rejected, {art['deadline_misses']} past a deadline; "
                  f"bn_act {kern['launches']} launches = "
                  f"{kern['per_adapt_batch']} x {kern['adapt_runs']} adapt + "
                  f"{kern['per_predict_batch']} x {kern['predict_runs']} "
                  f"predict batches (warm-up included) ({card})",
                  flush=True)
            return art

        top = serve_bench(0.0)
        serve_bench(round(top["value"] / 2, 1))
        torch.cuda.empty_cache()
        marks.append(("serve_bench", time.perf_counter()))

        # 2. The chaos suite: kill, crash loop, burst, 3 replicas.
        chaos = _run_harness(CHAOS_FLEET_SCRIPT,
                             CHAOS_ARGS + ["--checkpoint", models],
                             os.path.join(tmp, "chaos"), 900)
        ph = chaos["phases"]
        kill, crash, burst = ph["kill"], ph["crash_loop"], ph["burst"]
        fired = set(chaos["alert_fired_kinds"])
        if not (chaos["value"] == 3 and kill["stats"]["dropped"] == 0
                and kill["restarts"] >= 1 and kill["restored"]
                and crash["crash_loops"] >= 1 and crash["slot_failed"]
                and crash["stats"]["dropped"] == 0 and burst["shed"] > 0
                and burst["deadline_misses"] == 0
                and {"replica_restarts", "replica_lease_stale",
                     "replica_crash_loop", "admission_shedding"} <= fired
                and chaos["alerts_resolved"]
                and chaos["console"]["alerts_firing"] == 0):
            raise AssertionError(f"fleet: chaos gates: "
                                 f"{json.dumps(chaos)[-6000:]}")
        for name, phase in ph.items():
            entry["launches"] += _replica_launches(
                f"chaos {name}", phase["kernels"], per_forward, steps, card)
            boots = {slot: [(r["boot_seconds"], r["exit_code"])
                            for r in runs]
                     for slot, runs in phase["lifecycle"].items()}
            print(f"fleet: chaos {name} ({phase['seconds']} s): replica "
                  f"(boot seconds, exit code) per slot {json.dumps(boots)} "
                  f"({card})", flush=True)
        print(f"fleet: chaos kill: replica {kill['victim_slot']} SIGKILLed "
              f"mid-leg, {kill['stats']['responses_ok']} answered, 0 lost, "
              f"{kill['failovers']} failovers, {kill['restarts']} restart, "
              f"restored to 3 live in {kill['restore_seconds']} s (budget "
              f"{kill['restore_budget_s']} s), p95 "
              f"{kill['stats']['p95_ms']} ms; crash_loop: slot "
              f"{crash['poisoned_slot']} FAILED after "
              f"{crash['restarts']} restarts, served at "
              f"{crash['served_at']}, p95 {crash['stats']['p95_ms']} ms; "
              f"burst: {burst['burst_requests']} requests, {burst['shed']} "
              f"shed, {burst['deadline_misses']} past the deadline, "
              f"admitted p95 {burst['admitted_p95_ms']} ms (SLO "
              f"{burst['slo_p95_ms']} ms); alerts fired "
              f"{sorted(fired)}, all resolved, console firing "
              f"{chaos['console']['alerts_firing']} ({card})", flush=True)
        marks.append(("chaos", time.perf_counter()))

        # 3. The traffic replay: fixed, cb, rollout.
        replay_out = os.path.join(tmp, "replay")
        replay = _run_harness(REPLAY_SCRIPT,
                              REPLAY_ARGS + ["--checkpoint", models],
                              replay_out, 900)
        legs = replay["legs"]
        for name, leg in legs.items():
            entry["launches"] += _replica_launches(
                f"replay {name}", leg["kernels"], per_forward, steps, card)
        cal = replay["calibration"]
        print(f"fleet: replay calibration: probe miss "
              f"{cal['probe_miss_ms']} ms, hit {cal['probe_hit_ms']} ms -> "
              f"per-request cost {cal['per_request_cost_ms']} ms, peak "
              f"{cal['peak_rate']} req/s, base {cal['base_rate']} req/s, "
              f"linger {cal['linger_ms']} ms; trace "
              f"{json.dumps(replay['trace'])} ({card})", flush=True)
        print("fleet: replay legs: " + "; ".join(
            f"{n} p50 {leg['p50_ms']} p95 {leg['p95_ms']} p99 "
            f"{leg['p99_ms']} ms, cb groups {leg['cb_groups']}, scale-ups "
            f"{leg['scale_ups']}, burn {leg['slo_burn_rate']}"
            for n, leg in legs.items())
            + f"; rollout {json.dumps(legs['rollout']['rollout'])}, "
            f"top-ups {legs['rollout']['topup_requests']}; gates "
            f"{json.dumps(replay['gates'])}; seconds "
            f"{json.dumps(replay['seconds'])} ({card})", flush=True)
        marks.append(("replay", time.perf_counter()))

        # 4. The SLO report over the replay's traced events.
        proc = _child("torch_slo_report",
                      [sys.executable, SLO_SCRIPT, replay_out, "--json"],
                      timeout=300)
        slo = json.loads(proc.stdout.strip().splitlines()[-1])
        # Every tracked request of the three legs was traced (rate 1.0);
        # a trace is linked when a replica's spans survived its 4096-span
        # ring, which a leg of this length overflows.
        traced = sum(leg["offered"] for leg in legs.values())
        if proc.returncode != 0 or slo["traces"] != traced:
            raise AssertionError(f"fleet: slo report over {traced} traced "
                                 f"requests: {json.dumps(slo)[:3000]}")
        print(f"fleet: slo report: {slo['traces']} traces of {traced} "
              f"traced requests, linked {slo['linked_frac']:.4f}, "
              f"{slo['spans']} spans, dominant tier {slo['dominant_tier']}, "
              f"tier seconds {json.dumps(slo['tier_seconds'])}", flush=True)

        # 5. The trace export over phase 5's run, the checkpoint's source.
        out_trace = os.path.join(tmp, "trace.json")
        proc = _child("torch_trace_export",
                      [sys.executable, EXPORT_SCRIPT, os.path.dirname(src),
                       "--out", out_trace], timeout=300)
        exp = json.loads(proc.stdout.strip().splitlines()[-1])
        with open(out_trace) as f:
            written = json.load(f)
        trace.validate_trace(written)
        if proc.returncode != 0 or not exp["spans"] or not exp["events_rows"]:
            raise AssertionError(f"fleet: trace export {json.dumps(exp)}")
        print(f"fleet: trace export of the trainer run: {exp['spans']} "
              f"spans, {exp['instants']} instants, {exp['hosts']} hosts "
              f"from {exp['events_rows']} events rows and "
              f"{exp['flight_rows']} flight rows; "
              f"{len(written['traceEvents'])} trace events, valid",
              flush=True)
        marks.append(("reports", time.perf_counter()))
        print("phase 11 seconds per part: " + json.dumps(
            {b[0]: round(b[1] - a[1], 1) for a, b in zip(marks, marks[1:])}),
            flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(os.path.dirname(src), ignore_errors=True)
        torch.cuda.empty_cache()


# Phase 12: the mesh. Each leg runs in subprocesses (ranks) with a time
# limit; a rank that fails, hangs in a collective or cannot join its group
# fails the phase. (b) is the flagship CLI under torchrun with phase 5's
# length cuts; (c) maps the ResNet-12 pod JSON onto two ranks of one card.
MESH_CHILD_FLAG = "--mesh-child"
MESH_CLI_ARGS = CLI_ARGS + ["--mesh_shape", "1", "2"]
R12_MESH_ARGS = ["--bn_backend", "pallas", "--mesh_shape", "1", "2",
                 "--batch_size", "16"]
MESH_TIMEOUT = 300


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_ranks(tag: str, cmd, timeout: float, env=None, proc=None) -> str:
    """Run ``cmd`` (one rank, or torchrun and its ranks) in a session of
    its own, or wait for ``proc``, one :func:`_start_ranks` started; its
    output. Fails when it exits non-zero or outlives ``timeout`` (a hung
    collective): the whole session is killed."""
    proc = proc or _start_ranks(cmd, env)
    try:
        out = _finish(tag, proc, timeout).stdout
    except TimeoutError as e:
        raise AssertionError(f"{tag}: a hung collective? {e}")
    if proc.returncode != 0:
        raise AssertionError(f"{tag}: exit {proc.returncode}. Output tail: "
                             f"{out[-4000:]}")
    return out


def _start_ranks(cmd, env=None) -> subprocess.Popen:
    """Start ``cmd`` in a session of its own, its output piped."""
    return _spawn("ranks", cmd, env=env, stderr=subprocess.STDOUT)


def _start_torchrun(out: str, mode: str, argv) -> subprocess.Popen:
    """Start two ranks of this script's ``mode`` child under torchrun
    (they share the card, so gloo)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + ([os.environ["PYTHONPATH"]]
                  if os.environ.get("PYTHONPATH") else [])))
    return _start_ranks([sys.executable, "-m", "torch.distributed.run",
                         "--nnodes", "1", "--nproc_per_node", "2",
                         "--master_addr", "127.0.0.1", "--master_port",
                         str(_free_port()), os.path.abspath(__file__),
                         MESH_CHILD_FLAG, mode, out] + list(argv), env)


def _torchrun(tag: str, out: str, mode: str, argv, timeout: float,
              proc=None):
    """Two ranks of this script's ``mode`` child under torchrun, or the
    ones ``proc`` (:func:`_start_torchrun`) runs; each rank's result
    JSON, in rank order."""
    _run_ranks(tag, None, timeout,
               proc=proc or _start_torchrun(out, mode, argv))
    ranks = []
    for r in range(2):
        with open(f"{out}.rank{r}.json") as f:
            ranks.append(json.load(f))
    return ranks


def _timed_all_reduce(times: list) -> None:
    """Time each of the mesh's fused all-reduces (synchronized on both
    sides, so the time is the collective's alone, host staging
    included)."""
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.parallel import multihost
    real = multihost.all_reduce_sum

    def timed(buf, group=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real(buf, group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return buf
    multihost.all_reduce_sum = timed


def _digest(leaves: dict) -> str:
    import hashlib
    h = hashlib.sha256()
    for name in sorted(leaves):
        h.update(name.encode())
        h.update(leaves[name].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _mesh_cli_rank(out: str, argv, info: dict) -> None:
    """(b) One rank of the port's CLI: per-step loss and wall time (a
    wrapper around the builder's step), launches, where the run started
    and ended, whether it wrote, its final state's digest (rank 0 also
    saves the state's leaves)."""
    import torch
    from howtotrainyourmamlpytorch_tpu_torch import train_maml_system
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    info.update(losses=[], step_ms=[])

    class Hook(list):
        def append(self, builder):
            super().append(builder)
            info.update(rank=builder.mesh.rank, world=builder.mesh.world,
                        start_iter=builder.current_iter)
            step = builder.train_step

            def timed(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                new, m = step(*a, **k)
                info["losses"].append(float(m.loss).hex())
                info["step_ms"].append((time.perf_counter() - t0) * 1e3)
                return new, m
            builder.train_step = timed

    builders = Hook()
    bn_act.reset_launches()
    info["rc"] = train_maml_system.main(argv, builders=builders)
    b = builders[0]
    leaves = _state_leaves(b.state)
    info.update(launches=bn_act.launches, end_iter=b.current_iter,
                main=b.is_main_process, digest=_digest(leaves),
                save_bytes=b.ckpt_writer.last_save_bytes,
                logs=b.paths["logs"], models=b.paths["saved_models"],
                base=b.paths["base"])
    if b.is_main_process:
        torch.save({n: t.cpu() for n, t in leaves.items()},
                   f"{out}.leaves.pt")


def _rank_graph_steps(cfg, plan, state, batches, epoch: int, key,
                      store_dir: str, profile_card: str = "",
                      eager=None) -> dict:
    """A rank's steps of phase ``key`` from ``state`` over ``batches``,
    eagerly and through the rank's graphs (``parallel/aot.py §
    TrainGraph``: the accumulation and the update, the rank's all-reduce
    run eagerly between them), captured through a fresh store at
    ``store_dir`` (process 0 writes the record). Returns whether the two
    chains are bitwise (state, Adam moments, metrics, counters), the BN
    kernel's launches of the capture and the replays against the
    derivation, the record's hit, the counters, the eager peak and the
    graphs' pool memory, and step times; with ``profile_card``, each
    replay runs under the profiler (its wall is the profiled one).
    ``eager``: the caller's own eager chain from ``state`` over
    ``batches`` (new state, each step's ``(loss, accuracy,
    support_loss, learning_rate)``, step ms, peak GiB), not run again."""
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.parallel import aot
    from howtotrainyourmamlpytorch_tpu_torch.telemetry.registry import (
        MetricsRegistry)
    so, msl = key
    # Own copies: the loader may reuse its device buffers.
    batches = [type(b)(*(t.clone() for t in b)) for b in batches]
    device = batches[0].support_x.device
    per_step = (cfg.effective_task_microbatches() * _bn_per_forward(cfg)
                * _forwards_per_chunk(cfg, so, msl))
    reg = MetricsRegistry()
    for name in aot.COUNTERS:
        reg.counter(name)
    store = aot.AOTStore.from_config(
        cfg.replace(aot_store_dir=store_dir), device, registry=reg,
        writer=plan.mesh.rank == 0)

    def chain(fn):
        st, metrics, ms = state, [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = fn(st, b, epoch, second_order=so, use_msl=msl)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append((m.loss, m.accuracy, m.support_loss,
                            m.learning_rate))
        return st, metrics, ms

    if eager is None:
        torch.cuda.reset_peak_memory_stats()
        eager = (*chain(plan.train_step),
                 torch.cuda.max_memory_allocated() / 2**30)
    eager, m_e, eager_ms, eager_peak = eager
    torch.cuda.empty_cache()
    alloc0 = torch.cuda.memory_allocated()
    reserved0 = torch.cuda.memory_reserved()
    zero = aot.zero_episode(cfg, batches[0].support_x.shape[0], device)
    before = bn_act.launches
    fn, hit = aot.load_or_compile(
        store, aot.train_exec_name(key),
        lambda: aot.TrainGraph(cfg, plan.train_step, key, state, zero,
                               epoch),
        aot.signature_of(state, zero), registry=reg,
        fallback=plan.train_step)
    del zero
    torch.cuda.empty_cache()
    graph = getattr(fn, "compiled", None)
    pool_gib = (torch.cuda.memory_reserved() - reserved0) / 2**30
    held_gib = (torch.cuda.memory_allocated() - alloc0) / 2**30
    profiled = []
    replay = fn
    if profile_card:
        def replay(*a, **k):   # each replay under the profiler
            out = []
            profiled.append(_profiled(
                f"rank {plan.mesh.rank} replayed step",
                lambda: out.append(fn(*a, **k)), profile_card))
            return out[0]
    got, m_g, graph_ms = chain(replay)
    launches = bn_act.launches - before
    diff = _trees_bitwise(eager, got)
    m_diff = [i for i, (x, y) in enumerate(zip(m_e, m_g))
              if _trees_bitwise(x[:3], y[:3]) or x[3] != y[3]]
    counters = (eager.opt_state.count, eager.step, got.opt_state.count,
                got.step)
    out = {"bitwise": not diff and not m_diff
           and counters[:2] == counters[2:],
           "differing": diff + [f"metrics{i}" for i in m_diff],
           "graphs": len(graph.exec.graphs) if graph else 0,
           "stage_launches": graph.exec.stage_launches if graph else None,
           "launches": launches,
           "derived": per_step * (1 + len(batches)),
           "per_step": per_step, "hit": hit,
           "counters": {k: reg.counter(k).value for k in (
               aot.HITS, aot.MISSES, aot.ERRORS, aot.EXEC_FALLBACKS)},
           "losses": [float(x[0]).hex() for x in m_g],
           "eager_ms": eager_ms, "graph_ms": graph_ms,
           "eager_peak_gib": eager_peak, "pool_gib": pool_gib,
           "held_gib": held_gib}
    if profiled:
        # A replay's wall is the profiled window's, not the trace's
        # post-processing after it.
        out["graph_ms"] = [p["wall_ms"] for p in profiled]
        out["profiled"] = {k: profiled[-1][k] for k in ("wall_ms",
                                                        "device_ms", "idle")}
    del fn, graph, replay
    torch.cuda.empty_cache()
    return out


def _mesh_step_rank(out: str, job: str, info: dict) -> None:
    """(a) The one rank of an NCCL group: one flagship second-order f32
    step through ``make_sharded_steps`` and the meta-gradient through
    the same all-reduce, on phase 4's state and batch."""
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    from howtotrainyourmamlpytorch_tpu_torch.device import numerics_policy
    from howtotrainyourmamlpytorch_tpu_torch.meta.inner import Episode
    from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
        make_meta_gradients)
    from howtotrainyourmamlpytorch_tpu_torch.models import make_model
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.parallel import (
        initialize_distributed, make_mesh, make_sharded_steps, multihost)
    initialize_distributed()
    cfg = MAMLConfig.from_json_file(FLAGSHIP).replace(
        bn_backend="pallas", compute_dtype="float32")
    _, apply = make_model(cfg)
    mesh = make_mesh(cfg)
    print(mesh.describe(torch.device("cuda", torch.cuda.current_device())),
          flush=True)
    plan = make_sharded_steps(cfg, apply, mesh)
    data = torch.load(job, weights_only=False)
    state, batch = data["state"], Episode(*data["batch"])
    with numerics_policy("float32", deterministic=True):
        bn_act.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        step_ms = []
        for _ in range(2):   # the first call pays the process's first use
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, m = plan.train_steps[(True, False)](state, batch, 41)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        info.update(step_ms=step_ms, launches=bn_act.launches,
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        loss, _, _, _, grads = make_meta_gradients(
            cfg, apply, reduce_axes=mesh)(state, batch, 41,
                                          second_order=True, use_msl=False)
        # The same rank through its graphs on a fresh store: two steps
        # eager and replayed from phase 4's state.
        info["graph"] = _rank_graph_steps(
            cfg, plan, state, [batch, batch], 41, (True, False),
            f"{out}.store")
    info.update(rank=mesh.rank, world=mesh.world,
                backend=multihost.backend(), losses=[float(m.loss).hex()])
    torch.save({"loss": float(m.loss), "mg_loss": float(loss),
                "grads": {n: v.cpu() for n, v in _leaf_vectors(grads).items()},
                "leaves": {n: t.cpu() for n, t in _state_leaves(new).items()}},
               f"{out}.result.pt")
    torch.distributed.destroy_process_group()


def _mesh_shard_rank(out: str, job: str, info: dict) -> None:
    """(b) witness: one of two gloo ranks sharing the card, each with its
    half of phase 4's batch (its ``local_batch_positions``): the f32
    second-order meta-gradient through the fused all-reduce, then the
    same rank's meta-gradient left unreduced (a planted fault: what a
    rank that skipped the all-reduce, or both ranks reading the same
    tasks, would step with)."""
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    from howtotrainyourmamlpytorch_tpu_torch.device import numerics_policy
    from howtotrainyourmamlpytorch_tpu_torch.meta.inner import Episode
    from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
        make_meta_gradients)
    from howtotrainyourmamlpytorch_tpu_torch.models import make_model
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.parallel import (
        initialize_distributed, local_batch_positions, make_mesh)
    initialize_distributed()
    cfg = MAMLConfig.from_json_file(FLAGSHIP).replace(
        bn_backend="pallas", compute_dtype="float32", mesh_shape=(1, 2))
    cfg = cfg.replace(
        task_microbatches=cfg.effective_task_microbatches(2))
    _, apply = make_model(cfg)
    mesh = make_mesh(cfg)
    data = torch.load(job, weights_only=False)
    start, stop = local_batch_positions(mesh, cfg.batch_size)
    state = data["state"]
    local = Episode(*(t[start:stop] for t in data["batch"]))
    results, step_ms = {}, []
    with numerics_policy("float32", deterministic=True):
        bn_act.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        for name, kw in (("sound", {"reduce_axes": mesh}),
                         ("sound", {"reduce_axes": mesh}),
                         ("unreduced", {})):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _, _, _, grads = make_meta_gradients(cfg, apply, **kw)(
                state, local, 41, second_order=True, use_msl=False)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            results[name] = {"loss": float(loss), "grads": {
                n: v.cpu() for n, v in _leaf_vectors(grads).items()}}
    info.update(rank=mesh.rank, world=mesh.world, step_ms=step_ms,
                launches=bn_act.launches, positions=[start, stop],
                micro=cfg.effective_task_microbatches(),
                want_launches=3 * (cfg.effective_task_microbatches()
                                   * _bn_per_forward(cfg)
                                   * _forwards_per_chunk(cfg, True, False)),
                losses=[results["sound"]["loss"].hex()],
                digest=_digest(results["sound"]["grads"]),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if mesh.rank == 0:
        torch.save(results, f"{out}.result.pt")
    torch.distributed.destroy_process_group()


def _mesh_pod_rank(out: str, argv, info: dict) -> None:
    """(c) One rank of the ResNet-12 pod JSON on (1, 2): the builder (the
    entry point's geometry, loader and plan) and one second-order MSL
    step of the train step its loop calls, on the rank's shard of the
    first batch."""
    import torch
    from howtotrainyourmamlpytorch_tpu_torch import train_maml_system
    from howtotrainyourmamlpytorch_tpu_torch.device import numerics_policy
    from howtotrainyourmamlpytorch_tpu_torch.experiment import (
        ExperimentBuilder)
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.parallel import (
        initialize_distributed)
    from howtotrainyourmamlpytorch_tpu_torch.resilience import cluster
    cfg = train_maml_system.get_args(argv)
    initialize_distributed(timeout_s=cluster.process_group_timeout(cfg))
    builder = ExperimentBuilder(cfg)
    cfg = builder.cfg
    batches = builder.data.get_train_batches(0, 1)
    batch = next(batches)
    batches.close()
    with numerics_policy(cfg.compute_dtype, deterministic=True):
        bn_act.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, m = builder.train_step(builder.state, batch, 0,
                                    second_order=True, use_msl=True)
        loss = float(m.loss)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        launches = bn_act.launches
        # The same step from the same state through the rank's graphs
        # (the builder's plan, a fresh store), the replay profiled.
        info["graph"] = _rank_graph_steps(
            cfg, builder._plan, builder.state, [batch], 0, (True, True),
            os.path.join(cfg.experiment_root, "aot_store"),
            profile_card=_card_line(),
            eager=(new, [(m.loss, m.accuracy, m.support_loss,
                          m.learning_rate)], [step_ms], peak_gib))
        del new
    info.update(
        rank=builder.mesh.rank, world=builder.mesh.world,
        losses=[loss.hex()], local_tasks=int(batch.support_x.shape[0]),
        micro=cfg.effective_task_microbatches(),
        step_ms=[step_ms], launches=launches,
        want_launches=(cfg.effective_task_microbatches()
                       * _bn_per_forward(cfg)
                       * _forwards_per_chunk(cfg, True, True)),
        peak_gib=peak_gib)
    torch.distributed.destroy_process_group()


def _mesh_child(argv) -> int:
    """A rank of phase 12: ``chip_smoke.py --mesh-child <mode> <out>
    [args]``, started by the phase (under torchrun for 'cli' and 'pod').
    Writes ``<out>.rank<r>.json``."""
    import torch
    sys.path.insert(0, REPO)
    mode, out, rest = argv[0], argv[1], argv[2:]
    info = {"mode": mode, "all_reduce_ms": []}
    _timed_all_reduce(info["all_reduce_ms"])
    if mode == "step":
        _mesh_step_rank(out, rest[0], info)
    elif mode == "shard":
        _mesh_shard_rank(out, rest[0], info)
    elif mode == "cli":
        _mesh_cli_rank(out, rest, info)
    else:
        _mesh_pod_rank(out, rest, info)
    info.setdefault("peak_gib", torch.cuda.max_memory_allocated() / 2**30)
    with open(f"{out}.rank{info['rank']}.json", "w") as f:
        json.dump(info, f)
    return 0


def _rank_line(tag: str, ranks, card: str) -> None:
    """Each rank's step and all-reduce times (medians after the first
    call, which pays the process's first use; an all-reduce timed from a
    synchronize also waits for the slower rank), launches and peak."""
    def median(v):
        v = v[1:] or v
        return statistics.median(v) if v else float("nan")
    for r in ranks:
        steps, ar = r["step_ms"], r["all_reduce_ms"]
        print(f"{tag} rank {r['rank']}/{r['world']}: step ms "
              f"{[round(v, 1) for v in steps]} (median after the first "
              f"{median(steps):.1f}), all-reduce ms "
              f"{[round(v, 3) for v in ar]} (median after the first "
              f"{median(ar):.3f}), bn_act launches {r['launches']}, peak "
              f"memory {r['peak_gib']:.2f} GiB ({card})", flush=True)


def _check_rank_graphs(tag: str, ranks, card: str) -> list:
    """Print and check each rank's ``_rank_graph_steps`` result: two
    graphs, the replays bitwise the eager steps, the BN kernel's
    launches as derived, a fresh store's one miss, nothing demoted.
    Returns the failures; adds nothing to the kernel's entry (the
    caller adds the launches)."""
    failures = []
    for r in ranks:
        g = r["graph"]
        c = g["counters"]
        prof = g.get("profiled")
        print(f"{tag} rank {r['rank']}/{r['world']} graphs: "
              f"{g['graphs']} graphs around the rank's collective, "
              f"captured launches per graph {g['stage_launches']}; "
              f"{len(g['graph_ms'])} step(s) eager and replayed from one "
              f"state: bitwise {g['bitwise']} (differing "
              f"{g['differing'][:6]}); step ms eager "
              f"{[round(v, 1) for v in g['eager_ms']]}, replayed "
              f"{[round(v, 1) for v in g['graph_ms']]}"
              + (f" under the profiler: wall {prof['wall_ms']:.1f} ms, "
                 f"device {prof['device_ms']:.1f} ms, idle "
                 f"{prof['idle']:.3f}" if prof else "")
              + f"; eager peak {g['eager_peak_gib']:.2f} GiB, graph pool "
              f"{g['pool_gib']:.2f} GiB reserved ({g['held_gib']:.2f} GiB "
              f"held in its buffers); bn_act launches {g['launches']} = "
              f"derived {g['derived']} (the capture's warm-up and every "
              f"replay, {g['per_step']} per step); store "
              f"{json.dumps(c)} ({card})", flush=True)
        if (not g["bitwise"] or g["graphs"] != 2
                or g["launches"] != g["derived"]
                or g["stage_launches"] != [g["per_step"], 0]
                or c["aot/exec_fallbacks"] or c["aot/errors"]
                or (c["aot/hits"], c["aot/misses"]) != (0, 1)):
            failures.append(f"{tag} rank {r['rank']} graphs: "
                            f"{json.dumps(g)[:1500]}")
    return failures


def mesh_path(entry: dict, card: str, train: dict, cli: dict) -> None:
    """Phase 12: the mesh on the card (module docstring); adds every
    rank's BN-kernel launches to ``entry``."""
    import math
    import shutil
    import tempfile
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.ckpt.manifest import (
        COMMITTED, Manifest, verify_record)
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    from howtotrainyourmamlpytorch_tpu_torch.device import numerics_policy
    from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
        init_train_state, make_meta_gradients, make_train_step)
    from howtotrainyourmamlpytorch_tpu_torch.models import make_model
    from howtotrainyourmamlpytorch_tpu_torch.utils.storage import (
        load_statistics)

    runs_dir = os.path.join(REPO, ".smoke_runs")
    os.makedirs(runs_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="mesh_", dir=runs_dir)
    seconds, failures = {}, []
    try:
        # (a) A one-rank NCCL group, bitwise against phase 4's step.
        t0 = time.perf_counter()
        cfg32 = MAMLConfig.from_json_file(FLAGSHIP).replace(
            bn_backend="pallas", compute_dtype="float32")
        _, apply32 = make_model(cfg32)
        state, spare = train["state"], train["spare"]
        with numerics_policy("float32", deterministic=True):
            ref_loss, _, _, _, ref_g = make_meta_gradients(cfg32, apply32)(
                state, spare, 41, second_order=True, use_msl=False)
            ref_new, ref_m = make_train_step(cfg32, apply32)(
                state, spare, 41, second_order=True, use_msl=False)
        ref_grads = _leaf_vectors(ref_g)
        job = os.path.join(tmp, "step_job.pt")
        torch.save({"state": state, "batch": tuple(spare)}, job)
        out = os.path.join(tmp, "step")
        env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                   LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(_free_port()))
        # (a)'s rank, (c)'s ranks and the paused half of (b)'s CLI run
        # beside (b)'s witness ranks (for run time); the CLI's resumed
        # half follows its paused half.
        pod_argv = (["--name_of_args_json_file", RESNET12,
                     "--experiment_root", os.path.join(tmp, "pod_run")]
                    + R12_MESH_ARGS)
        pod_proc = _start_torchrun(os.path.join(tmp, "pod"), "pod", pod_argv)
        root = os.path.join(tmp, "cli")
        base = ["--name_of_args_json_file", FLAGSHIP, "--experiment_root",
                root] + MESH_CLI_ARGS
        pause_argv = base + ["--total_epochs_before_pause", "1"]
        pause_proc = _start_torchrun(os.path.join(tmp, "pause"), "cli",
                                     pause_argv)
        step_proc = _start_ranks([sys.executable, os.path.abspath(__file__),
                                  MESH_CHILD_FLAG, "step", out, job], env)
        shard_proc = _start_torchrun(os.path.join(tmp, "shard"), "shard",
                                     [job])
        started = [pod_proc, pause_proc, step_proc, shard_proc]
        try:
            # The CLI's resumed half starts as soon as its paused half
            # ends, beside the rest (for run time).
            paused = _torchrun("mesh (b) pause", os.path.join(tmp, "pause"),
                               "cli", pause_argv, MESH_TIMEOUT,
                               proc=pause_proc)
            resume_argv = base + ["--continue_from_epoch", "latest"]
            started.append(_start_torchrun(os.path.join(tmp, "resume"),
                                           "cli", resume_argv))
            shard = _torchrun("mesh (b) witness", os.path.join(tmp, "shard"),
                              "shard", [job], MESH_TIMEOUT, proc=shard_proc)
            log = _run_ranks("mesh (a)", None, MESH_TIMEOUT, proc=step_proc)
            pod = _torchrun("mesh (c)", os.path.join(tmp, "pod"), "pod",
                            pod_argv, MESH_TIMEOUT, proc=pod_proc)
            resumed = _torchrun("mesh (b) resume",
                                os.path.join(tmp, "resume"), "cli",
                                resume_argv, MESH_TIMEOUT, proc=started[-1])
        finally:
            for proc in started:   # none is left running, whatever raised
                _reap(proc)
        with open(f"{out}.rank0.json") as f:
            rank = json.load(f)
        got = torch.load(f"{out}.result.pt", weights_only=False)
        want = (cfg32.effective_task_microbatches() * _bn_per_forward(cfg32)
                * _forwards_per_chunk(cfg32, True, False))
        if rank["backend"] != "nccl" or rank["world"] != 1:
            failures.append(f"mesh (a): backend {rank['backend']}, world "
                            f"{rank['world']}")
        if rank["launches"] != 2 * want or want != 336:
            failures.append(f"mesh (a): bn_act launched "
                            f"{rank['launches']} times over 2 steps, "
                            f"derived {want} per step (336 expected)")
        grads_bitwise = (got["mg_loss"] == float(ref_loss) and all(
            torch.equal(got["grads"][n], ref_grads[n].cpu())
            for n in ref_grads))
        ref_leaves = _state_leaves(ref_new)
        state_bitwise = all(torch.equal(got["leaves"][n],
                                        ref_leaves[n].cpu())
                            for n in ref_leaves)
        started = [ln for ln in log.splitlines() if ln.startswith("mesh:")]
        print(f"mesh (a): {started}; one flagship second-order f32 step "
              f"through "
              f"make_sharded_steps: loss {got['loss']!r} vs phase 4's "
              f"unsharded {float(ref_m.loss)!r}, meta-gradient bitwise "
              f"{grads_bitwise}, new state bitwise {state_bitwise}; "
              f"step ms {[round(v, 1) for v in rank['step_ms']]} (first "
              f"call, then warm, beside (b)'s witness ranks; phase 4's bf16 "
              f"second-order step {train['step_ms'][41]:.1f}), all-reduce ms "
              f"{[round(v, 3) for v in rank['all_reduce_ms']]} (the first "
              f"builds the NCCL communicator), bn_act launches "
              f"{rank['launches']} = 2 x {want}, peak "
              f"{rank['peak_gib']:.2f} GiB ({card})", flush=True)
        if not grads_bitwise:
            failures += _compare_meta_gradients(
                "mesh (a) NCCL world 1 vs unsharded",
                (got["mg_loss"], got["grads"]),
                (float(ref_loss), {n: v.cpu() for n, v in ref_grads.items()}),
                F32_FLOORS, card)
        if got["loss"] != float(ref_m.loss) and abs(
                got["loss"] - float(ref_m.loss)) / abs(
                    float(ref_m.loss)) > F32_FLOORS[0]:
            failures.append(f"mesh (a): step loss {got['loss']} vs "
                            f"{float(ref_m.loss)}")
        entry["launches"] += rank["launches"] + rank["graph"]["launches"]
        failures += _check_rank_graphs("mesh (a)", [rank], card)
        del ref_new, ref_g

        # (b) Two gloo ranks sharing the card. First a witness in f32,
        # where two ranks against one differ only in the order of the
        # f32 sums: phase 4's batch split over the ranks, its
        # meta-gradient held to the one-rank one by F32_FLOORS, and a
        # rank left unreduced read against the same, which every floor
        # must refuse.
        got = torch.load(f"{os.path.join(tmp, 'shard')}.result.pt",
                         weights_only=False)
        ref = (float(ref_loss), {n: v.cpu() for n, v in ref_grads.items()})
        if shard[0]["losses"] != shard[1]["losses"] or (
                shard[0]["digest"] != shard[1]["digest"]):
            failures.append("mesh (b) witness: the ranks' reduced "
                            "meta-gradients differ")
        for r in shard:
            if r["launches"] != r["want_launches"] or r["micro"] != 6:
                failures.append(
                    f"mesh (b) witness rank {r['rank']}: bn_act launched "
                    f"{r['launches']} times, derived {r['want_launches']}; "
                    f"{r['micro']} microbatches")
        print(f"mesh (b) witness: phase 4's 12 tasks, positions "
              f"{[r['positions'] for r in shard]} on 2 gloo ranks, 6 "
              f"one-task microbatches each, f32, deterministic cuDNN",
              flush=True)
        failures += _compare_meta_gradients(
            "mesh (b) witness 2 ranks vs 1 (F32_FLOORS)",
            (got["sound"]["loss"], got["sound"]["grads"]), ref,
            F32_FLOORS, card)
        # BF16_FLOORS are the looser, so what they refuse F32_FLOORS do.
        if not _compare_meta_gradients(
                "mesh (b) witness rank 0 unreduced vs 1 (planted fault, "
                "BF16_FLOORS)",
                (got["unreduced"]["loss"], got["unreduced"]["grads"]), ref,
                BF16_FLOORS, card):
            failures.append(f"mesh (b) witness: BF16_FLOORS {BF16_FLOORS} "
                            f"do not refuse a rank left unreduced")
        _rank_line("mesh (b) witness", shard, card)
        entry["launches"] += sum(r["launches"] for r in shard)
        seconds["a, b, c"] = round(time.perf_counter() - t0, 1)

        # The CLI under torchrun, paused after epoch 0 and resumed (run
        # above, beside (a), the witness and (c)).
        t0 = time.perf_counter()
        cfg = MAMLConfig.from_json_file(os.path.join(paused[0]["base"],
                                                     "config.json"))
        iters = cfg.total_iter_per_epoch
        want_a = _train_path_launches(cfg, 1, {0: iters}, val_sweeps=1,
                                      test_models=0)
        want_b = _train_path_launches(cfg, 2, {1: iters}, val_sweeps=1,
                                      test_models=cfg.max_models_to_save)
        for tag, ranks, start, end, want in (
                ("pause", paused, 0, iters, want_a),
                ("resume", resumed, iters, 2 * iters, want_b)):
            for r in ranks:
                if (r["rc"], r["start_iter"], r["end_iter"]) != (0, start,
                                                                 end):
                    failures.append(
                        f"mesh (b) {tag} rank {r['rank']}: exit {r['rc']}, "
                        f"iterations {r['start_iter']}..{r['end_iter']}, "
                        f"want {start}..{end}")
                if r["launches"] != want:
                    failures.append(
                        f"mesh (b) {tag} rank {r['rank']}: bn_act "
                        f"launched {r['launches']} times, derived {want}")
                if r["main"] != (r["rank"] == 0) or (
                        (r["save_bytes"] > 0) != (r["rank"] == 0)):
                    failures.append(
                        f"mesh (b) {tag} rank {r['rank']}: main "
                        f"{r['main']}, wrote {r['save_bytes']} bytes")
        losses = [p["losses"] + q["losses"] for p, q in zip(paused,
                                                             resumed)]
        if losses[0] != losses[1] or len(losses[0]) != 2 * iters:
            failures.append(f"mesh (b): ranks' losses differ {losses}")
        if paused[0]["digest"] != paused[1]["digest"] or (
                resumed[0]["digest"] != resumed[1]["digest"]):
            failures.append("mesh (b): the ranks' final states differ")
        models = resumed[0]["models"]
        records = Manifest(models).records
        if (set(records) != {"0", "1", "latest"}
                or any(r["status"] != COMMITTED for r in records.values())
                or not all(verify_record(models, r)["ok"]
                           for r in records.values())):
            failures.append(f"mesh (b): manifest {records}")
        stats = load_statistics(resumed[0]["logs"])
        mesh_loss = [float(v) for v in stats["train_loss"]]
        rel = [abs(a - b) / abs(b) for a, b in zip(mesh_loss,
                                                    cli["train_loss"])]
        model_init, _ = make_model(cfg)
        start = _state_leaves(init_train_state(cfg, model_init,
                                               seed=cfg.seed,
                                               device="cuda"))
        final = torch.load(f"{os.path.join(tmp, 'resume')}.leaves.pt")
        held = [n for n in final if n.startswith("/params/")
                and not (n.split("/")[2].startswith("conv")
                         and n.endswith("/b"))]
        du = {n: final[n] - start[n].cpu() for n in held}
        dw = {n: cli["leaves"][n] - start[n].cpu() for n in held}
        leaf_cos = {n: _cosine(du[n], dw[n]) for n in held}
        whole = _cosine(torch.cat([du[n].flatten() for n in held]),
                        torch.cat([dw[n].flatten() for n in held]))
        worst = min((v, n) for n, v in leaf_cos.items())
        loss_rtol, whole_floor, leaf_floor = BF16_FLOORS
        print(f"mesh (b): 2 gloo ranks, {cfg.batch_size // 2} tasks in "
              f"{cfg.effective_task_microbatches()} microbatches per rank; "
              f"losses bitwise equal across ranks over {len(losses[0])} "
              f"steps; resumed at iteration {resumed[0]['start_iter']} on "
              f"both ranks; only rank 0 wrote ({paused[0]['save_bytes']} + "
              f"{resumed[0]['save_bytes']} bytes); epoch train loss "
              f"{mesh_loss} vs phase 5's one rank {cli['train_loss']} "
              f"(rel {[f'{v:.2e}' for v in rel]}); weight updates vs phase "
              f"5: whole cosine {whole:.6f}, worst leaf {worst[1]} "
              f"{worst[0]:.6f}; floors BF16_FLOORS {BF16_FLOORS} ({card})",
              flush=True)
        if max(rel) > loss_rtol or whole < whole_floor or (
                worst[0] < leaf_floor):
            failures.append("mesh (b): the two-rank run misses phase 5's "
                            "one-rank run by BF16_FLOORS")
        for tag, ranks in (("pause", paused), ("resume", resumed)):
            _rank_line(f"mesh (b) {tag}", ranks, card)
        print(f"mesh (b): one rank alone (phase 4, 12 tasks per step) "
              f"{train['step_ms'][0]:.1f} ms per first-order MSL step, "
              f"{train['step_ms'][41]:.1f} ms per second-order step "
              f"({card})", flush=True)
        entry["launches"] += sum(r["launches"] for r in paused + resumed)
        seconds["b checks"] = round(time.perf_counter() - t0, 1)

        # (c) The ResNet-12 pod JSON on (1, 2): one second-order MSL step
        # (run above, beside (a) and the witness).
        print("mesh (c) cuts of the pod JSON: batch_size 256 -> 16 (8 tasks "
              "per rank, 8 one-task microbatches), mesh_shape (4, 8) -> "
              "(1, 2) as 2 gloo ranks on one card, one train step (no "
              "epoch, eval or checkpoint); its own cluster knobs (600 s "
              "budget, 10 s leases) kept; beside (a) and (b)'s witness",
              flush=True)
        pod_losses = [float.fromhex(r["losses"][0]) for r in pod]
        if pod[0]["losses"] != pod[1]["losses"] or not all(
                math.isfinite(v) for v in pod_losses):
            failures.append(f"mesh (c): losses {pod_losses}")
        for r in pod:
            if r["launches"] != r["want_launches"] or (
                    r["local_tasks"], r["micro"]) != (8, 8):
                failures.append(
                    f"mesh (c) rank {r['rank']}: bn_act launched "
                    f"{r['launches']} times, derived {r['want_launches']}; "
                    f"{r['local_tasks']} tasks in {r['micro']} microbatches")
        print(f"mesh (c): ResNet-12 second-order MSL step on (1, 2): loss "
              f"{pod_losses} (bitwise equal across ranks: "
              f"{pod[0]['losses'] == pod[1]['losses']}), bn_act launches "
              f"{[r['launches'] for r in pod]} = "
              f"{[r['want_launches'] for r in pod]} ({card})", flush=True)
        _rank_line("mesh (c)", pod, card)
        entry["launches"] += sum(r["launches"] + r["graph"]["launches"]
                                 for r in pod)
        failures += _check_rank_graphs("mesh (c)", pod, card)
        if pod[0]["graph"]["losses"] != pod[1]["graph"]["losses"]:
            failures.append(f"mesh (c): the ranks' replayed losses differ "
                            f"{[r['graph']['losses'] for r in pod]}")
        print("phase 12 seconds per part: " + json.dumps(seconds),
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("phase 12: " + "; ".join(failures))


# Phase 13: the pod fault domain. scripts/torch_chaos_pod.py starts the
# ranks (gloo, sharing the card) on the flagship JSON with phase 5's length
# cuts; the cluster knobs are cut for run time (POD_ARGS). Its two chains
# of legs, (a) then (b) and (c), are independent experiments: one harness
# process each, side by side (for run time), while leg (d) runs here.
POD_SCRIPT = os.path.join(REPO, "scripts", "torch_chaos_pod.py")
POD_BUDGET_S = 20.0
POD_LEASE_S = 1.0
POD_ARGS = ["--budget", str(POD_BUDGET_S), "--lease-interval",
            str(POD_LEASE_S), "--timeout", "300"]
POD_CHAINS = ("peer_kill,restart", "elastic")
POD_TIMEOUT = 600
POD_ARMED = ["--cluster_collective_timeout_s", str(POD_BUDGET_S),
             "--cluster_lease_interval_s", str(POD_LEASE_S)]


def _pod_rank_cfg(cfg, world: int, orig: int = 0):
    """The config a rank of a ``world``-rank pod run trains with (mesh
    ``(world, 1)``, microbatches clamped to its share as the builder
    clamps them); with ``orig`` > ``world``, a survivor of an ``orig``-rank
    run at the degraded geometry (``derive_degraded_config``)."""
    from howtotrainyourmamlpytorch_tpu_torch.parallel.mesh import (
        derive_degraded_config)
    if orig > world:
        c = derive_degraded_config(cfg.replace(mesh_shape=(orig, 1)),
                                   world, orig)
    else:
        c = cfg.replace(mesh_shape=(world, 1))
    return c.replace(task_microbatches=c.effective_task_microbatches(world))


def _pod_launches(cfg, world: int, steps: dict, val_sweeps: int,
                  test_models: int, orig: int = 0) -> int:
    """BN-kernel launches of one rank of a pod run (``_train_path_launches``
    at that rank's geometry): a killed run's survivor trains epoch 0 and
    the steps of epoch 1 up to the kill, a restarted or resharded one
    from the committed epoch to the end, with the test protocol."""
    return _train_path_launches(_pod_rank_cfg(cfg, world, orig), 0, steps,
                                val_sweeps, test_models)


def _pod_warmups(cfg, world: int, start_epoch: int, orig: int = 0) -> int:
    """BN-kernel launches of a pod rank's captures under a warm-start
    store (each graph's one eager warm-up): one train step per phase key
    its run visits from ``start_epoch`` (all captured before the first
    step under several processes) and one eval batch."""
    c = _pod_rank_cfg(cfg, world, orig)
    s = _bn_per_forward(c)
    keys = {(c.use_second_order(e), c.use_msl(e))
            for e in range(start_epoch, c.total_epochs)}
    return (sum(c.effective_task_microbatches() * s
                * _forwards_per_chunk(c, so, msl) for so, msl in keys)
            + s * (c.number_of_evaluation_steps_per_iter + 1))


def _median(values) -> float:
    v = list(values or [])[1:] or list(values or [])
    return round(statistics.median(v), 1) if v else float("nan")


# Phase 13 (c)'s survivor-roster prewarm, run as a phase child beside
# phase 12 for run time; phase 13 hands its artifact to the elastic leg.
POD_PREWARM = os.path.join(REPO, ".smoke_runs", "pod_prewarm")
POD_PREWARM_ARTIFACT = os.path.join(POD_PREWARM, "prewarm.json")


def _pod_cfg():
    """Phase 13's config: the flagship JSON with phase 5's length cuts."""
    from howtotrainyourmamlpytorch_tpu_torch import train_maml_system
    return train_maml_system.get_args(
        ["--name_of_args_json_file", FLAGSHIP] + CLI_ARGS)


def pod_prewarm(entry: dict, card: str) -> None:
    """``scripts/torch_aot_prewarm.py --degraded 1 --degraded-only`` on
    the elastic leg's config (``torch_chaos_pod.py § elastic_cfg``), as
    the leg itself would run it, into a store under ``POD_PREWARM``;
    writes its artifact to ``POD_PREWARM_ARTIFACT``. Launches nothing in
    this process."""
    import shutil
    harness = _load_script(POD_SCRIPT)
    shutil.rmtree(POD_PREWARM, ignore_errors=True)
    pod = harness.Pod(POD_PREWARM, _pod_cfg().to_dict(), "cuda",
                      POD_BUDGET_S, POD_LEASE_S)
    eout = os.path.join(POD_PREWARM, "elastic")
    art = harness.run_prewarm(eout, harness.elastic_cfg(
        pod, eout, os.path.join(POD_PREWARM, "aot_store")), POD_TIMEOUT)
    with open(POD_PREWARM_ARTIFACT, "w") as f:
        json.dump(art, f)
    print(f"pod (c) prewarm beside phase 12: exit {art.get('exit_code')}, "
          f"ok {art.get('ok')}, {art.get('seconds')} s ({card})",
          flush=True)


def pod_fault_domain(entry: dict, card: str, cli: dict) -> None:
    """Phase 13: the pod fault domain on the card (module docstring); adds
    every rank's BN-kernel launches to ``entry``."""
    import shutil
    import tempfile
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.resilience import cluster
    from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import read_jsonl

    runs_dir = os.path.join(REPO, ".smoke_runs")
    os.makedirs(runs_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="pod_", dir=runs_dir)
    seconds, failures, procs = {}, [], []
    try:
        t0 = time.perf_counter()
        cfg = _pod_cfg()
        config = os.path.join(tmp, "pod_config.json")
        with open(config, "w") as f:
            json.dump(cfg.to_dict(), f)
        print(f"pod cuts of the flagship JSON: phase 5's length cuts "
              f"({' '.join(CLI_ARGS)}), dispatch_sync_every 1, "
              f"cluster_collective_timeout_s 0 -> {POD_BUDGET_S} and "
              f"cluster_lease_interval_s 5 -> {POD_LEASE_S} (for run time), "
              f"mesh_shape (n, 1) over n gloo ranks sharing the card, batch "
              f"12 (6 tasks per rank of 2, 4 per rank of 3); width uncut; "
              f"legs {' and '.join(POD_CHAINS)} in two harness processes "
              f"side by side, leg (d) beside them (for run time) ({card})",
              flush=True)
        # The elastic leg takes the prewarm run beside phase 12, if any.
        prewarmed = (["--elastic-prewarm", POD_PREWARM_ARTIFACT]
                     if os.path.exists(POD_PREWARM_ARTIFACT) else [])
        for i, chain in enumerate(POD_CHAINS):
            with open(os.path.join(tmp, f"harness{i}.out"), "w") as log:
                procs.append(_spawn(
                    f"pod harness {chain}",
                    [sys.executable, POD_SCRIPT, "--device", "cuda",
                     "--config", config, "--out",
                     os.path.join(tmp, f"pod{i}"), "--phases", chain]
                    + POD_ARGS + (prewarmed if "elastic" in chain else []),
                    stdout=log, stderr=subprocess.STDOUT))

        # (d) armed, not tripped: one rank, bitwise phase 5's run; in this
        # process while the harness's ranks run.
        t1 = time.perf_counter()
        bn_act.reset_launches()
        rc, armed, run_s = _cli_run(POD_ARMED, os.path.join(tmp, "armed"))
        armed_launches = bn_act.launches
        seconds["d"] = round(time.perf_counter() - t1, 1)

        art, deadline = {}, time.monotonic() + POD_TIMEOUT
        for i, (chain, proc) in enumerate(zip(POD_CHAINS, procs)):
            try:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in procs:
                    _reap(q)
            with open(os.path.join(tmp, f"harness{i}.out")) as f:
                out = f.read()
            if proc.returncode is None or proc.returncode < 0:
                raise AssertionError(
                    f"pod {chain}: no exit within {POD_TIMEOUT} s; killed. "
                    f"Output tail: {out[-3000:]}")
            part = json.loads(out.strip().splitlines()[-1])
            if proc.returncode != 0 or part.get("status") != "recovered":
                failures.append(
                    f"pod {chain}: harness exit {proc.returncode}, status "
                    f"{part.get('status')}: " + json.dumps(
                        {k: v for k, v in part.items()
                         if k.endswith("ok") or "tail" in k})[-4000:])
            art.update(part)
        seconds["all"] = round(time.perf_counter() - t0, 1)
        with open(os.path.join(tmp, "pod_artifact.json"), "w") as f:
            json.dump(art, f)
        os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
        shutil.copy(os.path.join(tmp, "pod_artifact.json"),
                    os.path.join(REPO, "chiprun_out", "pod_artifact.json"))
        iters = cfg.total_iter_per_epoch
        killed = {0: iters, 1: art["peer_kill_kill_iter"] - iters}
        rest = {1: iters}
        models = cfg.max_models_to_save

        # (a) peer_kill.
        want = _pod_launches(cfg, 2, killed, 1, 0)
        got = art.get("peer_kill_survivor_launches")
        if got != want:
            failures.append(f"pod (a): rank 0 launched bn_act {got} times "
                            f"up to iteration {art['peer_kill_kill_iter']}, "
                            f"derived {want}")
        print(f"pod (a) peer_kill: host 1 SIGKILLed at iteration "
              f"{art['peer_kill_kill_iter']} (exit "
              f"{art['peer_kill_victim_exit_code']}); rank 0 exit "
              f"{art['peer_kill_survivor_exit_code']} "
              f"{art['peer_kill_survivor_latency_s']} s after the death "
              f"(bound {art['peer_kill_latency_bound_s']} s), peer_lost "
              f"suspects {art['peer_kill_suspect_hosts']}, bundle "
              f"{art['peer_kill_bundle_files']} reason "
              f"{art['peer_kill_bundle_reason']}, metrics.prom "
              f"cluster/peer_losses {art['peer_kill_prom_peer_losses']}; "
              f"committed epoch {art['peer_kill_committed_epoch']} at iter "
              f"{art['peer_kill_committed_iter']}; rank 0 bn_act launches "
              f"{got} = derived {want}; host 1's count unread (SIGKILL "
              f"flushes nothing); rank 0 step ms median "
              f"{_median(art.get('peer_kill_survivor_step_ms'))} ({card})",
              flush=True)
        entry["launches"] += got or 0

        # (b) restart, then the planted stale manifest.
        want = _pod_launches(cfg, 2, rest, 1, models)
        for key, tag in (("restart_launches", "restart"),
                         ("restart_consensus_launches", "consensus")):
            if art.get(key) != [want, want]:
                failures.append(f"pod (b) {tag}: bn_act launches "
                                f"{art.get(key)}, derived {want} per rank")
            entry["launches"] += sum(art.get(key) or [])
        print(f"pod (b) restart: exits {art.get('restart_exit_codes')}, "
              f"{art.get('restart_resumed_lines')}, committed epoch file "
              f"CRC unchanged {art.get('restart_committed_crc_unchanged')}, "
              f"test protocol {art.get('restart_test_protocol_ran')}; "
              f"launches {art.get('restart_launches')} = {want} per rank; "
              f"step ms median per rank "
              f"{[_median(v) for v in art.get('restart_step_ms') or []]} "
              f"({card})", flush=True)
        print(f"pod (b) consensus: rank 1's MANIFEST.json without epoch "
              f"{art.get('restart_consensus_dropped_epoch')}; "
              f"{art.get('restart_consensus_lines')}; "
              f"{art.get('restart_consensus_resumed_lines')}; "
              f"consensus_resume rows (epoch, rank 0's view) "
              f"{art.get('restart_consensus_rows')}; final checkpoint bytes "
              f"equal the restart's {art.get('restart_consensus_final_crc_equal')}"
              f"; consensus-resume wall (launch to first step) "
              f"{art.get('restart_consensus_resume_wall_s')} s; launches "
              f"{art.get('restart_consensus_launches')} ({card})",
              flush=True)

        # (c) elastic: 3 ranks, host 0 killed, 2 survivors, a cold run.
        # The survivors ran on the store the harness's prewarm filled:
        # each rank's launches include its captures' warm-ups.
        want0 = (_pod_launches(cfg, 3, killed, 1, 0)
                 + _pod_warmups(cfg, 3, 0))
        want1 = _pod_launches(cfg, 2, rest, 1, models, orig=3)
        warm1 = want1 + _pod_warmups(cfg, 2, 1, orig=3)
        gen0 = art.get("elastic_generation0_launches") or {}
        gen1 = art.get("elastic_generation1_launches") or {}
        cold = art.get("elastic_cold_launches") or {}
        for tag, got, w in (("generation 0", gen0, want0),
                            ("generation 1", gen1, warm1),
                            ("cold", cold, want1)):
            if sorted(got.values()) != [w, w]:
                failures.append(f"pod (c) {tag}: bn_act launches {got}, "
                                f"derived {w} per process")
            entry["launches"] += sum(v or 0 for v in got.values())
        print(f"pod (c) elastic: host 0 SIGKILLed at iteration "
              f"{art.get('elastic_kill_iter')}; survivors exit "
              f"{art.get('elastic_survivor_exit_codes')}, roster "
              f"{art.get('elastic_roster')} generation "
              f"{art.get('elastic_roster_generation')}, reshard rows "
              f"{art.get('elastic_reshard_rows')} (suspects "
              f"{art.get('elastic_reshard_suspects')}), report "
              f"{art.get('elastic_report_elastic')}; generation-1 (host, "
              f"rank, world) {art.get('elastic_generation1_ranks')} resumed "
              f"at {art.get('elastic_generation1_start_iters')}; trip "
              f"{art.get('elastic_trip_after_death_s')} s after the death, "
              f"reshard wall (trip to generation 1's first step) "
              f"{art.get('elastic_reshard_wall_s')} s, death to first step "
              f"{art.get('elastic_death_to_generation1_step_s')} s; cold "
              f"2-rank run exits {art.get('elastic_cold_exit_codes')}, final "
              f"checkpoint bitwise the survivors' "
              f"{art.get('elastic_bitwise_equal_cold')}; launches generation "
              f"0 {gen0} = {want0}, generation 1 {gen1} = {warm1}, cold "
              f"{cold} = {want1}; step ms median per rank generation 1 "
              f"{[_median(v) for v in art.get('elastic_generation1_step_ms') or []]}"
              f", cold {[_median(v) for v in art.get('elastic_cold_step_ms') or []]}"
              f" ({card})", flush=True)
        pre = art.get("elastic_prewarm") or {}
        rows = art.get("elastic_generation1_warm_start") or []
        aots = art.get("elastic_generation1_aot") or []
        execs = [(e.get("name"), e.get("disposition"), e.get("bitwise"))
                 for e in pre.get("executables") or []]
        warm = [[(r or {}).get(k) for k in (
            "compiles_before_first_step", "aot_misses", "aot_hits",
            "nvcc_runs_before_first_step", "time_to_first_step_seconds")]
            for r in rows]
        print(f"pod (c) warm start: the survivor roster prewarmed by "
              f"scripts/torch_aot_prewarm.py --degraded 1 --degraded-only "
              f"(exit {pre.get('exit_code')}, ok {pre.get('ok')}, "
              f"{pre.get('hits')} hits, {pre.get('misses')} misses, "
              f"{pre.get('failures')} failures, nvcc runs "
              f"{pre.get('nvcc_runs')}, {pre.get('seconds')} s, "
              f"executables {execs}); each survivor's warm_start "
              f"(compiles before the first step, misses, hits, nvcc runs, "
              f"time to first step s) {warm}, nvcc runs in all "
              f"{art.get('elastic_generation1_nvcc_runs')}, exec fallbacks "
              f"{[(a or {}).get('aot/exec_fallbacks') for a in aots]}; "
              f"reshard wall {art.get('elastic_reshard_wall_s')} s beside "
              f"PR 12's eager 7.95-9.43 s (no gate; ranks sharing the card "
              f"beside the other chain) ({card})", flush=True)
        if not (art.get("elastic_store") and art.get("elastic_warm_ok")
                and pre.get("ok")):
            failures.append(f"pod (c) warm start: store "
                            f"{art.get('elastic_store')}, warm "
                            f"{art.get('elastic_warm_ok')}, prewarm "
                            f"{json.dumps(pre)[:1500]}, rows "
                            f"{json.dumps(rows)[:1500]}, aot "
                            f"{json.dumps(aots)[:800]}")
        print("pod harness seconds per phase: " + json.dumps(
            {k: art.get(f"{k}_seconds")
             for k in ("peer_kill", "restart", "elastic")}), flush=True)

        # (d) armed, not tripped (run above, beside the harness).
        launches = armed_launches
        leaves = _state_leaves(armed.state)
        bitwise = all(torch.equal(leaves[n].cpu(), cli["leaves"][n])
                      for n in cli["leaves"])
        beats = [r for r in read_jsonl(os.path.join(
            armed.paths["logs"], "events.jsonl")) if r["event"] == "heartbeat"]
        lease = os.path.join(armed.paths["base"], cluster.LEASE_DIR,
                             "host_0.lease")
        if (rc != 0 or not bitwise or launches != cli["launches"]
                or not os.path.exists(lease)
                or not all("peer_lease_age_seconds" in b for b in beats)):
            failures.append(f"pod (d): exit {rc}, bitwise phase 5 "
                            f"{bitwise}, launches {launches} vs "
                            f"{cli['launches']}, lease "
                            f"{os.path.exists(lease)}, heartbeat rows "
                            f"{[sorted(b) for b in beats]}")
        print(f"pod (d) armed, not tripped: the flagship CLI on one rank "
              f"with {' '.join(POD_ARMED)}: exit {rc} in {run_s:.1f} s, "
              f"final state bitwise phase 5's (domain off) {bitwise}, "
              f"bn_act launches {launches} = {cli['launches']}, lease "
              f"written, heartbeat lease ages "
              f"{[b.get('peer_lease_age_seconds') for b in beats]}; phase 5 "
              f"epoch seconds {cli['epoch_seconds']}, armed "
              f"{_epoch_seconds(armed.paths['logs'])} (beside the harness's "
              f"ranks) ({card})", flush=True)
        entry["launches"] += launches
        print("phase 13 seconds per part: " + json.dumps(seconds),
              flush=True)
    finally:
        for q in procs:  # none is left running, whatever raised
            _reap(q)
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(POD_PREWARM, ignore_errors=True)
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("phase 13: " + "; ".join(failures))


# Phase 14: the warm start. The CLI children run phase 5's length cuts,
# both knobs on fresh directories.
WARM_TIMEOUT = 300
# (b)'s steps: (epoch, batch index); two opt.count values per phase key.
WARM_STEPS = ((0, 0), (0, 1), (41, 2), (41, 3))


def _cli_child_cmd(root: str, tag: str, store: str, cache: str) -> list:
    return ([sys.executable, "-m",
             "howtotrainyourmamlpytorch_tpu_torch.train_maml_system",
             "--name_of_args_json_file", FLAGSHIP, "--experiment_root", root,
             "--experiment_name", tag] + CLI_ARGS
            + ["--aot_store_dir", store, "--compilation_cache_dir", cache])


def _warm_row(root: str, tag: str) -> dict:
    """A CLI child's ``warm_start`` row and its last registry snapshot."""
    from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import read_jsonl
    rows = read_jsonl(os.path.join(root, tag, "logs", "events.jsonl"))
    warm = [r for r in rows if r.get("event") == "warm_start"]
    snaps = [r.get("metrics") or {} for r in rows
             if r.get("event") == "metrics"]
    return {"row": warm[-1] if warm else {},
            "metrics": snaps[-1] if snaps else {}}


def _trees_bitwise(a, b) -> list:
    """Names of the differing leaves of two trees (by
    ``parallel/aot.py § flatten``; a different structure is one name)."""
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.parallel import aot
    (la, sa), (lb, sb) = aot.flatten(a), aot.flatten(b)
    if aot._structure(sa) != aot._structure(sb):
        return ["<structure>"]
    return [str(i) for i, (x, y) in enumerate(zip(la, lb))
            if x.shape != y.shape or not torch.equal(x, y)]


def _card_faults(name: str, card, fingerprint: str) -> list:
    """What a cost card of the store lacks: FLOPs, bytes accessed, a
    peak memory, a compute or memory bound, the store's fingerprint."""
    if card is None:
        return [f"{name}: no cost card"]
    faults = [f"{name}: {key} {card.get(key)!r}" for key, ok in (
        ("flops", (card.get("flops") or 0) > 0),
        ("bytes_accessed", (card.get("bytes_accessed") or 0) > 0),
        ("memory", ((card.get("memory") or {}).get("peak_bytes") or 0) > 0),
        ("bound", card.get("bound") in ("compute", "memory")),
        ("fingerprint", card.get("fingerprint") == fingerprint[:16]))
        if not ok]
    return faults


def _card_text(card: dict) -> str:
    """A cost card on one line: FLOPs, bytes, intensity, bound, memory."""
    mem = {k.replace("_size_in_bytes", ""): v
           for k, v in (card.get("memory") or {}).items()}
    ai = card.get("arithmetic_intensity")
    return (f"{card['flops'] / 1e9:.3f} GFLOP, "
            f"{card['bytes_accessed'] / 1e9:.3f} GB accessed, AI "
            f"{'n/a' if ai is None else f'{ai:.2f}'} FLOP/B (ridge "
            f"{card.get('ridge_flops_per_byte')}), bound {card['bound']}, "
            f"memory {json.dumps(mem)}")


def _warm_cost_cards(leg_out: str, runs: str, pre: dict,
                     card: str) -> list:
    """Phase 14 (c)'s cost cards: the prewarm's store holds one for each
    executable it made; the warm CLI child's ``logs/PROFILE.json``
    carries them, and the store's file was last written before that
    child's config was (the child counted nothing again); the cold CLI
    child's logs carry its own store's cards. Returns the faults."""
    import glob
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import profiler
    faults = []
    paths = glob.glob(os.path.join(leg_out, "warm_store", "*",
                                   profiler.PROFILE_FILE))
    doc = profiler.load_profile(paths[0]) if len(paths) == 1 else None
    if doc is None:
        return [f"(c) prewarm store: cost databases {paths}"]
    names = sorted(e["name"] for e in pre.get("executables") or [])
    for n in names:
        faults += [f"(c) {f}" for f in _card_faults(
            n, doc["cards"].get(n), doc["fingerprint"])]
    warm = profiler.load_profile(os.path.join(
        leg_out, "chaos_warm", "logs", profiler.PROFILE_FILE))
    child_cfg = os.path.join(leg_out, "chaos_warm.json")
    recounted = doc["written_ts"] >= os.path.getmtime(child_cfg)
    cold_store = glob.glob(os.path.join(os.path.dirname(runs), "cold_store",
                                        "*", profiler.PROFILE_FILE))
    cold_doc = (profiler.load_profile(cold_store[0]) if len(cold_store) == 1
                else None)
    cold_logs = profiler.load_profile(os.path.join(
        runs, "cold", "logs", profiler.PROFILE_FILE))
    print(f"warm start (c) cost cards: the prewarm's store "
          f"{sorted(doc['cards'])} for executables {names}; the warm CLI "
          f"child's logs/PROFILE.json "
          f"{sorted((warm or {}).get('cards') or {})}, the store last "
          f"written {'after' if recounted else 'before'} the child began; "
          f"the cold CLI child's store "
          f"{sorted((cold_doc or {}).get('cards') or {})} and logs "
          f"{sorted((cold_logs or {}).get('cards') or {})} ({card})",
          flush=True)
    if (not names or warm is None or warm["cards"] != doc["cards"]
            or recounted or cold_doc is None or not cold_doc["cards"]
            or cold_logs is None or cold_logs["cards"] != cold_doc["cards"]):
        faults.append("(c) cost cards: the warm child's logs do not carry "
                      "the prewarm's cards, the child wrote the store, or "
                      "the cold child's logs lack its store's cards")
    return faults


def warm_start(entry: dict, card: str) -> None:
    """Phase 14: the warm-start subsystem at the flagship's full width
    (``parallel/aot.py``; module docstring). (a) serving: an eager
    engine, a cold engine on a fresh store (misses, captured and
    recorded) and a second engine on the same store (hits, no misses),
    all on the same requests under deterministic cuDNN: logits bitwise,
    BN-kernel launches 20 per adapt run and 4 per predict run, replays
    and captures' warm-ups included. (b) training: ``WARM_STEPS`` through
    the phase keys' graphs and eagerly from one state (epoch 0 and 41,
    two ``opt.count`` values each): state, Adam moments and metrics
    bitwise (else held to ``F32_FLOORS``), one eval batch bitwise,
    launches as derived; step wall times and one profiled step each
    printed, nothing claimed. (c) warm restart: the prewarm script and a
    cold CLI child run beside (a) and (b); then the CLI child on the warm
    store: exit 0, hits > 0, misses 0, no nvcc run. The cost database
    (``AOTStore.record_cost_card``): the cold engine counts a card for
    every adapt and predict extent, the warm one none, and
    ``write_profile_json`` copies them; (b)'s store holds a card for each
    phase key and the eval step (the flagship ``train_so1_msl0`` card,
    its counted warm-up's wall and its bytes over a profiled replay's
    device time printed); the prewarm's store a card for each
    executable, which the warm CLI child's ``logs/PROFILE.json`` carries
    without writing the store. Each card has FLOPs, bytes, a peak memory,
    a compute or memory bound and the store's fingerprint. Adds the
    launches of (a) and (b) to ``entry``."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    from howtotrainyourmamlpytorch_tpu_torch.data import (
        MetaLearningDataLoader)
    from howtotrainyourmamlpytorch_tpu_torch.device import numerics_policy
    from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
        init_train_state, make_eval_step, make_train_step)
    from howtotrainyourmamlpytorch_tpu_torch.models import make_model
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.parallel import aot
    from howtotrainyourmamlpytorch_tpu_torch.serve import (
        FewShotRequest, ServingEngine)
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import (
        MetricsRegistry)
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import profiler

    t_phase = time.perf_counter()
    seconds = {}
    os.makedirs(os.path.join(REPO, ".smoke_runs"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="warm_start_",
                           dir=os.path.join(REPO, ".smoke_runs"))
    children = []
    failures = []
    try:
        # (c) first half, beside (a) and (b): the chaos harness's
        # warm-restart leg starts its prewarm child (a fresh store and
        # kernel cache); a cold CLI child runs on empty ones.
        chaos = _load_script(CHAOS_SCRIPT)
        leg_out = os.path.join(tmp, "leg")

        def popen(cmd, **kw):
            children.append(_spawn("warm restart leg", cmd,
                                   env=kw.get("env"), stdout=kw["stdout"],
                                   stderr=kw["stderr"]))
            return children[-1]

        leg = chaos.start_warm_restart_leg(leg_out, "cuda", quick=False,
                                           popen=popen,
                                           prewarm_args=["--serve"])
        runs = os.path.join(tmp, "runs")
        cold = _spawn("cold cli", _cli_child_cmd(
            runs, "cold", os.path.join(tmp, "cold_store"),
            os.path.join(tmp, "cold_cache")))
        children.append(cold)

        # (a) serving.
        t1 = time.perf_counter()
        cfg = MAMLConfig.from_json_file(FLAGSHIP).replace(
            bn_backend="pallas", serve_default_deadline_ms=0.0)
        model_init, _ = make_model(cfg)
        state = init_train_state(cfg, model_init, seed=cfg.seed,
                                 device="cuda")
        h, w, c = cfg.image_shape
        n, k = cfg.num_classes_per_set, cfg.num_samples_per_class
        rng = np.random.default_rng(cfg.seed + 14)
        requests = [FewShotRequest(
            support_x=rng.integers(0, 256, (n * k, h, w, c), dtype=np.uint8),
            support_y=np.repeat(np.arange(n, dtype=np.int32), k),
            query_x=rng.integers(0, 256, (cfg.num_target_per_task, h, w, c),
                                 dtype=np.uint8))
            for _ in range(2 * cfg.serve_batch_tasks)]
        store_a = os.path.join(tmp, "serve_store")
        served, counts = {}, {}
        serve_cfg = cfg.replace(aot_store_dir=store_a, experiment_root=tmp,
                                experiment_name="serve")
        with numerics_policy(cfg.compute_dtype, deterministic=True):
            for name, ecfg in (("eager", cfg), ("cold", serve_cfg),
                               ("warm", serve_cfg)):
                bn_act.reset_launches()
                eng = ServingEngine(ecfg, state, device="cuda")
                try:
                    eng.warmup()
                    for req in requests:
                        eng.submit(FewShotRequest(
                            support_x=req.support_x,
                            support_y=req.support_y,
                            query_x=req.query_x))
                    out = eng.drain()
                    torch.cuda.synchronize()
                    snap = eng.registry.snapshot()
                    served[name] = [r.logits for r in out]
                    execs = list(eng._aot_adapt.values()) + list(
                        eng._aot_predict.values())
                    counts[name] = {
                        "launches": bn_act.launches,
                        "derived": 20 * eng.adapt_runs
                        + 4 * eng.predict_runs,
                        "adapt_runs": eng.adapt_runs,
                        "predict_runs": eng.predict_runs,
                        "hits": int(snap.get(aot.HITS, 0)),
                        "misses": int(snap.get(aot.MISSES, 0)),
                        "errors": int(snap.get(aot.ERRORS, 0)),
                        "graphs": [getattr(e, "compiled", None) is not None
                                   for e in execs],
                        "captured": [getattr(e.compiled, "launches", None)
                                     for e in execs
                                     if getattr(e, "compiled", None)],
                        "counted": [e.compiled.costs is not None
                                    for e in execs
                                    if getattr(e, "compiled", None)]}
                    if name == "warm":
                        serve_fp = eng._aot_store.fingerprint
                        serve_doc = profiler.load_profile(
                            eng._aot_store.profile_path())
                        copied = eng.write_profile_json()
                finally:
                    eng.close()
        entry["launches"] += sum(counts[k]["launches"] for k in counts)
        bitwise = {k: all(np.array_equal(a, b) for a, b in zip(
            served["eager"], served[k])) and len(served[k]) == len(
            served["eager"]) for k in ("cold", "warm")}
        print(f"warm start (a) serving: {len(requests)} requests through an "
              f"eager engine, a cold one and a warm one on one store: "
              f"logits bitwise the eager engine's {json.dumps(bitwise)}; "
              f"{json.dumps(counts)} ({card})", flush=True)
        a = counts
        if (not all(bitwise.values())
                or any(a[k]["launches"] != a[k]["derived"] for k in a)
                or a["cold"]["misses"] != 2 or a["cold"]["hits"] != 0
                or a["warm"]["hits"] != 2 or a["warm"]["misses"] != 0
                or a["cold"]["errors"] or a["warm"]["errors"]
                or not all(a["cold"]["graphs"] + a["warm"]["graphs"])
                or sorted(a["warm"]["captured"]) != [4, 20]):
            failures.append(f"(a) serving: bitwise {bitwise}, "
                            f"{json.dumps(counts)}")
        # The cost database: the cold engine counted every extent's
        # card, the warm one none; the engine copies them to its logs.
        extents = sorted({aot.serve_adapt_name(sb)
                          for sb, _ in cfg.serve_bucket_shapes}
                         | {aot.serve_predict_name(qb)
                            for _, qb in cfg.serve_bucket_shapes})
        serve_cards = (serve_doc or {}).get("cards") or {}
        copied_doc = profiler.load_profile(copied) if copied else None
        for n in extents:
            print(f"warm start (a) cost card {n}: "
                  f"{_card_text(serve_cards[n]) if n in serve_cards else None}"
                  f" ({card})", flush=True)
            failures += [f"(a) {f}" for f in _card_faults(
                n, serve_cards.get(n), serve_fp)]
        if (not all(a["cold"]["counted"]) or any(a["warm"]["counted"])
                or sorted(serve_cards) != extents or copied_doc is None
                or copied_doc["cards"] != serve_cards):
            failures.append(f"(a) cost cards: counted cold "
                            f"{a['cold']['counted']}, warm "
                            f"{a['warm']['counted']}; store cards "
                            f"{sorted(serve_cards)} of {extents}; copied to "
                            f"{copied}")
        seconds["a"] = round(time.perf_counter() - t1, 1)

        # (b) training: the phase keys' graphs against the eager steps.
        t1 = time.perf_counter()
        model_init, apply = make_model(cfg)
        state0 = init_train_state(cfg, model_init, seed=cfg.seed,
                                  device="cuda")
        loader = MetaLearningDataLoader(cfg, device="cuda")
        it = loader.get_train_batches(0, len(WARM_STEPS))
        batches = [next(it) for _ in WARM_STEPS]
        it.close()
        val = loader.get_val_batches()
        eval_batch = next(val)
        val.close()
        train_step = make_train_step(cfg, apply)
        eval_step = make_eval_step(cfg, apply)
        micro, stages = cfg.effective_task_microbatches(), cfg.num_stages
        per_step = {e: micro * stages * _forwards_per_chunk(
            cfg, cfg.use_second_order(e), cfg.use_msl(e))
            for e, _ in WARM_STEPS}
        chains, times = {}, {"eager": {}, "graph": {}}
        graphs = {}
        # The graphs come through the adoption primitive on a fresh
        # store, which counts each capture's warm-up into its cost card.
        reg_b = MetricsRegistry()
        store_b = aot.AOTStore.from_config(
            cfg.replace(aot_store_dir=os.path.join(tmp, "train_store")),
            "cuda", registry=reg_b)

        def adopt(name, capture, sig, fallback):
            fn_, _ = aot.load_or_compile(store_b, name, capture, sig,
                                         registry=reg_b, fallback=fallback)
            if getattr(fn_, "compiled", None) is None:
                raise AssertionError(f"warm start (b): the capture of "
                                     f"{name} failed")
            return fn_.compiled

        with numerics_policy(cfg.compute_dtype, deterministic=True):
            bn_act.reset_launches()
            for mode in ("eager", "graph"):
                st, metrics = state0, []
                for epoch, b in WARM_STEPS:
                    key = (cfg.use_second_order(epoch), cfg.use_msl(epoch))
                    fn = train_step
                    if mode == "graph":
                        if key not in graphs:
                            zero = aot.zero_episode(cfg, cfg.batch_size,
                                                    "cuda")
                            graphs[key] = adopt(
                                aot.train_exec_name(key),
                                lambda: aot.TrainGraph(cfg, train_step, key,
                                                       st, zero, epoch),
                                aot.signature_of(st, zero), train_step)
                        fn = graphs[key]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    st, m = fn(st, batches[b], epoch, second_order=key[0],
                               use_msl=key[1])
                    torch.cuda.synchronize()
                    times[mode].setdefault(str(key), []).append(round(
                        (time.perf_counter() - t0) * 1e3, 1))
                    metrics.append((m.loss, m.accuracy, m.support_loss,
                                    m.learning_rate))
                chains[mode] = (st, metrics)
            eval_graph = adopt(
                "eval", lambda: aot.EvalGraph(eval_step, chains["eager"][0],
                                              eval_batch),
                aot.EvalGraph.signature(chains["eager"][0], eval_batch),
                eval_step)
            res_e = eval_step(chains["eager"][0], eval_batch)
            res_g = eval_graph(chains["eager"][0], eval_batch)
            torch.cuda.synchronize()
            train_launches = bn_act.launches
            # Wall and device time of one step of each, for the record.
            key41 = (cfg.use_second_order(41), cfg.use_msl(41))
            prof_e = _profiled("warm start (b) eager epoch-41 step",
                               lambda: train_step(
                                   chains["eager"][0], batches[3], 41,
                                   second_order=key41[0],
                                   use_msl=key41[1]), card)
            prof_g = _profiled("warm start (b) graph epoch-41 step",
                               lambda: graphs[key41](
                                   chains["graph"][0], batches[3], 41,
                                   second_order=key41[0],
                                   use_msl=key41[1]), card)
        entry["launches"] += train_launches
        (st_e, m_e), (st_g, m_g) = chains["eager"], chains["graph"]
        diff = _trees_bitwise(st_e, st_g)
        m_diff = [i for i, (x, y) in enumerate(zip(m_e, m_g))
                  if _trees_bitwise(x[:3], y[:3]) or x[3] != y[3]]
        e_diff = _trees_bitwise(tuple(res_e), tuple(res_g))
        counters = (st_e.opt_state.count, st_e.step,
                    st_g.opt_state.count, st_g.step)
        warmups = sum(per_step[e] for e, _ in ((0, 0), (41, 0)))
        derived = (2 * sum(per_step[e] for e, _ in WARM_STEPS) + warmups
                   + 3 * stages * (cfg.number_of_evaluation_steps_per_iter
                                   + 1))
        captured = {str(k_): g.launches for k_, g in graphs.items()}
        print(f"warm start (b) training: {len(WARM_STEPS)} steps (epochs "
              f"{[e for e, _ in WARM_STEPS]}, opt.count 0..3) eagerly and "
              f"through {len(graphs)} phase-key graphs from one state: "
              f"differing state leaves {diff}, differing step metrics "
              f"{m_diff}, counters {counters}; eval batch graph vs eager "
              f"differing {e_diff}; bn_act launches {train_launches} (derived "
              f"{derived}: 2 x the steps + one warm-up step per key + 3 eval "
              f"batches, the graph's warm-up included; captured per key {json.dumps(captured)}); step ms "
              f"{json.dumps(times)}; profiled wall/device/idle eager "
              f"{prof_e['wall_ms']:.1f}/{prof_e['device_ms']:.1f}/"
              f"{prof_e['idle']:.3f}, graph {prof_g['wall_ms']:.1f}/"
              f"{prof_g['device_ms']:.1f}/{prof_g['idle']:.3f} ({card})",
              flush=True)
        if diff or m_diff:
            from howtotrainyourmamlpytorch_tpu_torch.tree import tree_map
            upd = lambda s: _leaf_vectors(tree_map(
                torch.sub, {"params": s.params, "lslr": s.lslr},
                {"params": state0.params, "lslr": state0.lslr}))
            failures += _compare_meta_gradients(
                "warm start (b) graph vs eager",
                (float(m_g[-1][0]), upd(st_g)),
                (float(m_e[-1][0]), upd(st_e)), F32_FLOORS, card,
                what="the update over the steps")
        for key_, g in graphs.items():
            if g.launches != per_step[41 if key_[0] else 0]:
                failures.append(f"(b) {key_}: captured {g.launches} "
                                f"launches, the step makes "
                                f"{per_step[41 if key_[0] else 0]}")
        if (e_diff or train_launches != derived
                or counters != (4, 4, 4, 4)):
            failures.append(f"(b) eval differing {e_diff}, launches "
                            f"{train_launches} vs {derived}, counters "
                            f"{counters}")
        # The store's cards: one per phase key and the eval step, each
        # counted on its capture's warm-up (its wall inside
        # aot/compile_seconds, beside an eager step of the key).
        cards_b = {n: store_b.cost_card(n) for n in sorted(
            [aot.train_exec_name(k_) for k_ in graphs] + ["eval"])}
        for n, c in cards_b.items():
            failures += [f"(b) {f}" for f in _card_faults(
                n, c, store_b.fingerprint)]
        warmups_s = {aot.train_exec_name(k_): round(
            g.exec.warmup_seconds, 3) for k_, g in graphs.items()}
        warmups_s["eval"] = round(eval_graph.exec.warmup_seconds, 3)
        flagship = cards_b.get(aot.train_exec_name(key41))
        bw = _bandwidth(torch.cuda.get_device_name())
        if flagship is not None:
            rate = flagship["bytes_accessed"] / (prof_g["device_ms"] / 1e3)
            print(f"warm start (b) cost card {aot.train_exec_name(key41)} "
                  f"(the flagship's second-order step): "
                  f"{_card_text(flagship)}; its counted bytes over the "
                  f"profiled replay's device time {rate / 1e12:.3f} TB/s "
                  f"beside {bw / 1e12:.2f} TB/s ({card})", flush=True)
        for n, c in cards_b.items():
            if c is not None:
                print(f"warm start (b) cost card {n}: {_card_text(c)}; "
                      f"{c.get('flops_source')} ({card})", flush=True)
        print(f"warm start (b) counted warm-ups (s) {json.dumps(warmups_s)}"
              f" beside eager step ms {json.dumps(times['eager'])}; "
              f"aot/compile_seconds "
              f"{reg_b.counter(aot.COMPILE_SECONDS).value:.3f} over "
              f"{len(cards_b)} captures, perf/errors "
              f"{reg_b.counter(profiler.ERRORS_COUNTER).value} ({card})",
              flush=True)
        del graphs, eval_graph, chains, store_b
        torch.cuda.empty_cache()
        seconds["b"] = round(time.perf_counter() - t1, 1)

        # (c) warm restart: the leg waits for its prewarm, then runs the
        # CLI child on the warm store; the cold child's time to first
        # step beside it.
        t1 = time.perf_counter()
        res = chaos.finish_warm_restart_leg(leg, timeout=WARM_TIMEOUT)
        seconds["leg"] = round(time.perf_counter() - t1, 1)
        coldp = _finish("cold cli", cold, WARM_TIMEOUT)
        pre = res["warm_restart_prewarm"]
        wm = _warm_row(leg_out, "chaos_warm")["metrics"]
        crow = _warm_row(runs, "cold")["row"]
        print(f"warm start (c): prewarm {json.dumps(pre)}; the warm "
              f"restart leg {json.dumps({k_: v for k_, v in res.items() if k_ != 'warm_restart_prewarm'})}, "
              f"aot counters "
              f"{json.dumps({k_: v for k_, v in wm.items() if k_.startswith('aot/')})}"
              f"; cold CLI (beside (a) and (b)) exit {coldp.returncode}: "
              f"warm_start {json.dumps(crow)}; time to first step cold "
              f"{crow.get('time_to_first_step_seconds')} s, warm "
              f"{res.get('warm_restart_time_to_first_step_s')} s ({card})",
              flush=True)
        if (not res["warm_restart_ok"] or pre.get("nvcc_runs") != 1
                or res["warm_restart_nvcc_runs_before_first_step"] != 0
                or int(wm.get(aot.MISSES, -1)) != 0
                or int(wm.get(aot.HITS, 0)) < 1
                or int(wm.get(aot.ERRORS, 0)) != 0):
            failures.append(f"(c) warm restart: {json.dumps(res)[-3000:]}"
                            f", metrics {json.dumps(wm)[-1500:]}")
        if (coldp.returncode != 0 or (crow.get("aot_misses") or 0) < 1
                or crow.get("nvcc_runs_before_first_step") != 1):
            failures.append(f"(c) cold CLI: exit {coldp.returncode}, row "
                            f"{json.dumps(crow)}; stderr "
                            f"{coldp.stderr[-2000:]}")
        failures += _warm_cost_cards(leg_out, runs, pre, card)
        seconds["c"] = round(time.perf_counter() - t1, 1)
    finally:
        for proc in children:
            _reap(proc)
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    seconds["all"] = round(time.perf_counter() - t_phase, 1)
    print("phase 14 seconds per part: " + json.dumps(seconds), flush=True)
    if failures:
        raise AssertionError("phase 14: " + "; ".join(failures))


TUNE_SCRIPT = os.path.join(REPO, "scripts", "torch_autotune.py")
# Phase 15's base: the flagship JSON on the hand-written kernel, under
# the slowest remat policy, so the sweep holds a known faster point (the
# shipped 'block_outs', bitwise the same program).
TUNE_BASE = {"bn_backend": "pallas", "remat_policy": "dots"}
# The sweep's space: the shipped remat policy with cuDNN's
# nondeterministic algorithms, and with a value no backend option
# takes. Three trials: the baseline, the winner ('block_outs', false)
# and an invalid flag.
TUNE_SPEC = {"axes": [
    {"name": "remat_policy", "values": ["block_outs"]},
    {"name": "cudnn_deterministic", "kind": "xla",
     "values": ["false", "fastest"]}]}
TUNE_WINNER = ({"remat_policy": "block_outs"},
               {"cudnn_deterministic": "false"})
TUNE_STEPS = 3
TUNE_TRIAL_TIMEOUT = 300
TUNE_TIMEOUT = 900


def _tune_artifact(tag: str, cmd, out: str) -> dict:
    """Run the autotune driver as a child; its artifact (last line)."""
    res = _child(tag, cmd, timeout=TUNE_TIMEOUT)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    for line in lines[:-1]:
        print(f"{tag}: {line}", flush=True)
    if res.returncode != 0 or not lines:
        raise AssertionError(f"{tag}: exit {res.returncode}\n"
                             f"{res.stdout[-3000:]}{res.stderr[-3000:]}")
    art = json.loads(lines[-1])
    if not (art.get("ok") and art.get("jax_free") and art.get("torch_free")):
        raise AssertionError(f"{tag}: artifact {art}")
    return art


def tune_sweep(entry: dict, card: str) -> None:
    """Phase 15: ``scripts/torch_autotune.py`` on the flagship JSON at
    full width (``TUNE_BASE``; 3 timed steps per trial) over
    ``TUNE_SPEC``, the parity gate at its default tolerance, the
    accuracy gate skipped (recorded) and ``--prove-warm-train``; then the
    same command again, which must run no trial. The unknown value is
    counted ``invalid_flag`` and the sweep goes on; every ``ok`` trial
    ran on the card with BN-kernel launches (added to ``entry``);
    ``TUNED.json`` holds the verdict and its reason; ``TUNE_WINNER`` is
    adopted with bitwise parity, and its warm train read no compile
    before its first step; no process of the phase is left. Rates are printed, not
    gated (the phase runs beside others)."""
    import shutil

    import torch
    t0 = time.perf_counter()
    root = os.path.join(REPO, ".smoke_runs", f"tune_{os.getpid()}")
    os.makedirs(root, exist_ok=True)
    with open(FLAGSHIP) as f:
        base = {**json.load(f), **TUNE_BASE,
                "experiment_root": os.path.join(root, "exp")}
    base_path = os.path.join(root, "base.json")
    with open(base_path, "w") as f:
        json.dump(base, f)
    spec_path = os.path.join(root, "space.json")
    with open(spec_path, "w") as f:
        json.dump(TUNE_SPEC, f)
    out = os.path.join(root, "sweep")
    cmd = [sys.executable, TUNE_SCRIPT, "--config", base_path, "--out",
           out, "--space", spec_path, "--platform", "cuda",
           "--steps", str(TUNE_STEPS),
           "--trial-timeout", str(TUNE_TRIAL_TIMEOUT),
           "--accuracy-gate", "skip"]
    art = _tune_artifact("tune sweep", cmd + ["--prove-warm-train"], out)
    sweep_s = time.perf_counter() - t0
    if (art["trials_total"] != 3 or art["trials_run"] != 3
            or art["failed_by_outcome"] != {"invalid_flag": 1}
            or art["invalid_flag_failures"] != 1):
        raise AssertionError(f"tune sweep: trials {art}")
    with open(art["ledger"]) as f:
        rows = json.load(f)["trials"]
    kind = torch.cuda.get_device_name(0)
    launched = 0
    for tid, row in rows.items():
        print(f"tune trial {tid} {row['assignment']}: {row['outcome']}, "
              f"{row.get('value')} tasks/s, {row.get('step_ms')} ms/step, "
              f"{row.get('bn_launches')} BN launches, {row['seconds']} s "
              f"of process ({card})", flush=True)
        if row["outcome"] != "ok":
            continue
        if row.get("device_kind") != kind or not row.get("bn_launches"):
            raise AssertionError(f"tune trial {tid} did not run the BN "
                                 f"kernel on the card: {row}")
        launched += row["bn_launches"]
    with open(art["tuned_path"]) as f:
        tuned = json.load(f)
    if not isinstance(tuned.get("adopted"), bool) or not tuned.get("reason"):
        raise AssertionError(f"tune: TUNED.json without a verdict {tuned}")
    # The winner is known by construction ('block_outs' runs the same
    # program as 'dots' at about twice the rate): it must be adopted,
    # its parity bitwise and its warm train free of compiles.
    warm, parity = art["warm_train"], art["gates"]["parity"]
    best = art["best"] or {}
    if not (tuned["adopted"] is True
            and (best.get("config_overrides"),
                 best.get("compiler_options")) == TUNE_WINNER
            and parity.get("pass") is True
            and parity.get("mode") == "bitwise"
            and tuned.get("bitwise_resume") is False
            and warm and warm.get("ok")
            and warm.get("compiles_before_first_step") == 0
            and warm.get("bitwise_resume") is False):
        raise AssertionError(f"tune: winner {best}, verdict {tuned}, "
                             f"parity {parity}, warm train {warm}")
    print(f"tune: winner {art['best']}, adopted {tuned['adopted']} "
          f"({tuned['reason']}); parity {art['gates']['parity']}; warm "
          f"train {warm}; sweep {sweep_s:.1f} s ({card})", flush=True)
    t1 = time.perf_counter()
    again = _tune_artifact("tune resume", cmd, out)
    if again["trials_run"] != 0 or again["trials_resumed"] != 3:
        raise AssertionError(f"tune resume ran trials: {again}")
    # Orphans of the driver's children come to this process (a
    # subreaper) and are listed too.
    left = _survivors()
    if left:
        raise AssertionError(f"tune: processes left {left}")
    entry["launches"] += launched
    shutil.rmtree(root, ignore_errors=True)
    print(f"tune: {launched} BN launches in the trials; resume "
          f"{time.perf_counter() - t1:.1f} s; phase 15 "
          f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)


SCRIPTS_DIR = os.path.join(REPO, "scripts")
# Phase 16's runs: (script, arguments). One point per sweep at full
# width, one timed step per leg, batches cut where the script takes a
# batch (the ResNet-12 sweep's one-task point); two trajectory steps for
# the drift at the flagship's batch (its floors' geometry).
SCRIPT_RUNS = (
    ("torch_bf16_drift", ["--steps", "2"]),
    ("torch_perf_variants", ["--points", "block_outs_fm1", "--steps", "1",
                             "--batch", "4"]),
    ("torch_perf_sweep", ["--points", "b16_noremat_nothing", "--steps",
                          "1"]),
    ("torch_perf_msl", ["--points", "msl_batched_out_of_scan", "--steps",
                        "1", "--batch", "4"]),
    ("torch_perf_eval", ["--points", "eb24", "--episodes", "48"]),
    ("torch_perf_microbatch_sweep", [
        "--configs", "omniglot_maml++_5-way_5-shot.json", "--points",
        "mb4", "--steps", "1"]),
    ("torch_perf_resnet12_sweep", ["--phase", "batch", "--points", "b1",
                                   "--steps", "1"]))
SCRIPT_TIMEOUT = 300
# Floors of the bf16-vs-f32 drift probes (scripts/torch_bf16_drift.py,
# flagship JSON, batch 12, two trajectory steps): each lies between what
# the sound pair reads (the shipped bf16 step against the f32 path) and
# what a planted fault reads (the bf16, or the f32, variant with a 10 %
# larger inner learning rate; the f32 reference unchanged): eval logits'
# mean abs diff over the mean abs logit 0.0477 sound against 0.0708 /
# 0.0578 faulted; one-step loss rel 1.41e-3 against 2.61e-3 / 4.02e-3;
# the trajectories' largest loss gap, noise 2.24e-3 against 6.65e-3 /
# 5.57e-3 and separable 7.95e-3 against 2.07e-2 / 2.09e-2 (NVIDIA H100
# 80GB HBM3, 700 W; PERF.md § 6). The argmax agreement at init (sound
# 0.943, faulted 0.903 / 0.950) and the post-update weights' rel-L2
# (sound up to 0.0132, faulted 0.0139 / 0.0118) do not tell the two
# apart: both are printed, and the agreement is held only against a
# gross fault.
DRIFT_FLOORS = {
    "eval_mean_abs_diff_rel_max": 0.053,
    "eval_argmax_agreement_min": 0.85,
    "one_step_loss_rel_max": 2.0e-3,
    "noise_loss_gap_max": 4.0e-3,
    "separable_loss_gap_max": 1.4e-2,
}


def _drift_faults(rows: list) -> list:
    """The drift floors the probe rows miss."""
    by = {r["probe"] if r["probe"] != "trajectory" else r["stream"]: r
          for r in rows}
    ev, one = by["eval_logits"], by["one_step"]
    read = {
        "eval_mean_abs_diff_rel_max": (ev["mean_abs_diff"]
                                       / ev["logit_scale_mean_abs"]),
        "eval_argmax_agreement_min": ev["argmax_agreement"],
        "one_step_loss_rel_max": (abs(one["loss_bf16"] - one["loss_f32"])
                                  / abs(one["loss_f32"])),
        "noise_loss_gap_max": by["noise"]["loss_gap_max"],
        "separable_loss_gap_max": by["separable"]["loss_gap_max"]}
    print(f"scripts drift readings {json.dumps(read)} against "
          f"{json.dumps(DRIFT_FLOORS)}", flush=True)
    return [f"{k} {v:.4g} (floor {DRIFT_FLOORS[k]})"
            for k, v in read.items()
            if (v < DRIFT_FLOORS[k] if k.endswith("_min")
                else v > DRIFT_FLOORS[k])]


def script_sweeps(entry: dict, card: str) -> None:
    """Phase 16: each of ``SCRIPT_RUNS`` in a process of its own; see
    the module docstring."""
    t0 = time.perf_counter()
    launched = 0
    for name, argv in SCRIPT_RUNS:
        t1 = time.perf_counter()
        tag = f"scripts {name}"
        res = _child(tag, [sys.executable, os.path.join(
            SCRIPTS_DIR, f"{name}.py")] + argv, timeout=SCRIPT_TIMEOUT)
        rows = [json.loads(line) for line in res.stdout.splitlines()
                if line.startswith("{")]
        if res.returncode != 0 or not rows:
            raise AssertionError(f"{tag}: exit {res.returncode}\n"
                                 f"{res.stdout[-3000:]}"
                                 f"{res.stderr[-3000:]}")
        measured = [r for r in rows if "point" in r or "probe" in r]
        bad = [r for r in rows if "error" in r]
        if bad or not measured:
            raise AssertionError(f"{tag}: rows {bad or rows}\n"
                                 f"{res.stderr[-3000:]}")
        for r in rows:
            print(f"{tag}: {json.dumps(r)}", flush=True)
        for r in measured:
            # A sweep row's graph leg: run, with its own launches.
            legs = [r] + ([r["graph"]] if "point" in r else [])
            if any(not leg.get("bn_launches") for leg in legs):
                raise AssertionError(f"{tag}: a leg without BN launches "
                                     f"or a graph leg not run: {r}")
            launched += sum(leg["bn_launches"] for leg in legs)
        if name == "torch_bf16_drift":
            faults = _drift_faults(measured)
            if faults:
                raise AssertionError(f"{tag}: drift floors missed "
                                     f"{faults}")
        left = _survivors()
        if left:
            raise AssertionError(f"{tag}: processes left {left}")
        print(f"{tag}: exit 0, {len(measured)} rows, "
              f"{time.perf_counter() - t1:.1f} s ({card})", flush=True)
    entry["launches"] += launched
    print(f"scripts: {launched} BN launches in the seven scripts; phase 16 "
          f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)


def _epoch_seconds(logs: str) -> list:
    """A run's epoch seconds from its ``summary_statistics.csv``."""
    from howtotrainyourmamlpytorch_tpu_torch.utils.storage import (
        load_statistics)
    return [round(float(v), 2)
            for v in load_statistics(logs)["epoch_seconds"]]


def _no_leftovers() -> bool:
    """Print the processes this script started that are still alive and
    the compute processes on the card other than this one; True when
    both lists are empty. Whatever is left is killed all the same."""
    alive = _survivors()
    on_card = _card_processes()
    print(f"chip_smoke: processes started and still alive {alive}; "
          f"compute processes on the card besides this one {on_card} "
          f"({len(_STARTED)} processes started)", flush=True)
    if alive or on_card:
        print(f"chip_smoke: FAILED: left running {alive}, on the card "
              f"{on_card}", file=sys.stderr, flush=True)
        for pid, _ in alive:
            with contextlib.suppress(ProcessLookupError, PermissionError):
                os.kill(pid, signal.SIGKILL)
    return not alive and not on_card


def _become_subreaper() -> None:
    """Make this process the reaper of its orphaned descendants (Linux
    ``PR_SET_CHILD_SUBREAPER``), so a grandchild whose parent died still
    counts as this script's and is listed and killed at the end."""
    import ctypes
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(36, 1, 0, 0, 0) != 0:   # PR_SET_CHILD_SUBREAPER
        print(f"chip_smoke: PR_SET_CHILD_SUBREAPER failed (errno "
              f"{ctypes.get_errno()}): orphans of children are not "
              f"tracked", flush=True)


# Phases 6, 8, 14, 15 and 16 need nothing of the others: each runs in a
# child process (``--phase-child``) beside other phases, for run time (the
# limit is 1200 s); the child's output is printed when it is joined, its
# launches added to the kernel's entry. Phase 11's latency gates and
# phase 13's leases run beside nothing.
PHASE_CHILD_FLAG = "--phase-child"
PHASE_SCHEDULE = (
    ("start", "backbones"), ("start", "tune"), ("start", "scripts"),
    ("run", "serve"), ("run", "train"), ("run", "cli"),
    ("run", "telemetry"), ("join", "backbones"), ("join", "tune"),
    ("start", "faults"), ("start", "warm"), ("run", "serving"),
    ("run", "data"), ("start", "pod_prewarm"), ("run", "mesh"),
    ("join", "warm"), ("join", "pod_prewarm"), ("join", "faults"),
    ("join", "scripts"), ("run", "fleet"), ("run", "pod"))
PHASE_CHILD_TIMEOUT = 900


def _phase_children() -> dict:
    return {"backbones": other_backbones, "faults": fault_path,
            "warm": warm_start, "tune": tune_sweep,
            "pod_prewarm": pod_prewarm, "scripts": script_sweeps}


def _start_phase_child(name: str) -> dict:
    """Start phase ``name`` in a child process; its output goes to a file
    under ``.smoke_runs/``."""
    runs = os.path.join(REPO, ".smoke_runs")
    os.makedirs(runs, exist_ok=True)
    out = os.path.join(runs, f"phase_{name}_{os.getpid()}")
    log = open(f"{out}.log", "w")
    proc = _spawn(f"phase {name}", [sys.executable, os.path.abspath(
        __file__), PHASE_CHILD_FLAG, name, f"{out}.json"], stdout=log,
        stderr=subprocess.STDOUT)
    log.close()
    print(f"chip_smoke: phase {name} started in child {proc.pid}",
          flush=True)
    return {"name": name, "proc": proc, "out": out}


def _join_phase_child(handle: dict, entry: dict) -> float:
    """Wait for a :func:`_start_phase_child` child, print its output, add
    its launches to ``entry``; returns its own seconds. Fails when it
    failed or outlived ``PHASE_CHILD_TIMEOUT``."""
    name, proc, out = handle["name"], handle["proc"], handle["out"]
    try:
        proc.wait(timeout=PHASE_CHILD_TIMEOUT)
    except subprocess.TimeoutExpired:
        pass
    _reap(proc)
    with open(f"{out}.log") as f:
        log = f.read()
    print(f"chip_smoke: --- phase {name} (child {proc.pid}, exit "
          f"{proc.returncode}) ---\n{log.rstrip()}\n"
          f"chip_smoke: --- end of phase {name} ---", flush=True)
    if proc.returncode != 0 or not os.path.exists(f"{out}.json"):
        raise AssertionError(f"phase {name} (child): exit "
                             f"{proc.returncode}")
    with open(f"{out}.json") as f:
        res = json.load(f)
    for path in (f"{out}.log", f"{out}.json"):
        os.remove(path)
    entry["launches"] += res["launches"]
    return res["seconds"]


def _phase_child(argv) -> int:
    """``chip_smoke.py --phase-child <name> <out.json>``: one phase in
    this process, as main() sets the card up; writes its launches and
    seconds."""
    import torch
    name, out = argv
    _become_subreaper()
    sys.path.insert(0, REPO)
    from howtotrainyourmamlpytorch_tpu_torch.ops import build
    build.load("bn_act")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card_line()
    entry = {"launches": 0}
    t0 = time.perf_counter()
    try:
        _phase_children()[name](entry, card)
    finally:
        _reap_all()
    with open(out, "w") as f:
        json.dump({"launches": entry["launches"],
                   "seconds": round(time.perf_counter() - t0, 1)}, f)
    return 0


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
    _become_subreaper()
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
    results, children = {}, {}
    phases = {
        "serve": serve_flagship, "train": train_flagship,
        "cli": cli_flagship,
        "telemetry": lambda e, c: cli_telemetry(e, c, results["cli"]),
        "serving": lambda e, c: serving_plane(
            e, c, results["cli"]["saved_models"]),
        "data": data_path,
        "fleet": lambda e, c: fleet_harnesses(
            e, c, results["cli"]["saved_models"]),
        "mesh": lambda e, c: mesh_path(e, c, results["train"],
                                       results["cli"]),
        "pod": lambda e, c: pod_fault_domain(e, c, results["cli"])}
    try:
        for step, name in PHASE_SCHEDULE:
            t1 = time.perf_counter()
            if step == "start":
                children[name] = _start_phase_child(name)
                continue
            try:
                if step == "join":
                    seconds[f"{name} (beside)"] = _join_phase_child(
                        children.pop(name), entry)
                    seconds[f"{name} join wait"] = round(
                        time.perf_counter() - t1, 1)
                    continue
                results[name] = phases[name](entry, card)
            finally:
                if not children:
                    _reap_all()
            seconds[name] = round(time.perf_counter() - t1, 1)
    finally:
        _reap_all()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all, build "
          f"included; seconds per phase {json.dumps(seconds)}", flush=True)
    if not _no_leftovers():
        return 1

    print(card, flush=True)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [MESH_CHILD_FLAG]:
        sys.exit(_mesh_child(sys.argv[2:]))
    if sys.argv[1:2] == [PHASE_CHILD_FLAG]:
        sys.exit(_phase_child(sys.argv[2:]))
    sys.exit(main())
