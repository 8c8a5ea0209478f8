"""The autotune trial leg of the port: the steady-state train step of one
config, timed (the port's counterpart of the ``bench.py`` headline leg
that the JAX package's harness spawns).

    python -m howtotrainyourmamlpytorch_tpu_torch.tune.trial \\
        --config <cfg.json> [--steps N] [--quick] [--device cpu] \\
        [--backend-option KEY=VAL ...] [--tuned TUNED.json]

The config is reshaped as ``bench.py`` reshapes a workload for one
device (batch = the file's batch over its mesh size, ``task_microbatches``
clamped to it; ``--quick`` shrinks it to tiny shapes with
:func:`quick_shrink`). The timed step is the schedule's last epoch's, as
``bench.py`` times it: second order, past the MSL window. The backend
options (``--backend-option``, or an adopted ``--tuned`` record's, with
its structural overrides) ride the config's ``xla_compiler_options`` key
and are applied by ``device.numerics_policy`` before the first step: an
unknown one raises with ``device.NO_SUCH_OPTION``. With ``aot_store_dir``
set the step runs as the CUDA graph of its phase key
(``parallel/aot.py``), captured or loaded before the warm-up.

Two warm-up steps come first, the first of them counted by
``FlopCounterMode``; then ``--steps`` timed steps in up to three windows,
each closed by a loss fetch (the median window's rate is the value).
:func:`run` also times another epoch or phase key (the perf sweeps'
points, ``tune/points.py``); a graph that was not captured, or that
rejected the step's arguments, raises rather than timing the eager step
under its name.

The last stdout line is the JAX contract's artifact,
``{"metric": "meta_tasks_per_sec_per_chip", "value": ..., "mfu": ...,
...}`` (``mfu`` null without a known peak, e.g. on the CPU), plus
``bn_launches``: the BN kernel's launches of the whole leg. On the card
a batch-norm config must run the hand-written kernel
(``bn_backend='pallas'``), and a leg that launched it no time raises.
With no card the leg raises unless ``--device cpu`` is given. Any
failure prints ``{"metric": ..., "error": ...}`` last and exits 1.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time
import traceback
from typing import Any, Dict, Tuple

import numpy as np

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.tune.record import read_tuned
from howtotrainyourmamlpytorch_tpu_torch.tune.space import (
    parse_compiler_options)

METRIC = "meta_tasks_per_sec_per_chip"
# Timed windows (``bench.py § measure_rate``): the median of up to three,
# after this many untimed steps (the first counts FLOPs).
WINDOWS = 3
WARMUP = 2


def synthetic_batch(cfg: MAMLConfig, seed: int):
    """A host episode batch from a numpy seed, in the loader's wire
    dtypes (raw uint8 pixels by default), as ``bench.py`` makes it."""
    from howtotrainyourmamlpytorch_tpu_torch.meta.inner import Episode
    rng = np.random.RandomState(seed)
    n, k, t, b = (cfg.num_classes_per_set, cfg.num_samples_per_class,
                  cfg.num_target_samples, cfg.batch_size)
    h, w, c = cfg.image_shape
    if cfg.transfer_images_uint8:
        sx = rng.randint(0, 256, (b, n * k, h, w, c)).astype(np.uint8)
        tx = rng.randint(0, 256, (b, n * t, h, w, c)).astype(np.uint8)
    else:
        sx = rng.randn(b, n * k, h, w, c).astype(np.float32)
        tx = rng.randn(b, n * t, h, w, c).astype(np.float32)
    sy = np.tile(np.repeat(np.arange(n), k)[None], (b, 1)).astype(np.int32)
    ty = np.tile(np.repeat(np.arange(n), t)[None], (b, 1)).astype(np.int32)
    return Episode(sx, sy, tx, ty)


def load_workload(config_path: str, n_dev: int = 1) -> MAMLConfig:
    """A config reshaped for ``n_dev`` devices: per-device batch = the
    file's batch over its mesh size, ``task_microbatches`` clamped."""
    base = MAMLConfig.from_json_file(config_path)
    per_chip = max(base.batch_size // max(math.prod(base.mesh_shape), 1),
                   1)
    cfg = base.replace(batch_size=per_chip * n_dev, mesh_shape=(1, n_dev))
    return cfg.replace(
        task_microbatches=cfg.effective_task_microbatches(n_dev))


def quick_shrink(cfg: MAMLConfig, n_dev: int) -> MAMLConfig:
    """Tiny shapes for CPU runs and plumbing proofs (``bench.py §
    quick_shrink``): the parity gate probes the same geometry."""
    quick_batch = max(2 * n_dev, 2)
    cfg = cfg.replace(
        image_height=16, image_width=16,
        cnn_num_filters=8, num_stages=2,
        batch_size=quick_batch)
    return cfg.replace(
        task_microbatches=cfg.effective_task_microbatches(n_dev))


def read_tuned_record(tuned_path: str) -> Tuple[Dict[str, str],
                                                Dict[str, Any]]:
    """(backend options, config overrides) of an adopted autotune record;
    raises ValueError on a rejected or malformed one."""
    doc = read_tuned(tuned_path)
    opts = doc.get("xla_compiler_options") or {}
    overrides = doc.get("config_overrides") or {}
    if not isinstance(opts, dict) or not isinstance(overrides, dict):
        raise ValueError(
            f"--tuned {tuned_path!r}: xla_compiler_options / "
            f"config_overrides are not mappings")
    return {str(k): str(v) for k, v in opts.items()}, dict(overrides)


def apply_tuned_overrides(cfg: MAMLConfig, overrides: Dict[str, Any],
                          n_dev: int) -> MAMLConfig:
    """Adopted structural overrides on a workload, ``task_microbatches``
    re-clamped at this geometry; an unknown key raises."""
    if not overrides:
        return cfg
    try:
        cfg = cfg.replace(**overrides)
    except TypeError as e:
        raise ValueError(f"--tuned config_overrides: {e}") from None
    return cfg.replace(
        task_microbatches=cfg.effective_task_microbatches(n_dev))


def run(cfg: MAMLConfig, device, steps: int, *, epoch=None,
        phase_key=None, count: bool = True) -> Dict[str, Any]:
    """Warm up, count one step's FLOPs (unless ``count`` is False), time
    ``steps`` steps; the artifact's measured keys. ``epoch`` defaults to
    the schedule's last, ``phase_key`` (``(second_order, use_msl)``) to
    that epoch's."""
    import torch

    from howtotrainyourmamlpytorch_tpu_torch.device import (
        numerics_policy, resume_is_bitwise)
    from howtotrainyourmamlpytorch_tpu_torch.meta.inner import Episode
    from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
        init_train_state, make_train_step)
    from howtotrainyourmamlpytorch_tpu_torch.models import make_model
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.parallel import aot
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import profiler

    if (device.type == "cuda" and cfg.norm_layer == "batch_norm"
            and cfg.bn_backend != "pallas"):
        raise ValueError(
            "on the card the trial leg times the hand-written BN kernel: "
            "set bn_backend='pallas' in the config")
    aot.require_card(cfg, device)
    if epoch is None:
        epoch = max(cfg.total_epochs - 1, 0)
    so, msl = phase_key or (cfg.use_second_order(epoch), cfg.use_msl(epoch))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_start = time.perf_counter()
    with numerics_policy(cfg.compute_dtype, deterministic=True,
                         options=cfg.xla_compiler_options_dict):
        init, apply = make_model(cfg)
        state = init_train_state(cfg, init, seed=0, device=device)
        batch = Episode(*(torch.from_numpy(a).to(device)
                          for a in synthetic_batch(cfg, 0)))
        eager = make_train_step(cfg, apply)
        bn_act.reset_launches()
        # The first warm-up step is eager and counted (a graph replay
        # runs no torch op to count).
        first = lambda: eager(state, batch, epoch, second_order=so,
                              use_msl=msl)
        (state, m), flops = (profiler.count_flops(first) if count
                             else (first(), 0.0))
        step, aot_hits, graph = eager, None, None
        if aot.enabled(cfg):
            store = aot.AOTStore.from_config(cfg, device)
            zero = aot.zero_episode(cfg, cfg.padded_batch_size, device)
            step, hit = aot.load_or_compile(
                store, aot.train_exec_name((so, msl)),
                lambda: aot.TrainGraph(cfg, eager, (so, msl), state, zero,
                                       epoch),
                aot.signature_of(state, zero), fallback=eager)
            if not isinstance(step, aot.GuardedExec):
                raise RuntimeError(f"the CUDA graph of phase {(so, msl)} "
                                   f"was not captured (see the warning)")
            aot_hits, graph = int(hit), step.compiled
        loss = float(m.loss)
        for _ in range(WARMUP - 1):
            state, m = step(state, batch, epoch, second_order=so,
                            use_msl=msl)
            loss = float(m.loss)
        windows = min(WINDOWS, max(steps, 1))
        per_window = max(1, steps // windows)
        warmup_s = time.perf_counter() - t_start
        seconds = []
        for _ in range(windows):
            t0 = time.perf_counter()
            for _ in range(per_window):
                state, m = step(state, batch, epoch, second_order=so,
                                use_msl=msl)
            loss = float(m.loss)   # a fetch: the window's work is done
            seconds.append(time.perf_counter() - t0)
            if not math.isfinite(loss):
                raise FloatingPointError(f"non-finite loss {loss}")
        launches = bn_act.launches
        if graph is not None and step.compiled is None:
            raise RuntimeError(f"the CUDA graph of phase {(so, msl)} "
                               f"rejected the step's arguments")
    if (device.type == "cuda" and cfg.norm_layer == "batch_norm"
            and launches == 0):
        raise RuntimeError("the trial launched the BN kernel no time")
    step_s = statistics.median(seconds) / per_window
    kind = profiler.device_kind(device)
    peaks = profiler.resolve_peaks(kind)
    mfu = (flops / step_s / peaks["peak_flops"]
           if flops and peaks["peak_flops"] > 0 else None)
    return {"value": cfg.batch_size / step_s, "mfu": mfu,
            "flops_per_task": flops / cfg.batch_size if count else None,
            "peak_flops_source": peaks["source"], "device_kind": kind,
            "step_ms": step_s * 1e3, "steps": windows * per_window,
            "warmup_s": warmup_s,
            "bn_launches": launches, "aot_hits": aot_hits, "loss": loss,
            "epoch": epoch, "second_order": so, "use_msl": msl,
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else None),
            "graph_memory": graph.exec.memory if graph is not None else None,
            "bitwise_resume": resume_is_bitwise(
                cfg.xla_compiler_options_dict)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="autotune trial leg: time one config's steady-state "
                    "train step (last line: the artifact)")
    ap.add_argument("--config", required=True, help="the trial's JSON")
    ap.add_argument("--steps", type=int, default=3,
                    help="timed steps, in up to 3 windows")
    ap.add_argument("--quick", action="store_true",
                    help="tiny shapes (CPU runs, plumbing proofs)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU (default: the card)")
    ap.add_argument("--backend-option", action="append", default=[],
                    metavar="KEY=VAL",
                    help="a backend option (repeatable), carried by the "
                         "config's xla_compiler_options key")
    ap.add_argument("--tuned", default=None, metavar="TUNED.json",
                    help="apply an adopted autotune record's options and "
                         "overrides (exclusive with --backend-option)")
    args = ap.parse_args(argv)
    try:
        options = parse_compiler_options(args.backend_option)
        if options and args.tuned:
            raise ValueError("--backend-option and --tuned are mutually "
                             "exclusive")
        from howtotrainyourmamlpytorch_tpu_torch.device import (
            resolve_device)
        device = resolve_device(args.device)
        cfg = load_workload(args.config)
        if args.tuned:
            options, overrides = read_tuned_record(args.tuned)
            cfg = apply_tuned_overrides(cfg, overrides, 1)
        if args.quick:
            cfg = quick_shrink(cfg, 1)
        cfg = cfg.replace(xla_compiler_options=tuple(
            f"{k}={v}" for k, v in sorted(options.items())))
        measured = run(cfg, device, args.steps)
    except Exception as e:  # noqa: BLE001 — the harness reads the line
        traceback.print_exc()
        print(json.dumps({"metric": METRIC,
                          "error": f"{type(e).__name__}: {e}"}), flush=True)
        return 1
    print(json.dumps({"metric": METRIC, "unit": "tasks/s/chip",
                      **measured, "workload": cfg.experiment_name,
                      "batch_size": cfg.batch_size,
                      "backend_options": options,
                      "device": str(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
