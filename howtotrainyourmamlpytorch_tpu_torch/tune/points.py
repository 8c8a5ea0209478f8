"""The measurement core of the port's perf sweeps (``scripts/torch_perf_*.py``)
and of ``scripts/torch_bf16_drift.py``: the flagship config, a grid's
points, and each point timed twice.

A point is one config and the step it times. Each is timed in two legs:

* ``eager``, the step as the trainer runs it by default;
* ``graph``, the same step through the CUDA graph of its phase key
  (``aot_store_dir`` on a fresh temporary directory, as the trainer arms
  it; ``parallel/aot.py § TrainGraph``, ``EvalGraph`` for an eval sweep):
  the counterpart of the compiled executable the JAX sweeps time. The
  eager flagship step is bound by the host, so an eager leg alone would
  rank configs by their Python overhead.

A train leg is :func:`tune.trial.run` (two warm-ups, then the timed
steps in up to three windows, each closed by a loss fetch; the median
window). An eval leg is :func:`time_eval_sweep`. A row carries the JAX
script's keys from the eager leg under the same names, the eager leg's
``step_ms``, ``bn_launches``, ``peak_memory_bytes`` (the peak of
``torch.cuda.max_memory_allocated`` since the leg began) and
``device_kind``, and a ``graph`` object with the same keys for the graph
leg (plus ``graph_memory``, the captured pool), or ``{"ran": false,
"reason": ...}`` where ``aot.require_card`` refused it (the CPU).

A point that fails (out of memory, a non-finite loss, a capture that
failed) prints ``{<point keys>, "error": "<first 200 chars>"}`` and the
sweep goes on, after the card's memory is freed; where only the graph
leg failed, the row keeps the eager leg's keys and its ``graph`` holds
the error. On the card a
batch-norm point runs the hand-written BN kernel (``bn_backend``
'pallas', :func:`on_device`) and a leg that launched it no time raises.
"""

from __future__ import annotations

import gc
import json
import math
import os
import statistics
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.tune import trial

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIGS = os.path.join(REPO, "experiment_config")
FLAGSHIP_JSON = os.path.join(
    CONFIGS, "mini-imagenet_maml++_5-way_5-shot_DA_b12.json")
POD_JSON = os.path.join(
    CONFIGS, "tiered-imagenet_maml++_5-way_5-shot_resnet12_pod.json")
# Keys of a leg's measurement carried into a row (and its graph object).
LEG_KEYS = ("step_ms", "bn_launches", "peak_memory_bytes", "mfu",
            "device_kind")
ERROR_CHARS = 200


def flagship_config(batch_size: int, n_devices: int) -> MAMLConfig:
    """The flagship bench workload (``bench.py § flagship_config``)."""
    return MAMLConfig(
        experiment_name="bench_flagship",
        dataset_name="mini_imagenet_full_size",
        image_height=84, image_width=84, image_channels=3,
        num_classes_per_set=5, num_samples_per_class=5,
        num_target_samples=3,
        batch_size=batch_size,
        cnn_num_filters=48, num_stages=4,
        number_of_training_steps_per_iter=5,
        number_of_evaluation_steps_per_iter=5,
        second_order=True,
        use_multi_step_loss_optimization=True,
        learnable_per_layer_per_step_inner_loop_learning_rate=True,
        per_step_bn_statistics=True,
        mesh_shape=(1, n_devices),
        remat_policy="block_outs",
        bn_fast_math=True,
    )


def on_device(cfg: MAMLConfig, device, quick: bool = False) -> MAMLConfig:
    """A grid's config as a point runs it: the hand-written BN kernel on
    the card for a batch-norm config, tiny shapes with ``quick``."""
    if quick:
        cfg = trial.quick_shrink(cfg, 1)
    if device.type == "cuda" and cfg.norm_layer == "batch_norm":
        cfg = cfg.replace(bn_backend="pallas")
    return cfg


def select(grid: Sequence[Dict[str, Any]], names: str
           ) -> List[Dict[str, Any]]:
    """The points of ``grid`` named in the comma list ``names`` (all
    when empty), in grid order; an unknown name raises."""
    wanted = [n.strip() for n in names.split(",") if n.strip()]
    known = [p["point"] for p in grid]
    unknown = sorted(set(wanted) - set(known))
    if unknown:
        raise ValueError(f"unknown points {unknown}; the grid has {known}")
    return [p for p in grid if not wanted or p["point"] in wanted]


def _leg(measured: Dict[str, Any], rate_key: str, rate: float
         ) -> Dict[str, Any]:
    out = {rate_key: round(rate, 3)}
    out.update({k: measured.get(k) for k in LEG_KEYS})
    if measured.get("graph_memory") is not None:
        out["graph_memory"] = measured["graph_memory"]
    return out


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def graph_leg(cfg: MAMLConfig, device, timed: Callable[[MAMLConfig], Any]
              ) -> Any:
    """``timed(cfg)`` with ``aot_store_dir`` on a fresh temporary
    directory, or ``{"ran": False, "reason": ...}`` where
    ``aot.require_card`` refuses the graph (not on the card)."""
    from howtotrainyourmamlpytorch_tpu_torch.parallel import aot
    with tempfile.TemporaryDirectory(prefix="points_aot_") as store:
        armed = cfg.replace(aot_store_dir=store)
        try:
            aot.require_card(armed, device)
        except ValueError as e:
            return {"ran": False, "reason": str(e)}
        return timed(armed)


def time_train(cfg: MAMLConfig, device, steps: int, *, epoch=None,
               phase_key=None) -> Dict[str, Any]:
    """One train leg (:func:`tune.trial.run`; FLOPs counted in the eager
    leg only); ``tasks_per_sec_per_chip`` is its ``value``, ``warmup_s``
    the seconds before its timed windows."""
    m = trial.run(cfg, device, steps, epoch=epoch, phase_key=phase_key,
                  count=not cfg.aot_store_dir)
    leg = _leg(m, "tasks_per_sec_per_chip", m["value"])
    leg["warmup_s"] = round(m["warmup_s"], 1)
    return leg


def eval_batches(cfg: MAMLConfig, eval_batch: int, episodes: int
                 ) -> List[Any]:
    """ceil(episodes / eval_batch) host batches of ``eval_batch`` tasks,
    seeds 0.. (``perf_eval.py § sweep_time``)."""
    cfg = cfg.replace(batch_size=eval_batch)
    return [trial.synthetic_batch(cfg, s)
            for s in range(-(-episodes // eval_batch))]


def time_eval_sweep(cfg: MAMLConfig, device, eval_batch: int,
                    episodes: int, repeats: int = 3) -> Dict[str, Any]:
    """One eval leg: a sweep over :func:`eval_batches`, resident on the
    device, after one warm-up batch; ``sweep_seconds`` is the median of
    ``repeats`` sweeps, each closed by a fetch of the mean accuracy.
    Under ``aot_store_dir`` the step is the ``EvalGraph``."""
    import torch

    from howtotrainyourmamlpytorch_tpu_torch.device import numerics_policy
    from howtotrainyourmamlpytorch_tpu_torch.meta.inner import Episode
    from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
        init_train_state, make_eval_step)
    from howtotrainyourmamlpytorch_tpu_torch.models import make_model
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.parallel import aot
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import profiler

    cfg = cfg.replace(eval_batch_size=eval_batch)
    aot.require_card(cfg, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with numerics_policy(cfg.compute_dtype, deterministic=True,
                         options=cfg.xla_compiler_options_dict):
        init, apply = make_model(cfg)
        state = init_train_state(cfg, init, seed=0, device=device)
        batches = [Episode(*(torch.from_numpy(a).to(device) for a in b))
                   for b in eval_batches(cfg, eval_batch, episodes)]
        step = eager = make_eval_step(cfg, apply)
        before = bn_act.launches
        graph = None
        if aot.enabled(cfg):
            store = aot.AOTStore.from_config(cfg, device)
            step, _ = aot.load_or_compile(
                store, "eval", lambda: aot.EvalGraph(eager, state,
                                                     batches[0]),
                aot.EvalGraph.signature(state, batches[0]), fallback=eager)
            if not isinstance(step, aot.GuardedExec):
                raise RuntimeError("the eval step's CUDA graph was not "
                                   "captured (see the warning)")
            graph = step.compiled
        float(step(state, batches[0]).loss.mean())
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = [step(state, b) for b in batches]
            acc = float(torch.cat([r.accuracy for r in out]).mean())
            times.append(time.perf_counter() - t0)
            if not math.isfinite(acc):
                raise FloatingPointError(f"non-finite accuracy {acc}")
        if graph is not None and step.compiled is None:
            raise RuntimeError("the eval step's CUDA graph rejected a batch")
        launches = bn_act.launches - before
    if (device.type == "cuda" and cfg.norm_layer == "batch_norm"
            and launches == 0):
        raise RuntimeError("the eval sweep launched the BN kernel no time")
    seconds = statistics.median(times)
    measured = {"step_ms": seconds / len(batches) * 1e3,
                "bn_launches": launches,
                "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                      if device.type == "cuda" else None),
                "mfu": None, "device_kind": profiler.device_kind(device),
                "graph_memory": (graph.exec.memory if graph is not None
                                 else None)}
    return _leg(measured, "sweep_seconds", seconds)


def run_point(point: Dict[str, Any], device,
              timed: Callable[[MAMLConfig], Dict[str, Any]],
              finish: Optional[Callable[[Dict[str, Any]], None]] = None
              ) -> Dict[str, Any]:
    """Both legs of one point (``point["cfg"]`` through ``timed``) as its
    row, completed by ``finish`` and printed; a failure of either leg is
    the row's ``error``. The card's memory is freed after each leg."""
    keys = {k: v for k, v in point.items() if k != "cfg"}
    try:
        row = {**keys, **timed(point["cfg"])}
    except Exception as e:  # noqa: BLE001 — a failing point is a row
        row = {**keys, "error": _error(e)}
    else:
        _free(device)
        try:
            row["graph"] = graph_leg(point["cfg"], device, timed)
            if finish is not None:
                finish(row)
        except Exception as e:  # noqa: BLE001 — the eager leg stays
            row["graph"] = {"error": _error(e)}
            row["error"] = f"graph leg: {row['graph']['error']}"
    _free(device)
    print(json.dumps(row), flush=True)
    return row


def _error(e: BaseException) -> str:
    traceback.print_exc()
    return f"{type(e).__name__}: {e}"[:ERROR_CHARS]


def graph_ran(row: Dict[str, Any]) -> bool:
    """Whether a row's graph leg ran to its end."""
    graph = row.get("graph", {})
    return "error" not in graph and graph.get("ran", True)


def add_common_args(ap, steps: Optional[int]) -> None:
    """``--steps`` (unless None: an eval sweep), ``--quick``,
    ``--device``, ``--points``."""
    if steps is not None:
        ap.add_argument("--steps", type=int, default=steps,
                        help="timed steps per leg, in up to 3 windows")
    ap.add_argument("--quick", action="store_true",
                    help="tiny shapes (trial.quick_shrink): CPU runs")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU (default: the card)")
    ap.add_argument("--points", default="",
                    help="comma list of point names to run (default: "
                         "the whole grid)")
