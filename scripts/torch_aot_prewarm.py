"""Pre-launch prewarmer of the PyTorch/CUDA port: fill the warm-start
store before the job (the port's counterpart of
``scripts/aot_prewarm.py``, with its flags and its last-line contract).

    python scripts/torch_aot_prewarm.py \
        --config experiment_config/mini-imagenet_maml++_5-way_5-shot_DA_b12.json \
        [--store DIR] [--serve] [--key value ...]

On the card it builds the BN kernel into ``compilation_cache_dir`` (when
set), then captures every executable the run needs as a CUDA graph
(``parallel/aot.py``): one train step per (derivative-order, MSL) phase
key the epoch schedule visits, the eval step, and (``--serve``) each
serve bucket's adapt and predict. Each replay is held bitwise against
the eager step on seeded inputs (deterministic cuDNN), and its record is
written into the store under the run's fingerprint. A job started
afterwards with the same config and ``aot_store_dir`` captures every
executable from a record (a hit) and, with the same
``compilation_cache_dir``, runs no ``nvcc``. Re-running against a warm
store is idempotent (every executable a hit, nothing rewritten).

A mesh of several processes (``mesh_shape`` over more than one device,
one process each) is recorded for its world size: the rank-local pieces
of a rank's step (``meta/outer.py § TrainPieces``: the accumulation and
the update; its all-reduce runs eagerly between their graphs) are
captured here in one process, with no process group, and each replay is
held bitwise against the same pieces run eagerly, at every rank position
whose elastic pads differ (position 0 alone without pads).
``--degraded K``: also the N-1..N-K survivor rosters of an elastic pod,
each config derived as a resharded group derives it
(``parallel/mesh.py § derive_degraded_config``) and recorded under the
fingerprint of its survivor count (``--degraded-only``: those alone), so
a survivor group's first step after a reshard captures every graph from
a record.

Graphs need the card: with ``--device cpu`` (or no card) the script
exits 1 and its last line says so in ``status``.

Artifact contract: the LAST stdout line is ``{"metric": "aot_prewarm",
...}`` with per-executable dispositions (``hit``, ``compiled``,
``failed``; ``bitwise`` for the replay against the eager step); exit 0
iff every requested executable is in the store afterwards and every
replay was bitwise the eager step.

Trailing ``--key value`` pairs are config overrides with the port's
trainer CLI's coercion rules (``train_maml_system.get_args``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def _artifact(**kw) -> dict:
    """The last line, with every key of the JAX script's artifact."""
    doc = {"metric": "aot_prewarm", "value": 0, "unit": "executables",
           "ok": False, "status": None, "hits": 0, "misses": 0,
           "failures": 0, "seconds": 0.0, "store_dir": None,
           "fingerprint": None, "fingerprints": [],
           "xla_compiler_options": {}, "workload": None, "executables": [],
           "device": None, "nvcc_runs": 0, "kernel_cache_dir": None}
    doc.update(kw)
    return doc


def _seeded_episode(cfg, tasks: int, seed: int, device):
    """A batch of ``tasks`` seeded tasks in the loader's wire dtypes."""
    import numpy as np
    import torch

    from howtotrainyourmamlpytorch_tpu_torch.meta.inner import Episode
    rng = np.random.default_rng(seed)
    h, w, c = cfg.image_shape
    n = cfg.num_classes_per_set
    lbl = np.dtype(cfg.label_dtype)

    def images(rows):
        if cfg.transfer_images_uint8:
            return rng.integers(0, 256, (tasks, rows, h, w, c),
                                dtype=np.uint8)
        return rng.standard_normal((tasks, rows, h, w, c)).astype(
            np.float32)

    def labels(rows):
        if lbl.kind == "f":
            return rng.standard_normal((tasks, rows)).astype(lbl)
        return np.tile(np.arange(rows) % n, (tasks, 1)).astype(lbl)

    s, t = cfg.num_support_per_task, cfg.num_target_per_task
    return Episode(*(torch.from_numpy(a).to(device) for a in (
        images(s), labels(s), images(t), labels(t))))


def _bitwise(a, b) -> bool:
    import torch

    from howtotrainyourmamlpytorch_tpu_torch.parallel import aot
    la, sa = aot.flatten(a)
    lb, sb = aot.flatten(b)
    return (aot._structure(sa) == aot._structure(sb)
            and len(la) == len(lb)
            and all(x.shape == y.shape and x.dtype == y.dtype
                    and torch.equal(x, y) for x, y in zip(la, lb)))


def roster_config(cfg, survivors: int = 0):
    """``(config, world size)`` of one roster of ``cfg``'s pod, as its
    builder resolves them: the full roster (``survivors`` 0) on the
    mesh's processes, or a survivor roster derived as a resharded group
    derives it (``derive_degraded_config``); ``task_microbatches``
    resolved at that geometry."""
    import numpy as np

    from howtotrainyourmamlpytorch_tpu_torch.parallel.mesh import (
        derive_degraded_config)
    if survivors:
        cfg = derive_degraded_config(cfg, survivors, int(cfg.mesh_shape[0]))
    world = int(np.prod(cfg.mesh_shape))
    return (cfg.replace(task_microbatches=cfg.effective_task_microbatches(
        world)), world)


def prewarm(cfg, serve: bool, degraded: int, degraded_only: bool,
            log=print) -> dict:
    """Every executable of ``cfg``'s run (and of ``degraded`` survivor
    rosters) into its store, on the card; returns the artifact."""
    import numpy as np
    import torch

    from howtotrainyourmamlpytorch_tpu_torch.device import numerics_policy
    from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
        init_train_state)
    from howtotrainyourmamlpytorch_tpu_torch.models import make_model
    from howtotrainyourmamlpytorch_tpu_torch.ops import build
    from howtotrainyourmamlpytorch_tpu_torch.parallel import aot
    from howtotrainyourmamlpytorch_tpu_torch.parallel.mesh import (
        Mesh, make_sharded_steps)
    from howtotrainyourmamlpytorch_tpu_torch.serve.adapt import (
        adapt_task, predict_tasks)

    t_start = time.perf_counter()
    device = torch.device("cuda")
    if cfg.compilation_cache_dir:
        build.set_cache_dir(cfg.compilation_cache_dir)
    nvcc_before = build.nvcc_runs
    build.load("bn_act")
    executables, stores = [], []
    counts = {"hits": 0, "misses": 0, "failures": 0}

    def prewarm_topology(tcfg, world: int, label: str, serve: bool):
        """Every executable one (config, roster) pair needs, into that
        pair's fingerprint directory of the store root."""
        model_init, apply = make_model(tcfg)
        state = init_train_state(tcfg, model_init, seed=tcfg.seed,
                                 device=device)
        store = aot.AOTStore.from_config(tcfg, device, world_size=world)
        stores.append(store)

        def warm_one(name, capture, sig, check, rank):
            """Capture ``name`` through the store, hold one replay against
            the eager step (``check(executable) -> bool``), record it."""
            t0 = time.perf_counter()
            fn, hit = aot.load_or_compile(store, name, capture, sig)
            compiled = getattr(fn, "compiled", None)
            bitwise = bool(compiled is not None and check(compiled))
            rec = store.manifest.get(name)
            ready = rec is not None and rec.get("status") == "committed"
            counts["hits" if hit else "misses"] += 1
            if not (ready and bitwise):
                counts["failures"] += 1
            executables.append({
                "name": f"{label}:{name}" if label else name,
                "disposition": ("hit" if hit and ready else
                                "compiled" if ready else "failed"),
                "bitwise": bitwise, "rank": rank, "world": world,
                "launches": getattr(compiled, "launches", None),
                "seconds": round(time.perf_counter() - t0, 3)})
            log(json.dumps(executables[-1]))

        keys, first_epoch = [], {}
        for e in range(tcfg.total_epochs):
            key = (tcfg.use_second_order(e), tcfg.use_msl(e))
            if key not in first_epoch:
                first_epoch[key] = e
                keys.append(key)
        train_rows = tcfg.padded_batch_size // world
        eval_rows = tcfg.effective_eval_batch_size // world
        # A rank's graphs differ by position only through its pads.
        for rank in (range(world) if tcfg.elastic_pad_tasks else [0]):
            plan = make_sharded_steps(tcfg, apply, Mesh(
                shape=tuple(tcfg.mesh_shape),
                axis_names=tuple(tcfg.mesh_axis_names), rank=rank,
                world=world))
            for i, key in enumerate(keys):
                epoch = first_epoch[key]
                batch = _seeded_episode(tcfg, train_rows, tcfg.seed + i,
                                        device)
                zero = aot.zero_episode(tcfg, train_rows, device)

                def check(graph, key=key, epoch=epoch, batch=batch,
                          plan=plan):
                    so, msl = key
                    want = plan.train_step(state, batch, epoch,
                                           second_order=so, use_msl=msl)
                    got = graph(state, batch, epoch, second_order=so,
                                use_msl=msl)
                    return (_bitwise(want[0], got[0])
                            and _bitwise(tuple(want[1][:3]),
                                         tuple(got[1][:3])))

                warm_one(aot.train_exec_name(key),
                         lambda key=key, epoch=epoch, zero=zero, plan=plan:
                         aot.TrainGraph(tcfg, plan.train_step, key, state,
                                        zero, epoch),
                         aot.signature_of(state, zero), check, rank)
            batch = _seeded_episode(tcfg, eval_rows, tcfg.seed + 100,
                                    device)
            zero = aot.zero_episode(tcfg, eval_rows, device)
            warm_one("eval",
                     lambda plan=plan: aot.EvalGraph(plan.eval_step, state,
                                                     zero),
                     aot.EvalGraph.signature(state, zero),
                     lambda g, plan=plan: _bitwise(
                         tuple(plan.eval_step(state, batch)),
                         tuple(g(state, batch))), rank)
        if serve:
            steps = tcfg.effective_serve_adapt_steps

            def adapt_body(*args):
                return adapt_task(tcfg, apply, *args, num_steps=steps)

            def predict_body(*args):
                return predict_tasks(tcfg, apply, *args, num_steps=steps)

            done_s, done_q = set(), set()
            rng = np.random.default_rng(tcfg.seed)
            for s_b, q_b in tcfg.serve_bucket_shapes:
                for rows, done, name, make_args, body in (
                        (s_b, done_s, aot.serve_adapt_name(s_b),
                         aot.serve_adapt_args, adapt_body),
                        (q_b, done_q, aot.serve_predict_name(q_b),
                         aot.serve_predict_args, predict_body)):
                    if rows in done:
                        continue
                    done.add(rows)
                    args = make_args(tcfg, state, rows, device)
                    # Seeded inputs of the same signature.
                    seeded = tuple(
                        a if not isinstance(a, torch.Tensor) else (
                            torch.from_numpy(rng.integers(
                                0, 256 if a.dtype == torch.uint8
                                else tcfg.num_classes_per_set,
                                tuple(a.shape))).to(a.dtype).to(device)
                            if a.dtype in (torch.uint8, torch.long)
                            else a)
                        for a in args)
                    warm_one(name,
                             lambda name=name, body=body, args=args:
                             aot.GraphExec(name, body, args),
                             aot.signature_of(*args),
                             lambda g, body=body, seeded=seeded:
                             _bitwise(body(*seeded), g(*seeded)), 0)
        del state
        torch.cuda.empty_cache()

    with numerics_policy(cfg.compute_dtype, deterministic=True,
                         options=cfg.xla_compiler_options_dict):
        if not degraded_only:
            prewarm_topology(*roster_config(cfg), label="", serve=serve)
        # Degraded survivor rosters (elastic pod): each N-k roster's
        # config derived as its resharded group derives it, stamped with
        # the survivor count, so the reshard finds this directory.
        orig = int(cfg.mesh_shape[0])
        for k in range(1, max(degraded, 0) + 1):
            survivors = orig - k
            if survivors < 1:
                break
            prewarm_topology(*roster_config(cfg, survivors),
                             label=f"degraded{survivors}", serve=False)
    ok = counts["failures"] == 0 and bool(executables)
    return _artifact(
        value=len(executables) - counts["failures"], ok=ok,
        status="ok" if ok else "failed", **counts,
        seconds=round(time.perf_counter() - t_start, 3),
        store_dir=stores[-1].dir if stores else None,
        fingerprint=stores[-1].fingerprint if stores else None,
        fingerprints=[st.fingerprint for st in stores],
        xla_compiler_options=cfg.xla_compiler_options_dict,
        workload=cfg.experiment_name, executables=executables,
        device=torch.cuda.get_device_name(device),
        nvcc_runs=build.nvcc_runs - nvcc_before,
        kernel_cache_dir=build.cache_dir())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="capture every executable a run needs as a CUDA graph "
                    "and record it in its warm-start store "
                    "(parallel/aot.py)")
    ap.add_argument("--config", required=True,
                    help="experiment_config/*.json to prewarm for")
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="store directory (default: the config's "
                         "aot_store_dir; required via one of the two)")
    ap.add_argument("--serve", action="store_true",
                    help="also prewarm the serve buckets' adapt/predict "
                         "executables (ServingEngine.warmup's set)")
    ap.add_argument("--degraded", type=int, default=0, metavar="K",
                    help="also prewarm the N-1..N-K survivor rosters of "
                         "an elastic pod (the config derived as a "
                         "resharded group derives it, stamped with its "
                         "survivor count)")
    ap.add_argument("--degraded-only", action="store_true",
                    help="skip the full-roster executables")
    ap.add_argument("--backend-timeout", type=float, default=600.0,
                    help="accepted for the JAX script's command line; a "
                         "CUDA card is local (no backend to wait for)")
    ap.add_argument("--device", default="cuda",
                    help="the card (default); anything else is refused, "
                         "since graphs need the card")
    try:
        args, overrides = ap.parse_known_args(argv)
    except SystemExit:
        print(json.dumps(_artifact(status="failed",
                                   error="invalid command line")))
        return 1

    from howtotrainyourmamlpytorch_tpu_torch.train_maml_system import (
        get_args)
    try:
        cfg = get_args(["--name_of_args_json_file", args.config]
                       + overrides)
    except (SystemExit, OSError, ValueError) as e:
        print(json.dumps(_artifact(status="failed",
                                   error=f"invalid config/override: {e}")))
        return 1
    if args.store:
        cfg = cfg.replace(aot_store_dir=args.store)
    if not cfg.aot_store_dir:
        print(json.dumps(_artifact(
            status="failed", workload=cfg.experiment_name,
            error="no store: set --store or the config's aot_store_dir")))
        return 1
    import torch
    if args.device != "cuda" or not torch.cuda.is_available():
        why = (f"device {args.device!r}" if args.device != "cuda"
               else "no CUDA device is available")
        print(json.dumps(_artifact(
            status=f"needs the card: the executables are CUDA graphs "
                   f"({why})", workload=cfg.experiment_name,
            device=args.device)))
        return 1
    artifact = prewarm(cfg, args.serve, args.degraded, args.degraded_only)
    print(json.dumps(artifact), flush=True)
    return 0 if artifact["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
