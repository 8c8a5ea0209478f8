"""Autotune driver of the PyTorch/CUDA port: a crash-isolated sweep of
backend options and structural knobs with parity-gated winner adoption
(the port's counterpart of ``scripts/autotune.py``).

    python scripts/torch_autotune.py \
        --config <cfg.json> --out <sweep dir> [--space SPACE.json] \
        [--platform cuda|cpu] [--quick] [--accuracy-gate run|skip] \
        [--prove-warm-train]

1. **Enumerate** the search space (``tune/space.py``): backend-option
   axes (``kind: "xla"``, the cuDNN switches of
   ``device.BACKEND_OPTIONS``) x structural config axes, validity-pruned,
   baseline first.
2. **Sweep**: every trial is a process group of its own running the
   trial leg (``tune/trial.py``, through ``tune/harness.py``): an
   unknown option, a crash, a time-out or an out-of-memory is a counted
   outcome (``invalid_flag``/``crashed``/``timeout``/``oom``/``error``),
   never the sweep's end. The ledger (``TUNE.json``) is rewritten around
   every trial: a re-run against the same ``--out`` repeats no finished
   trial.
3. **Gate**: the best point must beat the baseline, pass the parity
   probe against the untuned program (``scripts/torch_tune_parity.py``)
   and pass ``scripts/torch_accuracy_gate.py``, or the sweep records
   ``adopted: false`` with the refusing gate. ``--accuracy-gate skip``
   is recorded in the verdict.
4. **Adopt**: the winner is written as ``TUNED.json`` (its
   ``xla_compiler_options`` and structural overrides; the trial leg
   applies one with ``--tuned``), with ``bitwise_resume: false`` when
   its options give up the trainer's bitwise resume
   (``cudnn_deterministic=false`` or ``cudnn_benchmark=true``; the
   trainer's ``warm_start`` row says the same). ``--prove-warm-train`` then prewarms
   the tuned store at tiny shapes (``scripts/torch_aot_prewarm.py``),
   launches the port's trainer CLI on it with ``compilation_cache_dir``
   and requires its ``warm_start`` row to read
   ``compiles_before_first_step == 0`` under the prewarmed fingerprint
   (on the card: graphs need it).

``--platform`` picks the default space's axes and where the children
run: ``cuda`` (the card, the default) or ``cpu`` (``--device cpu``).
Trial rows and the ``tune/*`` counters go to ``<out>/logs/events.jsonl``
(the port's ``telemetry/report.py`` tune section reads them).

The LAST stdout line is ``{"metric": "autotune", ...}``. Exit 0 iff the
sweep reached a verdict (a rejected winner included).

The driver imports neither jax nor torch: ``tune/*`` is stdlib only and
the telemetry registry is loaded by file path. The artifact's
``jax_free`` and ``torch_free`` keys say so per run.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import math
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from howtotrainyourmamlpytorch_tpu_torch.tune import (  # noqa: E402
    harness, record, space)
from howtotrainyourmamlpytorch_tpu_torch.utils import reaper  # noqa: E402
from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import (  # noqa: E402
    JsonlLogger)


def _load_module(name: str, relpath: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# Through the package its __init__ would import torch.
_registry = _load_module(
    "_torch_tune_registry",
    "howtotrainyourmamlpytorch_tpu_torch/telemetry/registry.py")

TRIALS_RUN = "tune/trials_run"
TRIALS_FAILED = "tune/trials_failed"
TRIALS_RESUMED = "tune/trials_resumed"
INVALID_FLAG = "tune/invalid_flag_failures"
# Seconds each leg of the warm-train proof may take.
PROOF_TIMEOUT_S = 900.0


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def build_proof_config(base: dict, tuned: dict, out_dir: str) -> str:
    """The warm-train proof's workload: the winner's knobs at tiny
    shapes and a 2-iteration schedule, with its store, kernel cache and
    experiment inside the sweep dir. The proof is about the plumbing
    (options -> fingerprint -> prewarmed store -> no capture and no
    build before the first step), which the shapes do not change."""
    cfg = dict(base)
    cfg.update(tuned.get("config_overrides") or {})
    cfg.update({
        "experiment_name": str(base.get("experiment_name", "autotune"))
        + "_tuned_proof",
        "xla_compiler_options": tuned.get("xla_compiler_options") or {},
        "image_height": 16, "image_width": 16,
        "cnn_num_filters": 8, "num_stages": 2,
        "batch_size": 2, "mesh_shape": [1, 1],
        "eval_batch_size": 2, "num_evaluation_tasks": 2,
        "total_epochs": 1, "total_iter_per_epoch": 2,
        "max_models_to_save": 1, "live_progress": False,
        "aot_store_dir": os.path.join(out_dir, "aot"),
        "compilation_cache_dir": os.path.join(out_dir, "kernels"),
        "experiment_root": os.path.join(out_dir, "exp"),
    })
    # The winner's microbatch count may not divide the proof's batch.
    mb = int(cfg.get("task_microbatches", 1) or 1)
    if 2 % mb != 0:
        cfg["task_microbatches"] = 1
    path = os.path.join(out_dir, "proof.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2, sort_keys=True)
    return path


def prove_warm_train(proof_cfg_path: str, env) -> dict:
    """Prewarm the tuned store, run the trainer CLI against it, and read
    its ``warm_start`` row: ``compiles_before_first_step == 0`` under the
    prewarmed (tuned) fingerprint."""
    result: dict = {"ok": False}
    out, err, rc = harness.run_group(
        [sys.executable, os.path.join(_REPO, "scripts",
                                      "torch_aot_prewarm.py"),
         "--config", proof_cfg_path], timeout_s=PROOF_TIMEOUT_S, env=env)
    art = harness.last_json_line(out)
    if not art or not art.get("ok"):
        result["error"] = ("prewarm failed: "
                           + str((art or {}).get("status")
                                 or (out + err)[-300:]))
        return result
    result["prewarm_fingerprint"] = art.get("fingerprint")
    result["prewarm_executables"] = art.get("value")
    result["prewarm_options"] = art.get("xla_compiler_options")
    out, err, rc = harness.run_group(
        [sys.executable, "-m",
         "howtotrainyourmamlpytorch_tpu_torch.train_maml_system",
         "--name_of_args_json_file", proof_cfg_path],
        timeout_s=PROOF_TIMEOUT_S, env=env)
    if rc != 0:
        result["error"] = (f"tuned training run rc {rc}: "
                           + (out + err)[-300:])
        return result
    cfg = load_json(proof_cfg_path)
    events_path = os.path.join(cfg["experiment_root"],
                               cfg["experiment_name"], "logs",
                               "events.jsonl")
    warm = None
    try:
        with open(events_path) as f:
            for line in f:
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if row.get("event") == "warm_start":
                    warm = row
    except OSError as e:
        result["error"] = f"no warm_start row readable: {e}"
        return result
    if warm is None:
        result["error"] = "training run emitted no warm_start row"
        return result
    for key in ("compiles_before_first_step", "nvcc_runs_before_first_step",
                "aot_hits", "aot_misses", "time_to_first_step_seconds",
                "bitwise_resume"):
        result[key] = warm.get(key)
    result["fingerprint"] = warm.get("aot_fingerprint")
    fp = str(result.get("prewarm_fingerprint") or "")
    result["fingerprint_match"] = bool(
        fp and str(warm.get("aot_fingerprint") or "") == fp[:16])
    result["ok"] = (warm.get("compiles_before_first_step") == 0
                    and result["fingerprint_match"])
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="backend-option + structural-knob autotune sweep with "
                    "parity-gated winner adoption")
    ap.add_argument("--config", required=True,
                    help="the base workload's config JSON")
    ap.add_argument("--out", required=True, metavar="DIR",
                    help="sweep directory (ledger, trial configs and logs, "
                         "TUNED.json; re-running against it resumes)")
    ap.add_argument("--space", default=None, metavar="SPEC.json",
                    help="search-space spec (tune/space.py § "
                         "space_from_spec); default: the built-in space "
                         "for --platform")
    ap.add_argument("--platform", default="cuda", choices=space.PLATFORMS,
                    help="the default space's axes, and where the trial, "
                         "parity and accuracy children run (default: the "
                         "card)")
    ap.add_argument("--trials", type=int, default=0,
                    help="cap enumerated trials (0 = the whole space; the "
                         "baseline always runs)")
    ap.add_argument("--steps", type=int, default=9,
                    help="timed steps per trial leg")
    ap.add_argument("--quick", action="store_true",
                    help="tiny-shape trial legs (plumbing proofs)")
    ap.add_argument("--trial-timeout", type=float, default=900.0,
                    help="seconds per trial child (then a counted "
                         "timeout)")
    ap.add_argument("--parity-steps", type=int, default=2)
    ap.add_argument("--parity-tolerance", type=float, default=5e-3)
    ap.add_argument("--accuracy-gate", choices=("run", "skip"),
                    default="run",
                    help="'skip' records the skip in the verdict")
    ap.add_argument("--min-accuracy", type=float, default=None,
                    help="passed to scripts/torch_accuracy_gate.py")
    ap.add_argument("--accuracy-timeout", type=float, default=0.0,
                    help="seconds for the accuracy gate (0 = none)")
    ap.add_argument("--prove-warm-train", action="store_true",
                    help="after adoption: prewarm the tuned store and run "
                         "the trainer CLI on it, requiring "
                         "compiles_before_first_step == 0")
    args = ap.parse_args(argv)
    reaper.install()

    t_start = time.monotonic()
    out_dir = os.path.abspath(args.out)
    os.makedirs(out_dir, exist_ok=True)
    device = "cpu" if args.platform == "cpu" else None

    def fail(msg: str) -> int:
        print(json.dumps({"metric": "autotune", "ok": False,
                          "error": msg}), flush=True)
        return 1

    try:
        base_config = load_json(args.config)
    except (OSError, ValueError) as e:
        return fail(f"unreadable --config: {e}")
    try:
        if args.space:
            sp = space.space_from_spec(load_json(args.space))
        else:
            mesh_n = max(math.prod(base_config.get("mesh_shape", [1, 1])),
                         1)
            per_dev = (2 if args.quick else max(
                int(base_config.get("batch_size", 1)) // mesh_n, 1))
            sp = space.default_space(args.platform,
                                     per_device_tasks=per_dev)
        trials, pruned = sp.enumerate()
    except (OSError, ValueError, KeyError) as e:
        return fail(f"bad search space: {e}")
    if args.trials > 0:
        trials = trials[:max(args.trials, 1)]

    ledger = record.TrialLedger(out_dir)
    try:
        ledger.ensure_workload(hashlib.sha256(json.dumps(
            base_config, sort_keys=True, default=str).encode())
            .hexdigest())
    except ValueError as e:
        return fail(str(e))
    registry = _registry.MetricsRegistry()
    jsonl = JsonlLogger(os.path.join(out_dir, "logs", "events.jsonl"))
    for name in (TRIALS_RUN, TRIALS_FAILED, TRIALS_RESUMED,
                 INVALID_FLAG):
        registry.counter(name)

    env = dict(os.environ)
    done = set(ledger.completed_ids())
    interrupted = set(ledger.interrupted_ids())
    ran = resumed = 0
    for trial in trials:
        if trial.trial_id in done:
            resumed += 1
            registry.counter(TRIALS_RESUMED).inc()
            continue
        ledger.begin(trial.trial_id, trial.assignment)
        row = harness.run_trial(
            trial, base_config=base_config, sweep_dir=out_dir,
            steps=args.steps, quick=args.quick,
            timeout_s=args.trial_timeout, env=env, device=device)
        ledger.complete(trial.trial_id, row)
        ran += 1
        registry.counter(TRIALS_RUN).inc()
        if row["outcome"] != "ok":
            registry.counter(TRIALS_FAILED).inc()
            if row["outcome"] == "invalid_flag":
                registry.counter(INVALID_FLAG).inc()
        rec = ledger.record(trial.trial_id)
        jsonl.log("tune_trial", trial_id=trial.trial_id,
                  outcome=row["outcome"],
                  objective=row.get("objective"),
                  objective_key=row.get("objective_key"),
                  assignment=trial.assignment,
                  attempt=rec.get("attempt"),
                  resumed_after_interrupt=(trial.trial_id
                                           in interrupted),
                  seconds=row["seconds"])
        registry.flush_jsonl(jsonl)
        print(json.dumps({"trial": trial.trial_id,
                          "outcome": row["outcome"],
                          "objective": row.get("objective"),
                          "value": row.get("value"),
                          "step_ms": row.get("step_ms"),
                          "bn_launches": row.get("bn_launches"),
                          "assignment": trial.assignment,
                          "seconds": row["seconds"]}), flush=True)

    counts = ledger.counts()
    baseline = ledger.record(space.BASELINE_TRIAL_ID)
    if baseline is not None:
        baseline = {**baseline, "trial_id": space.BASELINE_TRIAL_ID}
    # Rank in the baseline's objective unit only (a trial whose FLOPs
    # were not counted falls back to tasks/s).
    base_key = (baseline or {}).get("objective_key")
    best = ledger.best(objective_key=base_key) if base_key else None

    # -- gates ----------------------------------------------------------
    parity = accuracy = None
    candidate = (best if best and baseline
                 and best.get("trial_id") != space.BASELINE_TRIAL_ID
                 and isinstance(baseline.get("objective"), (int, float))
                 and best["objective"] > baseline["objective"] else None)
    gates_reused = False
    if candidate is not None:
        trials_dir = os.path.join(out_dir, "trials")
        winner_cfg = os.path.join(trials_dir,
                                  f"{candidate['trial_id']}.json")
        base_cfg = os.path.join(trials_dir, "baseline.json")
        # A resumed driver reuses an earlier segment's gate verdicts for
        # this candidate, made under the same gate parameters; a stored
        # skip never satisfies --accuracy-gate run.
        gate_params = {"parity_steps": args.parity_steps,
                       "parity_tolerance": args.parity_tolerance,
                       "min_accuracy": args.min_accuracy}
        stored = ledger.gates_for(candidate["trial_id"],
                                  params=gate_params)
        if stored is not None:
            parity = stored.get("parity")
            accuracy = stored.get("accuracy")
            if (args.accuracy_gate == "run"
                    and isinstance(accuracy, dict)
                    and accuracy.get("skipped")):
                accuracy = None
            gates_reused = parity is not None and accuracy is not None
        if not (isinstance(parity, dict) and "pass" in parity):
            parity = harness.run_parity(
                winner_cfg, base_cfg,
                parity_py=os.path.join(_REPO, "scripts",
                                       "torch_tune_parity.py"),
                compiler_options=(candidate.get("compiler_options")
                                  or {}),
                steps=args.parity_steps,
                tolerance=args.parity_tolerance,
                timeout_s=args.trial_timeout, env=env, device=device)
            jsonl.log("tune_parity", **{k: v for k, v in parity.items()
                                        if k != "metric"})
        if accuracy is None:
            if args.accuracy_gate == "skip":
                accuracy = {"skipped": "--accuracy-gate skip (operator "
                                       "choice; e.g. no real dataset "
                                       "on this box)"}
            else:
                accuracy = harness.run_accuracy_gate(
                    winner_cfg,
                    gate_py=os.path.join(_REPO, "scripts",
                                         "torch_accuracy_gate.py"),
                    min_accuracy=args.min_accuracy,
                    timeout_s=args.accuracy_timeout, env=env,
                    device=device)
        ledger.record_gates(candidate["trial_id"], parity, accuracy,
                            params=gate_params)

    verdict = record.decide_adoption(best, baseline, parity, accuracy)

    tuned_doc = {
        "adopted": verdict["adopted"],
        "reason": verdict["reason"],
        "workload": base_config.get("experiment_name"),
        "base_config": os.path.abspath(args.config),
        "objective_key": (best or {}).get("objective_key"),
        "objective": (best or {}).get("objective"),
        "baseline_objective": (baseline or {}).get("objective"),
        "trial_id": (best or {}).get("trial_id"),
        "assignment": (best or {}).get("assignment"),
        "xla_compiler_options": (best or {}).get("compiler_options"),
        "config_overrides": (best or {}).get("config_overrides"),
        # False: the winner's backend options give up the trainer's
        # bitwise resume (device.resume_is_bitwise, read by its leg).
        "bitwise_resume": (best or {}).get("bitwise_resume"),
        "gates": {"parity": parity, "accuracy": accuracy},
    }
    tuned_path = record.write_tuned(out_dir, tuned_doc)

    # -- warm-train proof ----------------------------------------------
    warm_train = None
    if verdict["adopted"] and args.prove_warm_train:
        try:
            proof_cfg = build_proof_config(base_config, tuned_doc,
                                           out_dir)
            warm_train = prove_warm_train(proof_cfg, env)
        except Exception as e:  # noqa: BLE001 — the sweep's result must
            # survive a proof-leg failure, visibly.
            warm_train = {"ok": False,
                          "error": f"{type(e).__name__}: {e}"}

    jsonl.log("tune_adopt", adopted=verdict["adopted"],
              reason=verdict["reason"],
              trial_id=(best or {}).get("trial_id"),
              objective=(best or {}).get("objective"),
              objective_key=(best or {}).get("objective_key"),
              baseline_objective=(baseline or {}).get("objective"),
              tuned_fingerprint=((warm_train or {})
                                 .get("prewarm_fingerprint")))
    registry.flush_jsonl(jsonl)

    # ok: this invocation's enumerated trials all reached a terminal
    # state (judged over the enumeration, not the whole ledger).
    ok = all((ledger.record(t.trial_id) or {}).get("status")
             in record.TERMINAL for t in trials)
    artifact = {
        "metric": "autotune",
        "value": (best or {}).get("objective"),
        "unit": (best or {}).get("objective_key"),
        "ok": ok,
        "workload": base_config.get("experiment_name"),
        "platform": args.platform,
        "trials_total": len(trials),
        "trials_run": ran,
        "trials_resumed": resumed,
        "trials_ok": counts["ok"],
        "trials_failed": counts["failed"],
        "failed_by_outcome": counts["failed_by_outcome"],
        "invalid_flag_failures": counts["failed_by_outcome"].get(
            "invalid_flag", 0),
        "pruned": len(pruned),
        "baseline_objective": (baseline or {}).get("objective"),
        "best": ({k: (best or {}).get(k) for k in
                  ("trial_id", "objective", "objective_key",
                   "assignment", "compiler_options",
                   "config_overrides")} if best else None),
        "gates": {"parity": parity, "accuracy": accuracy},
        "gates_reused": gates_reused,
        "adopted": verdict["adopted"],
        "reason": verdict["reason"],
        "bitwise_resume": tuned_doc["bitwise_resume"],
        "tuned_path": tuned_path,
        "warm_train": warm_train,
        "ledger": ledger.path,
        "events": jsonl.path,
        "seconds": round(time.monotonic() - t_start, 1),
        "jax_free": "jax" not in sys.modules,
        "torch_free": "torch" not in sys.modules,
    }
    print(json.dumps(artifact), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
