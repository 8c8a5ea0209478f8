"""Chaos harness of the PyTorch/CUDA port: inject the reference's
deterministic faults into the port's trainer and prove it recovers.

The port's counterpart of ``scripts/chaos_run.py``, with its phases and
its artifact contract, and no JAX:

1. **baseline** — a fault-free run through the ensemble test protocol.
2. **faulted** — the same run with ``io_write@1;nan_loss@5;kill@6``: one
   transient ``config.json`` write error (recovered by the storage
   backoff), a NaN outer loss at iteration 5 (the divergence guard
   rewinds to the newest epoch checkpoint and re-seeds the train stream;
   the health grad-norm warning lands before the rewind) and a SIGTERM
   at iteration 6 (save-on-signal). The phase ends preempted.
3. **restart** — resume from 'latest' without faults through the test
   protocol.
4. **ckpt_kill** — a subprocess with ``ckpt_async=1`` and
   ``kill_in_ckpt_write@2``: exit 137 after epoch 1's tmp bytes, before
   the rename. The manifest holds epoch 0 committed and epoch 1 pending;
   a restart resumes from the last committed entry, sweeps the pending
   record and the ``*.tmp``, quarantines nothing and finishes.
5. **hang** — a subprocess with ``hang_feed@5`` and a tight feed
   deadline: the watchdog trips, writes ``logs/crash_bundle`` and exits
   74; a restart resumes from the last committed entry and finishes.
6. **peer_kill** — shells out to ``scripts/torch_chaos_pod.py --phases
   peer_kill,restart`` at the same geometry: a SIGKILLed rank, the
   survivor's attributed exit 73 naming it, then the consensus restart.
   A box that cannot run two ranks (one core, or no localhost sockets)
   skips it with the reason recorded; so does a caller that runs the pod
   harness itself (``pod_legs=False``).
7. **warm_restart** — ``scripts/torch_aot_prewarm.py`` fills a
   warm-start store and a kernel build cache for this harness's config
   (``parallel/aot.py``), then the CLI runs on them as a child: its
   ``warm_start`` row must show at least one hit, no miss and nothing
   compiled (no ``nvcc`` run, no graph captured on a miss) before its
   first step. CUDA graphs need the card: on the CPU the leg is skipped
   with that reason; a caller that runs it itself passes
   ``warm_legs=False`` (or drives :func:`start_warm_restart_leg` and
   :func:`finish_warm_restart_leg`).

The ckpt_kill and hang restarts replay the same iterations from a
committed checkpoint under the entry point's deterministic numerics
policy, so their final weights and Adam state must be bitwise the
baseline's; the artifact names any leaf that differs.

Geometry: ``--quick`` runs the JAX harness's tiny config (2 epochs x 4
iterations, 10x10x1, 2 stages of 4 filters); otherwise the flagship JSON
at full width with ``bn_backend=pallas``, cut in length only (2 epochs x
3 iterations, 48 evaluation tasks, the top 2 checkpoints). The last
stdout line is ``{"metric": "chaos_recovery", "status": "recovered" |
"failed", ...}``; exit 0 iff recovered.

Usage:
    python scripts/torch_chaos_run.py --quick --device cpu   # ~60 s here
    python scripts/torch_chaos_run.py --device cuda          # flagship
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

FLAGSHIP = os.path.join(_REPO, "experiment_config",
                        "mini-imagenet_maml++_5-way_5-shot_DA_b12.json")
# The flagship's length cuts (chip_smoke.py phase 5): epoch 0 first order
# + MSL, epoch 1 second order.
FLAGSHIP_ARGS = ["--bn_backend", "pallas", "--total_epochs", "2",
                 "--total_iter_per_epoch", "3",
                 "--first_order_to_second_order_epoch", "0",
                 "--multi_step_loss_num_epochs", "1",
                 "--num_evaluation_tasks", "48", "--max_models_to_save", "2"]
# Both geometries: the guard and the fault hooks act at the dispatch-sync
# points, so sync every iteration; health on, so the faulted phase shows
# the grad-norm warning before the rewind.
CHAOS = dict(dispatch_sync_every=1, live_progress=False,
             divergence_patience=1, health_metrics_every_n_steps=1)
# scripts/chaos_run.py § tiny_cfg.
QUICK = dict(
    dataset_name="synthetic_chaos", image_height=10, image_width=10,
    image_channels=1, num_classes_per_set=3, num_samples_per_class=1,
    num_target_samples=2, batch_size=2, cnn_num_filters=4, num_stages=2,
    number_of_training_steps_per_iter=2,
    number_of_evaluation_steps_per_iter=2, second_order=False,
    use_multi_step_loss_optimization=False, total_epochs=2,
    total_iter_per_epoch=4, num_evaluation_tasks=4, max_models_to_save=2,
    compute_dtype="float32", meta_learning_rate=0.005)
FAULTED_SPEC = "io_write@1;nan_loss@5;kill@6"
CKPT_KILL_SPEC = "kill_in_ckpt_write@2"
HANG_SPEC = "hang_feed@5"
# The hang phase's deadlines: a tight feed deadline, the others generous.
HANG_DEADLINES = dict(watchdog_feed_timeout_s=6.0,
                      watchdog_step_timeout_s=300.0,
                      watchdog_compile_timeout_s=900.0,
                      watchdog_poll_interval_s=0.5)
# Bounds an injected hang if the watchdog fails to trip: the child then
# finishes and the artifact shows the wrong exit code.
HANG_SECONDS = "120"
POD_SCRIPT = os.path.join(_REPO, "scripts", "torch_chaos_pod.py")
PREWARM_SCRIPT = os.path.join(_REPO, "scripts", "torch_aot_prewarm.py")
WARM_SKIP_CPU = ("CUDA graphs need the card: the warm-start store's "
                 "executables cannot be captured on the CPU")

# A subprocess run of the port's CLI on a device (the CLI itself runs on
# the card; device="cpu" must be asked for from Python).
CHILD = ("import sys; sys.path.insert(0, sys.argv[3]); "
         "from howtotrainyourmamlpytorch_tpu_torch import "
         "train_maml_system as t; "
         "sys.exit(t.main(['--name_of_args_json_file', sys.argv[1]], "
         "device=sys.argv[2]))")


def make_cfg(out: str, name: str, quick: bool, **kw):
    """The phase's config: the tiny one or the cut flagship, with the
    chaos knobs, under ``out/name``."""
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    from howtotrainyourmamlpytorch_tpu_torch.train_maml_system import (
        get_args)
    base = (MAMLConfig(**QUICK) if quick else get_args(
        ["--name_of_args_json_file", FLAGSHIP] + FLAGSHIP_ARGS))
    return base.replace(experiment_root=out, experiment_name=name,
                        **{**CHAOS, **kw})


def run_phase(cfg, device: str) -> dict:
    """One in-process ``ExperimentBuilder`` run: its result, counters,
    the iteration it started from, the BN kernel's launches and the
    builder."""
    from howtotrainyourmamlpytorch_tpu_torch.experiment import (
        ExperimentBuilder)
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    builder = ExperimentBuilder(cfg, device=device)
    start_iter = builder.current_iter
    bn_act.reset_launches()
    t0 = time.perf_counter()
    result = builder.run_experiment()
    return {"result": result, "counters": builder.registry.snapshot(),
            "start_iter": start_iter, "launches": bn_act.launches,
            "seconds": time.perf_counter() - t0, "builder": builder}


def spawn(cfg, device: str, env_extra=None, timeout: float = 900.0,
          code: str = CHILD) -> subprocess.CompletedProcess:
    """The CLI on ``cfg`` in a subprocess (a watchdog trip or an injected
    kill ends its process, not ours). The fault plan comes from the
    config only."""
    path = os.path.join(cfg.experiment_root, f"{cfg.experiment_name}.json")
    os.makedirs(cfg.experiment_root, exist_ok=True)
    with open(path, "w") as f:
        json.dump(cfg.to_dict(), f)
    env = dict(os.environ)
    env.pop("MAML_FAULTS", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code, path, device, _REPO],
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def manifest_view(saved: str) -> dict:
    """Committed iteration, pending records, tmp and quarantine files of
    a checkpoint directory."""
    records = {}
    path = os.path.join(saved, "MANIFEST.json")
    if os.path.exists(path):
        with open(path) as f:
            records = json.load(f).get("records", {})
    committed = [int(r.get("iter") or 0) for r in records.values()
                 if r.get("status") == "committed"]
    return {"committed_iter": max(committed) if committed else None,
            "pending": sum(1 for r in records.values()
                           if r.get("status") != "committed"),
            "tmp": len(glob.glob(os.path.join(saved, "*.tmp"))),
            "corrupt": len(glob.glob(os.path.join(saved, "*.corrupt")))}


def read_events(logs: str) -> list:
    path = os.path.join(logs, "events.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def bundle_view(bundle: str) -> dict:
    """What a crash bundle holds: its files, ``crash.json`` and the
    flight ring's rows."""
    crash, flight = {}, []
    if os.path.exists(os.path.join(bundle, "crash.json")):
        with open(os.path.join(bundle, "crash.json")) as f:
            crash = json.load(f)
    if os.path.exists(os.path.join(bundle, "flight.jsonl")):
        with open(os.path.join(bundle, "flight.jsonl")) as f:
            flight = [json.loads(line) for line in f if line.strip()]
    files = sorted(os.listdir(bundle)) if os.path.isdir(bundle) else []
    stacks = os.path.join(bundle, "stacks.txt")
    return {"files": files, "crash": crash, "flight": flight,
            "stacks": (open(stacks).read() if os.path.exists(stacks)
                       else "")}


def state_leaves(state) -> dict:
    """``{name: tensor}`` over params, LSLR, BN state, Adam's moments and
    the step counter."""
    out = {"/step": state.step}

    def walk(prefix, tree):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(f"{prefix}/{key}", value)
            else:
                out[f"{prefix}/{key}"] = value
    walk("", {"params": state.params, "lslr": state.lslr,
              "bn_state": state.bn_state, "mu": state.opt_state.mu,
              "nu": state.opt_state.nu})
    return out


def differing_leaves(a, b) -> list:
    """Names of the leaves where two states are not bitwise equal."""
    import torch
    la, lb = state_leaves(a), state_leaves(b)
    return sorted(n for n in la
                  if n not in lb or not torch.equal(torch.as_tensor(la[n]),
                                                    torch.as_tensor(lb[n])))


def warn_precedes_rewind(events: list):
    """(warn rows, the first warning lands before the first rewind)."""
    names = [e.get("event") for e in events]
    warns = names.count("health_grad_norm_warn")
    before = ("health_grad_norm_warn" in names and "rewind" in names
              and names.index("health_grad_norm_warn")
              < names.index("rewind"))
    return warns, before


def run_peer_kill_phase(out: str, device: str, quick: bool) -> dict:
    """The pod fault domain's legs, by shelling out to
    ``scripts/torch_chaos_pod.py --phases peer_kill,restart`` at this
    harness's geometry (the flagship's length cuts unless ``quick``),
    when this box can run two ranks; otherwise a recorded skip."""
    import socket
    reason = None
    if (os.cpu_count() or 1) < 2:
        reason = ("single-core box: a 2-rank training pair would "
                  "serialize past the harness timeouts")
    else:
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
        except OSError:
            reason = "cannot bind localhost sockets in this sandbox"
    if reason:
        return {"skipped": reason, "recovered": None}
    cmd = [sys.executable, POD_SCRIPT, "--out", os.path.join(out, "pod"),
           "--phases", "peer_kill,restart", "--device", device]
    if quick:
        cmd.append("--quick")
    else:
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, "pod_config.json")
        with open(path, "w") as f:
            json.dump(make_cfg(out, "pod", False).to_dict(), f)
        cmd += ["--config", path]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=3000,
                          env={k: v for k, v in os.environ.items()
                               if k != "MAML_FAULTS"})
    artifact = {}
    for line in proc.stdout.strip().splitlines()[::-1]:
        try:
            row = json.loads(line)
        except json.JSONDecodeError:
            continue
        if row.get("metric") == "pod_chaos":
            artifact = row
            break
    return {
        "skipped": None,
        "recovered": artifact.get("status") == "recovered",
        "exit_code": proc.returncode,
        "survivor_exit_code": artifact.get("peer_kill_survivor_exit_code"),
        "suspect_hosts": artifact.get("peer_kill_suspect_hosts"),
        "resumed_lines": artifact.get("restart_resumed_lines"),
        "consensus_ok": artifact.get("restart_consensus_ok"),
        "stderr_tail": (proc.stderr[-800:] if proc.returncode != 0
                        else None),
    }


def last_warm_start_row(logs: str) -> dict:
    """The last ``warm_start`` row of a run's ``events.jsonl`` (the most
    recent session's)."""
    rows = [e for e in read_events(logs) if e.get("event") == "warm_start"]
    return rows[-1] if rows else {}


def start_warm_restart_leg(out: str, device: str, quick: bool,
                           popen=subprocess.Popen, prewarm_args=()) -> dict:
    """Start the warm-restart leg: the prewarm script (with
    ``prewarm_args``) on this harness's config (training health off, so
    the steps replay their graphs), with a fresh store and kernel cache
    under ``out``. Returns the leg's handle for
    :func:`finish_warm_restart_leg`; ``popen`` starts each child (a
    caller that reaps its children passes its own)."""
    store = os.path.join(out, "warm_store")
    cache = os.path.join(out, "warm_kernel_cache")
    cfg = make_cfg(out, "chaos_warm", quick, health_metrics_every_n_steps=0,
                   aot_store_dir=store, compilation_cache_dir=cache)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "chaos_warm_prewarm.json")
    with open(path, "w") as f:
        json.dump(cfg.to_dict(), f)
    proc = popen([sys.executable, PREWARM_SCRIPT, "--config", path,
                  *prewarm_args],
                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                 cwd=_REPO)
    return {"cfg": cfg, "device": device, "prewarm": proc, "popen": popen,
            "out": out}


def _wait(proc, timeout: float):
    """``(returncode, stdout, stderr)``; a child past ``timeout`` is
    killed (returncode None)."""
    try:
        out, err = proc.communicate(timeout=timeout)
        return proc.returncode, out, err
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        return None, out, err


def finish_warm_restart_leg(leg: dict, timeout: float = 900.0) -> dict:
    """Wait for the prewarm, then run the CLI on the warm store and read
    its ``warm_start`` row: the JAX harness's ``warm_restart_*`` keys."""
    cfg = leg["cfg"]
    rc, out, err = _wait(leg["prewarm"], timeout)
    prewarm = {}
    for line in (out or "").strip().splitlines()[::-1]:
        try:
            prewarm = json.loads(line)
            break
        except json.JSONDecodeError:
            continue
    path = os.path.join(cfg.experiment_root, f"{cfg.experiment_name}.json")
    with open(path, "w") as f:
        json.dump(cfg.to_dict(), f)
    env = {k: v for k, v in os.environ.items() if k != "MAML_FAULTS"}
    proc = leg["popen"]([sys.executable, "-c", CHILD, path, leg["device"],
                         _REPO], stdout=subprocess.PIPE,
                        stderr=subprocess.PIPE, text=True, cwd=_REPO,
                        env=env)
    cli_rc, _, cli_err = _wait(proc, timeout)
    row = last_warm_start_row(os.path.join(cfg.experiment_root,
                                           cfg.experiment_name, "logs"))
    ok = bool(rc == 0 and prewarm.get("ok") and cli_rc == 0
              and row.get("compiles_before_first_step") == 0
              and (row.get("aot_hits") or 0) >= 1
              and row.get("aot_misses") == 0)
    return {
        "warm_restart_skipped": None,
        "warm_restart_prewarm_exit_code": rc,
        "warm_restart_prewarm": {k: prewarm.get(k) for k in (
            "ok", "hits", "misses", "failures", "seconds", "nvcc_runs",
            "executables")},
        "warm_restart_exit_code": cli_rc,
        "warm_restart_compiles_before_first_step": row.get(
            "compiles_before_first_step"),
        "warm_restart_nvcc_runs_before_first_step": row.get(
            "nvcc_runs_before_first_step"),
        "warm_restart_aot_hits": row.get("aot_hits"),
        "warm_restart_aot_misses": row.get("aot_misses"),
        "warm_restart_time_to_first_step_s": row.get(
            "time_to_first_step_seconds"),
        "warm_restart_ok": ok,
        "warm_restart_stderr_tail": (
            None if ok else ((err or "")[-800:] + (cli_err or "")[-800:])),
    }


def run_warm_restart_leg(out: str, device: str, quick: bool) -> dict:
    """The whole warm-restart leg, or its skip on the CPU."""
    if device != "cuda":
        return {"warm_restart_skipped": WARM_SKIP_CPU,
                "warm_restart_ok": None}
    return finish_warm_restart_leg(start_warm_restart_leg(out, device,
                                                          quick))


def counter_sum(phases, key) -> int:
    return int(sum(float(p["counters"].get(key) or 0) for p in phases))


def chaos(out: str, device: str, quick: bool, tolerance: float = 0.4,
          log=print, pod_legs: bool = True, warm_legs: bool = True) -> dict:
    """Every phase; returns the artifact (plus, under ``"_phases"``, the
    in-process phases' records for callers that check more).
    ``pod_legs=False`` skips the peer_kill phase, for a caller that runs
    ``scripts/torch_chaos_pod.py`` itself; ``warm_legs=False`` the
    warm_restart phase, for a caller that runs it itself."""
    from howtotrainyourmamlpytorch_tpu_torch.resilience import EXIT_HUNG

    def cfg(name, **kw):
        return make_cfg(out, name, quick, **kw)

    def announce(phase, **kw):
        log(json.dumps({"phase": phase, "status": "running", **kw}))

    announce("baseline")
    baseline = run_phase(cfg("chaos_baseline"), device)

    announce("faulted", spec=FAULTED_SPEC)
    faulted = run_phase(cfg("chaos_faulted", fault_spec=FAULTED_SPEC),
                        device)
    preempted = "preempted_at_iter" in faulted["result"]
    announce("restart")
    restart = run_phase(cfg("chaos_faulted", continue_from_epoch="latest"),
                        device)

    announce("ckpt_kill", spec=CKPT_KILL_SPEC)
    kill_proc = spawn(cfg("chaos_ckpt", fault_spec=CKPT_KILL_SPEC,
                          ckpt_async=1), device)
    saved = os.path.join(out, "chaos_ckpt", "saved_models")
    kill_before = manifest_view(saved)
    announce("ckpt_kill_restart")
    ckpt_restart = run_phase(cfg("chaos_ckpt", continue_from_epoch="latest",
                                 ckpt_async=1), device)
    kill_after = manifest_view(saved)

    announce("hang", spec=HANG_SPEC)
    t0 = time.time()
    hang_proc = spawn(cfg("chaos_hang", fault_spec=HANG_SPEC,
                          **HANG_DEADLINES), device,
                      {"MAML_HANG_SECONDS": HANG_SECONDS})
    hang_exit_ts = time.time()
    hang_logs = os.path.join(out, "chaos_hang", "logs")
    bundle = bundle_view(os.path.join(hang_logs, "crash_bundle"))
    hang_committed = manifest_view(os.path.join(out, "chaos_hang",
                                                "saved_models"))
    trips = sum(1 for e in read_events(hang_logs)
                if e.get("event") == "watchdog_trip")
    announce("hang_restart")
    hang_restart = run_phase(cfg("chaos_hang", continue_from_epoch="latest"),
                             device)
    announce("peer_kill")
    peer_kill = (run_peer_kill_phase(out, device, quick) if pod_legs else
                 {"skipped": "pod_legs=False: the caller runs "
                             "scripts/torch_chaos_pod.py itself",
                  "recovered": None})
    if peer_kill["skipped"]:
        log(json.dumps({"phase": "peer_kill", "status": "skipped",
                        "reason": peer_kill["skipped"]}))
    announce("warm_restart")
    warm = (run_warm_restart_leg(out, device, quick) if warm_legs else
            {"warm_restart_skipped": "warm_legs=False: the caller runs "
                                     "the warm restart itself",
             "warm_restart_ok": None})
    if warm["warm_restart_skipped"]:
        log(json.dumps({"phase": "warm_restart", "status": "skipped",
                        "reason": warm["warm_restart_skipped"]}))

    grad_norm_warns, warn_before_rewind = warn_precedes_rewind(
        read_events(os.path.join(out, "chaos_faulted", "logs")))
    chaos_phases = [faulted, restart]
    rewinds = counter_sum(chaos_phases, "resilience/rewinds")
    io_retries = counter_sum(chaos_phases, "resilience/io_retries")

    def acc(phase):
        return phase["result"].get("test_accuracy_mean")

    def delta(phase):
        a, b = acc(phase), acc(baseline)
        return abs(a - b) if a is not None and b is not None else None

    base_state = baseline["builder"].state
    ckpt_diff = differing_leaves(ckpt_restart["builder"].state, base_state)
    hang_diff = differing_leaves(hang_restart["builder"].state, base_state)
    ckpt_kill_recovered = bool(
        kill_proc.returncode == 137
        and kill_before["pending"] >= 1
        and kill_before["committed_iter"] == ckpt_restart["start_iter"]
        and acc(ckpt_restart) is not None
        and kill_after["pending"] == 0 and kill_after["tmp"] == 0
        and kill_after["corrupt"] == 0
        and counter_sum([ckpt_restart], "resilience/quarantined") == 0
        and not ckpt_diff)
    crash = bundle["crash"]
    hang_recovered = bool(
        hang_proc.returncode == EXIT_HUNG
        and {"stacks.txt", "flight.jsonl", "trace.json", "crash.json"}
        <= set(bundle["files"])
        and crash.get("reason") == "hung_feed" and trips == 1
        and any(r.get("kind") == "phase" and r.get("phase") == "feed"
                for r in bundle["flight"])
        and hang_committed["committed_iter"] == hang_restart["start_iter"]
        and acc(hang_restart) is not None and not hang_diff)
    chaos_delta = delta(restart)
    peer_kill_ok = (peer_kill["skipped"] is not None
                    or bool(peer_kill["recovered"]))
    # The warm restart gates recovery when it ran; a skip is recorded
    # with its reason.
    warm_restart_ok = (warm["warm_restart_skipped"] is not None
                       or bool(warm["warm_restart_ok"]))
    recovered = bool(
        preempted and rewinds >= 1 and io_retries >= 1
        and warn_before_rewind and chaos_delta is not None
        and chaos_delta <= tolerance
        and ckpt_kill_recovered and hang_recovered and peer_kill_ok
        and warm_restart_ok)
    recoveries = (int(preempted) + int(rewinds >= 1) + int(io_retries >= 1)
                  + int(ckpt_kill_recovered) + int(hang_recovered)
                  + int(bool(peer_kill["recovered"]))
                  + int(bool(warm["warm_restart_ok"])))

    def tail(proc, ok_code):
        return proc.stderr[-800:] if proc.returncode != ok_code else None

    return {
        "metric": "chaos_recovery",
        "value": 1.0 if recovered else 0.0,
        "unit": "recovered",
        "status": "recovered" if recovered else "failed",
        "device": device,
        "geometry": "quick" if quick else "flagship",
        "fault_spec": FAULTED_SPEC,
        "faults_injected": counter_sum(chaos_phases,
                                       "resilience/faults_injected"),
        "recoveries": recoveries,
        "rewinds": rewinds,
        "io_retries": io_retries,
        "quarantined": counter_sum(chaos_phases, "resilience/quarantined"),
        "grad_norm_warns": grad_norm_warns,
        "grad_norm_warn_before_rewind": warn_before_rewind,
        "preempted": preempted,
        "preempted_at_iter": faulted["result"].get("preempted_at_iter"),
        "baseline_test_accuracy": acc(baseline),
        "chaos_test_accuracy": acc(restart),
        "test_accuracy_delta": chaos_delta,
        "ckpt_kill_exit_code": kill_proc.returncode,
        "ckpt_kill_committed_iter": kill_before["committed_iter"],
        "ckpt_kill_pending_before_restart": kill_before["pending"],
        "ckpt_kill_tmp_before_restart": kill_before["tmp"],
        "ckpt_kill_restart_iter": ckpt_restart["start_iter"],
        "ckpt_kill_pending_after_restart": kill_after["pending"],
        "ckpt_kill_tmp_after_restart": kill_after["tmp"],
        "ckpt_kill_quarantined": counter_sum([ckpt_restart],
                                             "resilience/quarantined"),
        "ckpt_kill_restart_differing_leaves": ckpt_diff,
        "ckpt_kill_test_accuracy": acc(ckpt_restart),
        "ckpt_kill_stderr_tail": tail(kill_proc, 137),
        "ckpt_kill_recovered": ckpt_kill_recovered,
        "hang_exit_code": hang_proc.returncode,
        "hang_bundle_files": bundle["files"],
        "hang_reason": crash.get("reason"),
        "hang_age_seconds": crash.get("age_seconds"),
        "hang_deadline_seconds": crash.get("deadline_seconds"),
        "hang_exit_after_trip_seconds": (
            hang_exit_ts - crash["ts"] if "ts" in crash else None),
        "hang_flight_rows": len(bundle["flight"]),
        "hang_watchdog_trips": trips,
        "hang_committed_iter": hang_committed["committed_iter"],
        "hang_restart_iter": hang_restart["start_iter"],
        "hang_restart_differing_leaves": hang_diff,
        "hang_test_accuracy": acc(hang_restart),
        "hang_stderr_tail": tail(hang_proc, EXIT_HUNG),
        "hang_seconds": hang_exit_ts - t0,
        "hang_recovered": hang_recovered,
        "peer_kill_skipped": peer_kill["skipped"],
        "peer_kill_recovered": peer_kill["recovered"],
        "peer_kill_survivor_exit_code": peer_kill.get("survivor_exit_code"),
        "peer_kill_suspect_hosts": peer_kill.get("suspect_hosts"),
        "peer_kill_resumed_lines": peer_kill.get("resumed_lines"),
        "peer_kill_consensus_ok": peer_kill.get("consensus_ok"),
        "peer_kill_stderr_tail": peer_kill.get("stderr_tail"),
        **{"warm_restart_compiles_before_first_step": None,
           "warm_restart_aot_hits": None, "warm_restart_aot_misses": None,
           "warm_restart_time_to_first_step_s": None, **warm},
        "tolerance": tolerance,
        "_phases": {"baseline": baseline, "faulted": faulted,
                    "restart": restart, "ckpt_kill_restart": ckpt_restart,
                    "hang_restart": hang_restart},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Deterministic chaos run of the PyTorch/CUDA port: "
                    "inject faults, prove recovery, print a JSON artifact.")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="experiment root (default: a fresh temp dir, "
                         "removed on success)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card) or 'cpu'")
    ap.add_argument("--quick", action="store_true",
                    help="the tiny config instead of the flagship's width")
    ap.add_argument("--tolerance", type=float, default=0.4,
                    help="max |test accuracy(restart) - test accuracy"
                         "(baseline)|: the rewind re-seeds the train "
                         "stream, so equality is not expected")
    args = ap.parse_args(argv)
    out = args.out or tempfile.mkdtemp(prefix="torch_chaos_")
    artifact = chaos(out, args.device, args.quick, args.tolerance)
    artifact.pop("_phases")
    artifact["out_dir"] = out if args.out else None
    if args.out is None and artifact["status"] == "recovered":
        shutil.rmtree(out, ignore_errors=True)
    print(json.dumps(artifact), flush=True)
    return 0 if artifact["status"] == "recovered" else 1


if __name__ == "__main__":
    sys.exit(main())
