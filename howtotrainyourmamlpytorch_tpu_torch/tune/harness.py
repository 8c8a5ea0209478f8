"""Crash-isolated autotune trial legs of the port: every trial is its own
process group (the port's counterpart of the JAX package's
``tune/harness.py``).

A trial is never run in the driver: each one is a fresh
``python -m howtotrainyourmamlpytorch_tpu_torch.tune.trial`` child (the
port's counterpart of the ``bench.py`` headline leg, with its last-JSON-
line contract), and whatever happens to it (a clean artifact, a Python
error, a signal, a time-out, running out of memory) is classified into
a counted outcome: a crashed trial is a ledger row, never a dead sweep.

Every child starts in a session of its own and is tracked as its whole
process group (``utils/reaper.py``): on a time-out, and when the driver
exits or is sent SIGTERM, the group is killed, grandchildren included,
and the child waited for; a child that exits leaving members of its
group behind has them killed.

The objective is read from the trial artifact: ``mfu`` when the card's
peak is known, else ``value`` (tasks/s/chip; a CPU has no peak).

Stdlib only: imported by the torch-free driver; torch lives only in the
children.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from howtotrainyourmamlpytorch_tpu_torch.tune.space import Trial
from howtotrainyourmamlpytorch_tpu_torch.utils import reaper

# The repo's root: children run from it, so ``-m`` finds the package.
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TRIAL_MODULE = "howtotrainyourmamlpytorch_tpu_torch.tune.trial"

# Substrings that classify a failed leg's output, checked in order: an
# unknown backend option raises with ``device.NO_SUCH_OPTION``; an
# exhausted card or host raises torch's or Python's out-of-memory error.
_INVALID_FLAG_MARKERS = ("No such backend option",)
_OOM_MARKERS = ("torch.OutOfMemoryError", "CUDA out of memory",
                "std::bad_alloc", "MemoryError")

# Artifact keys copied from the trial's last JSON line into its ledger
# row (absent keys stay absent).
_CARRY_KEYS = ("value", "mfu", "flops_per_task", "peak_flops_source",
               "workload", "bn_launches", "step_ms", "device_kind",
               "aot_hits", "bitwise_resume")

# Seconds a timed-out group has between SIGTERM and SIGKILL.
TERM_GRACE_S = 5.0


def write_trial_config(trial: Trial, base_config: Dict[str, Any],
                       trials_dir: str) -> str:
    """The trial's config JSON: the base workload + this trial's
    structural overrides (experiment_name suffixed). The backend-option
    channel rides the command line: a base config's own adopted
    ``xla_compiler_options`` is dropped, so the baseline is the untuned
    program. A base config with ``aot_store_dir`` gets a fresh store
    under the trial's own directory, so the trial times replayed
    graphs of its own captures."""
    cfg = dict(base_config)
    cfg.pop("xla_compiler_options", None)
    cfg.update(trial.config_overrides)
    cfg["experiment_name"] = (str(base_config.get("experiment_name",
                                                  "autotune"))
                              + f"_tune_{trial.trial_id}")
    os.makedirs(trials_dir, exist_ok=True)
    if base_config.get("aot_store_dir"):
        store = os.path.join(trials_dir, f"{trial.trial_id}_aot")
        shutil.rmtree(store, ignore_errors=True)
        cfg["aot_store_dir"] = store
    path = os.path.join(trials_dir, f"{trial.trial_id}.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2, sort_keys=True)
    return path


def classify_failure(returncode: Optional[int], tail: str) -> str:
    """Outcome label for a non-ok leg: ``timeout``, ``invalid_flag``,
    ``oom``, ``crashed`` (a signal) or ``error``."""
    if returncode is None:
        return "timeout"
    for marker in _INVALID_FLAG_MARKERS:
        if marker in tail:
            return "invalid_flag"
    for marker in _OOM_MARKERS:
        if marker in tail:
            return "oom"
    if returncode < 0:
        return "crashed"
    return "error"


def last_json_line(stdout: str) -> Optional[Dict[str, Any]]:
    for line in reversed(stdout.splitlines()):
        if line.startswith("{"):
            try:
                return json.loads(line)
            except ValueError:
                continue
    return None


def run_group(cmd: List[str], *, timeout_s: Optional[float],
              env: Optional[Dict[str, str]] = None
              ) -> Tuple[str, str, Optional[int]]:
    """Run ``cmd`` from the repo's root as a process group of its own to
    its end or ``timeout_s``: ``(stdout, stderr, returncode)``, the code
    None on a time-out. The group is killed on a time-out and whatever
    of it outlived the child is killed at the end."""
    group = reaper.spawn(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, env=env,
                         cwd=REPO, start_new_session=True)
    proc = group.proc
    rc: Optional[int] = None
    try:
        try:
            out, err = proc.communicate(timeout=timeout_s or None)
            rc = proc.returncode
        except subprocess.TimeoutExpired:
            group.end(TERM_GRACE_S)
            try:
                out, err = proc.communicate(timeout=TERM_GRACE_S)
            except subprocess.TimeoutExpired:
                out, err = "", ""
    finally:
        group.end(0.0)
    return out or "", err or "", rc


def _child_cmd(script: Optional[str]) -> List[str]:
    return [sys.executable] + ([script] if script else ["-m", TRIAL_MODULE])


def run_trial(trial: Trial, *, base_config: Dict[str, Any],
              sweep_dir: str, trial_py: Optional[str] = None,
              steps: int = 3, quick: bool = True,
              timeout_s: float = 600.0,
              env: Optional[Dict[str, str]] = None,
              device: Optional[str] = None) -> Dict[str, Any]:
    """One isolated trial leg; returns the ledger row (never raises on a
    failed child). ``trial_py`` replaces the trial module by a script
    with its command line; ``device`` is passed on as ``--device``."""
    trials_dir = os.path.join(sweep_dir, "trials")
    cfg_path = write_trial_config(trial, base_config, trials_dir)
    cmd = _child_cmd(trial_py) + ["--config", cfg_path,
                                  "--steps", str(steps)]
    if quick:
        cmd.append("--quick")
    if device:
        cmd += ["--device", device]
    for k, v in sorted(trial.compiler_options.items()):
        cmd += ["--backend-option", f"{k}={v}"]
    log_path = os.path.join(trials_dir, f"{trial.trial_id}.log")
    t0 = time.monotonic()
    out, err, rc = run_group(cmd, timeout_s=timeout_s, env=env)
    seconds = round(time.monotonic() - t0, 3)
    with open(log_path, "w") as f:
        f.write(f"$ {' '.join(cmd)}\n{out}\n--- stderr ---\n{err}")
    row: Dict[str, Any] = {
        "assignment": trial.assignment,
        "compiler_options": trial.compiler_options,
        "config_overrides": trial.config_overrides,
        "seconds": seconds,
        "returncode": rc,
        "log": os.path.relpath(log_path, sweep_dir),
    }
    artifact = last_json_line(out)
    if (rc == 0 and artifact
            and artifact.get("metric") == "meta_tasks_per_sec_per_chip"
            and isinstance(artifact.get("value"), (int, float))):
        row["outcome"] = "ok"
        for key in _CARRY_KEYS:
            if artifact.get(key) is not None:
                row[key] = artifact[key]
        if isinstance(artifact.get("mfu"), (int, float)):
            row["objective"], row["objective_key"] = (
                float(artifact["mfu"]), "mfu")
        else:
            row["objective"], row["objective_key"] = (
                float(artifact["value"]), "tasks_per_sec_per_chip")
        return row
    tail = (out + "\n" + err)[-8000:]
    row["outcome"] = classify_failure(rc, tail)
    if artifact and artifact.get("error"):
        row["error"] = str(artifact["error"])[:500]
    else:
        row["error"] = tail.strip().splitlines()[-1][:500] if \
            tail.strip() else f"returncode {rc}"
    return row


def run_parity(winner_cfg_path: str, base_cfg_path: str, *,
               parity_py: str, compiler_options: Dict[str, str],
               steps: int = 2, tolerance: float = 5e-3,
               timeout_s: float = 600.0,
               env: Optional[Dict[str, str]] = None,
               device: Optional[str] = None) -> Dict[str, Any]:
    """The parity gate leg (``scripts/torch_tune_parity.py`` as a child,
    isolated like a trial); returns its verdict, or a failure."""
    cmd = [sys.executable, parity_py,
           "--config", winner_cfg_path, "--base-config", base_cfg_path,
           "--steps", str(steps), "--tolerance", str(tolerance)]
    if device:
        cmd += ["--device", device]
    for k, v in sorted(compiler_options.items()):
        cmd += ["--backend-option", f"{k}={v}"]
    out, err, rc = run_group(cmd, timeout_s=timeout_s, env=env)
    if rc is None:
        return {"metric": "tune_parity", "pass": False, "mode": "fail",
                "error": f"parity probe timed out after {timeout_s}s"}
    verdict = last_json_line(out)
    if verdict and verdict.get("metric") == "tune_parity":
        return verdict
    return {"metric": "tune_parity", "pass": False, "mode": "fail",
            "error": (out + err)[-500:] or f"returncode {rc}"}


def run_accuracy_gate(config_path: str, *, gate_py: str,
                      overrides: Optional[List[str]] = None,
                      min_accuracy: Optional[float] = None,
                      timeout_s: float = 0.0,
                      env: Optional[Dict[str, str]] = None,
                      device: Optional[str] = None) -> Dict[str, Any]:
    """``scripts/torch_accuracy_gate.py`` as a gate leg (the full
    schedule on real data: the driver offers a recorded skip). Exit 2 is
    "ran, below the gate"; both verdicts return the gate's own JSON."""
    cmd = [sys.executable, gate_py, "--config", config_path]
    if min_accuracy is not None:
        cmd += ["--min-accuracy", str(min_accuracy)]
    if device:
        cmd += ["--device", device]
    cmd += list(overrides or [])
    out, err, rc = run_group(cmd, timeout_s=timeout_s or None, env=env)
    if rc is None:
        return {"gate": "accuracy", "pass": False,
                "error": f"accuracy gate timed out after {timeout_s}s"}
    verdict = last_json_line(out)
    if verdict and verdict.get("gate") == "accuracy":
        return verdict
    return {"gate": "accuracy", "pass": False,
            "error": (out + err)[-500:] or f"returncode {rc}"}
