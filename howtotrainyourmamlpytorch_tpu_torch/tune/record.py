"""Autotune trial ledger and winner record of the port: the sweep's
durable state (the port's copy of the JAX package's ``tune/record.py``,
with its schema strings, so either package's tools read the other's
files).

``TUNE.json`` is the crash-recoverable ledger (``ckpt/manifest.py §
atomic_write_json``: tmp + fsync + rename). Each trial id moves
``pending -> running -> ok|failed``; re-running the driver against the
same sweep dir resumes: terminal trials are never re-run, and a trial
stranded ``running`` (the driver died mid-subprocess) re-runs with its
attempt count bumped.

``TUNED.json`` is the adoption record: the backend options
(``xla_compiler_options``) and structural overrides of a winner that
cleared the gates (:func:`decide_adoption`). A rejected sweep still
writes it, with ``adopted: false`` and the refusing gate.

Stdlib only: the torch-free driver imports it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from howtotrainyourmamlpytorch_tpu_torch.ckpt.manifest import (
    atomic_write_json)

LEDGER_SCHEMA = "maml_tpu_tune_ledger_v1"
TUNED_SCHEMA = "maml_tpu_tuned_v1"
LEDGER_FILE = "TUNE.json"
TUNED_FILE = "TUNED.json"

# Terminal trial states — a resumed sweep skips these, whatever the
# outcome: a crashed/timed-out/OOM trial is a COUNTED failure, not a
# retry candidate (re-running a flag that aborts the process would
# re-abort it; the operator edits the space instead).
TERMINAL = ("ok", "failed")


class TrialLedger:
    """One sweep directory's ``TUNE.json``."""

    def __init__(self, sweep_dir: str):
        self.sweep_dir = sweep_dir
        self.path = os.path.join(sweep_dir, LEDGER_FILE)
        self.doc: Dict[str, Any] = {"schema": LEDGER_SCHEMA,
                                    "created": time.time(),
                                    "trials": {}}
        try:
            with open(self.path) as f:
                loaded = json.load(f)
            if (isinstance(loaded, dict)
                    and loaded.get("schema") == LEDGER_SCHEMA
                    and isinstance(loaded.get("trials"), dict)):
                self.doc = loaded
        except FileNotFoundError:
            pass
        except (OSError, ValueError):
            # A torn/corrupt ledger (should be impossible under the
            # atomic-rewrite idiom; a hand-edit is not) restarts the
            # sweep rather than crashing it — but never silently: the
            # damaged file is kept aside for forensics.
            try:
                os.replace(self.path, self.path + ".corrupt")
            except OSError:
                pass

    # -- state transitions (each an atomic whole-file rewrite) ----------
    def _flush(self) -> None:
        os.makedirs(self.sweep_dir, exist_ok=True)
        atomic_write_json(self.path, self.doc)

    def begin(self, trial_id: str, assignment: Dict[str, Any]) -> None:
        rec = self.doc["trials"].get(trial_id) or {
            "assignment": assignment, "attempt": 0}
        rec.update(status="running", attempt=int(rec["attempt"]) + 1,
                   started=time.time())
        self.doc["trials"][trial_id] = rec
        self._flush()

    def complete(self, trial_id: str, result: Dict[str, Any]) -> None:
        rec = self.doc["trials"].setdefault(trial_id, {"attempt": 1})
        status = "ok" if result.get("outcome") == "ok" else "failed"
        rec.update(result, status=status, finished=time.time())
        self._flush()

    def ensure_workload(self, workload_key: str) -> None:
        """Bind this ledger to one base workload (a content hash of the
        base config). Trial ids hash only the AXIS assignment, so
        resuming a sweep dir against a different --config would
        silently reuse cross-workload results and write a TUNED.json
        whose flag set was never validated on the workload it names —
        refuse instead."""
        existing = self.doc.get("workload_key")
        if existing is None:
            self.doc["workload_key"] = str(workload_key)
            self._flush()
        elif existing != str(workload_key):
            raise ValueError(
                f"sweep dir {self.sweep_dir!r} belongs to workload "
                f"{existing[:16]}… but this run's base config hashes "
                f"to {str(workload_key)[:16]}…; use a fresh --out (a "
                f"resumed ledger's trials were measured on the OTHER "
                f"workload)")

    def record_gates(self, trial_id: str,
                     parity: Optional[Dict[str, Any]],
                     accuracy: Optional[Dict[str, Any]],
                     params: Optional[Dict[str, Any]] = None) -> None:
        """Persist the winner-gate verdicts keyed to the candidate
        trial AND the gate parameters they were produced under. The
        gates are the EXPENSIVE legs (the accuracy gate trains the
        full schedule on real data — hours) and the ledger's
        kill-and-resume contract must cover them too: a resumed driver
        whose candidate is unchanged reuses these instead of re-paying
        the subprocesses — but only at the SAME parameters: a stored
        tolerance-5e-3 pass must never satisfy a re-run that tightened
        the gate to 1e-4."""
        self.doc["gates"] = {"trial_id": trial_id, "parity": parity,
                             "accuracy": accuracy,
                             "params": dict(params or {}),
                             "recorded": time.time()}
        self._flush()

    def gates_for(self, trial_id: str,
                  params: Optional[Dict[str, Any]] = None
                  ) -> Optional[Dict[str, Any]]:
        g = self.doc.get("gates")
        if not (isinstance(g, dict) and g.get("trial_id") == trial_id):
            return None
        if params is not None and g.get("params") != dict(params):
            return None
        return g

    # -- queries --------------------------------------------------------
    def record(self, trial_id: str) -> Optional[Dict[str, Any]]:
        return self.doc["trials"].get(trial_id)

    def completed_ids(self) -> List[str]:
        return [tid for tid, rec in self.doc["trials"].items()
                if rec.get("status") in TERMINAL]

    def interrupted_ids(self) -> List[str]:
        """Trials stranded ``running`` by a killed driver — re-run on
        resume (their attempt bump records the interruption)."""
        return [tid for tid, rec in self.doc["trials"].items()
                if rec.get("status") == "running"]

    def counts(self) -> Dict[str, int]:
        c = {"ok": 0, "failed": 0, "running": 0}
        outcomes: Dict[str, int] = {}
        for rec in self.doc["trials"].values():
            s = rec.get("status")
            if s in c:
                c[s] += 1
            o = rec.get("outcome")
            if s == "failed" and o:
                outcomes[o] = outcomes.get(o, 0) + 1
        c["failed_by_outcome"] = outcomes
        return c

    def best(self, objective_key: Optional[str] = None
             ) -> Optional[Dict[str, Any]]:
        """Highest-objective ``ok`` trial (ties: first in insertion
        order — the enumeration order, so the baseline wins a dead
        heat and a no-op 'winner' is never adopted over it).
        ``objective_key`` restricts the ranking to trials measured in
        that unit: a sweep normally scores every trial in mfu OR in
        tasks/s, but one trial whose flops walk failed falls back to
        tasks/s, and a raw max would crown its rate over everyone
        else's utilization. Callers anchor on the baseline's key."""
        best_rec = None
        for tid, rec in self.doc["trials"].items():
            if rec.get("status") != "ok":
                continue
            if (objective_key is not None
                    and rec.get("objective_key") != objective_key):
                continue
            v = rec.get("objective")
            if not isinstance(v, (int, float)):
                continue
            if best_rec is None or v > best_rec["objective"]:
                best_rec = {**rec, "trial_id": tid}
        return best_rec


def decide_adoption(best: Optional[Dict[str, Any]],
                    baseline: Optional[Dict[str, Any]],
                    parity: Optional[Dict[str, Any]],
                    accuracy: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """The winner gate, as one pure decision: ``{"adopted": bool,
    "reason": str}``. Refusal reasons in priority order — no winner at
    all, no baseline to beat, no improvement over baseline, parity gate
    failed/missing, accuracy gate failed/missing. The accuracy gate may
    be explicitly SKIPPED (``{"skipped": reason}``) — recorded verbatim
    in the verdict, never treated as a pass silently: adoption then
    says so in its reason. A parity gate can never be skipped: a flag
    set that changes the program's results is exactly what this
    subsystem must not adopt."""
    if best is None:
        return {"adopted": False, "reason": "no successful trial"}
    if baseline is None or not isinstance(
            baseline.get("objective"), (int, float)):
        return {"adopted": False,
                "reason": "baseline trial missing or failed — nothing "
                          "to compare the winner against"}
    if best.get("trial_id") == baseline.get("trial_id"):
        return {"adopted": False,
                "reason": "baseline is the best point — nothing to "
                          "adopt"}
    if best.get("objective_key") != baseline.get("objective_key"):
        return {"adopted": False,
                "reason": f"objective units differ: winner "
                          f"{best.get('objective_key')} vs baseline "
                          f"{baseline.get('objective_key')} — an "
                          f"apples-to-oranges compare can never adopt"}
    if best["objective"] <= baseline["objective"]:
        return {"adopted": False,
                "reason": f"winner objective {best['objective']} does "
                          f"not beat baseline {baseline['objective']}"}
    if not (isinstance(parity, dict) and parity.get("pass") is True):
        why = (parity or {}).get("mode") or (parity or {}).get("error") \
            or "not run"
        return {"adopted": False, "reason": f"parity gate: {why}"}
    if isinstance(accuracy, dict) and accuracy.get("skipped"):
        return {"adopted": True,
                "reason": f"parity passed ({parity.get('mode')}); "
                          f"accuracy gate SKIPPED: "
                          f"{accuracy['skipped']}"}
    if not (isinstance(accuracy, dict) and accuracy.get("pass") is True):
        why = (accuracy or {}).get("error") or "not run"
        return {"adopted": False, "reason": f"accuracy gate: {why}"}
    return {"adopted": True,
            "reason": f"parity passed ({parity.get('mode')}); accuracy "
                      f"gate passed"}


def write_tuned(sweep_dir: str, doc: Dict[str, Any]) -> str:
    path = os.path.join(sweep_dir, TUNED_FILE)
    atomic_write_json(path, {"schema": TUNED_SCHEMA,
                             "written": time.time(), **doc})
    return path


def read_tuned(path: str) -> Dict[str, Any]:
    """Load a TUNED.json; raises ValueError on a non-TUNED file or a
    record whose verdict was ``adopted: false`` — a rejected flag set
    must be applied deliberately (--backend-option), never by pointing
    a launcher at the refusal record."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("schema") != TUNED_SCHEMA:
        raise ValueError(f"{path!r} is not a {TUNED_SCHEMA} record")
    if not doc.get("adopted"):
        raise ValueError(
            f"{path!r} records adopted=false "
            f"({doc.get('reason', 'no reason recorded')}); refusing to "
            f"apply a rejected flag set implicitly")
    return doc
