"""Experiment folder scaffolding and CSV statistics (the port's copy of the
JAX package's ``utils/storage.py``; same file names and layout, so either
package resumes or reads the other's experiment directory):

    <experiment_root>/<experiment_name>/
        config.json
        saved_models/
        logs/summary_statistics.csv
        logs/test_summary.csv

The idempotent whole-file operations (JSON save/load) retry transient IO
with jittered backoff (``resilience/retry.py``); the append-style CSV
write is deliberately NOT retried — a retry after a partial append would
duplicate the row. The ``io_write``/``io_read`` fault hooks sit inside
the retried bodies (``resilience/faults.py``), so an injected fault is
recovered by the path a real mount hiccup takes.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, List

from howtotrainyourmamlpytorch_tpu_torch.ckpt.manifest import fsync_dir
from howtotrainyourmamlpytorch_tpu_torch.resilience import faults
from howtotrainyourmamlpytorch_tpu_torch.resilience.retry import retry_io


def build_experiment_folder(experiment_root: str,
                            experiment_name: str) -> Dict[str, str]:
    base = os.path.join(experiment_root, experiment_name)
    paths = {
        "base": base,
        "saved_models": os.path.join(base, "saved_models"),
        "logs": os.path.join(base, "logs"),
    }
    for p in paths.values():
        os.makedirs(p, exist_ok=True)
    return paths


def save_statistics(logs_dir: str, stats: Dict[str, Any],
                    filename: str = "summary_statistics.csv") -> str:
    """Append one row; writes the header on first use. Columns are fixed by
    the first call (extra keys in later rows would be silently misaligned,
    so they raise)."""
    path = os.path.join(logs_dir, filename)
    exists = os.path.isfile(path)
    if exists:
        with open(path, newline="") as f:
            header = next(csv.reader(f))
        if set(stats) != set(header):
            raise ValueError(
                f"stats keys {sorted(stats)} != existing columns "
                f"{sorted(header)} in {path}")
    else:
        header = list(stats)
    with open(path, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=header)
        if not exists:
            writer.writeheader()
        writer.writerow(stats)
    return path


def load_statistics(logs_dir: str,
                    filename: str = "summary_statistics.csv"
                    ) -> Dict[str, List[str]]:
    """Column-name → list of values (strings, as the reference returns)."""
    path = os.path.join(logs_dir, filename)
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return {}
    return {k: [r[k] for r in rows] for k in rows[0]}


@retry_io("json write")
def save_to_json(path: str, obj: Any) -> None:
    """tmp + fsync + rename + best-effort directory fsync: resume depends
    on state.json, so a crash must not leave it torn."""
    if faults.maybe_fire("io_write"):
        raise OSError(f"injected io_write fault ({path})")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path))


@retry_io("json read")
def load_from_json(path: str) -> Any:
    if faults.maybe_fire("io_read"):
        raise OSError(f"injected io_read fault ({path})")
    with open(path) as f:
        return json.load(f)
