"""Model registry (the port's copy of the JAX package's
``ckpt/registry.py § ModelRegistry``).

Training publishes each COMMITTED epoch checkpoint to ``REGISTRY.json``
next to the checkpoints, with its validation accuracy and the file's
content fingerprint; serving processes poll it. Same schema as the JAX
package's, so either package's server reads a registry the other wrote:

    {"schema": ..., "next_version": N, "versions": [
        {"version", "tag", "epoch", "iter", "val_acc", "fingerprint",
         "status": "live" | "retired" | "rolled_back", "reason",
         "published_ts"}]}

Statuses: ``live`` (servable), ``retired`` (the checkpoint file fell
out of retention), ``rolled_back`` (an operator withdrew it).
``latest()`` returns the newest live version: the serving engine's
hot-swap poll. Single-writer by contract (the training process, or an
operator's ``rollback``); pollers build fresh instances and never write.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from howtotrainyourmamlpytorch_tpu_torch.ckpt.manifest import (
    atomic_write_json)

REGISTRY_FILE = "REGISTRY.json"
SCHEMA = "maml_model_registry_v1"
LIVE = "live"
RETIRED = "retired"
ROLLED_BACK = "rolled_back"


class ModelRegistry:
    """``REGISTRY.json`` in a checkpoint directory."""

    def __init__(self, directory: str):
        self.directory = directory
        self.path = os.path.join(directory, REGISTRY_FILE)
        self.versions: List[Dict[str, Any]] = []
        self.next_version = 1
        self.reload()

    def reload(self) -> "ModelRegistry":
        """Re-read from disk; damage degrades to an empty registry."""
        self.versions = []
        self.next_version = 1
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return self
        if isinstance(doc.get("versions"), list):
            self.versions = [dict(v) for v in doc["versions"]
                             if isinstance(v, dict)]
            self.next_version = int(doc.get("next_version")
                                    or len(self.versions) + 1)
        return self

    def _write(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        atomic_write_json(self.path, {
            "schema": SCHEMA,
            "next_version": self.next_version,
            "versions": self.versions,
        })

    def publish(self, *, tag, epoch: Optional[int] = None,
                iteration: int = 0, val_acc: Optional[float] = None,
                fingerprint: Optional[int] = None,
                directory: Optional[str] = None) -> Dict[str, Any]:
        """Register one committed checkpoint as a servable version
        (``directory``: where its file lives, when not beside the
        registry)."""
        rec = {
            "version": self.next_version,
            "tag": str(tag),
            "epoch": int(epoch) if epoch is not None else None,
            "iter": int(iteration),
            "val_acc": float(val_acc) if val_acc is not None else None,
            "fingerprint": (int(fingerprint) if fingerprint is not None
                            else None),
            "status": LIVE,
            "reason": None,
            "published_ts": time.time(),
        }
        if directory is not None:
            rec["directory"] = directory
        self.versions.append(rec)
        self.next_version += 1
        self._write()
        return rec

    def retire_missing(self, ckpt_directory: str) -> List[int]:
        """Mark live versions whose checkpoint file no longer exists
        (retention-pruned) as ``retired``; returns their version ids."""
        retired = []
        for rec in self.versions:
            if rec.get("status") != LIVE:
                continue
            path = os.path.join(ckpt_directory,
                                f"train_model_{rec['tag']}.ckpt")
            if not os.path.isfile(path):
                rec["status"] = RETIRED
                rec["reason"] = "checkpoint file missing"
                retired.append(rec["version"])
        if retired:
            self._write()
        return retired

    def rollback(self, version: int, reason: str = "") -> Dict[str, Any]:
        """Withdraw a published version (an operator's action); pollers
        treat it as if it had never been published."""
        rec = self.get(version)
        if rec is None:
            raise KeyError(f"no version {version} in {self.path}")
        rec["status"] = ROLLED_BACK
        rec["reason"] = reason or "rolled back"
        self._write()
        return rec

    def get(self, version: int) -> Optional[Dict[str, Any]]:
        for rec in self.versions:
            if int(rec.get("version") or -1) == int(version):
                return rec
        return None

    def latest(self) -> Optional[Dict[str, Any]]:
        """Newest live version by version number (publish order), or
        None."""
        live = [r for r in self.versions if r.get("status") == LIVE]
        return max(live, key=lambda r: int(r.get("version") or 0),
                   default=None)
