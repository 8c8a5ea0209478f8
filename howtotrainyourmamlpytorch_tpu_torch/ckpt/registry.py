"""Model registry, publish side (the port's copy of the JAX package's
``ckpt/registry.py § ModelRegistry`` as far as training uses it).

Training publishes each COMMITTED epoch checkpoint to ``REGISTRY.json``
next to the checkpoints, with its validation accuracy and the file's
content fingerprint; serving processes poll it. Same schema as the JAX
package's, so either package's server reads a registry the other wrote:

    {"schema": ..., "next_version": N, "versions": [
        {"version", "tag", "epoch", "iter", "val_acc", "fingerprint",
         "status": "live" | "retired" | "rolled_back", "reason",
         "published_ts"}]}

Single-writer by contract (the training process); the poller side
(``latest``, rollback) is not ported yet. Stdlib only.
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
                fingerprint: Optional[int] = None) -> Dict[str, Any]:
        """Register one committed checkpoint as a servable version."""
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
