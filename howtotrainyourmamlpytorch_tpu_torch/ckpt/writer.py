"""The checkpoint save facade of the experiment loop (the port's copy of
the JAX package's ``ckpt/writer.py § CheckpointWriter``, synchronous path
only).

Epoch saves and the preemption/rewind snapshot go through here; loads,
bookkeeping queries and quarantine stay on the ``CheckpointManager``.
With ``publish`` each committed epoch checkpoint is published to the
model registry (``REGISTRY.json`` next to the checkpoints), as the JAX
package does by default (``ckpt_publish``). Saves and publishes count
into the installed telemetry registry under the JAX names (:data:`SAVES`,
:data:`SAVE_SECONDS`, :data:`PUBLISHED`). The asynchronous
double-buffered writer (``ckpt_async=1``) is not ported yet.
"""

from __future__ import annotations

import time
import warnings
from typing import Optional

from howtotrainyourmamlpytorch_tpu_torch.ckpt.registry import ModelRegistry
from howtotrainyourmamlpytorch_tpu_torch.resilience import counter_inc

SAVES = "ckpt/saves"
SAVE_SECONDS = "ckpt/save_seconds"
BLOCKED_SECONDS = "ckpt/blocked_seconds"
SKIPPED_SAVES = "ckpt/skipped_saves"
PUBLISHED = "ckpt/published"


class CheckpointWriter:
    """Wraps a ``CheckpointManager``'s save path; records the last save's
    size and duration (``last_save_bytes``, ``last_save_seconds``)."""

    def __init__(self, manager, *, async_saves: bool = False,
                 publish: bool = False):
        if async_saves:
            raise NotImplementedError(
                "ckpt_async=1 (the background double-buffered checkpoint "
                "writer) is not ported yet (ROADMAP.md, Queue 1: "
                "resilience/ckpt slice)")
        self.manager = manager
        self.publish = bool(publish)
        self._registry: Optional[ModelRegistry] = None
        self.last_save_bytes = 0
        self.last_save_seconds = 0.0

    def save(self, state, epoch: int, current_iter: int,
             val_acc: float) -> None:
        """Epoch save, synchronous; then the registry publish."""
        t0 = time.perf_counter()
        self.last_save_bytes = self.manager.save(state, epoch, current_iter,
                                                 val_acc)
        self.last_save_seconds = time.perf_counter() - t0
        counter_inc(SAVES)
        counter_inc(SAVE_SECONDS, self.last_save_seconds)
        self._maybe_publish(epoch, current_iter, val_acc)

    def save_latest(self, state, current_iter: int) -> None:
        """The preemption/rewind snapshot (``train_model_latest`` only)."""
        self.manager.save_latest(state, current_iter)

    def _maybe_publish(self, epoch: int, current_iter: int,
                       val_acc: float) -> None:
        """Publish the just-committed epoch checkpoint and retire live
        versions whose files retention has pruned. Best-effort: a failed
        publish never fails training."""
        if not self.publish:
            return
        try:
            if self._registry is None:
                self._registry = ModelRegistry(self.manager.directory)
            reg = self._registry.reload()
            reg.publish(tag=str(int(epoch)), epoch=int(epoch),
                        iteration=int(current_iter), val_acc=float(val_acc),
                        fingerprint=self.manager.fingerprint(int(epoch)))
            reg.retire_missing(self.manager.directory)
            counter_inc(PUBLISHED)
        except Exception as e:  # noqa: BLE001
            warnings.warn(f"model-registry publish failed for epoch "
                          f"{epoch} ({type(e).__name__}: {e}); serving "
                          f"keeps polling the previous version")
