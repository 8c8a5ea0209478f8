"""The checkpoint save facade of the experiment loop, with the async
double-buffered writer (the port's copy of the JAX package's
``ckpt/writer.py § CheckpointWriter``).

A save has two halves:

* **snapshot + bookkeeping** (caller thread): the state is copied to the
  host and framed (``CheckpointManager.encode``: the device-to-host copy,
  msgpack and MAMLCKP1 framing), and the in-memory bookkeeping is updated
  exactly as the synchronous path would. The bytes are those of the
  state that was passed in: later steps write other tensors.
* **file writes** (one background daemon thread with ``ckpt_async=1``):
  the framed bytes, the manifest pending → committed transition, the
  'latest' link, retention pruning and ``state.json``, through the same
  ``CheckpointManager.write_epoch_files`` the synchronous path runs, so
  the files are byte-identical.

The queue is bounded at depth 1 (one save in flight, at most one
waiting). When a third save arrives first, ``queue_policy`` decides:
``block`` (default) waits, never losing a checkpoint; ``skip`` drops the
new save's file write (``ckpt/skipped_saves``; bookkeeping still
updates, and every consumer of ``top_epochs`` filters by
``has_checkpoint``). ``ckpt_async=0`` runs both halves on the caller.

Progress contract (``resilience/watchdog.py``): the caller-thread waits
— a synchronous save, the encode's device-to-host copy, a ``block``
enqueue, ``save_latest``, ``drain`` — run under a ``ckpt`` watchdog
phase, so a save wedged on dead storage (or behind a wedged kernel)
trips ``watchdog_ckpt_timeout_s``. The background thread never stamps
the beacon (it would clobber the train loop's live phase); its activity
shows in ``ckpt_write`` flight events and the ``ckpt/*`` counters.

Preemption safety: ``save_latest`` (the SIGTERM snapshot and the rewind
rewrite) first drains the queue, then writes synchronously.

With ``publish`` each committed epoch checkpoint is published to the
model registry (``REGISTRY.json`` next to the checkpoints). Saves, blocked
seconds, skips, write errors and publishes count into the installed
telemetry registry under the JAX names (:data:`SAVES` ... :data:`PUBLISHED`).
"""

from __future__ import annotations

import json
import queue
import threading
import time
import warnings
from typing import Any, Optional

from howtotrainyourmamlpytorch_tpu_torch.ckpt.registry import ModelRegistry
from howtotrainyourmamlpytorch_tpu_torch.resilience import (counter_inc,
                                                            flightrec,
                                                            watchdog)

SAVES = "ckpt/saves"
SAVE_SECONDS = "ckpt/save_seconds"
BLOCKED_SECONDS = "ckpt/blocked_seconds"
SKIPPED_SAVES = "ckpt/skipped_saves"
WRITE_ERRORS = "ckpt/write_errors"
PUBLISHED = "ckpt/published"

QUEUE_POLICIES = ("block", "skip")


class CheckpointWriter:
    """Wraps a ``CheckpointManager``'s save path. ``last_save_bytes`` and
    ``last_save_seconds`` are the last epoch save's size and the time the
    caller spent in :meth:`save` (the whole save when synchronous; the
    snapshot, bookkeeping and enqueue when async)."""

    def __init__(self, manager: Any, *, async_saves: bool = False,
                 queue_policy: str = "block", publish: bool = False):
        if queue_policy not in QUEUE_POLICIES:
            raise ValueError(f"queue_policy must be one of "
                             f"{QUEUE_POLICIES}, got {queue_policy!r}")
        self.manager = manager
        self.async_saves = bool(async_saves)
        self.queue_policy = queue_policy
        self.publish = bool(publish)
        # Depth 1: one job in flight (popped by the worker), at most one
        # waiting.
        self._queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.last_error: Optional[str] = None
        self._registry: Optional[ModelRegistry] = None
        self.last_save_bytes = 0
        self.last_save_seconds = 0.0

    # -- worker lifecycle ------------------------------------------------
    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._worker, daemon=True, name="ckpt-writer")
                self._thread.start()

    def _worker(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:  # close() sentinel
                self._queue.task_done()
                return
            try:
                self._run_job(*job)
            except Exception as e:  # noqa: BLE001 — a failed async write
                # (after retries) must not kill the worker: later saves may
                # succeed. Loud: counter, warning, last_error; the previous
                # committed checkpoint stays current.
                self.last_error = f"{type(e).__name__}: {e}"
                counter_inc(WRITE_ERRORS)
                warnings.warn(f"async checkpoint write failed "
                              f"({self.last_error}); the previous "
                              f"committed checkpoint remains current")
            finally:
                self._queue.task_done()

    def _run_job(self, data: bytes, epoch: int, current_iter: int,
                 val_acc: float, keep, meta) -> None:
        t0 = time.perf_counter()
        flightrec.record("ckpt_write", epoch=int(epoch),
                         iter=int(current_iter), bytes=len(data))
        self.manager.write_epoch_files(data, epoch, current_iter, val_acc,
                                       keep=keep, meta=meta)
        counter_inc(SAVES)
        counter_inc(SAVE_SECONDS, time.perf_counter() - t0)
        self._maybe_publish(epoch, current_iter, val_acc)

    # -- save API ----------------------------------------------------------
    def save(self, state, epoch: int, current_iter: int,
             val_acc: float, write: bool = True) -> None:
        """Epoch save. Sync mode runs it here; async mode runs the
        snapshot and bookkeeping here and hands the files to the
        worker. ``write=False`` (a process other than 0) updates the
        bookkeeping only."""
        mgr = self.manager
        t0 = time.perf_counter()
        if not write:
            mgr.save(state, epoch, current_iter, val_acc, write=False)
            return
        if not self.async_saves:
            with watchdog.phase("ckpt", detail=int(epoch)):
                self.last_save_bytes = mgr.save(state, epoch, current_iter,
                                                val_acc)
            self.last_save_seconds = time.perf_counter() - t0
            counter_inc(SAVES)
            counter_inc(SAVE_SECONDS, self.last_save_seconds)
            self._maybe_publish(epoch, current_iter, val_acc)
            return
        # The encode's device-to-host copy is where the caller waits for
        # the card: under the ckpt deadline.
        with watchdog.phase("ckpt", detail=int(epoch)):
            data = mgr.encode(state)
        mgr.record_save(epoch, current_iter, val_acc)
        # Freeze the job's view: the retention set and the meta dict as of
        # this save (the live meta keeps changing under later epochs).
        keep = {int(e) for e in mgr.top_epochs(mgr.max_to_keep)}
        meta = json.loads(json.dumps(mgr.meta))
        self._enqueue((data, int(epoch), int(current_iter), float(val_acc),
                       keep, meta))
        self.last_save_bytes = len(data)
        self.last_save_seconds = time.perf_counter() - t0

    def save_latest(self, state, current_iter: int,
                    write: bool = True) -> None:
        """The preemption/rewind snapshot (``train_model_latest`` only):
        always synchronous, after a drain, so the caller proceeds only
        once the snapshot is durable and no epoch write is in flight."""
        self.drain()
        with watchdog.phase("ckpt", detail="latest"):
            self.manager.save_latest(state, current_iter, write=write)

    def _enqueue(self, job) -> bool:
        self._ensure_thread()
        if self.queue_policy == "skip":
            try:
                self._queue.put_nowait(job)
                return True
            except queue.Full:
                counter_inc(SKIPPED_SAVES)
                flightrec.record("ckpt_skip", epoch=job[1])
                warnings.warn(
                    f"checkpoint queue full: skipped epoch {job[1]} save "
                    f"(ckpt_queue_policy='skip'; storage is slower than the "
                    f"epoch cadence)")
                return False
        t0 = time.perf_counter()
        with watchdog.phase("ckpt", detail="blocked"):
            self._queue.put(job)
        blocked = time.perf_counter() - t0
        if blocked > 0:
            counter_inc(BLOCKED_SECONDS, blocked)
        return True

    # -- lifecycle ---------------------------------------------------------
    def drain(self) -> None:
        """Block until every enqueued write has been processed (the
        preempt path, a rewind, the test protocol and ``close``)."""
        if self._thread is None:
            return
        with watchdog.phase("ckpt", detail="drain"):
            self._queue.join()

    def close(self) -> None:
        """Drain and stop the worker thread (idempotent); a later async
        save starts a fresh thread."""
        if self._thread is None:
            return
        self.drain()
        self._queue.put(None)
        self._queue.join()
        self._thread.join(timeout=10)
        with self._lock:
            self._thread = None

    # -- registry publish --------------------------------------------------
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
            flightrec.record("ckpt_publish", epoch=int(epoch),
                             val_acc=float(val_acc))
        except Exception as e:  # noqa: BLE001
            warnings.warn(f"model-registry publish failed for epoch "
                          f"{epoch} ({type(e).__name__}: {e}); serving "
                          f"keeps polling the previous version")
