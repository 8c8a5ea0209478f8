"""Instrumentation hooks: device memory and input-pipeline stalls (the
port's counterpart of the JAX package's ``telemetry/instruments.py``).

Each measurement is fail-soft (observability must never abort training):

* :func:`device_memory_stats` — live and peak bytes of the CUDA caching
  allocator under the JAX package's keys; ``None`` on the CPU, which the
  report prints as "unavailable" rather than a fake zero.
* :class:`FeedStallMeter` — consumer-side wait-vs-dispatch split of the
  training feed (``data/loader.py``): the fraction of loop wall-clock
  spent blocked on the next batch. A copy of the JAX class.

There is no ``CompileWatcher``: eager PyTorch compiles no executable, so
there is nothing to count. The ``telemetry`` row carries
``compile_count_total: null``, which the report prints as "unavailable".
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import torch


def device_memory_stats(device: Any = None) -> Optional[Dict[str, int]]:
    """The CUDA caching allocator's bytes on ``device`` (default: the
    current card): ``live_bytes_total`` (allocated now),
    ``live_bytes_max_device`` (the same: one device) and
    ``peak_bytes_max_device`` (``max_memory_allocated`` since the last
    peak reset). ``None`` when the device is not a CUDA device or
    reports nothing."""
    try:
        if device is not None and torch.device(device).type != "cuda":
            return None
        if not torch.cuda.is_available():
            return None
        live = int(torch.cuda.memory_allocated(device))
        peak = int(torch.cuda.max_memory_allocated(device))
        return {"live_bytes_total": live, "live_bytes_max_device": live,
                "peak_bytes_max_device": peak}
    except Exception:  # noqa: BLE001 — diagnostics never abort training
        return None


class FeedStallMeter:
    """Wait-vs-dispatch wall-clock split of a batch consumer loop.

    The loader's consumer records ``record_wait`` around its blocking
    queue get (input pipeline not ready = a stall) and
    ``record_dispatch`` for the time the consumer spent processing the
    yielded batch (the training step dispatch). The stall fraction
    ``wait / (wait + dispatch)`` is the canonical "are we input-bound"
    number. Counters are CUMULATIVE over the loader's life; per-epoch
    views subtract snapshots (:meth:`snapshot` / :func:`delta`).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.wait_seconds = 0.0
        self.dispatch_seconds = 0.0
        self.batches = 0

    def record_wait(self, seconds: float) -> None:
        with self._lock:
            self.wait_seconds += seconds
            self.batches += 1

    def record_dispatch(self, seconds: float) -> None:
        with self._lock:
            self.dispatch_seconds += seconds

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {"feed_wait_seconds": self.wait_seconds,
                    "feed_dispatch_seconds": self.dispatch_seconds,
                    "feed_batches": float(self.batches)}

    @staticmethod
    def delta(now: Dict[str, float],
              before: Optional[Dict[str, float]]) -> Dict[str, float]:
        """Per-window view between two snapshots, with the derived
        ``feed_stall_frac`` (None-safe: no time observed → frac 0.0)."""
        before = before or {}
        d = {k: now[k] - before.get(k, 0.0) for k in now}
        busy = d["feed_wait_seconds"] + d["feed_dispatch_seconds"]
        d["feed_stall_frac"] = (d["feed_wait_seconds"] / busy
                                if busy > 0 else 0.0)
        return d
