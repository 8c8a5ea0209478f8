"""Structured event log and step timer (the port's copy of the JAX
package's ``utils/tracing.py`` § ``JsonlLogger``, ``StepTimer``).

* :class:`JsonlLogger` — the experiment's append-only ``events.jsonl``:
  one JSON object per line with ``ts`` and ``event``; NaN/Inf become
  null, and a size cap rotates the live file into one spare.
* :class:`StepTimer` — host-side step intervals with nearest-rank
  p50/p95, never synchronizing the device itself.

Device tracing (``profile_trace``) waits for the telemetry slice
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence


class JsonlLogger:
    """Append-only JSONL event log; ``max_bytes > 0`` rotates the live
    file to ``path.1`` (one spare) once a write pushes it past the cap."""

    def __init__(self, path: str, max_bytes: int = 0):
        self.path = path
        self.max_bytes = int(max_bytes)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    @staticmethod
    def _coerce(value: Any) -> Any:
        if isinstance(value, float):
            # Bare NaN/Infinity tokens are not JSON: null is.
            return value if math.isfinite(value) else None
        if isinstance(value, (str, int, bool)) or value is None:
            return value
        if isinstance(value, dict):
            return {k: JsonlLogger._coerce(v) for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return [JsonlLogger._coerce(v) for v in value]
        if hasattr(value, "item"):  # numpy / torch scalar
            try:
                item = value.item()
                if isinstance(item, (int, float, bool, str)):
                    return JsonlLogger._coerce(item)
            except (TypeError, ValueError, RuntimeError):
                pass
        return str(value)

    def log(self, event: str, **payload: Any) -> Dict[str, Any]:
        row = {"ts": time.time(), "event": event,
               **{k: self._coerce(v) for k, v in payload.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
            size = f.tell()
        if self.max_bytes > 0 and size > self.max_bytes:
            try:
                os.replace(self.path, self.path + ".1")
            except OSError:
                pass  # rotation is hygiene, never a lost event
        return row


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def nearest_rank(sorted_values: Sequence[float], q: float) -> float:
    """Nearest-rank quantile of an ascending-sorted sequence: the
    ``ceil(q*n)``-th smallest value (1-based)."""
    if not sorted_values:
        raise ValueError("nearest_rank of an empty sequence")
    if not 0 < q <= 1:
        raise ValueError(f"quantile {q} outside (0, 1]")
    return sorted_values[max(0, math.ceil(q * len(sorted_values)) - 1)]


class StepTimer:
    """Wall-clock stats over a window of step intervals: ``tick()`` once per
    completed step; ``summary(tasks_per_step)`` yields mean/p50/p95 step
    seconds and tasks/s (one device: per chip is the same)."""

    def __init__(self) -> None:
        self._durations: List[float] = []
        self._last: Optional[float] = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._durations.append(now - self._last)
        self._last = now

    def summary(self, tasks_per_step: int) -> Dict[str, float]:
        if not self._durations:
            return {}
        d = sorted(self._durations)
        n, total = len(d), sum(d)
        return {
            "steps": n,
            "mean_step_seconds": total / n,
            "p50_step_seconds": nearest_rank(d, 0.5),
            "p95_step_seconds": nearest_rank(d, 0.95),
            "meta_tasks_per_sec": tasks_per_step * n / total,
            "meta_tasks_per_sec_per_chip": tasks_per_step * n / total,
        }
