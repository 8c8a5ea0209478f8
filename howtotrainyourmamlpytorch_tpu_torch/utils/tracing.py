"""Structured event log, step timer and device traces (the port's
counterpart of the JAX package's ``utils/tracing.py``).

* :class:`JsonlLogger` — the experiment's append-only ``events.jsonl``:
  one JSON object per line with ``ts`` and ``event``; NaN/Inf become
  null, and a size cap rotates the live file into one spare
  (:func:`read_jsonl_rotated` reads both, oldest first).
* :class:`StepTimer` — host-side step intervals with nearest-rank
  p50/p95, never synchronizing the device itself.
* :func:`profile_trace` — ``torch.profiler`` around a block, written as
  a Chrome trace (``profile_dir``, ``profile_epoch``); fail-soft.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
import warnings
from typing import Any, Dict, Iterator, List, Optional, Sequence


class JsonlLogger:
    """Append-only JSONL event log; ``max_bytes > 0`` rotates the live
    file to ``path.1`` (one spare) once a write pushes it past the cap.
    ``enabled=False`` (a process other than 0) keeps the logger callable
    but writes nothing."""

    def __init__(self, path: str, max_bytes: int = 0,
                 enabled: bool = True):
        self.path = path
        self.max_bytes = int(max_bytes)
        self.enabled = enabled
        if enabled:
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
        if not self.enabled:
            return row
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
            size = f.tell()
        if self.max_bytes > 0 and size > self.max_bytes:
            try:
                os.replace(self.path, rotated_path(self.path))
            except OSError:
                pass  # rotation is hygiene, never a lost event
        return row


def rotated_path(path: str) -> str:
    """The one spare segment a size-capped log rotates into."""
    return path + ".1"


def read_jsonl(path: str,
               tail: Optional[int] = None) -> List[Dict[str, Any]]:
    """Parse a JSONL file; ``tail`` parses only the last N lines."""
    with open(path) as f:
        lines = f.readlines()
    if tail is not None:
        lines = lines[-tail:]
    return [json.loads(line) for line in lines if line.strip()]


def read_jsonl_rotated(path: str,
                       tail: Optional[int] = None) -> List[Dict[str, Any]]:
    """:func:`read_jsonl` over the rotated spare then the live file, so
    rows come back in write order; a missing segment contributes
    nothing."""
    rows: List[Dict[str, Any]] = []
    for segment in (rotated_path(path), path):
        try:
            rows += read_jsonl(segment)
        except OSError:
            continue
    if tail is not None:
        rows = rows[-tail:]
    return rows


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

    @property
    def durations(self) -> List[float]:
        """Per-step intervals (a copy), for registry histograms."""
        return list(self._durations)

    def summary(self, tasks_per_step: int,
                n_devices: int = 1) -> Dict[str, float]:
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
            "meta_tasks_per_sec_per_chip": (tasks_per_step * n / total
                                            / n_devices),
        }


@contextlib.contextmanager
def profile_trace(profile_dir: Optional[str],
                  tag: str = "trace") -> Iterator[None]:
    """Trace the block with ``torch.profiler`` (host ops and, on a card,
    its kernels) and write ``profile_dir/tag/trace.json``, a Chrome trace
    (Perfetto, ``chrome://tracing``). No-op when ``profile_dir`` is
    falsy. Fail-soft: a profiler that cannot start or export warns, and
    the block runs anyway."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = os.path.join(profile_dir, tag)
    os.makedirs(out, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.__enter__()
    except Exception as e:  # noqa: BLE001 — diagnostics never kill training
        warnings.warn(f"profiling unavailable ({e}); continuing untraced")
        yield
        return
    try:
        yield
    finally:
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(out, "trace.json"))
        except Exception as e:  # noqa: BLE001
            warnings.warn(f"profiler stop/export failed ({e})")
