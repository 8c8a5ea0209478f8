"""Flight recorder: a bounded in-memory ring of recent run events (the
port's copy of the JAX package's ``resilience/flightrec.py``).

Post-mortem, the question is always *what was the run doing in its last
seconds?* Every phase transition, step index, checkpoint write and fault
injection appends one small dict to a lock-protected ring
(``collections.deque`` with ``maxlen``): an O(1) append, no IO. On a
watchdog trip, on the SIGTERM/SIGINT preemption path and on an unhandled
exception the ring is dumped as ``flight.jsonl`` into the crash bundle
beside the all-thread stack dump.

The recorder is installed process-wide (:func:`install`); :func:`record`
is one module-global ``None`` check when nothing is installed. Stdlib-only
at import time, like the JAX module. Events hold host values only (ints,
strings, host timestamps), never a tensor: a bundle is written from the
watchdog thread while the main thread may be blocked behind the card.
"""

from __future__ import annotations

import collections
import faulthandler
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

DEFAULT_CAPACITY = 256

# Bundle file names (the JAX package's docs/RESILIENCE.md § Hangs &
# forensics).
STACKS_FILE = "stacks.txt"
FLIGHT_FILE = "flight.jsonl"
CRASH_FILE = "crash.json"
TRACE_FILE = "trace.json"
PROFILE_FILE = "PROFILE.json"


class FlightRecorder:
    """Thread-safe bounded ring of event dicts, oldest-first.

    Each event carries ``t`` (monotonic seconds, orderable against the
    watchdog's beacon stamps), ``ts`` (unix seconds, correlatable with
    events.jsonl) and ``kind``; everything else is caller payload.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ring: "collections.deque" = collections.deque(
            maxlen=self.capacity)
        # RLock: the signal-escalation path records and dumps from a
        # handler that runs on the main thread and may interrupt it
        # inside record(); a plain lock would deadlock that path.
        self._lock = threading.RLock()

    def record(self, kind: str, **fields: Any) -> None:
        event = {"t": time.monotonic(), "ts": time.time(),
                 "kind": kind, **fields}
        with self._lock:
            self._ring.append(event)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def events(self) -> List[Dict[str, Any]]:
        """Snapshot, oldest-first (the deque drops from the left when
        full, so append order is chronological)."""
        with self._lock:
            return list(self._ring)

    def dump_jsonl(self, path: str) -> int:
        """Write the ring as JSONL, oldest-first; returns rows written."""
        events = self.events()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for event in events:
                f.write(json.dumps(event, default=str) + "\n")
        return len(events)


_recorder: Optional[FlightRecorder] = None
_profile_path: Optional[str] = None


def register_profile(path: Optional[str]) -> Optional[str]:
    """Remember the newest PROFILE.json (``telemetry/profiler.py`` cost
    cards) so crash bundles carry it; returns the previous registration
    (scoped lifetimes restore it)."""
    global _profile_path
    prev = _profile_path
    _profile_path = path
    return prev


def install(recorder: Optional[FlightRecorder]) -> Optional[FlightRecorder]:
    """Install the process-wide recorder; returns the previous one
    (scoped lifetimes restore it)."""
    global _recorder
    prev = _recorder
    _recorder = recorder
    return prev


def get() -> Optional[FlightRecorder]:
    return _recorder


def record(kind: str, **fields: Any) -> None:
    """Record into the installed recorder; one ``None`` check without."""
    rec = _recorder
    if rec is not None:
        rec.record(kind, **fields)


def write_crash_bundle(bundle_dir: str, *, reason: str,
                       info: Optional[Dict[str, Any]] = None,
                       recorder: Optional[FlightRecorder] = None,
                       registry: Optional[Any] = None,
                       process_index: int = 0) -> str:
    """Write a crash bundle: all-thread stacks + flight ring + context.

    * ``stacks.txt`` — ``faulthandler.dump_traceback(all_threads=True)``;
    * ``flight.jsonl`` — the flight ring, oldest-first (absent without a
      recorder);
    * ``trace.json`` — the same ring as a Chrome ``trace_event`` timeline
      (``telemetry/trace.py``; absent without a recorder);
    * ``PROFILE.json`` — the newest registered cost cards, if any;
    * ``crash.json`` — reason, timestamps, the caller's info and a final
      registry snapshot.

    Every write is best-effort (the process is dying; a second failure
    must not mask the first) and goes straight to the filesystem, with no
    retry layer. Nothing here touches the card.
    """
    os.makedirs(bundle_dir, exist_ok=True)
    try:
        with open(os.path.join(bundle_dir, STACKS_FILE), "w") as f:
            faulthandler.dump_traceback(file=f, all_threads=True)
    except Exception:
        pass
    rec = recorder if recorder is not None else _recorder
    if rec is not None:
        try:
            rec.dump_jsonl(os.path.join(bundle_dir, FLIGHT_FILE))
        except Exception:
            pass
        try:
            # Lazy: the telemetry package imports torch, and this module
            # stays stdlib-only at import time. A trainer has it loaded.
            from howtotrainyourmamlpytorch_tpu_torch.telemetry import (
                trace as _trace)
            _trace.write_trace(os.path.join(bundle_dir, TRACE_FILE),
                               flight=rec.events(),
                               process_index=process_index)
        except Exception:
            pass
    if _profile_path is not None:
        try:
            if os.path.isfile(_profile_path):
                shutil.copyfile(_profile_path,
                                os.path.join(bundle_dir, PROFILE_FILE))
        except Exception:
            pass
    crash: Dict[str, Any] = {"reason": reason, "ts": time.time(),
                             "pid": os.getpid(), **(info or {})}
    if registry is not None:
        try:
            crash["metrics"] = registry.snapshot()
        except Exception:
            pass
    try:
        with open(os.path.join(bundle_dir, CRASH_FILE), "w") as f:
            json.dump(crash, f, indent=2, default=str)
    except Exception:
        pass
    return bundle_dir
