"""Adapted-params LRU cache keyed by a support-set fingerprint.

The port's own copy of the JAX package's ``serve/cache.py`` (numpy only);
the port imports nothing of that package.

Few-shot serving traffic repeats tasks: the same user/tenant sends the
same support set with fresh queries (the "adapt once, predict many"
pattern). Adaptation is the expensive half of a request (K inner
forward+grad steps vs one predict forward), so a repeat task should skip
it entirely — the cache stores the adapted fast params + norm state per
support-set fingerprint and the engine goes straight to predict on a
hit (asserted by a counter in tests/test_serve.py, the tier-1
acceptance check).

The fingerprint is a sha256 over the support arrays' CONTENT (bytes +
shape + dtype, C-contiguous so memory layout never aliases two equal
sets apart) plus the adaptation geometry (step count) and a caller
context string (the engine passes the checkpoint fingerprint: a cache
entry must die with the weights that produced it).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Optional

import numpy as np


def support_fingerprint(support_x, support_y, num_steps: int,
                        context: str = "") -> str:
    """Content fingerprint of one support set + adaptation geometry."""
    h = hashlib.sha256()
    for arr in (support_x, support_y):
        arr = np.ascontiguousarray(arr)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    h.update(f"steps={num_steps};{context}".encode())
    return h.hexdigest()


def entry_nbytes(value: Any) -> int:
    """Approximate in-memory size of one cache entry: the sum of array
    ``nbytes`` over the entry's leaves (nested dicts/lists/tuples —
    NamedTuples included — walked without jax). Approximate by design:
    container overhead and replicated-device copies are ignored; the
    number exists to feed the ``serve/cache_bytes`` autoscale gauge,
    not an allocator. Fail-soft: anything unwalkable counts 0."""
    try:
        if isinstance(value, dict):
            return sum(entry_nbytes(v) for v in value.values())
        if isinstance(value, (list, tuple)):
            return sum(entry_nbytes(v) for v in value)
        return int(getattr(value, "nbytes", 0) or 0)
    except Exception:  # noqa: BLE001 — sizing must never break caching
        return 0


class AdaptedParamsLRU:
    """Thread-safe LRU of fingerprint -> adapted (fast params, bn state).

    ``get`` refreshes recency; ``put`` evicts the least-recently-used
    entry past ``capacity``. Capacity 0 disables caching (every get
    misses, puts are dropped) — the engine stays cache-agnostic.
    Hit/miss/eviction counts and the approximate resident byte total
    (``approx_bytes``, maintained put/evict/clear-incrementally via
    :func:`entry_nbytes`) are plain attributes; the engine mirrors them
    into telemetry counters/gauges after each step — eviction churn and
    resident bytes are the L1 half of the fleet autoscale signal.
    """

    def __init__(self, capacity: int):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = int(capacity)
        self._entries: "OrderedDict[str, Any]" = OrderedDict()
        self._nbytes: dict = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.approx_bytes = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                return self._entries[key]
            self.misses += 1
            return None

    def put(self, key: str, value: Any) -> None:
        if self.capacity == 0:
            return
        nb = entry_nbytes(value)
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.approx_bytes -= self._nbytes.get(key, 0)
            self._entries[key] = value
            self._nbytes[key] = nb
            self.approx_bytes += nb
            while len(self._entries) > self.capacity:
                evicted, _ = self._entries.popitem(last=False)
                self.approx_bytes -= self._nbytes.pop(evicted, 0)
                self.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._nbytes.clear()
            self.approx_bytes = 0
