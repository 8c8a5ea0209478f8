"""Metrics registry: counters, gauges, histograms → JSONL + Prometheus
(the port's copy of the JAX package's ``telemetry/registry.py``: the same
calls give byte-equal ``metrics.prom`` text and JSONL snapshots).

The observability layer's single source of truth for numeric run state.
The experiment loop, the loader, the checkpoint writer and the retry
paths record here first; the registry then fans out to two consumers:

* the append-only ``events.jsonl`` stream (:class:`JsonlLogger`),
  consumed by the JAX package's ``scripts/telemetry_report.py``;
* a Prometheus *textfile* snapshot (``metrics.prom``), the standard
  node-exporter sidecar format, so a fleet scraper sees the same numbers
  without parsing JSONL.

Histograms use FIXED exponential buckets (not adaptive): bucket layout
must be identical across hosts and across the whole run for per-host and
per-epoch snapshots to be mergeable by simple addition.

Thread-safety: the registry's name→metric map has one lock; each metric
carries its own lock for value mutation (no cross-metric atomicity — a
snapshot may observe metric A updated and B not yet). The experiment
loop and the prefetch worker record concurrently.
"""

from __future__ import annotations

import bisect
import math
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import JsonlLogger


def exponential_buckets(start: float = 1e-4, factor: float = 2.0,
                        count: int = 25) -> Tuple[float, ...]:
    """``count`` exponentially-spaced upper bounds starting at ``start``.

    The default (1e-4 .. ~1678s at factor 2) spans sub-ms host ops up to
    half-hour operations, the JAX package's layout (hosts and snapshots
    merge by addition only under identical buckets). Values beyond the
    last bound land in the +Inf overflow slot, whose quantile reports
    saturate at the top bound — pick wider buckets if that matters.
    """
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError(f"invalid bucket spec ({start}, {factor}, {count})")
    return tuple(start * factor ** i for i in range(count))


class Counter:
    """Monotonically-increasing total (count or seconds)."""

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc({amount}))")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-written value (a level, not a total)."""

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._value: Optional[float] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> Optional[float]:
        return self._value


class Histogram:
    """Fixed-bucket histogram (exponential by default).

    ``observe`` is O(log buckets); ``quantile`` returns the upper bound of
    the bucket containing the nearest-rank observation — an upper-bound
    estimate whose error is bounded by the bucket factor, which is the
    standard Prometheus-histogram trade (mergeable across hosts/epochs
    beats exact order statistics for always-on telemetry; exact step-time
    quantiles for a single window stay available via
    ``utils.tracing.StepTimer``).
    """

    def __init__(self, name: str, lock: threading.Lock,
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self._lock = lock
        bounds = tuple(sorted(buckets)) if buckets else exponential_buckets()
        if len(bounds) != len(set(bounds)):
            raise ValueError(f"histogram {name}: duplicate bucket bounds")
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # final slot = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        if not math.isfinite(value):
            return  # non-finite observations corrupt sums; drop, fail-soft
        idx = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> Optional[float]:
        """Upper bound of the bucket holding the nearest-rank(q) sample.
        Samples in the +Inf overflow bucket report the top FINITE bound
        (a saturated under-estimate — size buckets to the workload)."""
        if not 0 < q <= 1:
            raise ValueError(f"quantile {q} outside (0, 1]")
        with self._lock:
            n = self._count
            if n == 0:
                return None
            rank = max(1, math.ceil(q * n))  # nearest-rank, 1-based
            seen = 0
            for idx, c in enumerate(self._counts):
                seen += c
                if seen >= rank:
                    return (self.bounds[idx] if idx < len(self.bounds)
                            else self.bounds[-1])
        return self.bounds[-1]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counts = list(self._counts)
            total, count = self._sum, self._count
        return {"count": count, "sum": total,
                "p50": self.quantile(0.5) if count else None,
                "p95": self.quantile(0.95) if count else None,
                "bucket_counts": counts}


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    clean = _NAME_RE.sub("_", name)
    return clean if not clean[:1].isdigit() else "_" + clean


class MetricsRegistry:
    """Get-or-create metric store; one per process.

    Names are free-form strings (``/``-separated by convention, e.g.
    ``ckpt/save_seconds``); Prometheus output sanitizes them. Re-requesting
    a name with a different metric type is a programming error and raises.
    """

    def __init__(self) -> None:
        # RLock, not Lock: a signal handler may snapshot the registry
        # while it interrupts the main thread inside a registry
        # operation; per-metric locks are reentrant for the same reason.
        self._lock = threading.RLock()
        self._metrics: Dict[str, Any] = {}

    def _get_or_create(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                # Each metric gets its OWN lock (not the registry's):
                # hot-path observes never contend with get-or-create,
                # and there is deliberately no cross-metric atomicity.
                m = self._metrics[name] = cls(name, threading.RLock(), *args)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(name, Histogram, buckets)

    def metrics(self) -> List[Tuple[str, Any]]:
        with self._lock:
            return sorted(self._metrics.items())

    # -- consumers --------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Flat JSON-serializable view: counters/gauges → value,
        histograms → {count, sum, p50, p95}."""
        out: Dict[str, Any] = {}
        for name, m in self.metrics():
            if isinstance(m, Histogram):
                snap = m.snapshot()
                snap.pop("bucket_counts")  # bucket detail is Prometheus-only
                out[name] = snap
            else:
                out[name] = m.value
        return out

    def flush_jsonl(self, logger: JsonlLogger, event: str = "metrics",
                    **extra: Any) -> Dict[str, Any]:
        """One JSONL row holding the full snapshot."""
        return logger.log(event, metrics=self.snapshot(), **extra)

    def write_prometheus(self, path: str) -> None:
        """Prometheus textfile-collector snapshot (atomic rename — a
        scraper never sees a torn file)."""
        lines: List[str] = []
        for name, m in self.metrics():
            pname = _prom_name(name)
            if isinstance(m, Counter):
                lines += [f"# TYPE {pname} counter", f"{pname} {m.value}"]
            elif isinstance(m, Gauge):
                if m.value is not None:
                    lines += [f"# TYPE {pname} gauge", f"{pname} {m.value}"]
            else:
                snap = m.snapshot()
                lines.append(f"# TYPE {pname} histogram")
                cum = 0
                for bound, c in zip(m.bounds, snap["bucket_counts"]):
                    cum += c
                    lines.append(f'{pname}_bucket{{le="{bound}"}} {cum}')
                cum += snap["bucket_counts"][-1]
                lines.append(f'{pname}_bucket{{le="+Inf"}} {cum}')
                lines += [f"{pname}_sum {snap['sum']}",
                          f"{pname}_count {snap['count']}"]
        lines.append(f"# written {time.time()}")
        tmp = f"{path}.tmp.{os.getpid()}"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            f.write("\n".join(lines) + "\n")
        os.replace(tmp, path)
