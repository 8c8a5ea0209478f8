"""Resilience pieces the trainer uses: retry/backoff for storage IO and the
divergence guard (the port's own copies of the JAX package's
``resilience/retry.py`` and ``resilience/guard.py``).

Metrics: these modules, the checkpoint writer and the loader count into
one process-wide registry reference (:func:`set_registry`), installed by
the ``ExperimentBuilder`` that owns the run's telemetry (the last
installer wins: one live run per process). Counters are no-ops until a
registry is installed.

Not ported yet (ROADMAP.md, Queue 1: resilience/ckpt slice): fault
injection, the watchdog and flight recorder, the pod fault domain.
"""

from __future__ import annotations

from typing import Any, Optional

# Exit code for "preempted, checkpointed, restart me" — EX_TEMPFAIL, so
# schedulers/wrappers can distinguish a clean preemption (resubmit with
# continue_from_epoch='latest') from success (0) and real failure (1).
EXIT_PREEMPTED = 75

_registry: Optional[Any] = None  # duck-typed telemetry.MetricsRegistry


def set_registry(registry: Optional[Any]) -> Optional[Any]:
    """Install the registry resilience counters record into; returns the
    previous one (callers with a scoped lifetime restore it)."""
    global _registry
    prev = _registry
    _registry = registry
    return prev


def counter_inc(name: str, amount: float = 1.0) -> None:
    """Increment ``name`` on the installed registry; no-op without one."""
    reg = _registry
    if reg is not None:
        reg.counter(name).inc(amount)


from howtotrainyourmamlpytorch_tpu_torch.resilience.guard import (  # noqa: E402
    DivergenceGuard)
from howtotrainyourmamlpytorch_tpu_torch.resilience.retry import (  # noqa: E402
    backoff_delay, retry_io)

__all__ = ["EXIT_PREEMPTED", "DivergenceGuard", "backoff_delay",
           "counter_inc", "retry_io", "set_registry"]
