"""Resilience pieces the trainer composes (the port's copies of the JAX
package's ``resilience/`` modules):

* :mod:`~.faults` — the deterministic fault-injection registry
  (``fault_spec`` / ``MAML_FAULTS``);
* :mod:`~.retry` — jittered-exponential-backoff retry for storage IO;
* :mod:`~.guard` — host-side NaN/Inf + loss-spike detection on the outer
  loss (the experiment loop rewinds when it fires);
* :mod:`~.watchdog` — progress beacons + per-phase deadlines; a hang
  dumps all-thread stacks and the flight ring, then exits
  :data:`EXIT_HUNG`;
* :mod:`~.flightrec` — the bounded in-memory event ring dumped as
  ``flight.jsonl`` into every crash bundle;
* :mod:`~.cluster` — the pod fault domain: heartbeat leases, a lost peer
  named and :data:`EXIT_PEER_LOST`, the consensus resume;
* :mod:`~.elastic` — with ``elastic_mode=1``, the survivors' roster
  consensus and restart in place at the degraded geometry.

Metrics: these modules, the checkpoint writer and the loader count into
one process-wide registry reference (:func:`set_registry`), installed by
the ``ExperimentBuilder`` that owns the run's telemetry (the last
installer wins: one live run per process). Counters are no-ops until a
registry is installed.
"""

from __future__ import annotations

from typing import Any, Optional

# Exit code for "preempted, checkpointed, restart me" — EX_TEMPFAIL, so
# schedulers/wrappers can distinguish a clean preemption (resubmit with
# continue_from_epoch='latest') from success (0) and real failure (1).
EXIT_PREEMPTED = 75
# Exit code for "hung past a watchdog deadline; forensics dumped, resubmit
# me" — distinct from EXIT_PREEMPTED so a scheduler can tell a clean
# preemption from a hang kill.
EXIT_HUNG = 74
# Exit code for "a pod peer died or stalled and stranded our collectives;
# peer_lost forensics written, restart the WHOLE job" — distinct from
# EXIT_HUNG so a scheduler restarts every rank from the consensus
# checkpoint instead of resubmitting one rank into a pod that no longer
# exists.
EXIT_PEER_LOST = 73

_registry: Optional[Any] = None  # duck-typed telemetry.MetricsRegistry


def set_registry(registry: Optional[Any]) -> Optional[Any]:
    """Install the registry resilience counters record into; returns the
    previous one (callers with a scoped lifetime restore it)."""
    global _registry
    prev = _registry
    _registry = registry
    return prev


def get_registry() -> Optional[Any]:
    """The installed registry, or None."""
    return _registry


def counter_inc(name: str, amount: float = 1.0) -> None:
    """Increment ``name`` on the installed registry; no-op without one."""
    reg = _registry
    if reg is not None:
        reg.counter(name).inc(amount)


from howtotrainyourmamlpytorch_tpu_torch.resilience.faults import (  # noqa: E402
    FaultPlan, FaultSpec)
from howtotrainyourmamlpytorch_tpu_torch.resilience.cluster import (  # noqa: E402
    ClusterFaultDomain, ClusterMonitor, HeartbeatLease)
from howtotrainyourmamlpytorch_tpu_torch.resilience.flightrec import (  # noqa: E402
    FlightRecorder, write_crash_bundle)
from howtotrainyourmamlpytorch_tpu_torch.resilience.guard import (  # noqa: E402
    DivergenceGuard)
from howtotrainyourmamlpytorch_tpu_torch.resilience.retry import (  # noqa: E402
    backoff_delay, retry_io)
from howtotrainyourmamlpytorch_tpu_torch.resilience.watchdog import (  # noqa: E402
    ProgressBeacon, Watchdog)

__all__ = ["EXIT_HUNG", "EXIT_PEER_LOST", "EXIT_PREEMPTED",
           "ClusterFaultDomain", "ClusterMonitor", "DivergenceGuard",
           "FaultPlan", "FaultSpec", "FlightRecorder", "HeartbeatLease",
           "ProgressBeacon", "Watchdog", "backoff_delay", "counter_inc",
           "get_registry", "retry_io", "set_registry", "write_crash_bundle"]
