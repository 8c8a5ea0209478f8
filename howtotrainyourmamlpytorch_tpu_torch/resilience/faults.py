"""Deterministic fault-injection registry (the port's copy of the JAX
package's ``resilience/faults.py``).

A fault plan is a set of ``kind@at[:count]`` specs — e.g.
``"io_write@1;nan_loss@5;kill@6"`` — parsed from config
(``MAMLConfig.fault_spec``) or the ``MAML_FAULTS`` env var. Each
instrumented site asks :func:`maybe_fire` whether to inject; firing is a
pure function of the plan and the site's step/call index, so a chaos run
is exactly reproducible.

Two addressing modes, one per kind (the sites choose, not the spec):

* **step-keyed** — the site passes its own step counter (``nan_loss``,
  ``kill``, ``hang_step`` and ``hang_feed`` pass the global train
  iteration; ``episode_corrupt`` passes the episode index). ``kind@7``
  fires when that counter is 7.
* **call-counted** — the site passes no step; the plan counts the kind's
  calls (1-based) and ``kind@2:3`` fires on calls 2, 3 and 4. IO faults
  (``io_read``/``io_write``/``ckpt_corrupt``/``kill_in_ckpt_write``) work
  this way: a retried attempt advances the counter, so ``io_write@1``
  injects one transient write error that the backoff layer recovers from.

Every site lives in host-side Python between steps; with no plan
installed :func:`maybe_fire` is one ``None`` check. ``hang_collective``
fires inside a host-level collective (``parallel/multihost.py §
_collective``, call-counted). ``kill_peer`` SIGKILLs this rank at a
train iteration (the loop's sync point, before the stop-decision
collective), as a pod's surviving peers experience a lost host: the pod
fault domain (``resilience/cluster.py``) must name it and exit 73.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

ENV_VAR = "MAML_FAULTS"

KINDS = (
    "io_read",          # storage read raises OSError
    "io_write",         # storage write raises OSError
    "ckpt_corrupt",     # checkpoint bytes damaged in place after a save
    "nan_loss",         # outer loss read as NaN at a train iteration
    "kill",             # SIGTERM raised at a train iteration
    "episode_corrupt",  # episode sampling raises at an episode index
    "hang_feed",        # the prefetch worker sleeps past the feed
                        # deadline at a train iteration (loader)
    "hang_collective",  # a multihost collective sleeps past the
                        # collective deadline (call-counted)
    "hang_step",        # the train loop sleeps at a dispatch-sync point
                        # at a train iteration
    "kill_in_ckpt_write",  # os._exit(137) after a checkpoint tmp write
                        # but before its atomic rename: a simulated
                        # SIGKILL mid-save (call-counted over checkpoint
                        # file writes). Recovery must resume from the
                        # last committed manifest entry.
    "kill_peer",        # SIGKILL of this host at a train iteration, as
                        # the surviving peers of a pod experience it
)

# How long a hang_* fault sleeps (seconds): long enough to overrun any
# sane watchdog deadline (the watchdog's os._exit ends it), but bounded,
# so a hang injected with the watchdog off eventually releases the
# process. Overridable for tests.
HANG_SECONDS_ENV = "MAML_HANG_SECONDS"
DEFAULT_HANG_SECONDS = 3600.0


def hang(seconds: Optional[float] = None) -> None:
    """Deterministic sleep of the ``hang_*`` fault kinds: blocks the
    calling thread in small increments (so signal delivery on the main
    thread stays live) for ``seconds`` (default: env override or 1 h)."""
    if seconds is None:
        try:
            seconds = float(os.environ.get(HANG_SECONDS_ENV,
                                           DEFAULT_HANG_SECONDS))
        except ValueError:
            seconds = DEFAULT_HANG_SECONDS
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        time.sleep(min(0.2, max(deadline - time.monotonic(), 0.0)))


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injection: ``kind`` fires at steps ``[at, at + count)``."""
    kind: str
    at: int
    count: int = 1

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: {KINDS}")
        if self.at < 0 or self.count < 1:
            raise ValueError(
                f"fault {self.kind}: need at >= 0 and count >= 1, got "
                f"@{self.at}:{self.count}")


def parse_specs(text: str) -> List[FaultSpec]:
    """``"kind@at[:count]"`` items separated by ``;`` or ``,``; raises
    ``ValueError`` on a malformed item or an unknown kind (the JAX
    package's ``FaultPlan.parse`` rule, which its config validates
    with)."""
    specs = []
    for item in text.replace(",", ";").split(";"):
        item = item.strip()
        if not item:
            continue
        if "@" not in item:
            raise ValueError(
                f"fault spec item {item!r} is not 'kind@at[:count]'")
        kind, _, where = item.partition("@")
        at, _, count = where.partition(":")
        try:
            specs.append(FaultSpec(kind.strip(), int(at),
                                   int(count) if count else 1))
        except ValueError as e:
            raise ValueError(f"bad fault spec item {item!r}: {e}") from None
    return specs


class FaultPlan:
    """A parsed set of :class:`FaultSpec`; thread-safe (the prefetch
    worker and the train loop both consult it)."""

    def __init__(self, specs: Sequence[FaultSpec]):
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self._calls: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.fired: List[Tuple[str, int]] = []
        self._seen: set = set()

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        return cls(parse_specs(text))

    def maybe_fire(self, kind: str, step: Optional[int] = None) -> bool:
        """True iff a spec for ``kind`` covers this step/call. Each
        ``(kind, step)`` fires at most once per plan: recovery replays
        the covered window (a rewind revisits the poisoned iteration, a
        retry re-runs the failed write), and re-injecting on the replay
        would make every recovery path prove unrecoverability. Records
        every firing (``self.fired``), counts it into the resilience
        registry and the flight ring."""
        with self._lock:
            if step is None:
                self._calls[kind] = self._calls.get(kind, 0) + 1
                step = self._calls[kind]
            hit = (any(s.kind == kind and s.at <= step < s.at + s.count
                       for s in self.specs)
                   and (kind, int(step)) not in self._seen)
            if hit:
                self._seen.add((kind, int(step)))
                self.fired.append((kind, int(step)))
        if hit:
            from howtotrainyourmamlpytorch_tpu_torch import resilience
            from howtotrainyourmamlpytorch_tpu_torch.resilience import (
                flightrec)
            resilience.counter_inc("resilience/faults_injected")
            flightrec.record("fault", fault=kind, step=int(step))
        return hit


_plan: Optional[FaultPlan] = None


def configure(spec: str = "") -> Optional[FaultPlan]:
    """Install a plan from a spec string ('' clears). Returns the plan.
    A spec that does not parse raises and leaves no plan installed."""
    global _plan
    _plan = None
    if spec:
        _plan = FaultPlan.parse(spec)
    return _plan


def configure_from_env() -> Optional[FaultPlan]:
    return configure(os.environ.get(ENV_VAR, ""))


def get_plan() -> Optional[FaultPlan]:
    return _plan


def active() -> bool:
    return _plan is not None


def maybe_fire(kind: str, step: Optional[int] = None) -> bool:
    """The hook every instrumented site calls: one ``None`` check when no
    plan is installed."""
    plan = _plan
    if plan is None:
        return False
    return plan.maybe_fire(kind, step)
