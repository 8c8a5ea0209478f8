"""Pod fault domain: peer-death detection, collective deadlines,
coordinated abort (the port's copy of the JAX package's
``resilience/cluster.py``, with its names, rows and exit code).

On a mesh run the dominant failure is a *peer* dying or stalling. The
survivors then block inside a host-level collective, or (gloo over TCP:
a SIGKILLed peer closes its pairs) see the collective raise. Either way
the generic watchdog would name no host. This module, layered over
``parallel/multihost.py``, closes that gap:

* **Heartbeat leases** — each rank touches an mtime-stamped file
  (``<experiment>/cluster/host_<i>.lease``) from the loop's sync points
  AND from the watchdog's poll thread, so the lease proves the *process*
  is alive while its main thread is blocked in a collective.
* **:class:`ClusterMonitor`** — a pure classifier from lease ages to
  ``live``/``stalled``/``dead`` (negative ages read fresh; an expected
  host with no lease file reads dead).
* **Collective deadlines** — :func:`arm_deadlines` tightens the
  watchdog's ``collective`` budget to ``cluster_collective_timeout_s``;
  when it trips, or a collective raises a transport error,
  :class:`ClusterFaultDomain` consults the monitor, emits a
  ``peer_lost`` row *naming the suspect host(s)*, writes the crash
  bundle and exits ``EXIT_PEER_LOST`` (73), so a scheduler restarts the
  WHOLE job.
* **Consensus resume** — after such a restart every rank computes its
  view of the newest committed checkpoint epoch
  (:func:`latest_committed_epoch`) and all adopt
  :func:`consensus_epoch` over the gathered views.

The trip path uses host values only, as the watchdog's does: it touches
neither the card nor the process group (``destroy_process_group`` can
block on a dead peer). The process group's own timeout must outlast the
budget and its backstop (:func:`process_group_timeout`), or the backend
could end the process before the attributed trip.

Off (``cluster_collective_timeout_s = 0``, the default) nothing is
installed and every hook site is one module-global ``None`` check.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from howtotrainyourmamlpytorch_tpu_torch.resilience import flightrec

LEASE_DIR = "cluster"
LEASE_PREFIX = "host_"
LEASE_SUFFIX = ".lease"

PEER_LOST_EVENT = "peer_lost"
CONSENSUS_EVENT = "consensus_resume"
PEER_LOSSES_COUNTER = "cluster/peer_losses"
ESCALATIONS_COUNTER = "cluster/peer_lost_escalations"
LAST_SUSPECT_GAUGE = "cluster/last_suspect_host"
CONSENSUS_EPOCH_GAUGE = "cluster/consensus_epoch"

LIVE = "live"
STALLED = "stalled"
DEAD = "dead"


def cluster_enabled(cfg: Any) -> bool:
    """The subsystem's single on/off switch: a positive per-collective
    deadline. Everything else (lease cadence, monitor thresholds) only
    matters once this is set."""
    return float(getattr(cfg, "cluster_collective_timeout_s", 0.0)) > 0


def stalled_after(cfg: Any) -> float:
    """Lease age beyond which a peer counts as stalled. Explicit knob,
    else 3 lease intervals — one missed touch is scheduling jitter,
    three is a wedged process."""
    v = float(getattr(cfg, "cluster_peer_stalled_s", 0.0))
    return v if v > 0 else 3.0 * float(cfg.cluster_lease_interval_s)


def dead_after(cfg: Any) -> float:
    """Lease age beyond which a peer counts as dead. Explicit knob, else
    the collective deadline itself: a peer silent for the whole budget
    that strands a collective is what the exit code names. Never below
    the stalled threshold (a tight collective budget under a lazy lease
    cadence must not skip the stalled state)."""
    v = float(getattr(cfg, "cluster_peer_dead_s", 0.0))
    if v <= 0:
        v = float(cfg.cluster_collective_timeout_s)
    return max(v, stalled_after(cfg))


def arm_deadlines(cfg: Any,
                  deadlines: Dict[str, float]) -> Dict[str, float]:
    """Tighten the watchdog's ``collective`` phase budget to the
    per-collective cluster deadline (the watchdog thread is what arms
    and enforces it). A tighter generic collective deadline is kept —
    the cluster path only claims trips that overran ITS budget."""
    if not cluster_enabled(cfg):
        return deadlines
    out = dict(deadlines)
    budget = float(cfg.cluster_collective_timeout_s)
    current = out.get("collective", 0.0)
    out["collective"] = budget if current <= 0 else min(current, budget)
    return out


def process_group_timeout(cfg: Any) -> Optional[float]:
    """Seconds to give ``init_process_group`` when the domain is armed:
    above the cluster budget plus the trip's backstop (one more budget)
    with a minute of drain to spare, so neither gloo's nor NCCL's own
    collective timeout (30 and 10 minutes by default) can end a stranded
    rank before its attributed exit. None when the domain is off (the
    backend's default stands)."""
    if not cluster_enabled(cfg):
        return None
    budget = float(cfg.cluster_collective_timeout_s)
    return budget + max(budget, 1.0) + 60.0


# ---------------------------------------------------------------------------
# heartbeat leases
# ---------------------------------------------------------------------------

def lease_path(lease_dir: str, host: int) -> str:
    return os.path.join(lease_dir, f"{LEASE_PREFIX}{int(host)}{LEASE_SUFFIX}")


def read_lease_ages(lease_dir: str,
                    expected_hosts: int = 0,
                    now: Optional[float] = None) -> Dict[int, float]:
    """Per-host lease ages (seconds since last touch), fail-soft.

    Hosts with no lease file are reported as ``inf`` when they are
    *expected* (``expected_hosts`` > their index): on shared storage an
    absent lease from a host that should exist is itself evidence of
    death, not an excuse to skip it. With a known pod size, leases for
    indices BEYOND it are dropped — orphans from a previous, larger
    geometry resuming the same experiment dir would otherwise read as
    permanently dead and top every suspect list. Clock skew between the
    stat clock and a peer's write clock can make an age negative —
    clamped to 0 (a lease from "the future" is at worst fresh). Any
    filesystem error degrades to an empty dict; the caller reports
    "unavailable", never a fake verdict.
    """
    ages: Dict[int, float] = {}
    now = time.time() if now is None else now
    try:
        names = os.listdir(lease_dir)
    except OSError:
        names = []
    for name in names:
        if not (name.startswith(LEASE_PREFIX)
                and name.endswith(LEASE_SUFFIX)):
            continue
        raw = name[len(LEASE_PREFIX):-len(LEASE_SUFFIX)]
        if not raw.isdigit():
            continue
        if expected_hosts and int(raw) >= int(expected_hosts):
            continue  # orphan from a previous pod geometry
        try:
            mtime = os.stat(os.path.join(lease_dir, name)).st_mtime
        except OSError:
            continue  # racing writer/cleanup: skip, don't invent an age
        ages[int(raw)] = max(now - mtime, 0.0)
    for host in range(int(expected_hosts)):
        ages.setdefault(host, math.inf)
    return ages


class HeartbeatLease:
    """This host's liveness lease: one small file whose mtime IS the
    signal. Touches are rate-limited (``interval_s``) and fail-soft —
    a flaky shared mount must degrade peer-death detection, never kill
    the training it protects."""

    def __init__(self, lease_dir: str, process_index: int,
                 interval_s: float):
        self.lease_dir = lease_dir
        self.process_index = int(process_index)
        self.interval_s = float(interval_s)
        self.path = lease_path(lease_dir, process_index)
        self._lock = threading.Lock()
        self._last_touch = -math.inf  # monotonic; first touch always runs
        self.touches = 0
        self.errors = 0

    def touch(self, detail: Any = None, force: bool = False) -> bool:
        """Refresh the lease if ``interval_s`` has passed (or ``force``).
        Returns whether a write happened. The payload is advisory JSON
        (host/pid/detail) for humans; peers read only the mtime, so a
        torn write still carries the signal."""
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_touch < self.interval_s:
                return False
            prev = self._last_touch
            self._last_touch = now
        try:
            os.makedirs(self.lease_dir, exist_ok=True)
            with open(self.path, "w") as f:
                f.write(json.dumps({"host": self.process_index,
                                    "pid": os.getpid(),
                                    "ts": time.time(),
                                    "detail": detail}, default=str))
            self.touches += 1
            return True
        except OSError:
            self.errors += 1
            # A FAILED write must not consume the rate-limit window —
            # one mount blip per interval would otherwise silence the
            # lease long enough to read as stalled/dead to peers. Roll
            # the stamp back (unless a concurrent touch moved it) so
            # the very next call retries.
            with self._lock:
                if self._last_touch == now:
                    self._last_touch = prev
            return False


# ---------------------------------------------------------------------------
# monitor (pure)
# ---------------------------------------------------------------------------

class ClusterMonitor:
    """Pure classifier from lease ages to live/stalled/dead verdicts.

    No clocks, no filesystem: :meth:`check` is a function of the ages
    dict and the two thresholds, unit-testable like the watchdog's
    deadline math. Boundaries are inclusive on the healthy side
    (``age <= stalled_after_s`` is live) so an exactly-on-time lease
    never flaps.
    """

    def __init__(self, stalled_after_s: float, dead_after_s: float,
                 self_index: int = 0):
        if stalled_after_s <= 0 or dead_after_s <= 0:
            raise ValueError(
                f"thresholds must be > 0, got stalled={stalled_after_s} "
                f"dead={dead_after_s}")
        if dead_after_s < stalled_after_s:
            raise ValueError(
                f"dead_after_s {dead_after_s} < stalled_after_s "
                f"{stalled_after_s}: a dead peer must first be stalled")
        self.stalled_after_s = float(stalled_after_s)
        self.dead_after_s = float(dead_after_s)
        self.self_index = int(self_index)

    def classify(self, age: float) -> str:
        if age <= self.stalled_after_s:  # negative ages (clock skew)
            return LIVE                  # arrive clamped to 0 = fresh
        if age <= self.dead_after_s:
            return STALLED
        return DEAD

    def check(self, ages: Dict[int, float]) -> Dict[int, str]:
        """Verdict per host (self included — callers exclude it from
        suspect lists; its own lease going stale says nothing about
        peers)."""
        return {int(h): self.classify(a) for h, a in ages.items()}

    def suspects(self, ages: Dict[int, float]) -> List[int]:
        """Peers (never self) most likely to have stranded a collective:
        every ``dead`` host, else every ``stalled`` host, oldest lease
        first. Empty means the leases exonerate the peers — the trip is
        a genuine hang, not a peer loss."""
        verdicts = self.check(ages)
        peers = [h for h in verdicts if h != self.self_index]
        dead = [h for h in peers if verdicts[h] == DEAD]
        pool = dead if dead else [h for h in peers
                                  if verdicts[h] == STALLED]
        return sorted(pool, key=lambda h: (-ages[h], h))


# ---------------------------------------------------------------------------
# consensus resume (pure + manifest helpers)
# ---------------------------------------------------------------------------

def latest_committed_epoch(manifest: Any) -> int:
    """This host's view of the newest committed *epoch* checkpoint in a
    ``ckpt/manifest.py`` Manifest (-1 = none). The 'latest' link and any
    pending records don't count — consensus is over snapshots every
    host can provably load."""
    best = -1
    try:
        for rec in manifest.committed():
            tag = str(rec.get("tag"))
            if tag.isdigit():
                best = max(best, int(tag))
    except Exception:
        return -1  # a damaged manifest IS the stale-view scenario
    return best


def consensus_epoch(views: Sequence[int]) -> int:
    """The epoch the cluster agrees to resume from: the MINIMUM over
    hosts that see any committed epoch at all (every host can load it —
    a host whose view is newer adopts the older common ground), ignoring
    hosts that see none (-1: their manifest is stale/damaged; they adopt
    the peers' verdict rather than dragging everyone to a fresh start).
    -1 iff no host sees a committed epoch."""
    present = [int(v) for v in views if int(v) >= 0]
    return min(present) if present else -1


# ---------------------------------------------------------------------------
# fault domain (trip plumbing)
# ---------------------------------------------------------------------------

class ClusterFaultDomain:
    """Process-wide pod fault domain: lease + monitor + the peer-lost
    trip path.

    Installed (``install``) for the duration of a run like the beacon /
    flight recorder; the watchdog holds a reference and delegates a
    tripped ``collective`` deadline here when it overran the CLUSTER
    budget (:meth:`owns_trip`). A transport error inside a collective
    (``parallel/multihost.py § _collective``) arrives via
    :func:`maybe_trip_on_collective_error` — a dead peer manifests as
    either a hang or a connection reset depending on the transport, and
    both must end in the same attributed exit.
    """

    def __init__(self, *, lease_dir: str, process_index: int,
                 num_processes: int, collective_timeout_s: float,
                 stalled_after_s: float, dead_after_s: float,
                 lease_interval_s: float,
                 registry: Optional[Any] = None,
                 jsonl: Optional[Any] = None,
                 bundle_dir: Optional[str] = None,
                 prom_path: Optional[str] = None,
                 on_trip: Optional[Callable[[Dict[str, Any]], None]] = None):
        self.process_index = int(process_index)
        self.num_processes = int(num_processes)
        self.collective_timeout_s = float(collective_timeout_s)
        self.lease = HeartbeatLease(lease_dir, process_index,
                                    lease_interval_s)
        self.monitor = ClusterMonitor(stalled_after_s, dead_after_s,
                                      self_index=process_index)
        self.registry = registry
        self.jsonl = jsonl
        self.bundle_dir = bundle_dir
        self.prom_path = prom_path
        self.on_trip = on_trip
        # Elastic pod (resilience/elastic.py): when installed, an
        # attributed within-budget peer loss routes to a coordinated
        # reshard instead of the exit below. None (elastic_mode=0, the
        # default) keeps the exit-73 path byte-for-byte unchanged.
        self.elastic: Optional[Any] = None
        self.tripped: Optional[Dict[str, Any]] = None
        self._lock = threading.Lock()
        self._backstop: Optional[threading.Timer] = None
        self._exit = os._exit  # injectable for tests

    # -- liveness ---------------------------------------------------------
    def heartbeat(self, detail: Any = None, force: bool = False) -> bool:
        return self.lease.touch(detail=detail, force=force)

    def peer_lease_ages(self) -> Dict[int, float]:
        return read_lease_ages(self.lease.lease_dir,
                               expected_hosts=self.num_processes)

    def _attribute(self):
        """(ages, suspects), with one grace re-read when the first look
        exonerates everyone: on the instant-abort path a transport
        error lands milliseconds after the peer died, while every
        lease is still fresh. One stalled-window separates the dead
        (its refreshes stopped) from the live (their watchdog poll
        threads keep refreshing) — bounded to HALF the backstop delay
        so the drain's escalation timer can never fire inside the
        grace sleep itself."""
        ages = self.peer_lease_ages()
        suspects = self.monitor.suspects(ages)
        if not suspects and self.num_processes > 1:
            time.sleep(min(self.monitor.stalled_after_s
                           + self.lease.interval_s,
                           max(self.collective_timeout_s, 1.0) / 2.0))
            ages = self.peer_lease_ages()
            suspects = self.monitor.suspects(ages)
        return ages, suspects

    # -- trip path --------------------------------------------------------
    def owns_trip(self, info: Dict[str, Any]) -> bool:
        """Whether a watchdog trip is THIS subsystem's to handle: a
        ``collective`` phase whose BINDING deadline was the cluster
        budget. Discriminated on the armed deadline, not the observed
        age — poll overshoot routinely observes a trip late, and a
        tighter generic collective deadline tripping (then being seen
        past the cluster budget) must stay a plain hang (exit 74): no
        peer gets blamed below the cluster's bar."""
        return (info.get("phase") == "collective"
                and self.collective_timeout_s > 0
                and float(info.get("deadline_seconds") or 0.0)
                >= self.collective_timeout_s)

    def trip_peer_lost(self, info: Dict[str, Any],
                       attribution=None) -> None:
        """Attributed abort: classify peers from their leases, emit the
        ``peer_lost`` row naming the suspect host(s), write the crash
        bundle, flush telemetry, exit ``EXIT_PEER_LOST`` (73). An
        empty suspect list still exits — a collective stranded past
        the cluster budget is a cluster fault even when every peer's
        PROCESS is alive (a peer wedged in its main thread keeps its
        lease fresh; the row's verdicts say so).

        A SECOND trip while the first is still draining (the bundle /
        flush wedged on the same dead storage, or the armed backstop
        timer below firing) escalates straight to ``os._exit`` — the
        double-SIGTERM contract: a peer loss during the abort drain
        must not hang the survivor forever.
        """
        from howtotrainyourmamlpytorch_tpu_torch import resilience
        with self._lock:
            if self.tripped is not None:
                try:
                    if self.registry is not None:
                        self.registry.counter(ESCALATIONS_COUNTER).inc()
                except Exception:
                    pass
                self._exit(resilience.EXIT_PEER_LOST)
                return  # only reached with an injected _exit (tests)
            self.tripped = dict(info)
        # Backstop: if THIS drain never finishes, re-enter after one
        # more collective budget — the re-entry takes the escalation
        # branch above. Daemon timer: a successful exit doesn't wait.
        self._backstop = threading.Timer(
            max(self.collective_timeout_s, 1.0),
            self.trip_peer_lost, args=(info,))
        self._backstop.daemon = True
        self._backstop.start()

        ages, suspects = (self._attribute() if attribution is None
                          else attribution)
        verdicts = self.monitor.check(ages)
        row = {
            **info,
            "suspect_hosts": suspects,
            "peer_verdicts": {str(h): v
                              for h, v in sorted(verdicts.items())},
            "peer_lease_age_seconds": {
                str(h): (round(a, 3) if math.isfinite(a) else None)
                for h, a in sorted(ages.items())},
            "cluster_collective_timeout_s": self.collective_timeout_s,
        }
        flightrec.record(PEER_LOST_EVENT, **row)
        if self.registry is not None:
            try:
                self.registry.counter(PEER_LOSSES_COUNTER).inc()
                self.registry.gauge(LAST_SUSPECT_GAUGE).set(
                    float(suspects[0]) if suspects else -1.0)
            except Exception:
                pass
        # Elastic routing (resilience/elastic.py): an attributed loss
        # within the lost-host budget reshards instead of exiting —
        # initiate() execs into the survivor generation and never
        # returns. Any refusal (unattributed, over budget, consensus
        # timeout, roster excluded us) falls through to the ordinary
        # attributed exit 73 below. The backstop is re-armed for the
        # consensus window first, so a reshard that wedges (dead shared
        # storage) still escalates to the exit rather than hanging the
        # survivor forever.
        policy = self.elastic
        if policy is not None and policy.should_reshard(suspects):
            backstop = self._backstop
            if backstop is not None:
                backstop.cancel()
            self._backstop = threading.Timer(
                policy.timeout_s + max(self.collective_timeout_s, 1.0),
                self.trip_peer_lost, args=(info,))
            self._backstop.daemon = True
            self._backstop.start()
            if policy.initiate(row, ages, suspects):
                self.close()  # injected-exec (tests): the run continues
                return
        if self.bundle_dir:
            try:
                flightrec.write_crash_bundle(
                    self.bundle_dir, reason=PEER_LOST_EVENT, info=row,
                    registry=self.registry,
                    process_index=self.process_index)
            except Exception:
                pass
        if self.jsonl is not None:
            try:
                self.jsonl.log(PEER_LOST_EVENT, **row,
                               bundle_dir=self.bundle_dir)
                if self.registry is not None:
                    self.registry.flush_jsonl(self.jsonl,
                                              phase=PEER_LOST_EVENT)
            except Exception:
                pass
        if self.prom_path and self.registry is not None:
            try:
                self.registry.write_prometheus(self.prom_path)
            except Exception:
                pass
        if self.on_trip is not None:
            self.close()  # cancel the backstop: the test run continues
            self.on_trip(row)
            return
        self._exit(resilience.EXIT_PEER_LOST)

    def close(self) -> None:
        backstop = self._backstop
        if backstop is not None:
            backstop.cancel()
            self._backstop = None


_domain: Optional[ClusterFaultDomain] = None


def install(domain: Optional[ClusterFaultDomain]
            ) -> Optional[ClusterFaultDomain]:
    """Install the process-wide fault domain; returns the previous one
    (scoped lifetimes restore it — the beacon/recorder pattern)."""
    global _domain
    prev = _domain
    _domain = domain
    return prev


def get() -> Optional[ClusterFaultDomain]:
    return _domain


def heartbeat(detail: Any = None) -> None:
    """Touch the installed domain's lease; one ``None`` check without."""
    domain = _domain
    if domain is not None:
        domain.heartbeat(detail=detail)


def maybe_trip_on_collective_error(name: str, error: BaseException) -> None:
    """Convert an exception escaping a host-level collective into the
    attributed peer-lost abort (``parallel/multihost.py`` calls this
    from every ``_collective`` scope's except path). A dead peer shows
    up as a transport error on transports that detect the closed
    connection, and as a hang on those that don't — same failure, same
    exit. UNLIKE the deadline path, this one requires attribution:
    when the (grace-re-read) leases exonerate every peer, the error is
    an application failure, not a peer loss — converting it to exit 73
    would turn a deterministic bug into an infinite whole-job restart
    loop, so the original exception propagates instead (counted). One
    ``None`` check with no domain installed; single-process domains
    never claim an error (there is no peer to lose)."""
    domain = _domain
    if domain is None or domain.num_processes <= 1:
        return
    attribution = domain._attribute()
    if not attribution[1]:  # no suspects: a real error, let it raise
        if domain.registry is not None:
            try:
                domain.registry.counter(
                    "cluster/unattributed_collective_errors").inc()
            except Exception:
                pass
        return
    domain.trip_peer_lost({
        "phase": "collective", "detail": name,
        "error": f"{type(error).__name__}: {str(error)[:300]}",
        "age_seconds": None, "process_index": domain.process_index,
    }, attribution=attribution)
