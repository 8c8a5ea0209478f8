"""Fleet front router: consistent-hash + bounded-load request routing.

The port's own copy of the JAX package's ``serve/fleet/router.py`` (the
same ring, lease and wire formats; the request-trace module it resolves
is the port's). It imports nothing of that package.

The single-process ServingEngine keeps its adapted-params LRU
in-proc, so WHO serves a request decides whether the expensive adapt
step runs at all. This router exists to exploit that: repeat tenants —
the "adapt once, predict many" pattern the cache is built for — are
routed by a **consistent hash of their support-set content** back to
the replica whose L1 already holds their adaptation. Scaling the fleet
then scales the *working set* (aggregate L1 capacity), which on any
hardware is the serving win that raw per-replica FLOPs cannot give.

Three pieces, all host-side and deliberately **torch-free**:

* :class:`HashRing` — classic consistent hashing with virtual nodes:
  each replica owns ``vnodes`` pseudo-random points on a 64-bit ring;
  a key routes to the first replica clockwise from its hash. Adding or
  removing one replica moves only ~1/N of the key space (pinned in
  tests/test_fleet.py § ring churn).
* **Bounded-load spill** (:meth:`FleetRouter.route`) — plain
  consistent hashing lets one hot tenant melt one replica. Following
  the bounded-load variant (Mirrokni et al.), a replica may hold at
  most ``ceil(load_factor * (in_flight + 1) / N)`` outstanding
  requests; a key whose primary is at capacity spills to the next ring
  position (counted ``fleet/router_spills``) — affinity degrades
  gracefully instead of queueing without bound.
* **Membership from heartbeat leases** — replicas announce themselves
  exactly the way pod hosts do (``resilience/cluster.py``): an
  mtime-stamped lease file per replica under ``<fleet_dir>/``, aged
  into live/stalled/dead (inclusive-boundary thresholds, negative ages
  clamp to fresh — the ClusterMonitor rules, re-implemented here so
  this module stays loadable by file path with no package imports, the
  ``ckpt/registry.py`` discipline). Unlike cluster leases, the JSON
  payload here is load-bearing (port, served version, queue/latency
  stats), so it is written atomically (tmp + rename) and a torn or
  unparseable payload degrades that replica to age-only membership,
  never to a crash. **Drain = lease tombstone**: a sidecar
  ``replica_<i>.drain`` file marks a replica draining — it keeps its
  lease fresh (the process is alive) but leaves the ring, so its keys
  spill to their next ring position while in-flight work completes.
* **Failure feedback** (:class:`ReplicaBreaker` +
  :class:`FailoverPolicy`) — lease ages only prove the process is
  alive; requests can still fail. A per-replica consecutive-failure
  circuit breaker (closed/open/half-open with single-probe recovery)
  removes a request-failing replica from the candidate set before its
  lease ever goes stale, and the failover policy resubmits a dead
  connection's orphaned requests to the next ring candidate — bounded
  attempts, each counted ``fleet/failovers``, idempotent because
  serving is read-only over an immutable checkpoint.

The module is stdlib-only (numpy arrays are accepted where they appear
— ``routing_key`` needs only ``.tobytes()`` — but never imported) so a
frontend process can load it by file path and route without ever
initializing an accelerator runtime. ``scripts/fleet_bench.py`` does
exactly that.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import math
import os
import pickle
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

LEASE_PREFIX = "replica_"
LEASE_SUFFIX = ".lease"
DRAIN_SUFFIX = ".drain"

# -- request tracing (telemetry/reqtrace.py), resolved lazily ------------
# This module must stay loadable by file path with no package imports
# (the torch-free frontend contract above), but its spans must land in the
# SAME per-process ring the engine installs. Resolution order:
# 1. the package copy already in sys.modules — replica processes import
#    the engine (which imports reqtrace) before this module runs a
#    traced request, so they always share the engine's module object and
#    with it the installed ring;
# 2. a file-path load of ../../telemetry/reqtrace.py under a private
#    name — the torch-free frontend path (telemetry/__init__ imports health
#    which imports torch, so the package route is closed to it). The
#    frontend reaches the same object via reqtrace_mod() to mint/install.
_REQTRACE_PKG = "howtotrainyourmamlpytorch_tpu_torch.telemetry.reqtrace"
_reqtrace_cached: Optional[Any] = None


def reqtrace_mod() -> Any:
    """The process's request-trace module (shared object — see above)."""
    global _reqtrace_cached
    if _reqtrace_cached is None:
        import sys
        mod = sys.modules.get(_REQTRACE_PKG)
        if mod is None:
            import importlib.util
            path = os.path.abspath(os.path.join(
                os.path.dirname(os.path.abspath(__file__)),
                os.pardir, os.pardir, "telemetry", "reqtrace.py"))
            spec = importlib.util.spec_from_file_location(
                "_maml_torch_fleet_reqtrace", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        _reqtrace_cached = mod
    return _reqtrace_cached

LIVE = "live"
STALLED = "stalled"
DEAD = "dead"

# Per-replica circuit-breaker states (wire/serve failures, NOT lease
# liveness — a replica can heartbeat perfectly while failing every
# request, e.g. a poisoned checkpoint or a wedged accept loop).
BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"

# Eagerly-registered router metrics (telemetry satellite): a flush row
# must show "0 spills", not an absent key.
REQUESTS_COUNTER = "fleet/router_requests"
SPILLS_COUNTER = "fleet/router_spills"
NO_REPLICA_COUNTER = "fleet/router_no_replica"
FAILOVERS_COUNTER = "fleet/failovers"
BREAKER_TRIPS_COUNTER = "fleet/breaker_trips"
LIVE_GAUGE = "fleet/replicas_live"
DRAINING_GAUGE = "fleet/replicas_draining"
CANARY_REQUESTS_COUNTER = "fleet/canary_requests"
COHORT_FALLBACK_COUNTER = "fleet/cohort_fallbacks"


def lease_path(fleet_dir: str, replica_id: int) -> str:
    return os.path.join(fleet_dir,
                        f"{LEASE_PREFIX}{int(replica_id)}{LEASE_SUFFIX}")


def drain_path(fleet_dir: str, replica_id: int) -> str:
    return os.path.join(fleet_dir,
                        f"{LEASE_PREFIX}{int(replica_id)}{DRAIN_SUFFIX}")


def routing_key(support_x: Any, support_y: Any) -> str:
    """Content key of one tenant's support set, for ROUTING only.

    Same construction as ``serve/cache.py § support_fingerprint`` minus
    the adapt-step count and checkpoint context: the router must keep a
    tenant pinned to its replica ACROSS hot-swaps (the new version
    re-adapts fastest where the tenant's traffic already lands), so the
    routing identity is the tenant content alone. The engine-side cache
    key stays the full fingerprint — the two are deliberately different
    keys for different jobs.
    """
    h = hashlib.sha256()
    for arr in (support_x, support_y):
        h.update(str(getattr(arr, "dtype", type(arr))).encode())
        h.update(str(getattr(arr, "shape", ())).encode())
        h.update(arr.tobytes() if hasattr(arr, "tobytes") else bytes(arr))
    return h.hexdigest()


def canary_fraction(tenant: Any, seq: int) -> float:
    """Deterministic traffic-split coordinate of one request in [0, 1).

    A sha256 of ``(tenant, seq)`` scaled to the unit interval — the
    request-level identity of the weighted canary split. Comparing the
    SAME coordinate against a growing weight threshold makes every
    stage's canary cohort a strict superset of the previous stage's
    (the rate-monotone property the stage-over-stage SLO comparison
    depends on: promoted traffic ADDS requests to the canary, it never
    reshuffles which requests the canary already saw). Independent of
    the routing key on purpose: the split must sample tenants evenly,
    not follow cache affinity.
    """
    digest = hashlib.sha256(
        f"canary:{tenant}:{int(seq)}".encode()).digest()
    return int.from_bytes(digest[:8], "big") / 2.0 ** 64


def assign_canary(tenant: Any, seq: int, weight: float) -> bool:
    """True when request ``(tenant, seq)`` rides the canary cohort at
    traffic ``weight`` in [0, 1]. Deterministic across processes and
    reruns; monotone in ``weight``."""
    if weight <= 0.0:
        return False
    if weight >= 1.0:
        return True
    return canary_fraction(tenant, seq) < float(weight)


def _point(token: str) -> int:
    """64-bit ring position of one token (replica vnode or key)."""
    return int.from_bytes(
        hashlib.sha256(token.encode()).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring with virtual nodes.

    Pure and immutable: membership churn builds a NEW ring (they are
    tiny — N replicas x vnodes points), which is what makes the
    stability property testable as a function.
    """

    def __init__(self, members: Sequence[int], vnodes: int = 64):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.members = sorted(int(m) for m in set(members))
        self.vnodes = int(vnodes)
        points: List[tuple] = []
        for m in self.members:
            for v in range(self.vnodes):
                points.append((_point(f"replica:{m}:vnode:{v}"), m))
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [m for _, m in points]

    def __len__(self) -> int:
        return len(self.members)

    def candidates(self, key: str) -> List[int]:
        """Every member, in ring order starting at ``key``'s position —
        element 0 is the primary, the rest are the spill order (each
        member listed once)."""
        if not self.members:
            return []
        idx = bisect.bisect_left(self._points, _point(f"key:{key}"))
        seen: List[int] = []
        n = len(self._points)
        for i in range(n):
            owner = self._owners[(idx + i) % n]
            if owner not in seen:
                seen.append(owner)
                if len(seen) == len(self.members):
                    break
        return seen

    def primary(self, key: str) -> Optional[int]:
        c = self.candidates(key)
        return c[0] if c else None


class ReplicaLease:
    """Write side of one replica's membership lease.

    The ``resilience/cluster.py § HeartbeatLease`` idiom (mtime IS the
    liveness signal, rate-limited, fail-soft, a failed write does not
    consume the rate-limit window) with one deliberate difference: the
    payload is load-bearing here (port, version, serving stats the
    router and controller read), so the write is atomic (tmp + rename)
    — a reader must never parse a torn JSON and drop a live replica
    from the ring.
    """

    def __init__(self, fleet_dir: str, replica_id: int, interval_s: float):
        self.fleet_dir = fleet_dir
        self.replica_id = int(replica_id)
        self.interval_s = float(interval_s)
        self.path = lease_path(fleet_dir, replica_id)
        self._lock = threading.Lock()
        self._last_touch = -math.inf
        self.touches = 0
        self.errors = 0

    @property
    def due(self) -> bool:
        """Whether the rate-limit window has elapsed — lets callers
        skip building an expensive payload that ``touch`` would only
        discard."""
        return time.monotonic() - self._last_touch >= self.interval_s

    def touch(self, payload: Optional[Dict[str, Any]] = None,
              force: bool = False) -> bool:
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_touch < self.interval_s:
                return False
            prev = self._last_touch
            self._last_touch = now
        try:
            os.makedirs(self.fleet_dir, exist_ok=True)
            doc = {"replica": self.replica_id, "pid": os.getpid(),
                   "ts": time.time()}
            doc.update(payload or {})
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, self.path)
            self.touches += 1
            return True
        except OSError:
            self.errors += 1
            with self._lock:
                if self._last_touch == now:
                    self._last_touch = prev
            return False


def read_members(fleet_dir: str,
                 now: Optional[float] = None) -> Dict[int, Dict[str, Any]]:
    """Per-replica membership snapshot, fail-soft.

    Returns ``{replica_id: {"age": seconds, "payload": dict|None,
    "draining": bool}}``. Ages follow the cluster-lease rules (clock
    skew clamps to 0; a stat race skips the file rather than inventing
    an age); an unparseable payload degrades to ``None`` — the mtime
    still proves liveness. A drain tombstone marks the replica
    draining whether or not its lease is healthy.
    """
    out: Dict[int, Dict[str, Any]] = {}
    now = time.time() if now is None else now
    try:
        names = os.listdir(fleet_dir)
    except OSError:
        names = []
    for name in names:
        if not name.startswith(LEASE_PREFIX):
            continue
        if name.endswith(LEASE_SUFFIX):
            raw = name[len(LEASE_PREFIX):-len(LEASE_SUFFIX)]
            if not raw.isdigit():
                continue
            path = os.path.join(fleet_dir, name)
            try:
                mtime = os.stat(path).st_mtime
            except OSError:
                continue
            payload: Optional[Dict[str, Any]] = None
            try:
                with open(path) as f:
                    doc = json.load(f)
                if isinstance(doc, dict):
                    payload = doc
            except (OSError, ValueError):
                payload = None
            out.setdefault(int(raw), {})
            out[int(raw)].update({
                "age": max(now - mtime, 0.0), "payload": payload})
        elif name.endswith(DRAIN_SUFFIX):
            raw = name[len(LEASE_PREFIX):-len(DRAIN_SUFFIX)]
            if raw.isdigit():
                out.setdefault(int(raw), {})["draining"] = True
    for rec in out.values():
        rec.setdefault("age", math.inf)
        rec.setdefault("payload", None)
        rec.setdefault("draining", False)
    return out


def classify(age: float, stalled_after_s: float, dead_after_s: float) -> str:
    """Lease age -> live/stalled/dead; the ClusterMonitor boundary rules
    (inclusive on the healthy side so an exactly-on-time lease never
    flaps; a missing lease arrives as ``inf`` = dead)."""
    if age <= stalled_after_s:
        return LIVE
    if age <= dead_after_s:
        return STALLED
    return DEAD


class ReplicaBreaker:
    """Per-replica consecutive-failure circuit breaker (pure, clock-in).

    Lease liveness (classify above) catches replicas that stop
    heartbeating; this catches the other failure shape — a replica
    whose PROCESS is fine but whose requests fail (connection reset
    mid-serve, poisoned state after a bad swap). Classic three-state
    machine, time passed in so every transition is unit-testable:

    * CLOSED — healthy; requests flow. ``threshold`` consecutive
      failures trip it OPEN.
    * OPEN — no requests until ``cooldown_s`` elapses, then the record
      reads HALF_OPEN.
    * HALF_OPEN — exactly ONE probe request allowed through
      (``begin_probe``); its success closes the breaker fully, its
      failure reopens (fresh cooldown, NOT a new trip).

    Replicas with no record are trivially CLOSED and cost nothing —
    the healthy-fleet fast path in ``FleetRouter.route`` checks
    ``bool(self._records)`` before touching per-candidate state.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 2.0):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        if cooldown_s <= 0:
            raise ValueError(f"cooldown_s must be > 0, got {cooldown_s}")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._records: Dict[int, Dict[str, Any]] = {}

    def _record(self, replica_id: int) -> Dict[str, Any]:
        return self._records.setdefault(int(replica_id), {
            "failures": 0, "state": BREAKER_CLOSED,
            "opened_at": 0.0, "probe_out": False})

    def state(self, replica_id: int, now: Optional[float] = None) -> str:
        """Resolved state (OPEN past its cooldown reads HALF_OPEN)."""
        rec = self._records.get(int(replica_id))
        if rec is None:
            return BREAKER_CLOSED
        now = time.monotonic() if now is None else now
        if (rec["state"] == BREAKER_OPEN
                and now - rec["opened_at"] >= self.cooldown_s):
            rec["state"] = BREAKER_HALF_OPEN
            rec["probe_out"] = False
        return rec["state"]

    def allows(self, replica_id: int, now: Optional[float] = None) -> bool:
        """Whether a request may be routed to this replica right now.
        HALF_OPEN admits only while no probe is outstanding — the
        caller marks the probe with ``begin_probe`` on pick."""
        st = self.state(replica_id, now)
        if st == BREAKER_CLOSED:
            return True
        if st == BREAKER_OPEN:
            return False
        return not self._records[int(replica_id)]["probe_out"]

    def begin_probe(self, replica_id: int) -> None:
        rec = self._records.get(int(replica_id))
        if rec is not None and rec["state"] == BREAKER_HALF_OPEN:
            rec["probe_out"] = True

    def record_failure(self, replica_id: int,
                       now: Optional[float] = None) -> bool:
        """One request against this replica failed. Returns True only
        on a fresh CLOSED -> OPEN trip (the countable event); a
        HALF_OPEN probe failure re-opens silently."""
        now = time.monotonic() if now is None else now
        rec = self._record(replica_id)
        st = self.state(replica_id, now)
        if st == BREAKER_HALF_OPEN:
            rec["state"] = BREAKER_OPEN
            rec["opened_at"] = now
            rec["probe_out"] = False
            return False
        if st == BREAKER_OPEN:
            return False
        rec["failures"] += 1
        if rec["failures"] >= self.threshold:
            rec["state"] = BREAKER_OPEN
            rec["opened_at"] = now
            return True
        return False

    def record_success(self, replica_id: int) -> None:
        """A served response closes the breaker and clears all history
        — consecutive-failure semantics, not a failure-rate window."""
        self._records.pop(int(replica_id), None)

    def snapshot(self) -> Dict[int, str]:
        """{replica_id: state} for every replica with a record, for
        telemetry last-signal rows. Does not resolve cooldowns (pure
        read)."""
        return {r: rec["state"] for r, rec in self._records.items()}


class FleetRouter:
    """Membership + ring + bounded-load pick, with in-flight accounting.

    ``refresh()`` re-reads the lease dir and rebuilds the ring from
    live, non-draining replicas (cheap: a handful of small files — the
    caller decides the cadence). ``route(key)`` picks a replica and
    counts it in flight; the caller MUST pair it with ``complete()``
    when the response lands (or the request errors), or the load
    accounting — and with it the spill behavior — drifts.

    ``registry`` is duck-typed on the telemetry MetricsRegistry
    (counter/gauge get-or-create); None runs unobserved.
    """

    def __init__(self, fleet_dir: str, *, vnodes: int = 64,
                 load_factor: float = 1.25,
                 stalled_after_s: float = 1.5,
                 dead_after_s: float = 3.0,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 2.0,
                 registry: Optional[Any] = None):
        if load_factor < 1.0:
            raise ValueError(
                f"load_factor must be >= 1.0, got {load_factor}")
        if dead_after_s < stalled_after_s:
            raise ValueError(
                f"dead_after_s {dead_after_s} < stalled_after_s "
                f"{stalled_after_s}: a dead replica must first be stalled")
        self.fleet_dir = fleet_dir
        self.vnodes = int(vnodes)
        self.load_factor = float(load_factor)
        self.stalled_after_s = float(stalled_after_s)
        self.dead_after_s = float(dead_after_s)
        self.registry = registry
        self.ring = HashRing([], vnodes=self.vnodes)
        self.members: Dict[int, Dict[str, Any]] = {}
        self._in_flight: Dict[int, int] = {}
        self._last_pid: Dict[int, Any] = {}
        self._lock = threading.Lock()
        self.breaker = ReplicaBreaker(threshold=breaker_threshold,
                                      cooldown_s=breaker_cooldown_s)
        if registry is not None:
            for name in (REQUESTS_COUNTER, SPILLS_COUNTER,
                         NO_REPLICA_COUNTER, FAILOVERS_COUNTER,
                         BREAKER_TRIPS_COUNTER, CANARY_REQUESTS_COUNTER,
                         COHORT_FALLBACK_COUNTER):
                registry.counter(name)

    # -- membership -------------------------------------------------------
    def refresh(self, now: Optional[float] = None
                ) -> Dict[int, Dict[str, Any]]:
        members = read_members(self.fleet_dir, now=now)
        for rec in members.values():
            rec["state"] = classify(rec["age"], self.stalled_after_s,
                                    self.dead_after_s)
        routable = sorted(r for r, rec in members.items()
                          if rec["state"] == LIVE and not rec["draining"])
        with self._lock:
            self.members = members
            if routable != self.ring.members:
                self.ring = HashRing(routable, vnodes=self.vnodes)
            for r in list(self._in_flight):
                # A dead/vanished replica's outstanding requests will
                # never complete(); forget them so its load cannot
                # poison the bounded-load average forever. A replica
                # that died and was RESTARTED before any refresh saw it
                # dead shows up the same way through its changed lease
                # pid — the new process cannot be holding our old
                # requests.
                rec = members.get(r)
                pid = ((rec or {}).get("payload") or {}).get("pid")
                if (rec is None or rec.get("state") == DEAD
                        or (pid is not None
                            and self._last_pid.get(r) is not None
                            and pid != self._last_pid[r])):
                    del self._in_flight[r]
            for r, rec in members.items():
                pid = (rec.get("payload") or {}).get("pid")
                if pid is not None:
                    self._last_pid[r] = pid
        if self.registry is not None:
            self.registry.gauge(LIVE_GAUGE).set(len(routable))
            self.registry.gauge(DRAINING_GAUGE).set(
                sum(1 for rec in members.values() if rec["draining"]))
        return members

    @property
    def routable(self) -> List[int]:
        return list(self.ring.members)

    def in_flight(self, replica_id: int) -> int:
        with self._lock:
            return self._in_flight.get(int(replica_id), 0)

    # -- routing ----------------------------------------------------------
    def route(self, key: str,
              ctx: Optional[Dict[str, Any]] = None, *,
              among: Optional[Sequence[int]] = None) -> Optional[int]:
        """Pick the replica for ``key``: the ring primary unless it is
        past its bounded-load capacity, else the next ring position
        (counted as a spill), else — everyone saturated — the
        least-loaded routable replica (affinity yields to liveness).
        None (counted) when the ring is empty. ``ctx`` is an optional
        request-trace context — a sampled request records a ``route``
        span carrying the pick and whether it spilled.

        ``among`` restricts the pick to a version cohort (the weighted
        canary split: the caller assigns the request via
        :func:`assign_canary` and passes that cohort's replica ids).
        Ring order — and with it cache affinity — is preserved INSIDE
        the cohort; an empty intersection falls back to the full
        candidate list (counted ``fleet/cohort_fallbacks``: serving the
        request on the wrong cohort beats dropping it, and the fallback
        count is the honesty signal that the split was not exact)."""
        reg = self.registry
        t0 = time.monotonic() if ctx is not None else 0.0
        with self._lock:
            cands = self.ring.candidates(key)
            if among is not None and cands:
                cohort = [r for r in cands if r in set(among)]
                if cohort:
                    cands = cohort
                elif reg is not None:
                    reg.counter(COHORT_FALLBACK_COUNTER).inc()
            if cands and self.breaker._records:
                # Slow path only while some breaker record exists: a
                # healthy fleet never pays per-candidate state checks.
                now = time.monotonic()
                cands = [r for r in cands if self.breaker.allows(r, now)]
            if not cands:
                if reg is not None:
                    reg.counter(NO_REPLICA_COUNTER).inc()
                if ctx is not None:
                    rt = reqtrace_mod()
                    rt.record_span(ctx, rt.SPAN_ROUTE, t0,
                                   time.monotonic() - t0, replica=None,
                                   spilled=False)
                return None
            total = sum(self._in_flight.get(r, 0) for r in cands)
            cap = math.ceil(self.load_factor * (total + 1) / len(cands))
            chosen = None
            for i, r in enumerate(cands):
                if self._in_flight.get(r, 0) < cap:
                    chosen = r
                    spilled = i > 0
                    break
            if chosen is None:
                chosen = min(cands,
                             key=lambda r: (self._in_flight.get(r, 0), r))
                spilled = chosen != cands[0]
            self._in_flight[chosen] = self._in_flight.get(chosen, 0) + 1
            self.breaker.begin_probe(chosen)
        if reg is not None:
            reg.counter(REQUESTS_COUNTER).inc()
            if spilled:
                reg.counter(SPILLS_COUNTER).inc()
        if ctx is not None:
            rt = reqtrace_mod()
            rt.record_span(ctx, rt.SPAN_ROUTE, t0,
                           time.monotonic() - t0, replica=chosen,
                           spilled=bool(spilled))
        return chosen

    def complete(self, replica_id: int) -> None:
        with self._lock:
            n = self._in_flight.get(int(replica_id), 0)
            if n <= 1:
                self._in_flight.pop(int(replica_id), None)
            else:
                self._in_flight[int(replica_id)] = n - 1

    # -- failure feedback (circuit breaker) -------------------------------
    def record_failure(self, replica_id: int,
                       now: Optional[float] = None) -> bool:
        """A request against ``replica_id`` failed at the wire/serve
        layer. Feeds the per-replica breaker; a fresh CLOSED -> OPEN
        trip is counted (``fleet/breaker_trips``) and returned."""
        with self._lock:
            tripped = self.breaker.record_failure(replica_id, now)
        if tripped and self.registry is not None:
            self.registry.counter(BREAKER_TRIPS_COUNTER).inc()
        return tripped

    def record_success(self, replica_id: int) -> None:
        """A served response from ``replica_id`` — closes its breaker
        (half-open probe success included) and clears failure history."""
        with self._lock:
            self.breaker.record_success(replica_id)


class FailoverPolicy:
    """Idempotent resubmission of a dead replica's orphaned requests.

    When a replica connection dies mid-load, every request routed to it
    and not yet answered is orphaned — known lost, safe to resubmit
    (serving is read-only over an immutable checkpoint: re-adapting the
    same support set is idempotent, at worst a duplicate cache fill).
    ``replica_failed`` turns that event into two lists:

    * ``requeue`` — request ids to resubmit; the caller re-routes each
      (the breaker has already removed the dead replica from the
      candidate set, so they land on the next ring position). Each is
      one counted ``fleet/failovers``.
    * ``gave_up`` — ids that already failed over ``max_attempts`` times
      (a request chasing a cascading outage must eventually surface an
      error to ITS caller rather than orbit the ring forever).

    The policy also settles the router's books for the dead replica —
    one ``complete()`` per orphan (their responses will never arrive)
    and one breaker failure per orphan, so a crash with >= threshold
    requests in flight trips the breaker in a single event instead of
    needing ``threshold`` separate crashes.
    """

    def __init__(self, router: FleetRouter, max_attempts: int = 3):
        if max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {max_attempts}")
        self.router = router
        self.max_attempts = int(max_attempts)
        self._attempts: Dict[Any, int] = {}

    def replica_failed(self, replica_id: int, orphaned_ids: Sequence[Any],
                       now: Optional[float] = None) -> tuple:
        """-> (requeue, gave_up) — see class docstring."""
        reg = self.router.registry
        requeue: List[Any] = []
        gave_up: List[Any] = []
        for rid in orphaned_ids:
            self.router.record_failure(replica_id, now)
            self.router.complete(replica_id)
            n = self._attempts.get(rid, 0) + 1
            if n > self.max_attempts:
                gave_up.append(rid)
                self._attempts.pop(rid, None)
                continue
            self._attempts[rid] = n
            requeue.append(rid)
            if reg is not None:
                reg.counter(FAILOVERS_COUNTER).inc()
        return requeue, gave_up

    def request_done(self, request_id: Any) -> None:
        """Forget a request's failover history once it completes (or
        terminally errors) — ids are caller-scoped and may be reused."""
        self._attempts.pop(request_id, None)


# ---------------------------------------------------------------------------
# wire framing (router process <-> replica process)
# ---------------------------------------------------------------------------
# Length-prefixed pickle over a localhost socket: 8-byte magic + u32
# length + payload. Pickle is acceptable here because both ends are OUR
# processes on one box (the fleet_bench / replica contract), and it
# round-trips numpy arrays without this module importing numpy. The
# magic catches a desynced or foreign stream before pickle ever sees it.

WIRE_MAGIC = b"MAMLFLT1"
_LEN = struct.Struct("!I")
MAX_FRAME_BYTES = 1 << 28  # 256 MiB: no sane request is bigger


def send_msg(sock, obj: Any) -> None:
    # Sampled requests carry their trace context as an optional "trace"
    # key (omitted entirely when unsampled — rate=0 wire bytes are
    # byte-identical to untraced builds); the send itself is a span.
    ctx = obj.get("trace") if isinstance(obj, dict) else None
    t0 = time.monotonic() if ctx is not None else 0.0
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(WIRE_MAGIC + _LEN.pack(len(payload)) + payload)
    if ctx is not None:
        rt = reqtrace_mod()
        rt.record_span(ctx, rt.SPAN_WIRE_SEND, t0,
                       time.monotonic() - t0, frame_bytes=len(payload))


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf += chunk
    return buf


def recv_msg(sock) -> Any:
    head = _recv_exact(sock, len(WIRE_MAGIC) + _LEN.size)
    if head[:len(WIRE_MAGIC)] != WIRE_MAGIC:
        raise ConnectionError(f"bad frame magic {head[:8]!r}")
    (length,) = _LEN.unpack(head[len(WIRE_MAGIC):])
    if length > MAX_FRAME_BYTES:
        raise ConnectionError(f"frame of {length} bytes exceeds cap")
    # The wire_recv span starts AFTER the head arrives: reader threads
    # park in the blocking head read between requests, and that idle
    # time is not wire time. Whether the frame was sampled is only
    # knowable after unpickling, so the clock reads are unconditional
    # (two monotonic calls; no allocation when untraced).
    t0 = time.monotonic()
    msg = pickle.loads(_recv_exact(sock, length))
    ctx = msg.get("trace") if isinstance(msg, dict) else None
    if ctx is not None:
        t1 = time.monotonic()
        rt = reqtrace_mod()
        rt.record_span(ctx, rt.SPAN_WIRE_RECV, t0, t1 - t0,
                       frame_bytes=length)
        # Receipt instant for the receiver's queue span (replica reader:
        # recv -> engine submit) — local monotonic time, this process.
        ctx["recv_t"] = t1
    return msg
