r"""Fleet controller: rolling hot-swap + autoscale/drain signals.

The port's own copy of the JAX package's ``serve/fleet/controller.py``
(the same ``ROLLOUT.json`` schema and state machine). It imports nothing
of that package.

The single-engine hot-swap (``serve/engine.py § maybe_hot_swap``) makes
one replica adopt a newly published checkpoint behind a canary. At
fleet scale that must become a **rolling** swap — replicas swap one at
a time *behind the router*, so the fleet never has fewer than N-1
replicas serving and a bad version is caught by the FIRST replica's
canary instead of torching all of them at once.

Coordination is file-based over the same shared ``fleet_dir`` the
leases live in (no new transport; a controller crash loses nothing —
the state machine is one small JSON, re-entered on the next tick):

* ``ROLLOUT.json`` — the rollout record ``{version, replicas, index,
  state, rejected}``, atomically rewritten on every transition
  (``ckpt/manifest.py`` idiom). ``rejected`` is the FLEET-WIDE pin
  list: replicas read it every loop and refuse those versions locally,
  so one canary fail stops the version everywhere, not just where it
  failed.
* **Drain = lease tombstone** (``router.py § drain_path``): the
  controller tombstones exactly one replica at a time. A tombstoned
  replica leaves the ring (the router spills its tenants to the next
  ring position, where the shared L2 absorbs the re-adapt), finishes
  its queue, runs the engine's canary + swap, and reports the outcome
  through its lease payload (``version`` on success, ``swap_failed``
  on a canary rejection). The controller's ``tick()`` reads that
  payload and advances / halts.

State machine (docs/SERVING.md § Fleet has the prose version)::

    idle -> rolling --(replica acked version)--> rolling(index+1)
                 \--(swap_failed / replica died)--> halted (version
                    pinned in `rejected`, tombstone removed)
    rolling(index == len(replicas)) -> done

**Weighted rollouts** (``start_rollout(..., weights=...)``, config
``fleet_canary_weights``) interleave the same swap steps with BAKE
stages: after the first replica adopts the version, the traffic split
(``router.assign_canary`` — a deterministic hash of (tenant, seq))
sends ``weights[stage]`` of live requests to the swapped cohort while
two per-cohort :class:`SLOLedger` instances compare canary-vs-stable
burn rates. Each stage promotes only on fresh evidence (>=
``fleet_canary_min_requests`` canary completions, burn under
``max(1, stable * fleet_canary_burn_factor)``); a regression halts
and pins the version exactly like a canary failure. Reaching the
final 1.0 weight promotes the remaining replicas through the ordinary
rolling machine.

Autoscale/drain signals: :meth:`publish_signals` folds the per-replica
serving stats the replicas already publish in their lease payloads
(queue depth, p95, cache hit fraction — derived from the existing
serve/* telemetry on the replica side) into ``fleet/*`` gauges and
delta-accumulated counters in the controller's registry, so one flush
row carries the whole fleet picture and the report's fleet section
stays reset-aware across replica restarts.

Stdlib-only, no package imports (loadable by file path — the torch-free
router process hosts the controller).
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

ROLLOUT_FILE = "ROLLOUT.json"
ROLLOUT_SCHEMA = "maml_fleet_rollout_v1"

IDLE = "idle"
ROLLING = "rolling"
DONE = "done"
HALTED = "halted"

# Eagerly-registered controller metrics.
SWAPS_COUNTER = "fleet/rolling_swaps"
SWAP_STEPS_COUNTER = "fleet/rolling_swap_steps"
HALTS_COUNTER = "fleet/rolling_swap_halts"
CANARY_STAGE_COUNTER = "fleet/canary_stage_promotions"
CANARY_WEIGHT_GAUGE = "fleet/canary_weight"
QUEUE_GAUGE = "fleet/queue_depth_total"
P95_GAUGE = "fleet/p95_ms_max"
HIT_FRAC_GAUGE = "fleet/cache_hit_frac_min"
SLO_BURN_GAUGE = "fleet/slo_burn_rate"
SLO_GOOD_COUNTER = "fleet/slo_good_total"
SLO_BAD_COUNTER = "fleet/slo_bad_total"

# Replica-side aggregate counters re-published fleet-wide (summed over
# replica payloads, delta-accumulated so the controller's counters stay
# monotonic even when a replica restarts and its own counts reset).
# DISTINCT names from the replicas' own fleet/l2_* counters: a log that
# carries both a replica's flush rows and the controller's would
# otherwise feed the telemetry report the same hits twice.
_AGG_COUNTERS = {
    "l2_hits": "fleet/agg_l2_hits",
    "l2_misses": "fleet/agg_l2_misses",
    "l2_errors": "fleet/agg_l2_errors",
    "responses": "fleet/agg_responses_total",
}


def _atomic_write_json(path: str, obj: Any) -> None:
    # Mirrors ckpt/manifest.py § atomic_write_json (re-implemented so
    # this module stays loadable by file path).
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _nearest_rank(sorted_values: List[float], q: float) -> float:
    # utils/tracing.py § nearest_rank, re-implemented (no package
    # imports — the one pinned quantile definition).
    if not sorted_values:
        raise ValueError("nearest_rank of an empty sequence")
    if not 0 < q <= 1:
        raise ValueError(f"quantile {q} outside (0, 1]")
    return sorted_values[max(0, math.ceil(q * len(sorted_values)) - 1)]


class SLOLedger:
    """Per-tenant rolling good/bad request windows against a latency SLO.

    Each observed request is judged against ``slo_p95_ms`` (good = at or
    under) into a per-tenant rolling window of the last ``window``
    requests.  The headline signal is the **burn rate**:

        burn = bad_fraction / (1 - target_frac)

    — the SRE error-budget convention: 1.0 means the fleet is spending
    its error budget exactly as fast as the SLO allows; 2.0 means the
    budget burns at twice the sustainable rate (scale up); well under
    1.0 means latency headroom (scale-down is safe).  Feeding
    :func:`advise` this instead of raw queue depth makes autoscaling
    SLO-derived: queue depth says the fleet is busy, burn rate says the
    USERS are hurting.

    Thread-safe (the frontend's response callbacks observe concurrently);
    stdlib-only.  ``registry`` is the metrics-registry duck — when it
    also has ``histogram`` (the real MetricsRegistry, or the bench's
    mini duck), per-tenant latency histograms land under
    ``fleet/tenant/<t>/latency_ms`` so flush rows carry the per-tenant
    tail, reset-aware like every other counter stream.
    """

    def __init__(self, *, slo_p95_ms: float, target_frac: float,
                 window: int = 512, registry: Optional[Any] = None):
        if slo_p95_ms <= 0:
            raise ValueError(f"slo_p95_ms must be > 0, got {slo_p95_ms}")
        if not 0.0 < target_frac < 1.0:
            raise ValueError(
                f"target_frac must be in (0, 1), got {target_frac}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.slo_p95_ms = float(slo_p95_ms)
        self.target_frac = float(target_frac)
        self.window = int(window)
        self.registry = registry
        self._lock = threading.Lock()
        self._tenants: Dict[str, deque] = {}
        if registry is not None:
            registry.counter(SLO_GOOD_COUNTER)
            registry.counter(SLO_BAD_COUNTER)

    def observe(self, tenant: Any, latency_ms: float) -> bool:
        """Record one completed request; returns whether it met the SLO."""
        latency_ms = float(latency_ms)
        ok = latency_ms <= self.slo_p95_ms
        tenant = str(tenant)
        with self._lock:
            window = self._tenants.get(tenant)
            if window is None:
                window = self._tenants[tenant] = deque(maxlen=self.window)
            window.append((latency_ms, ok))
        reg = self.registry
        if reg is not None:
            reg.counter(SLO_GOOD_COUNTER if ok else SLO_BAD_COUNTER).inc()
            if hasattr(reg, "histogram"):
                reg.histogram(f"fleet/tenant/{tenant}/latency_ms").observe(
                    latency_ms)
            reg.gauge(SLO_BURN_GAUGE).set(self.burn_rate() or 0.0)
        return ok

    def _rows(self, tenant: Optional[str]) -> List[Tuple[float, bool]]:
        if tenant is not None:
            return list(self._tenants.get(str(tenant)) or ())
        out: List[Tuple[float, bool]] = []
        for window in self._tenants.values():
            out.extend(window)
        return out

    def count(self, tenant: Optional[str] = None) -> int:
        """Requests currently in the rolling window(s) — the evidence
        size a bake-stage decision is allowed to rest on."""
        with self._lock:
            return len(self._rows(tenant))

    def burn_rate(self, tenant: Optional[str] = None) -> Optional[float]:
        """Error-budget burn rate over the rolling window(s); None when
        nothing has been observed (an honest "no data", never a fake
        0 — advise() treats None as "no SLO signal")."""
        with self._lock:
            rows = self._rows(tenant)
        if not rows:
            return None
        bad_frac = sum(1 for _, ok in rows if not ok) / len(rows)
        return bad_frac / (1.0 - self.target_frac)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant ledger view: window count, bad fraction, burn
        rate, and EXACT nearest-rank p50/p95/p99 latency from the
        window (the window holds raw values, so no bucket error)."""
        with self._lock:
            tenants = {t: list(w) for t, w in self._tenants.items()}
        out: Dict[str, Dict[str, Any]] = {}
        for t, rows in sorted(tenants.items()):
            lat = sorted(ms for ms, _ in rows)
            bad = sum(1 for _, ok in rows if not ok)
            out[t] = {
                "count": len(rows),
                "bad_frac": bad / len(rows) if rows else 0.0,
                "burn_rate": ((bad / len(rows))
                              / (1.0 - self.target_frac) if rows else 0.0),
                "p50_ms": _nearest_rank(lat, 0.50) if lat else None,
                "p95_ms": _nearest_rank(lat, 0.95) if lat else None,
                "p99_ms": _nearest_rank(lat, 0.99) if lat else None,
            }
        return out


class FleetController:
    """Rolling-swap frontend + fleet signal aggregator.

    ``members`` is a zero-arg callable returning the router's
    membership snapshot (``FleetRouter.refresh``'s return shape:
    ``{rid: {"state", "age", "payload", "draining"}}``) — injected
    rather than re-read here so the router and controller always act
    on ONE view per loop, and so tests drive the state machine with a
    plain dict.
    """

    def __init__(self, fleet_dir: str,
                 members: Callable[[], Dict[int, Dict[str, Any]]],
                 *, registry: Optional[Any] = None,
                 step_stall_timeout_s: float = 600.0,
                 slo_p95_ms: float = 2000.0,
                 slo_target_frac: float = 0.95,
                 canary_min_requests: int = 32,
                 canary_burn_factor: float = 2.0):
        self.fleet_dir = fleet_dir
        self.members = members
        self.registry = registry
        self.step_stall_timeout_s = float(step_stall_timeout_s)
        self.rollout_path = os.path.join(fleet_dir, ROLLOUT_FILE)
        self._agg_prev: Dict[str, Dict[int, float]] = {}
        # SLO ledger (config: fleet_slo_p95_ms / fleet_slo_target_frac):
        # whoever observes completed requests — the bench frontend, a real
        # frontend — calls controller.slo.observe(tenant, latency_ms);
        # publish_signals folds the burn rate into the signal dict
        # advise() reads.
        self.slo = SLOLedger(slo_p95_ms=slo_p95_ms,
                             target_frac=slo_target_frac,
                             registry=registry)
        # Weighted-canary cohort ledgers (config: fleet_canary_*): the
        # frontend attributes each completion to the cohort that served it
        # via observe_cohort(); a bake stage promotes or halts on the
        # canary-vs-stable burn comparison. Fresh ledgers per stage —
        # each stage's verdict rests on its own evidence, never on
        # requests a lighter weight already judged.
        self.canary_min_requests = int(canary_min_requests)
        self.canary_burn_factor = float(canary_burn_factor)
        self._cohorts: Dict[str, SLOLedger] = {}
        self._reset_cohorts()
        if registry is not None:
            for name in (SWAPS_COUNTER, SWAP_STEPS_COUNTER, HALTS_COUNTER,
                         CANARY_STAGE_COUNTER):
                registry.counter(name)
            for name in _AGG_COUNTERS.values():
                registry.counter(name)

    def _reset_cohorts(self) -> None:
        self._cohorts = {
            name: SLOLedger(slo_p95_ms=self.slo.slo_p95_ms,
                            target_frac=self.slo.target_frac)
            for name in ("canary", "stable")}

    def observe_cohort(self, cohort: str, tenant: Any,
                       latency_ms: float) -> bool:
        """Attribute one completed request to its serving cohort
        (``"canary"`` / ``"stable"``) for the stage comparison. Callers
        still feed ``self.slo`` for the fleet-wide signal — the cohort
        ledgers exist ONLY to judge the rollout."""
        return self._cohorts[cohort].observe(tenant, latency_ms)

    # -- rollout record ---------------------------------------------------
    def read_rollout(self) -> Dict[str, Any]:
        try:
            with open(self.rollout_path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return {"schema": ROLLOUT_SCHEMA, "state": IDLE,
                    "version": None, "replicas": [], "index": 0,
                    "rejected": []}
        doc.setdefault("state", IDLE)
        doc.setdefault("rejected", [])
        doc.setdefault("replicas", [])
        doc.setdefault("index", 0)
        return doc

    def _write_rollout(self, doc: Dict[str, Any]) -> Dict[str, Any]:
        doc["schema"] = ROLLOUT_SCHEMA
        doc["updated_ts"] = time.time()  # the stall clock (tick)
        os.makedirs(self.fleet_dir, exist_ok=True)
        _atomic_write_json(self.rollout_path, doc)
        return doc

    # -- drain tombstones -------------------------------------------------
    def _drain_path(self, rid: int) -> str:
        # router.py § drain_path, inlined (no package imports).
        return os.path.join(self.fleet_dir, f"replica_{int(rid)}.drain")

    def drain(self, rid: int, reason: str = "drain",
              version: Optional[int] = None) -> None:
        """Tombstone one replica: it leaves the ring on the router's
        next refresh while its lease stays alive. Also the manual
        scale-down path — an operator drains, waits for in-flight to
        settle, then stops the process."""
        os.makedirs(self.fleet_dir, exist_ok=True)
        _atomic_write_json(self._drain_path(rid),
                           {"reason": reason, "version": version})

    def undrain(self, rid: int) -> None:
        try:
            os.remove(self._drain_path(rid))
        except OSError:
            pass

    # -- rolling swap -----------------------------------------------------
    def start_rollout(self, version: int,
                      replicas: Optional[List[int]] = None, *,
                      weights: Optional[List[float]] = None
                      ) -> Dict[str, Any]:
        """Begin a rolling swap to ``version``. Replicas default to the
        current live membership in id order (deterministic — operators
        and tests see the same order). Prior ``rejected`` pins carry
        over: a version rejected once stays rejected.

        ``weights`` turns the rollout WEIGHTED (config:
        ``fleet_canary_weights``): the first replica swaps as usual,
        then instead of immediately draining the next one the rollout
        BAKES — the traffic split (``router.assign_canary``) sends
        ``weights[stage]`` of requests to the swapped cohort and
        ``tick()`` promotes stage by stage on canary-vs-stable SLO
        evidence. Reaching the final 1.0 stage promotes: the remaining
        replicas roll exactly like an unweighted rollout."""
        doc = self.read_rollout()
        if version in doc.get("rejected", []):
            return doc  # pinned: never roll a known-bad version
        if replicas is None:
            snapshot = self.members()
            replicas = sorted(r for r, rec in snapshot.items()
                              if rec.get("state") == "live")
        doc.update({"state": ROLLING if replicas else DONE,
                    "version": int(version),
                    "replicas": [int(r) for r in replicas], "index": 0})
        doc.pop("mode", None)
        if weights is not None and replicas:
            self._reset_cohorts()
            doc.update({"mode": "weighted", "phase": "swap",
                        "weights": [float(w) for w in weights],
                        "stage": 0, "canary": [], "stage_history": []})
        # Rollout record FIRST, tombstone second: a crash between the
        # two leaves a rolling record whose next tick() re-drains (the
        # drain write is idempotent) — the reverse order would strand
        # a tombstoned replica with no record telling anyone to ever
        # lift it.
        doc = self._write_rollout(doc)
        if replicas:
            self.drain(replicas[0], reason="rolling_swap",
                       version=int(version))
        return doc

    def tick(self) -> Dict[str, Any]:
        """Advance the rollout one observation: read the draining
        replica's lease payload and decide. Idempotent and re-entrant —
        call it from the router loop at any cadence."""
        doc = self.read_rollout()
        if doc["state"] != ROLLING:
            return doc
        if doc.get("mode") == "weighted":
            return self._tick_weighted(doc)
        version = int(doc["version"])
        replicas = doc["replicas"]
        rid = replicas[doc["index"]]
        rec = self.members().get(rid) or {}
        payload = rec.get("payload") or {}
        failed = (payload.get("swap_failed") == version
                  or version in (payload.get("rejected") or []))
        died = rec.get("state", "dead") == "dead"
        if failed or died:
            # Canary fail (or the replica died mid-swap — same verdict:
            # this version does not roll) halts the WHOLE rollout and
            # pins the version fleet-wide; replicas poll the rejected
            # list and refuse it locally too.
            self.undrain(rid)
            doc["state"] = HALTED
            doc["halt_reason"] = ("replica died mid-swap" if died
                                  else "canary failed")
            doc["halt_detail"] = payload.get("swap_reason")
            doc["halt_replica"] = rid
            if version not in doc["rejected"]:
                doc["rejected"].append(version)
            if self.registry is not None:
                self.registry.counter(HALTS_COUNTER).inc()
            return self._write_rollout(doc)
        if int(payload.get("version") or -1) >= version:
            # Acked: rejoin this replica, move to the next.
            self.undrain(rid)
            doc["index"] += 1
            if self.registry is not None:
                self.registry.counter(SWAP_STEPS_COUNTER).inc()
            if doc["index"] >= len(replicas):
                doc["state"] = DONE
                if self.registry is not None:
                    self.registry.counter(SWAPS_COUNTER).inc()
            else:
                self.drain(replicas[doc["index"]], reason="rolling_swap",
                           version=version)
            return self._write_rollout(doc)
        # Still draining/swapping: wait — but make sure the tombstone
        # actually exists (a crash between the rollout write and the
        # drain, or an operator's stray cleanup, must heal rather than
        # wait forever on a replica that was never told to swap).
        if not os.path.exists(self._drain_path(rid)):
            self.drain(rid, reason="rolling_swap", version=version)
        # Stall backstop: a LIVE replica that can never decide (e.g.
        # the target version was retired from the registry mid-rollout,
        # so its maybe_hot_swap keeps seeing nothing to do) must not
        # keep one replica tombstoned at N-1 capacity forever. A stall
        # is NOT a canary verdict: halt WITHOUT pinning the version,
        # so an operator can retry the same rollout once the cause is
        # fixed.
        age = time.time() - float(doc.get("updated_ts") or time.time())
        if self.step_stall_timeout_s > 0 and age > self.step_stall_timeout_s:
            self.undrain(rid)
            doc["state"] = HALTED
            doc["halt_reason"] = "rollout step stalled"
            doc["halt_detail"] = (f"replica {rid} made no swap decision "
                                  f"in {age:.0f}s")
            doc["halt_replica"] = rid
            if self.registry is not None:
                self.registry.counter(HALTS_COUNTER).inc()
            return self._write_rollout(doc)
        return doc

    # -- weighted canary rollout ------------------------------------------
    def _halt(self, doc: Dict[str, Any], rid: Optional[int], *,
              reason: str, detail: Optional[str],
              pin: bool) -> Dict[str, Any]:
        """Stop the rollout. ``pin`` records the version in the
        fleet-wide ``rejected`` list (an SLO/canary VERDICT); a stall
        halts unpinned so the same rollout can be retried once the
        cause is fixed."""
        if rid is not None:
            self.undrain(rid)
        doc["state"] = HALTED
        doc["halt_reason"] = reason
        doc["halt_detail"] = detail
        doc["halt_replica"] = rid
        if pin and int(doc["version"]) not in doc["rejected"]:
            doc["rejected"].append(int(doc["version"]))
        if self.registry is not None:
            self.registry.counter(HALTS_COUNTER).inc()
        return self._write_rollout(doc)

    def _tick_weighted(self, doc: Dict[str, Any]) -> Dict[str, Any]:
        """One observation of the weighted machine::

            swap --(ack, stage weight < 1)--> bake
            swap --(ack, stage weight == 1)--> swap(next) ... -> done
            swap --(swap_failed / died)--> halted (version pinned)
            bake --(canary burn > max(1, stable burn * factor),
                    over >= min_requests)--> halted (version pinned)
            bake --(burn OK over >= min_requests)--> stage+1
                   (bake again, or swap(next) when the ladder hits 1.0)
            swap/bake --(stalled past step_stall_timeout_s)--> halted
                   (NOT pinned: a stall is not a canary verdict)
        """
        version = int(doc["version"])
        replicas = doc["replicas"]
        weights = [float(w) for w in doc["weights"]]
        stage = int(doc["stage"])
        if self.registry is not None:
            self.registry.gauge(CANARY_WEIGHT_GAUGE).set(
                weights[min(stage, len(weights) - 1)])
        age = time.time() - float(doc.get("updated_ts") or time.time())
        stalled = (self.step_stall_timeout_s > 0
                   and age > self.step_stall_timeout_s)
        if doc.get("phase") == "swap":
            rid = replicas[doc["index"]]
            rec = self.members().get(rid) or {}
            payload = rec.get("payload") or {}
            died = rec.get("state", "dead") == "dead"
            if (payload.get("swap_failed") == version
                    or version in (payload.get("rejected") or [])
                    or died):
                return self._halt(
                    doc, rid, pin=True,
                    reason=("replica died mid-swap" if died
                            else "canary failed"),
                    detail=payload.get("swap_reason"))
            if int(payload.get("version") or -1) >= version:
                self.undrain(rid)
                doc["canary"] = sorted(
                    set(int(r) for r in (doc.get("canary") or []))
                    | {int(rid)})
                doc["index"] += 1
                if self.registry is not None:
                    self.registry.counter(SWAP_STEPS_COUNTER).inc()
                if doc["index"] >= len(replicas):
                    doc["state"] = DONE
                    if self.registry is not None:
                        self.registry.counter(SWAPS_COUNTER).inc()
                elif weights[stage] >= 1.0:
                    # Promote ladder reached 1.0: keep rolling, one
                    # replica at a time, exactly like the unweighted
                    # machine.
                    self.drain(replicas[doc["index"]],
                               reason="weighted_rollout", version=version)
                else:
                    doc["phase"] = "bake"
                return self._write_rollout(doc)
            if not os.path.exists(self._drain_path(rid)):
                self.drain(rid, reason="weighted_rollout", version=version)
            if stalled:
                return self._halt(
                    doc, rid, pin=False, reason="rollout step stalled",
                    detail=(f"replica {rid} made no swap decision "
                            f"in {age:.0f}s"))
            return doc
        # -- bake: judge weights[stage] on cohort SLO evidence ----------
        canary, stable = self._cohorts["canary"], self._cohorts["stable"]
        n = canary.count()
        c_burn = canary.burn_rate()
        if n >= self.canary_min_requests and c_burn is not None:
            s_burn = stable.burn_rate()
            threshold = max(1.0, (s_burn or 0.0) * self.canary_burn_factor)
            if c_burn > threshold:
                doc["halt_stage"] = stage
                doc["halt_canary_burn"] = round(c_burn, 4)
                doc["halt_stable_burn"] = (None if s_burn is None
                                           else round(s_burn, 4))
                return self._halt(
                    doc, None, pin=True, reason="canary slo regression",
                    detail=(f"stage {stage} weight {weights[stage]:g}: "
                            f"canary burn {c_burn:.2f} > allowed "
                            f"{threshold:.2f} (stable "
                            f"{0.0 if s_burn is None else s_burn:.2f})"))
            doc["stage_history"].append({
                "stage": stage, "weight": weights[stage],
                "canary": {"count": n, "burn_rate": round(c_burn, 4)},
                "stable": {"count": stable.count(),
                           "burn_rate": (None if s_burn is None
                                         else round(s_burn, 4))}})
            doc["stage"] = stage = stage + 1
            self._reset_cohorts()
            if self.registry is not None:
                self.registry.counter(CANARY_STAGE_COUNTER).inc()
            if stage >= len(weights) or weights[stage] >= 1.0:
                doc["stage"] = min(stage, len(weights) - 1)
                doc["phase"] = "swap"
                self.drain(replicas[doc["index"]],
                           reason="weighted_rollout", version=version)
            return self._write_rollout(doc)
        if stalled:
            return self._halt(
                doc, None, pin=False, reason="bake stage stalled",
                detail=(f"stage {stage}: {n}/{self.canary_min_requests} "
                        f"canary observations in {age:.0f}s"))
        return doc

    def traffic_split(self) -> Dict[str, Any]:
        """The live split a frontend feeds ``router.route(among=...)``:
        ``{"weight", "canary", "stage"}``. ``weight`` None = split off
        (no weighted bake in flight — either no weighted rollout, or
        the promote leg where traffic routes unrestricted while the
        remaining replicas swap)."""
        doc = self.read_rollout()
        if doc.get("mode") != "weighted" or doc.get("state") != ROLLING:
            return {"weight": None, "canary": [], "stage": None}
        canary = [int(r) for r in (doc.get("canary") or [])]
        if not canary:
            return {"weight": None, "canary": [], "stage": None}
        stage = int(doc["stage"])
        weight = float(doc["weights"][stage])
        if doc.get("phase") != "bake" or weight >= 1.0:
            return {"weight": None, "canary": canary, "stage": stage}
        return {"weight": weight, "canary": canary, "stage": stage}

    # -- autoscale / drain signals ---------------------------------------
    def publish_signals(self,
                        snapshot: Optional[Dict[int, Dict[str, Any]]] = None
                        ) -> Dict[str, Any]:
        """Fold per-replica lease-payload stats into fleet/* metrics.

        Gauges take the fleet-aggregate view (total queue depth, worst
        p95, worst hit fraction — the autoscale inputs); counters sum
        replica-published cumulative counts with per-replica reset
        detection (a restarted replica's counts drop to 0; the delta
        rule contributes only growth, the Prometheus rate() rule the
        report also applies)."""
        snapshot = self.members() if snapshot is None else snapshot
        queue_total = 0.0
        p95_max: Optional[float] = None
        hit_min: Optional[float] = None
        sums: Dict[str, float] = {k: 0.0 for k in _AGG_COUNTERS}
        for rid, rec in sorted(snapshot.items()):
            payload = rec.get("payload") or {}
            stats = payload.get("stats") or {}
            queue_total += float(stats.get("queue_depth") or 0.0)
            v = stats.get("p95_ms")
            if isinstance(v, (int, float)):
                p95_max = v if p95_max is None else max(p95_max, v)
            v = stats.get("cache_hit_frac")
            if isinstance(v, (int, float)):
                hit_min = v if hit_min is None else min(hit_min, v)
            for label in _AGG_COUNTERS:
                v = stats.get(label)
                if not isinstance(v, (int, float)):
                    continue
                prev = self._agg_prev.setdefault(label, {})
                p = prev.get(rid, 0.0)
                delta = float(v) if v < p else float(v) - p
                prev[rid] = float(v)
                sums[label] += delta
        burn = self.slo.burn_rate()
        if self.registry is not None:
            self.registry.gauge(QUEUE_GAUGE).set(queue_total)
            if p95_max is not None:
                self.registry.gauge(P95_GAUGE).set(p95_max)
            if hit_min is not None:
                self.registry.gauge(HIT_FRAC_GAUGE).set(hit_min)
            if burn is not None:
                self.registry.gauge(SLO_BURN_GAUGE).set(burn)
            for label, name in _AGG_COUNTERS.items():
                if sums[label] > 0:
                    self.registry.counter(name).inc(sums[label])
        return {"queue_depth_total": queue_total, "p95_ms_max": p95_max,
                "cache_hit_frac_min": hit_min, "slo_burn_rate": burn,
                **{k: sums[k] for k in _AGG_COUNTERS}}


def advise(signals: Dict[str, Any], *, live: int,
           queue_per_replica_high: float = 32.0,
           p95_high_ms: float = 2000.0,
           queue_per_replica_low: float = 1.0,
           min_replicas: int = 1,
           burn_rate_high: float = 2.0,
           burn_rate_low: float = 0.25) -> str:
    """Pure autoscale verdict from one signal snapshot: ``scale_up``
    when queueing, tail latency or the SLO burn rate says the fleet is
    behind, ``scale_down`` when it is idle beyond the floor AND the
    error budget has headroom, else ``hold``. Deliberately a function,
    not a loop — the operator (or bench) decides what to do with the
    advice.

    The burn-rate clauses make the verdict SLO-derived: a burn rate at
    or past ``burn_rate_high`` scales up even with short queues (slow
    replicas hurt users without queueing), and a scale-down is vetoed
    while burn exceeds ``burn_rate_low`` (shrinking a fleet that is
    already spending error budget is how outages start). A snapshot
    with no SLO signal (``slo_burn_rate`` absent or None — no ledger,
    or nothing observed yet) behaves exactly as before the ledger
    existed."""
    live = max(int(live), 1)
    per = float(signals.get("queue_depth_total") or 0.0) / live
    p95 = signals.get("p95_ms_max")
    burn = signals.get("slo_burn_rate")
    has_burn = isinstance(burn, (int, float))
    if per >= queue_per_replica_high or (
            isinstance(p95, (int, float)) and p95 >= p95_high_ms) or (
            has_burn and burn >= burn_rate_high):
        return "scale_up"
    if (per <= queue_per_replica_low and live > max(min_replicas, 1)
            and (not has_burn or burn <= burn_rate_low)):
        return "scale_down"
    return "hold"
