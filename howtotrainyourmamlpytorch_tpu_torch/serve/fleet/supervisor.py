"""Fleet supervisor: replica process lifecycle + closed-loop autoscale.

The port's own copy of the JAX package's ``serve/fleet/supervisor.py``
(its sibling router and retry modules resolve to the port's files, under
aliases of their own). It imports nothing of that package.

Everything below the router (``serve/fleet/router.py``) ASSUMES someone
keeps replica processes alive: leases age out, the ring shrinks, and
the bench frontend shrugs. This module is that someone — the missing
actuator that turns the fleet from "observed" into "self-healing":

* **Restart with backoff** — the supervisor owns one OS process per
  fleet *slot*. A crashed replica (non-zero exit, SIGKILL, wedged
  heartbeat) is respawned after a jittered exponential backoff
  (``resilience/retry.py § backoff_delay`` — the one backoff
  definition in the repo; the attempt number is the slot's restart
  count inside the rolling window, so repeated crashes back off
  further while a one-off crash restarts almost immediately).
* **Crash-loop circuit breaker** — a slot that restarts
  ``max_restarts`` times inside ``restart_window_s`` is POISONED (bad
  checkpoint, broken venv, port squatter); respawning it forever burns
  CPU and log disk while hiding the outage. The breaker marks the slot
  FAILED (``fleet/crash_loops`` counter + an events row), the fleet
  serves at N-1, and only an operator (or ``reset_slot``) re-arms it.
* **Closed autoscaling loop** — ``FleetController.advise`` emits
  scale_up/scale_down; the supervisor acts on it. ``tick()``
  takes the advice, moves the desired-replica count (clamped to
  ``[scale_min, scale_max]``), and reconciles: scale-up spawns into
  the lowest free slot; scale-down writes the drain tombstone on the
  highest RUNNING slot (``router.py § drain_path`` — the replica
  leaves the ring immediately, in-flight work completes), waits for
  its queue to empty plus a grace period, then terminates and reaps.

The supervisor is stdlib-only and loadable by file path (the
router/controller discipline): it must survive exactly the failures it
supervises, so it shares no runtime with the replicas beyond the lease
directory. Only ``backoff_delay`` reaches further: the port's
``resilience/retry.py`` imports its package, which imports torch. Its clock is ``time.time()`` —
lease ages are mtime-derived, so the supervisor and the leases must
read the same clock (the ``read_members`` contract).

State machine per slot::

    EMPTY --spawn--> STARTING --lease live+port--> RUNNING
    STARTING/RUNNING --proc exit--> EMPTY(backoff)   [fleet/restarts]
                    `--window exceeded--> FAILED     [fleet/crash_loops]
    RUNNING --lease dead, proc alive--> kill -> (proc exit path)
    RUNNING --scale down--> DRAINING --queue empty + grace-->
        SIGTERM --exit--> reap (lease+tombstone removed) -> EMPTY

``spawn_fn(slot) -> proc`` is injectable (anything with ``poll()``,
``pid``, ``terminate()``, ``kill()`` — a ``subprocess.Popen`` or a
test fake), which keeps every transition above unit-testable without
sockets or real processes (tests/test_fleet_supervisor.py).
"""

from __future__ import annotations

import json
import math
import os
import random
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

# Lease-age states (textual mirrors of router.py's constants; the
# classify() calls go through the router module itself, so a rename
# there surfaces as a loud AttributeError, never silent drift).
LIVE_STATE = "live"
STALLED_STATE = "stalled"
DEAD_STATE = "dead"

# Slot states.
EMPTY = "empty"
STARTING = "starting"
RUNNING = "running"
DRAINING = "draining"
FAILED = "failed"

# Eagerly-registered supervisor metrics (a flush row must show
# "0 restarts", not an absent key — the router-counter discipline).
RESTARTS_COUNTER = "fleet/restarts"
CRASH_LOOPS_COUNTER = "fleet/crash_loops"
SCALE_UPS_COUNTER = "fleet/scale_ups"
SCALE_DOWNS_COUNTER = "fleet/scale_downs"
DESIRED_GAUGE = "fleet/replicas_desired"

# -- sibling/package modules, resolved lazily -----------------------------
# Resolution order: the package copy already in sys.modules (a process
# that imported the package shares its objects), else a FILE-PATH load
# under a private alias, else the package import. File-path beats
# package import here — the router is stdlib-only and pure, but its
# parent package's __init__ pulls torch, and the supervisor must stay
# loadable without it (the reason it exists as a file-path-loadable
# module at all).
_ROUTER_PKG = "howtotrainyourmamlpytorch_tpu_torch.serve.fleet.router"
_RETRY_PKG = "howtotrainyourmamlpytorch_tpu_torch.resilience.retry"
_router_cached: Optional[Any] = None
_backoff_cached: Optional[Callable[..., float]] = None


def _load_sibling(pkg_name: str, rel_path: str, alias: str) -> Any:
    import sys
    mod = sys.modules.get(pkg_name) or sys.modules.get(alias)
    if mod is not None:
        return mod
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        import importlib.util
        path = os.path.join(here, *rel_path.split("/"))
        spec = importlib.util.spec_from_file_location(alias, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[alias] = mod
        return mod
    except Exception:  # noqa: BLE001 — fall back to the package import
        import importlib
        repo_root = os.path.abspath(os.path.join(here, *[os.pardir] * 3))
        if repo_root not in sys.path:
            sys.path.insert(0, repo_root)
        return importlib.import_module(pkg_name)


def router_mod() -> Any:
    global _router_cached
    if _router_cached is None:
        _router_cached = _load_sibling(
            _ROUTER_PKG, "router.py", "_maml_torch_fleet_router_sup")
    return _router_cached


class _EventAppender:
    """Minimal JsonlLogger-shaped sink over the supervisor's events
    file: the alert evaluator only needs ``.log(event, **payload)``,
    and alert transitions must land in the same stream as the
    supervisor's own rows (fail-soft, same as ``_event``)."""

    def __init__(self, path: str):
        self.path = path

    def log(self, event: str, **payload: Any) -> Dict[str, Any]:
        row: Dict[str, Any] = {"ts": payload.get("at_ts") or time.time(),
                               "event": event}
        row.update(payload)
        try:
            with open(self.path, "a") as f:
                f.write(json.dumps(row, default=str) + "\n")
        except OSError:
            pass
        return row


def backoff_delay(*args: Any, **kwargs: Any) -> float:
    """``resilience/retry.py § backoff_delay`` via the lazy resolver —
    ONE backoff definition in the repo, not a re-implementation."""
    global _backoff_cached
    if _backoff_cached is None:
        mod = _load_sibling(_RETRY_PKG, "../../resilience/retry.py",
                            "_maml_torch_fleet_retry_sup")
        _backoff_cached = mod.backoff_delay
    return _backoff_cached(*args, **kwargs)


class CrashLoopBreaker:
    """Rolling-window restart budget per slot (pure, clock-in).

    ``record_restart`` logs one restart and answers "did this slot just
    exhaust its budget?" — True when the window now holds
    ``max_restarts`` restarts, i.e. the NEXT respawn would be the
    (max_restarts+1)-th crash-and-restart inside ``window_s``. The
    deque prunes itself, so a slot that crashes once a day never trips.
    """

    def __init__(self, max_restarts: int = 3, window_s: float = 60.0):
        if max_restarts < 1:
            raise ValueError(
                f"max_restarts must be >= 1, got {max_restarts}")
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.max_restarts = int(max_restarts)
        self.window_s = float(window_s)
        self._restarts: Dict[int, Deque[float]] = {}

    def _prune(self, slot: int, now: float) -> Deque[float]:
        dq = self._restarts.setdefault(int(slot), deque())
        while dq and now - dq[0] > self.window_s:
            dq.popleft()
        return dq

    def restarts_in_window(self, slot: int, now: float) -> int:
        return len(self._prune(slot, now))

    def record_restart(self, slot: int, now: float) -> bool:
        dq = self._prune(slot, now)
        dq.append(now)
        return len(dq) >= self.max_restarts

    def reset(self, slot: int) -> None:
        self._restarts.pop(int(slot), None)


class ReplicaSupervisor:
    """Owns the replica fleet's processes; see module docstring.

    ``registry`` is duck-typed on the telemetry MetricsRegistry
    (counter/gauge get-or-create); None runs unobserved. ``events_path``
    (optional) receives one JSONL row per lifecycle transition plus
    ``flush_metrics()`` rows the telemetry report folds into its
    fleet-health section.
    """

    def __init__(self, fleet_dir: str,
                 spawn_fn: Callable[[int], Any], *,
                 desired: Optional[int] = None,
                 scale_min: int = 1, scale_max: int = 4,
                 max_restarts: int = 3, restart_window_s: float = 60.0,
                 stalled_after_s: float = 1.5, dead_after_s: float = 3.0,
                 start_timeout_s: float = 60.0,
                 backoff_base_s: float = 0.05, backoff_cap_s: float = 2.0,
                 drain_grace_s: float = 1.0,
                 registry: Optional[Any] = None,
                 events_path: Optional[str] = None,
                 alert_evaluator: Optional[Any] = None,
                 rng: Optional[random.Random] = None):
        if scale_min < 1:
            raise ValueError(f"scale_min must be >= 1, got {scale_min}")
        if scale_max < scale_min:
            raise ValueError(
                f"scale_max {scale_max} < scale_min {scale_min}")
        self.fleet_dir = fleet_dir
        self.spawn_fn = spawn_fn
        self.scale_min = int(scale_min)
        self.scale_max = int(scale_max)
        self.desired = min(max(int(desired if desired is not None
                                   else scale_min), self.scale_min),
                           self.scale_max)
        self.stalled_after_s = float(stalled_after_s)
        self.dead_after_s = float(dead_after_s)
        self.start_timeout_s = float(start_timeout_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.drain_grace_s = float(drain_grace_s)
        self.registry = registry
        self.events_path = events_path
        # Duck-typed telemetry/alerts.py § AlertEvaluator (this module
        # stays stdlib + file-path loadable, so the caller constructs
        # it). None = alerting off: no rule ever runs, no event row
        # grows an alerts_firing field — the zero-cost discipline.
        self.alerts = alert_evaluator
        self.rng = random.Random() if rng is None else rng
        self.breaker = CrashLoopBreaker(max_restarts, restart_window_s)
        # Slot table: every slot 0..scale_max-1 exists from birth; a
        # slot is a STABLE identity (its replica id, lease name, port
        # affinity all derive from it) — scale churn moves slots
        # between EMPTY and RUNNING, never renumbers them.
        self.slots: Dict[int, Dict[str, Any]] = {
            s: {"state": EMPTY, "proc": None, "started_at": 0.0,
                "next_spawn_at": 0.0, "drained_at": 0.0}
            for s in range(self.scale_max)}
        if registry is not None:
            for name in (RESTARTS_COUNTER, CRASH_LOOPS_COUNTER,
                         SCALE_UPS_COUNTER, SCALE_DOWNS_COUNTER):
                registry.counter(name)

    # Decision kinds annotated with the alerts firing at decision time:
    # "the autoscaler scaled up WHILE slo_burn_high was firing" is the
    # line an operator needs in the post-mortem.
    _DECISION_KINDS = frozenset({
        "scale_up", "scale_down", "restart_scheduled", "crash_loop",
        "lease_dead_kill", "start_timeout_kill", "draining"})

    # -- small helpers ----------------------------------------------------
    def _event(self, kind: str, now: float, **fields: Any) -> None:
        if self.events_path is None:
            return
        row = {"event": "fleet_supervisor", "kind": kind, "ts": now}
        row.update(fields)
        if self.alerts is not None and kind in self._DECISION_KINDS:
            row["alerts_firing"] = sorted(
                {a["rule"] for a in self.alerts.active()})
        try:
            with open(self.events_path, "a") as f:
                f.write(json.dumps(row, default=str) + "\n")
        except OSError:
            pass  # fail-soft: supervision beats bookkeeping

    def _inc(self, name: str) -> None:
        if self.registry is not None:
            self.registry.counter(name).inc()

    def _cleanup_slot_files(self, slot: int) -> None:
        rt = router_mod()
        for path in (rt.lease_path(self.fleet_dir, slot),
                     rt.drain_path(self.fleet_dir, slot)):
            try:
                os.remove(path)
            except OSError:
                pass

    def states(self) -> Dict[int, str]:
        return {s: rec["state"] for s, rec in self.slots.items()}

    def count(self, *states: str) -> int:
        return sum(1 for rec in self.slots.values()
                   if rec["state"] in states)

    def reset_slot(self, slot: int) -> None:
        """Operator re-arm of a FAILED slot (fresh restart budget)."""
        rec = self.slots[int(slot)]
        if rec["state"] == FAILED:
            rec.update(state=EMPTY, proc=None, next_spawn_at=0.0)
            self.breaker.reset(slot)

    # -- the loop ---------------------------------------------------------
    def tick(self, now: Optional[float] = None,
             advice: str = "hold") -> Dict[int, str]:
        """One supervision pass; returns the post-tick slot states.

        ``advice`` is ``FleetController.advise()``'s verdict verbatim
        ("scale_up" / "scale_down" / "hold") — this is where the
        autoscaling loop closes.
        """
        now = time.time() if now is None else now
        self._apply_advice(advice, now)
        rt = router_mod()
        members = rt.read_members(self.fleet_dir, now=now)
        for slot in sorted(self.slots):
            self._observe_slot(slot, members, now)
        self._reconcile(members, now)
        if self.registry is not None:
            self.registry.gauge(DESIRED_GAUGE).set(self.desired)
        if self.alerts is not None:
            self._evaluate_alerts(members, now)
        return self.states()

    def _evaluate_alerts(self, members: Dict[int, Dict[str, Any]],
                         now: float) -> None:
        """Rule pass at the tick's end — the restart/crash counters the
        tick just bumped are visible, and absence rules see one
        ``lease:<slot>`` age per slot that SHOULD be leasing (RUNNING /
        DRAINING; a STARTING slot has not leased yet and must not
        false-fire). A vanished lease file is age ``inf``."""
        ages: Dict[str, float] = {}
        for slot, rec in self.slots.items():
            if rec["state"] in (RUNNING, DRAINING):
                ages[f"lease:{slot}"] = members.get(
                    slot, {}).get("age", math.inf)
        snapshot = (self.registry.snapshot()
                    if self.registry is not None
                    and hasattr(self.registry, "snapshot") else {})
        self.alerts.evaluate(
            now, snapshot=snapshot, ages=ages,
            jsonl=(_EventAppender(self.events_path)
                   if self.events_path is not None else None),
            registry=self.registry)

    def _apply_advice(self, advice: str, now: float) -> None:
        if advice == "scale_up":
            new = min(self.desired + 1, self.scale_max)
            if new != self.desired:
                self.desired = new
                self._inc(SCALE_UPS_COUNTER)
                self._event("scale_up", now, desired=new)
        elif advice == "scale_down":
            new = max(self.desired - 1, self.scale_min)
            if new != self.desired:
                self.desired = new
                self._inc(SCALE_DOWNS_COUNTER)
                self._event("scale_down", now, desired=new)

    def _observe_slot(self, slot: int, members: Dict[int, Dict[str, Any]],
                      now: float) -> None:
        rec = self.slots[slot]
        state, proc = rec["state"], rec["proc"]
        if state in (EMPTY, FAILED) or proc is None:
            return
        exit_code = proc.poll()
        if exit_code is not None:
            if state == DRAINING:
                # Expected exit: the drain reached SIGTERM. Reap.
                self._cleanup_slot_files(slot)
                rec.update(state=EMPTY, proc=None, next_spawn_at=0.0)
                self._event("reaped", now, slot=slot)
            else:
                self._on_crash(slot, exit_code, now)
            return
        member = members.get(slot)
        age = member["age"] if member is not None else float("inf")
        lease_state = rt_classify(age, self.stalled_after_s,
                                  self.dead_after_s)
        if state == STARTING:
            payload = (member or {}).get("payload") or {}
            if lease_state == LIVE_STATE and payload.get("port"):
                rec["state"] = RUNNING
                self._event("running", now, slot=slot, pid=proc.pid)
            elif now - rec["started_at"] > self.start_timeout_s:
                # Never announced: wedged before serving. Kill; the
                # exit surfaces on the next tick as a crash.
                self._event("start_timeout_kill", now, slot=slot)
                proc.kill()
        elif state == RUNNING:
            if lease_state == DEAD_STATE:
                # Alive-but-silent: the one failure poll() cannot see.
                self._event("lease_dead_kill", now, slot=slot,
                            age=age)
                proc.kill()
        elif state == DRAINING:
            payload = (member or {}).get("payload") or {}
            stats = payload.get("stats") or {}
            queue_empty = (stats.get("queue_depth") == 0)
            grace_over = now - rec["drained_at"] >= self.drain_grace_s
            if grace_over and (queue_empty or lease_state == DEAD_STATE):
                self._event("drain_terminate", now, slot=slot)
                proc.terminate()

    def _on_crash(self, slot: int, exit_code: Any, now: float) -> None:
        rec = self.slots[slot]
        tripped = self.breaker.record_restart(slot, now)
        if tripped:
            rec.update(state=FAILED, proc=None)
            self._inc(CRASH_LOOPS_COUNTER)
            self._event("crash_loop", now, slot=slot,
                        exit_code=exit_code,
                        restarts_in_window=self.breaker.restarts_in_window(
                            slot, now))
            self._cleanup_slot_files(slot)
            return
        attempt = max(self.breaker.restarts_in_window(slot, now) - 1, 0)
        delay = backoff_delay(attempt, base=self.backoff_base_s,
                              cap=self.backoff_cap_s, rng=self.rng)
        rec.update(state=EMPTY, proc=None, next_spawn_at=now + delay)
        self._inc(RESTARTS_COUNTER)
        self._event("restart_scheduled", now, slot=slot,
                    exit_code=exit_code, delay_s=delay)
        # The stale lease must go NOW, not at respawn: the router would
        # otherwise keep routing to a port nobody listens on until the
        # lease ages out on its own.
        self._cleanup_slot_files(slot)

    def _reconcile(self, members: Dict[int, Dict[str, Any]],
                   now: float) -> None:
        active = self.count(STARTING, RUNNING)
        # Scale down: tombstone the highest RUNNING slot. One per tick
        # — the rolling-swap discipline; never below desired mid-flight.
        while active > self.desired:
            running = [s for s, rec in self.slots.items()
                       if rec["state"] == RUNNING]
            if not running:
                break
            slot = max(running)
            rt = router_mod()
            doc = {"reason": "scale_down", "version": None}
            path = rt.drain_path(self.fleet_dir, slot)
            tmp = f"{path}.tmp.{os.getpid()}"
            try:
                os.makedirs(self.fleet_dir, exist_ok=True)
                with open(tmp, "w") as f:
                    json.dump(doc, f)
                os.replace(tmp, path)
            except OSError:
                break  # fail-soft; retry next tick
            self.slots[slot].update(state=DRAINING, drained_at=now)
            self._event("draining", now, slot=slot)
            active -= 1
        # Scale up / respawn: fill from the lowest eligible slot. A
        # slot still inside its restart backoff counts as RESERVED
        # capacity — spawning a spare slot over it would churn replica
        # identity (lease name, ring position) on every crash; the
        # restart IS the recovery. Slots that tripped to FAILED are
        # not reserved: a replacement (if a spare slot exists) is the
        # right call for a poisoned slot.
        pending = sum(1 for rec in self.slots.values()
                      if rec["state"] == EMPTY
                      and rec["next_spawn_at"] > now)
        while active + pending < self.desired:
            free = [s for s, rec in self.slots.items()
                    if rec["state"] == EMPTY
                    and now >= rec["next_spawn_at"]]
            if not free:
                break  # all candidates failed or still backing off
            slot = min(free)
            try:
                proc = self.spawn_fn(slot)
            except Exception as e:  # noqa: BLE001 — spawn itself failed
                self._on_crash(slot, f"spawn_error:{type(e).__name__}",
                               now)
                # A failed spawn lands the slot in backoff — RESERVED
                # capacity like any crash; do not backfill a spare
                # over it in the same pass (unless it tripped FAILED).
                if self.slots[slot]["state"] == EMPTY:
                    pending += 1
                continue
            self.slots[slot].update(state=STARTING, proc=proc,
                                    started_at=now)
            self._event("spawn", now, slot=slot,
                        pid=getattr(proc, "pid", None))
            active += 1

    def flush_metrics(self, now: Optional[float] = None) -> None:
        """One ``event: metrics`` row with the supervisor counters —
        the registry.flush_jsonl shape (snapshot nested under
        ``metrics``, source identity under ``replica``) so
        telemetry/report.py's fleet sections fold it like any
        replica's flush."""
        if self.events_path is None or self.registry is None:
            return
        now = time.time() if now is None else now
        snap: Dict[str, Any] = {}
        for name in (RESTARTS_COUNTER, CRASH_LOOPS_COUNTER,
                     SCALE_UPS_COUNTER, SCALE_DOWNS_COUNTER):
            snap[name] = self.registry.counter(name).value
        snap[DESIRED_GAUGE] = self.registry.gauge(DESIRED_GAUGE).value
        if self.alerts is not None:
            # Textual mirror of telemetry/alerts.py § FIRING_GAUGE (the
            # router-constant rule: importing the package would pull
            # torch into this torch-free module).
            snap["maml_alert_firing"] = float(
                self.alerts.firing_summary()["count"])
        row: Dict[str, Any] = {"event": "metrics", "ts": now,
                               "replica": "supervisor", "metrics": snap}
        try:
            with open(self.events_path, "a") as f:
                f.write(json.dumps(row, default=str) + "\n")
        except OSError:
            pass

    def stop(self, kill_after_s: float = 5.0) -> None:
        """Terminate every supervised process (TERM, then KILL) and
        remove their leases — a supervisor shutdown is a fleet
        shutdown, not a mass crash for some successor to diagnose."""
        procs = []
        for slot, rec in self.slots.items():
            proc = rec["proc"]
            if proc is not None and proc.poll() is None:
                try:
                    proc.terminate()
                except OSError:
                    pass
                procs.append((slot, proc))
        deadline = time.time() + kill_after_s
        for slot, proc in procs:
            while proc.poll() is None and time.time() < deadline:
                time.sleep(0.05)
            if proc.poll() is None:
                try:
                    proc.kill()
                except OSError:
                    pass
        for slot, rec in self.slots.items():
            if rec["proc"] is not None:
                self._cleanup_slot_files(slot)
            rec.update(state=(FAILED if rec["state"] == FAILED
                              else EMPTY), proc=None)


# Lease classification goes through the router module so the boundary
# rules never drift; bound lazily (module load must not force the
# sibling import).
def rt_classify(age: float, stalled_after_s: float,
                dead_after_s: float) -> str:
    return router_mod().classify(age, stalled_after_s, dead_after_s)
