"""Fleet chaos suite of the PyTorch port: kill, crash-loop and overload
the serving fleet (the port's counterpart of ``scripts/chaos_fleet.py``,
with its phases, gates and artifact keys).

The self-healing stack (the port's supervisor + router failover +
admission shedding) exercised against the three failure shapes it
exists for, each asserted from the artifact:

1. **kill** — N supervised replicas under load; one is SIGKILLed
   mid-leg. The router's failover policy resubmits the victim's
   orphaned requests to the surviving replicas (``fleet/failovers``),
   the per-replica breaker drops the dead socket from the candidate
   set before its lease ages out, and the supervisor respawns the slot
   (``fleet/restarts``). Asserts: **zero lost requests**, at least one
   restart, and the fleet restored to N live replicas within the
   restoration budget.
2. **crash_loop** — one slot's spawn is poisoned (nonexistent
   checkpoint: the replica exits on boot, every time, before it makes a
   CUDA context). The supervisor restarts it with backoff until the
   crash-loop breaker trips (``fleet/crash_loops``), marks the slot
   FAILED, and the fleet serves the whole leg at N-1 — no infinite
   respawn, zero lost requests.
3. **burst** — one replica, deadline shed policy on. A trickle of
   distinct tenants seeds the admission controller's service-time
   EWMA with honest miss-adapt cost, then a 10x burst slams the queue
   (grown, where the replica drains faster, to 1.5 deadlines' worth of
   the drain rate the priming wave measured).
   Excess load is refused AT ADMISSION with the distinct ``shed``
   status (``fleet/sheds`` > 0); every ADMITTED request completes
   inside its deadline (zero ``failed`` statuses) and the admitted p95
   holds the SLO.

Every phase also runs under alert rules (the port's
``telemetry/alerts.py``): kill proves the lease-absence and
restart-rate alerts fire during the fault and resolve after healing,
crash_loop the crash-loop rate alert, burst the admission-shedding rate
alert. The rollup (``alert_fired_kinds``, ``alerts_resolved``) and a
post-chaos ``scripts/torch_ops_console.py`` render (zero alerts still
firing) gate the ``recovered`` verdict.

Every replica (``python -m
howtotrainyourmamlpytorch_tpu_torch.serve.fleet.replica``) serves on the
card (``--device cuda``, the default; several CUDA contexts share it)
or on the CPU (``--device cpu``); without a card and without ``--device
cpu`` the harness exits non-zero before spawning anything. This process
makes no CUDA context: it only routes and times. ``--config`` serves an
experiment JSON's model and episode shapes (the flagship's width, for
one) and ``--checkpoint`` a trainer's ``saved_models`` (copied);
without them a seeded random checkpoint of the small profile is
written by the fleet bench's ``prepare`` child.

Artifact contract: the LAST stdout JSON line is ``{"metric":
"chaos_fleet", ...}`` with the JAX script's keys — per-phase verdicts,
the schema-stable fleet robustness keys (``fleet_restarts``,
``fleet_crash_loops``, ``fleet_failover_count``, ``fleet_shed_count``)
and the alert rollup — plus, per phase, each replica's boot and restart
seconds (from the supervisor's events) and the BN kernel's launches in
every replica it could still ask, the restarted one included, beside
the count that replica's adapt and predict batches need
(``kernels``); the kill phase adds ``restore_seconds`` (SIGKILL to N
live again). On a box that cannot bind localhost sockets: ``"status":
"skipped"``, exit 0.

Usage:
    python scripts/torch_chaos_fleet.py --quick --device cpu   # 2 replicas
    python scripts/torch_chaos_fleet.py --replicas 3 \
        --config experiment_config/mini-imagenet_maml++_5-way_5-shot_DA_b12.json
    python scripts/torch_chaos_fleet.py --phases kill,burst --out /tmp/cf
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

_SCRIPTS = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_SCRIPTS)
sys.path.insert(0, _SCRIPTS)
sys.path.insert(0, _REPO)

from torch_fleet_bench import (  # noqa: E402
    ReplicaConn, _MiniMetrics, _can_bind_localhost, _kernel_accounting,
    build_schedule, drive_leg, fleet_cfg_dict, prepare_checkpoint,
    require_card)
from torch_fleet_bench import fleet_router as _router_mod  # noqa: E402

from howtotrainyourmamlpytorch_tpu_torch.serve.fleet import (  # noqa: E402
    supervisor as _supervisor_mod)
from howtotrainyourmamlpytorch_tpu_torch.telemetry import (  # noqa: E402
    alerts as _alerts_mod)
from howtotrainyourmamlpytorch_tpu_torch.utils import reaper  # noqa: E402


# ---------------------------------------------------------------------------
# alert instrumentation (telemetry/alerts.py)
# ---------------------------------------------------------------------------

def _make_evaluator(rules: List[dict], *, source: str,
                    snapshot_path: Optional[str] = None):
    """Inline-rules AlertEvaluator for one chaos phase: each phase must
    prove its alerts FIRE during the fault and RESOLVE after healing,
    through the same rule engine production configs drive."""
    return _alerts_mod.AlertEvaluator(
        _alerts_mod.parse_rules({"rules": rules}), source=source,
        snapshot_path=snapshot_path)


def _alert_outcome(evaluators: Dict[str, Any],
                   events_paths: List[str]) -> dict:
    """Per-phase alert verdict: which rules fired (from the ``alert``
    rows the evaluators appended to the phase's events files) plus the
    fire/resolve ledger — the artifact's fire-AND-resolve proof.
    ``resolved_all`` is the recovery gate: every fired instance closed
    and nothing is still active on any evaluator."""
    fired_kinds: set = set()
    for path in events_paths:
        try:
            with open(path) as f:
                for line in f:
                    try:
                        row = json.loads(line)
                    except ValueError:
                        continue
                    if (row.get("event") == "alert"
                            and row.get("state") == "firing"):
                        fired_kinds.add(str(row.get("rule")))
        except OSError:
            continue
    fired = sum(ev.fired_total for ev in evaluators.values())
    resolved = sum(ev.resolved_total for ev in evaluators.values())
    active = sum(len(ev.active()) for ev in evaluators.values())
    return {"fired_kinds": sorted(fired_kinds), "fired": fired,
            "resolved": resolved, "active_final": active,
            "resolved_all": bool(fired > 0 and resolved == fired
                                 and active == 0)}


def _console_check(out: str) -> dict:
    """Render post-chaos fleet status via scripts/torch_ops_console.py —
    the operator's real entrypoint, as a subprocess — and keep the
    artifact fields the chaos verdict gates on: the console must agree
    that nothing is still firing after the suite."""
    try:
        proc = subprocess.run(
            [sys.executable, os.path.join(_SCRIPTS, "torch_ops_console.py"),
             out],
            cwd=_REPO, capture_output=True, text=True, timeout=120)
        lines = proc.stdout.strip().splitlines()
        doc = json.loads(lines[-1]) if lines else {}
    except Exception as e:  # noqa: BLE001 — folded into the verdict
        return {"error": f"{type(e).__name__}: {e}"}
    return {"exit_code": proc.returncode,
            "events_rows": doc.get("events_rows"),
            "replicas_live": doc.get("replicas_live"),
            "alerts_firing": doc.get("alerts_firing"),
            "alerts_by_severity": doc.get("alerts_by_severity"),
            "error": doc.get("error")}


def _settle_alerts(evaluators: Dict[str, Any], tick_fns,
                   timeout_s: float = 15.0) -> None:
    """Keep ticking the healing loops until every fired alert has
    resolved (or the budget runs out — the outcome assert then names
    the stuck rule). Rate rules need one more evaluation AFTER the
    counter stops moving; absence rules need the replacement lease."""
    deadline = time.monotonic() + timeout_s
    while (any(ev.active() for ev in evaluators.values())
           and time.monotonic() < deadline):
        for fn in tick_fns:
            fn()
        time.sleep(0.1)


# ---------------------------------------------------------------------------
# replica spawning + connection upkeep
# ---------------------------------------------------------------------------

def make_spawn(out: str, cfg_path: str, ckpt_dir: str, fleet_dir: str,
               poisoned=(), device: str = "cuda"):
    """Supervisor ``spawn_fn``: the fleet bench's replica recipe, per
    slot, on ``device``. ``poisoned`` slots get a nonexistent checkpoint
    dir — the crash-loop phase's reproducible boot failure (the replica
    fails at opening it, before it makes a CUDA context)."""
    def spawn(slot: int):
        ckpt = (ckpt_dir if slot not in poisoned
                else os.path.join(out, "no_such_checkpoint"))
        log = open(os.path.join(out, f"replica_{slot}.log"), "a")
        try:
            return reaper.spawn(
                [sys.executable, "-m",
                 "howtotrainyourmamlpytorch_tpu_torch.serve.fleet.replica",
                 "--config", cfg_path, "--replica-id", str(slot),
                 "--fleet-dir", fleet_dir, "--checkpoint", ckpt,
                 "--events",
                 os.path.join(out, f"events_replica_{slot}.jsonl"),
                 "--device", device],
                cwd=_REPO, stdout=log, stderr=subprocess.STDOUT)
        finally:
            log.close()  # the child holds its own inherited fd
    return spawn


class FleetClient:
    """Keeps one live ReplicaConn per announced replica, reconnecting
    when the lease pid changes (a supervisor restart) or the socket
    dies — the frontend's half of self-healing. ``pump()`` runs on
    drive_leg's refresh cadence via ``on_tick``."""

    def __init__(self, router, fleet_dir: str):
        self.router = router
        self.fleet_dir = fleet_dir
        self.conns: Dict[int, ReplicaConn] = {}
        self._pids: Dict[int, Any] = {}

    def pump(self) -> None:
        members = _router_mod.read_members(self.fleet_dir)
        for rid, rec in members.items():
            payload = rec.get("payload") or {}
            port, pid = payload.get("port"), payload.get("pid")
            if not port:
                continue
            conn = self.conns.get(rid)
            stale = (conn is None or conn._stopped_evt.is_set()
                     or self._pids.get(rid) != pid)
            if not stale:
                continue
            try:
                fresh = ReplicaConn(rid, int(port),
                                    lambda _rid, _msg: None)
            except OSError:
                continue  # announced but not accepting yet; next pump
            if conn is not None:
                conn.close()
            self.conns[rid] = fresh
            self._pids[rid] = pid
            # A reachable socket is the breaker's recovery signal: the
            # restarted replica rejoins the candidate set immediately
            # instead of waiting out a half-open probe cycle.
            self.router.record_success(rid)

    def close(self) -> None:
        for conn in self.conns.values():
            conn.close()


def _boot_fleet(sup, client, router, *, want_live: int,
                want_failed: int = 0, timeout_s: float = 420.0) -> None:
    """Tick the supervisor until ``want_live`` replicas are routable
    and connected (and, for the crash-loop phase, ``want_failed``
    slots have tripped their breaker)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        sup.tick()
        router.refresh()
        client.pump()
        failed = sup.count(_supervisor_mod.FAILED)
        if (len(router.routable) >= want_live
                and sum(1 for r in router.routable
                        if r in client.conns) >= want_live
                and failed >= want_failed):
            return
        time.sleep(0.1)
    raise TimeoutError(
        f"fleet never reached {want_live} live (+{want_failed} failed) "
        f"replicas in {timeout_s:.0f}s: states={sup.states()} "
        f"routable={router.routable}")


def _router_for(fleet_dir: str, cfg_doc: dict, registry) -> Any:
    return _router_mod.FleetRouter(
        fleet_dir, vnodes=int(cfg_doc["fleet_vnodes"]),
        load_factor=float(cfg_doc["fleet_load_factor"]),
        stalled_after_s=float(cfg_doc["fleet_replica_stalled_s"]),
        dead_after_s=float(cfg_doc["fleet_replica_dead_s"]),
        breaker_cooldown_s=1.0, registry=registry)


def _lifecycle(events_path: str) -> Dict[str, List[Dict[str, Any]]]:
    """Per slot, each process the supervisor spawned: its pid, its boot
    seconds (spawn to a live lease with a port: CUDA context, checkpoint
    load and warm-up included; None if it never announced) and how it
    ended (``exit_code`` of a crash, null while it ran to the end)."""
    out: Dict[str, List[Dict[str, Any]]] = {}
    try:
        with open(events_path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
    except (OSError, ValueError):
        return out
    for row in rows:
        if row.get("event") != "fleet_supervisor":
            continue
        runs = out.setdefault(str(row.get("slot")), [])
        kind = row.get("kind")
        if kind == "spawn":
            runs.append({"pid": row.get("pid"), "spawn_ts": row["ts"],
                         "boot_seconds": None, "exit_code": None})
        elif runs and kind == "running":
            runs[-1]["boot_seconds"] = round(
                row["ts"] - runs[-1]["spawn_ts"], 3)
        elif runs and kind in ("restart_scheduled", "crash_loop"):
            runs[-1]["exit_code"] = row.get("exit_code")
    for runs in out.values():
        for run in runs:
            run.pop("spawn_ts", None)
    return {k: v for k, v in out.items() if v}


def _replica_kernels(client, cfg_doc: dict, device: str) -> Dict[str, Any]:
    """The BN kernel's launches in every replica still connected, beside
    the count its own adapt and predict batches need (the fleet bench's
    accounting)."""
    per_replica = {}
    for rid, conn in sorted(client.conns.items()):
        if conn._stopped_evt.is_set():
            continue
        try:
            per_replica[str(rid)] = conn.stats()
        except Exception as e:  # noqa: BLE001 — folded into the verdict
            per_replica[str(rid)] = {"error": str(e)}
    return _kernel_accounting(per_replica, cfg_doc, device)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_kill(out: str, cfg_path: str, cfg_doc: dict, ckpt_dir: str,
               *, replicas: int, requests: int, tenants: int,
               quick: bool, shape: dict, device: str,
               boot_timeout_s: float, restore_budget_s: float) -> dict:
    fleet_dir = os.path.join(out, "fleet_kill")
    registry = _MiniMetrics()
    router = _router_for(fleet_dir, cfg_doc, registry)
    sup_events = os.path.join(out, "events_supervisor_kill.jsonl")
    drv_events = os.path.join(out, "events_driver_kill.jsonl")
    # Two evaluators, two vantage points. The SUPERVISOR one rides the
    # wired-in tick hook and watches the restart counter it bumps (a
    # SIGKILLed child is seen by poll() within one tick, so its lease
    # never ages while the slot counts as RUNNING — the supervisor's
    # absence view cannot fire here by design). The FRONTEND one watches
    # the raw membership leases the router routes by: the victim's
    # lease vanishes for the whole respawn window, fires, and resolves
    # when the replacement's lease lands.
    sup_alerts = _make_evaluator(
        [{"name": "replica_restarts", "type": "rate",
          "metric": _supervisor_mod.RESTARTS_COUNTER,
          "op": ">", "value": 0, "for_s": 0, "severity": "warn"}],
        source="supervisor",
        snapshot_path=os.path.join(out, "ALERTS_kill_sup.json"))
    drv_alerts = _make_evaluator(
        [{"name": "replica_lease_stale", "type": "absence",
          "signal_prefix": "lease:", "for_s": 0, "severity": "critical",
          "max_age_s": 2.0 * float(cfg_doc["fleet_replica_stalled_s"])}],
        source="driver",
        snapshot_path=os.path.join(out, "ALERTS_kill_driver.json"))
    drv_appender = _supervisor_mod._EventAppender(drv_events)
    seen_rids: set = set()

    def drv_alert_tick() -> None:
        # A replica that has EVER leased is expected to keep leasing:
        # the supervisor reaps the victim's stale lease file within a
        # tick of the kill (so its age never grows on disk), and a
        # vanished-but-expected lease is age inf — the absence rule
        # fires for the whole respawn window and resolves the moment
        # the replacement's lease lands.
        members = _router_mod.read_members(fleet_dir)
        seen_rids.update(members)
        ages = {f"lease:{rid}":
                (float(members[rid].get("age") or 0.0)
                 if rid in members else float("inf"))
                for rid in seen_rids}
        drv_alerts.evaluate(snapshot=registry.snapshot(), ages=ages,
                            jsonl=drv_appender, registry=registry)

    sup = _supervisor_mod.ReplicaSupervisor(
        fleet_dir, make_spawn(out, cfg_path, ckpt_dir, fleet_dir,
                              device=device),
        desired=replicas, scale_min=1, scale_max=replicas,
        max_restarts=5, restart_window_s=300.0,
        stalled_after_s=float(cfg_doc["fleet_replica_stalled_s"]),
        dead_after_s=float(cfg_doc["fleet_replica_dead_s"]),
        start_timeout_s=boot_timeout_s, backoff_base_s=0.2,
        backoff_cap_s=2.0, registry=registry, events_path=sup_events,
        alert_evaluator=sup_alerts)
    client = FleetClient(router, fleet_dir)
    try:
        _boot_fleet(sup, client, router, want_live=replicas,
                    timeout_s=boot_timeout_s)
        _, schedule = build_schedule(requests, tenants, 0, **shape)
        victim: Dict[str, Any] = {"slot": None, "pid": None, "t": None,
                                  "restored_t": None}

        def fire() -> None:
            # SIGKILL the lowest RUNNING slot mid-load — the ungraceful
            # death the whole stack exists for.
            for slot in sorted(sup.slots):
                rec = sup.slots[slot]
                if (rec["state"] == _supervisor_mod.RUNNING
                        and rec["proc"] is not None):
                    victim.update(slot=slot, pid=rec["proc"].pid,
                                  t=time.monotonic())
                    os.kill(rec["proc"].pid, signal.SIGKILL)
                    return

        def note_restored() -> None:
            # Restored: N routable replicas, the victim's slot among them
            # under a new process.
            if (victim["t"] is not None and victim["restored_t"] is None
                    and len(router.routable) >= replicas
                    and client._pids.get(victim["slot"]) not in (
                        None, victim["pid"])):
                victim["restored_t"] = time.monotonic()

        def on_tick(_now: float) -> None:
            sup.tick()
            client.pump()
            drv_alert_tick()
            note_restored()

        stats = drive_leg(
            router, client.conns, schedule,
            max_outstanding=4 * replicas,
            swap_trigger={"at_completed": max(requests // 4, 1),
                          "fire": fire},
            # Generous failover budget: until the victim's lease ages
            # out, half-open probes keep testing its dead socket and
            # each probe burns one attempt for some unlucky request.
            failover_max_attempts=10,
            stall_timeout_s=180.0 if quick else 300.0,
            on_tick=on_tick)
        # Restoration budget: the supervisor must put the fleet back at
        # full strength after the leg (the leg itself may complete on
        # N-1 before the restarted replica finishes booting).
        restore_deadline = (victim["t"] or time.monotonic()) + (
            restore_budget_s)
        while time.monotonic() < restore_deadline:
            sup.tick()
            router.refresh()
            client.pump()
            drv_alert_tick()
            note_restored()
            if victim["restored_t"] is not None:
                break
            time.sleep(0.1)
        restored = victim["restored_t"] is not None
        evaluators = {"supervisor": sup_alerts, "driver": drv_alerts}
        _settle_alerts(evaluators, [sup.tick, drv_alert_tick])
        alerts = _alert_outcome(evaluators, [sup_events, drv_events])
        sup.flush_metrics()
        snap = registry.snapshot()
        restarts = int(snap.get(_supervisor_mod.RESTARTS_COUNTER, 0))
        failovers = int(snap.get(_router_mod.FAILOVERS_COUNTER, 0))
        kernels = _replica_kernels(client, cfg_doc, device)
        ok = bool(stats["responses_ok"] == requests
                  and stats["dropped"] == 0
                  and victim["slot"] is not None
                  and restarts >= 1 and restored
                  # Fire-AND-resolve: both vantage points saw the kill
                  # (restart rate + lease staleness) and every alert
                  # closed once the fleet healed.
                  and "replica_restarts" in alerts["fired_kinds"]
                  and "replica_lease_stale" in alerts["fired_kinds"]
                  and alerts["resolved_all"]
                  and kernels["ok"] and len(kernels["replicas"]) == replicas)
        return {"ok": ok, "stats": stats, "victim_slot": victim["slot"],
                "victim_pid": victim["pid"],
                "restarts": restarts, "failovers": failovers,
                "breaker_trips": int(snap.get(
                    _router_mod.BREAKER_TRIPS_COUNTER, 0)),
                "restored": restored,
                "restore_seconds": (round(victim["restored_t"]
                                          - victim["t"], 3)
                                    if restored else None),
                "restore_budget_s": restore_budget_s,
                "lifecycle": _lifecycle(sup_events), "kernels": kernels,
                "alerts": alerts, "metrics": snap}
    finally:
        sup.stop()
        client.close()


def phase_crash_loop(out: str, cfg_path: str, cfg_doc: dict,
                     ckpt_dir: str, *, replicas: int, requests: int,
                     tenants: int, quick: bool, shape: dict, device: str,
                     boot_timeout_s: float) -> dict:
    fleet_dir = os.path.join(out, "fleet_crash")
    registry = _MiniMetrics()
    router = _router_for(fleet_dir, cfg_doc, registry)
    poisoned_slot = replicas  # one EXTRA slot beyond the healthy fleet
    sup_events = os.path.join(out, "events_supervisor_crash.jsonl")
    # The crash-loop story is entirely supervisor-side: each boot
    # failure bumps restarts (rate alert, warn) until the breaker
    # trips crash_loops (rate alert, critical). Rate rules resolve on
    # the first quiet evaluation — the FAILED slot stops respawning,
    # so a post-leg settle pass must end with zero active alerts.
    sup_alerts = _make_evaluator(
        [{"name": "replica_crash_loop", "type": "rate",
          "metric": _supervisor_mod.CRASH_LOOPS_COUNTER,
          "op": ">", "value": 0, "for_s": 0, "severity": "critical"},
         {"name": "replica_restarts", "type": "rate",
          "metric": _supervisor_mod.RESTARTS_COUNTER,
          "op": ">", "value": 0, "for_s": 0, "severity": "warn"}],
        source="supervisor",
        snapshot_path=os.path.join(out, "ALERTS_crash_sup.json"))
    sup = _supervisor_mod.ReplicaSupervisor(
        fleet_dir, make_spawn(out, cfg_path, ckpt_dir, fleet_dir,
                              poisoned={poisoned_slot}, device=device),
        desired=replicas + 1, scale_min=1, scale_max=replicas + 1,
        max_restarts=2, restart_window_s=300.0,
        stalled_after_s=float(cfg_doc["fleet_replica_stalled_s"]),
        dead_after_s=float(cfg_doc["fleet_replica_dead_s"]),
        start_timeout_s=boot_timeout_s, backoff_base_s=0.1,
        backoff_cap_s=0.5, registry=registry, events_path=sup_events,
        alert_evaluator=sup_alerts)
    client = FleetClient(router, fleet_dir)
    try:
        # The poisoned slot crash-loops DURING boot: wait for the
        # healthy N live AND the breaker trip.
        _boot_fleet(sup, client, router, want_live=replicas,
                    want_failed=1, timeout_s=boot_timeout_s)
        _, schedule = build_schedule(requests, tenants, 1, **shape)

        def on_tick(_now: float) -> None:
            sup.tick()
            client.pump()

        stats = drive_leg(router, client.conns, schedule,
                          max_outstanding=4 * replicas,
                          stall_timeout_s=180.0 if quick else 300.0,
                          on_tick=on_tick)
        evaluators = {"supervisor": sup_alerts}
        _settle_alerts(evaluators, [sup.tick])
        alerts = _alert_outcome(evaluators, [sup_events])
        sup.flush_metrics()
        snap = registry.snapshot()
        crash_loops = int(snap.get(
            _supervisor_mod.CRASH_LOOPS_COUNTER, 0))
        failed_state = (sup.states().get(poisoned_slot)
                        == _supervisor_mod.FAILED)
        kernels = _replica_kernels(client, cfg_doc, device)
        ok = bool(stats["responses_ok"] == requests
                  and stats["dropped"] == 0
                  and crash_loops >= 1 and failed_state
                  and len(router.routable) == replicas
                  and "replica_crash_loop" in alerts["fired_kinds"]
                  and alerts["resolved_all"]
                  and kernels["ok"] and len(kernels["replicas"]) == replicas)
        return {"ok": ok, "stats": stats,
                "poisoned_slot": poisoned_slot,
                "crash_loops": crash_loops,
                "restarts": int(snap.get(
                    _supervisor_mod.RESTARTS_COUNTER, 0)),
                "slot_failed": failed_state,
                "served_at": len(router.routable),
                "lifecycle": _lifecycle(sup_events), "kernels": kernels,
                "alerts": alerts, "metrics": snap}
    finally:
        sup.stop()
        client.close()


def phase_burst(out: str, cfg_path: str, cfg_doc: dict, ckpt_dir: str,
                *, requests: int, warm_requests: int, quick: bool,
                shape: dict, device: str, boot_timeout_s: float) -> dict:
    fleet_dir = os.path.join(out, "fleet_burst")
    registry = _MiniMetrics()
    router = _router_for(fleet_dir, cfg_doc, registry)
    sup_events = os.path.join(out, "events_supervisor_burst.jsonl")
    sup = _supervisor_mod.ReplicaSupervisor(
        fleet_dir, make_spawn(out, cfg_path, ckpt_dir, fleet_dir,
                              device=device),
        desired=1, scale_min=1, scale_max=1,
        stalled_after_s=float(cfg_doc["fleet_replica_stalled_s"]),
        dead_after_s=float(cfg_doc["fleet_replica_dead_s"]),
        start_timeout_s=boot_timeout_s, registry=registry,
        events_path=sup_events)
    client = FleetClient(router, fleet_dir)
    try:
        _boot_fleet(sup, client, router, want_live=1,
                    timeout_s=boot_timeout_s)

        def on_tick(_now: float) -> None:
            sup.tick()
            client.pump()

        # Trickle: distinct tenants at low concurrency — every request
        # pays the full miss-adapt, seeding the admission controller's
        # service-time EWMA with the honest per-batch cost.
        _, warm_sched = build_schedule(warm_requests, warm_requests, 2,
                                       **shape)
        warm = drive_leg(router, client.conns, warm_sched,
                         max_outstanding=2,
                         stall_timeout_s=180.0 if quick else 300.0,
                         on_tick=on_tick)
        # Prime: a saturating-but-survivable wave (distinct tenants,
        # concurrency well under the deadline's queue budget) that
        # trains the EWMA on BUSY completion intervals — the drain
        # rate a backlog actually pays, which idle trickle batches
        # understate ~2x. Without this the flood's head is admitted
        # on trickle-rate estimates faster than the EWMA can converge.
        prime_n = 96 if quick else 128
        _, prime_sched = build_schedule(prime_n, prime_n, 5, **shape)
        prime = drive_leg(router, client.conns, prime_sched,
                          max_outstanding=prime_n,
                          stall_timeout_s=180.0 if quick else 300.0,
                          on_tick=on_tick)
        # Burst: ALL-distinct tenants (every request is a real adapt —
        # offered work genuinely exceeds one replica's service rate) at
        # a concurrency whose full-queue wait sits PAST the deadline.
        # The admission controller holds the queue at the depth its
        # deadline math allows and refuses the rest at the door. The
        # burst holds at least 1.5 deadlines' worth of the drain rate the
        # prime wave measured (at most BURST_GROWTH x its configured
        # size): a replica that drains the configured burst before the
        # deadline would shed nothing, and how fast one drains is the
        # box's and the model's, not the harness's.
        drain_s = prime["wall_seconds"] / prime_n
        deadline_s = float(cfg_doc["serve_default_deadline_ms"]) / 1e3
        requests = min(max(requests, math.ceil(1.5 * deadline_s / drain_s)),
                       BURST_GROWTH * requests)
        _, burst_sched = build_schedule(requests, requests, 3, **shape)
        burst = drive_leg(router, client.conns, burst_sched,
                          max_outstanding=requests,
                          stall_timeout_s=180.0 if quick else 300.0,
                          on_tick=on_tick)
        per_replica = {}
        for rid, conn in client.conns.items():
            try:
                per_replica[str(rid)] = conn.stats()
            except Exception as e:  # noqa: BLE001
                per_replica[str(rid)] = {"error": str(e)}
        shed = int(burst["shed"])
        replica_sheds = sum(
            int((rec.get("stats") or {}).get("sheds") or 0)
            for rec in per_replica.values())
        failed = int(burst["status_counts"].get("failed", 0))
        slo_ms = float(cfg_doc["fleet_slo_p95_ms"])
        p95 = burst["p95_ms"]
        # Shed-rate alert over the frontend's own observation ledger: the
        # replica flushes its shed counter only at exit, so the frontend
        # mirrors the refusals it SAW into serve/shed_total and replays
        # the burst timeline through the rate rule — quiet baseline
        # (first observation), the burst's refusals (fires), cooldown
        # with the counter still (resolves). Synthetic timestamps keep
        # the rate math deterministic.
        sh_events = os.path.join(out, "events_driver_burst.jsonl")
        sh_alerts = _make_evaluator(
            [{"name": "admission_shedding", "type": "rate",
              "metric": "serve/shed_total",
              "op": ">", "value": 0, "for_s": 0, "severity": "warn"}],
            source="driver",
            snapshot_path=os.path.join(out, "ALERTS_burst_driver.json"))
        sh_appender = _supervisor_mod._EventAppender(sh_events)
        t0 = time.time()
        # Materialize the counter at 0 BEFORE the baseline pass: a rate
        # rule ignores an absent metric entirely, so without this the
        # post-burst value would itself become the baseline and the
        # alert could never fire.
        registry.counter("serve/shed_total")
        sh_alerts.evaluate(t0, snapshot=registry.snapshot(),
                           jsonl=sh_appender, registry=registry)
        registry.counter("serve/shed_total").inc(shed)
        sh_alerts.evaluate(t0 + 1.0, snapshot=registry.snapshot(),
                           jsonl=sh_appender, registry=registry)
        sh_alerts.evaluate(t0 + 2.0, snapshot=registry.snapshot(),
                           jsonl=sh_appender, registry=registry)
        alerts = _alert_outcome({"driver": sh_alerts}, [sh_events])
        kernels = _kernel_accounting(per_replica, cfg_doc, device)
        ok = bool(burst["dropped"] == 0 and warm["dropped"] == 0
                  and prime["dropped"] == 0
                  and shed > 0 and failed == 0
                  and replica_sheds >= shed > 0
                  and p95 is not None and p95 <= slo_ms
                  and "admission_shedding" in alerts["fired_kinds"]
                  and alerts["resolved_all"]
                  and kernels["ok"] and len(kernels["replicas"]) == 1)
        return {"ok": ok, "warm": warm, "prime": prime, "stats": burst,
                "burst_requests": requests, "shed": shed, "replica_sheds": replica_sheds,
                "deadline_misses": failed,
                "admitted_p95_ms": p95, "slo_p95_ms": slo_ms,
                "alerts": alerts, "lifecycle": _lifecycle(sup_events),
                "kernels": kernels,
                "per_replica": per_replica, "metrics": registry.snapshot()}
    finally:
        sup.stop()
        client.close()


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

# The most the burst grows past its configured size to outrun the
# deadline (phase_burst).
BURST_GROWTH = 5

# Boot and restoration budgets per device. A replica on the card pays
# for a CUDA context, the checkpoint load and a warm-up before it
# announces: at the flagship's width 8.9-12.1 s per boot with three
# starting at once, and 10.6 s from the SIGKILL to the fleet restored,
# on an NVIDIA H100 80GB HBM3 at 700 W. The budgets leave about 5x that
# for a slower host (each phase's ``lifecycle`` holds the boots).
BOOT_TIMEOUT_S = {"cuda": 60.0, "cpu": 420.0}
RESTORE_BUDGET_S = {"cuda": 45.0, "cpu": 120.0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="serving-fleet chaos suite of the PyTorch port (kill / "
                    "crash_loop / burst)")
    ap.add_argument("--quick", action="store_true",
                    help="2-replica CI smoke with a small load")
    ap.add_argument("--out", default=None)
    ap.add_argument("--phases", default="kill,crash_loop,burst",
                    help="comma list from {kill,crash_loop,burst}")
    ap.add_argument("--replicas", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the replicas serve (the card by default)")
    ap.add_argument("--config", default=None,
                    help="experiment JSON whose model and episode shapes "
                         "the replicas serve (e.g. the flagship's)")
    ap.add_argument("--checkpoint", default=None,
                    help="a trainer's saved_models to serve (copied); "
                         "default: a seeded random v1")
    args = ap.parse_args(argv)
    # Every replica this harness starts ends with it, on SIGTERM too.
    reaper.install()

    phases = [p.strip() for p in args.phases.split(",") if p.strip()]
    bad = set(phases) - {"kill", "crash_loop", "burst"}
    if bad:
        raise SystemExit(f"unknown phases: {sorted(bad)}")
    require_card(args.device)
    replicas = args.replicas or (2 if args.quick else 3)
    requests = 48 if args.quick else 150
    tenants = 8 if args.quick else 16
    burst_requests = 240 if args.quick else 400
    warm_requests = 12 if args.quick else 24

    artifact: Dict[str, Any] = {
        "metric": "chaos_fleet", "value": None, "unit": "phases_ok",
        "status": "failed", "quick": bool(args.quick),
        "replicas": replicas, "phases_run": phases,
        "backend": "torch", "device": args.device, "config": args.config,
    }
    if not _can_bind_localhost():
        artifact.update({"status": "skipped",
                         "skip_reason": "cannot bind localhost sockets"})
        print(json.dumps(artifact), flush=True)
        return 0

    out = args.out or tempfile.mkdtemp(prefix="torch_chaos_fleet_")
    made_tmp = args.out is None
    os.makedirs(out, exist_ok=True)
    ckpt_dir = os.path.join(out, "saved_models")
    l2_dir = os.path.join(out, "l2")
    l1_capacity = 4 * tenants
    base = None
    if args.config:
        with open(args.config) as f:
            base = json.load(f)

    # One shared serving profile; the burst phase layers the shed
    # policy on top.
    base_doc = fleet_cfg_dict(out, quick=args.quick,
                              l1_capacity=l1_capacity, l2_dir=l2_dir,
                              base=base)
    burst_doc = dict(base_doc)
    burst_doc.update(
        fleet_shed_policy="deadline",
        # 2.5s leaves deliberate margin over the worst honest admit:
        # the flood's head is admitted before the service-time EWMA
        # converges to the loaded drain rate, and those requests ride
        # the full queue. The deadline must sit above that or the phase
        # asserts on misses the estimator could never have predicted.
        serve_default_deadline_ms=2500.0,
        serve_max_queue_depth=512,
        fleet_slo_p95_ms=3000.0)
    cfg_base = os.path.join(out, "cfg_chaos.json")
    cfg_burst = os.path.join(out, "cfg_burst.json")
    with open(cfg_base, "w") as f:
        json.dump(base_doc, f)
    with open(cfg_burst, "w") as f:
        json.dump(burst_doc, f)

    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    mcfg = MAMLConfig.from_dict(base_doc)
    shape = dict(image_shape=mcfg.image_shape,
                 bucket=tuple(mcfg.serve_bucket_shapes[0]),
                 num_classes=mcfg.num_classes_per_set)
    common = dict(quick=args.quick, shape=shape, device=args.device,
                  boot_timeout_s=BOOT_TIMEOUT_S[args.device])
    results: Dict[str, Any] = {}
    try:
        artifact["prepare_seconds"] = prepare_checkpoint(
            out, cfg_base, ckpt_dir, args.checkpoint)
        if "kill" in phases:
            t0 = time.monotonic()
            results["kill"] = phase_kill(
                out, cfg_base, base_doc, ckpt_dir, replicas=replicas,
                requests=requests, tenants=tenants,
                restore_budget_s=RESTORE_BUDGET_S[args.device], **common)
            results["kill"]["seconds"] = round(time.monotonic() - t0, 1)
        if "crash_loop" in phases:
            t0 = time.monotonic()
            results["crash_loop"] = phase_crash_loop(
                out, cfg_base, base_doc, ckpt_dir,
                replicas=max(replicas - 1, 1), requests=requests,
                tenants=tenants, **common)
            results["crash_loop"]["seconds"] = round(
                time.monotonic() - t0, 1)
        if "burst" in phases:
            t0 = time.monotonic()
            results["burst"] = phase_burst(
                out, cfg_burst, burst_doc, ckpt_dir,
                requests=burst_requests, warm_requests=warm_requests,
                **common)
            results["burst"]["seconds"] = round(time.monotonic() - t0, 1)

        n_ok = sum(1 for r in results.values() if r.get("ok"))
        kill = results.get("kill") or {}
        crash = results.get("crash_loop") or {}
        burst = results.get("burst") or {}
        # Fire-AND-resolve rollup across phases: which alert rules the
        # chaos actually tripped, and whether every one of them closed
        # once the fleet healed. Both gate "recovered" — a fleet that
        # serves every request but leaves an alert stuck firing has NOT
        # recovered by the ops plane's definition.
        phase_alerts = [r.get("alerts") or {} for r in results.values()]
        alert_fired_kinds = sorted(
            {k for a in phase_alerts for k in a.get("fired_kinds", [])})
        alerts_resolved = bool(phase_alerts and all(
            a.get("resolved_all") for a in phase_alerts))
        # Post-chaos console render: the SAME status CLI an operator
        # would run, over the phase out-dir exhaust — and it must agree
        # that nothing is still firing.
        console = _console_check(out)
        recovered = bool(n_ok == len(phases)
                         and len(results) == len(phases)
                         and alerts_resolved
                         and console.get("alerts_firing") == 0)
        ok = recovered
        artifact.update({
            "status": "ok" if ok else "failed",
            "value": n_ok,
            "phases": results,
            # Schema-stable robustness keys (serve_bench/fleet_bench
            # carry the same names): null when the phase didn't run.
            "fleet_restarts": kill.get("restarts"),
            "fleet_crash_loops": crash.get("crash_loops"),
            "fleet_failover_count": kill.get("failovers"),
            "fleet_shed_count": burst.get("shed"),
            "alert_fired_kinds": alert_fired_kinds,
            "alerts_fired": sum(int(a.get("fired") or 0)
                                for a in phase_alerts),
            "alerts_resolved": alerts_resolved,
            "alerts_active_final": sum(int(a.get("active_final") or 0)
                                       for a in phase_alerts),
            "recovered": recovered,
            "console": console,
            "out_dir": None if made_tmp else out,
        })
        print(json.dumps(artifact), flush=True)
        if made_tmp and ok:
            shutil.rmtree(out, ignore_errors=True)
        return 0 if ok else 1
    except Exception as e:  # noqa: BLE001 — the artifact IS the report
        artifact.update({"status": "failed",
                         "error": f"{type(e).__name__}: {e}",
                         "phases": results, "out_dir": out})
        print(json.dumps(artifact), flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
