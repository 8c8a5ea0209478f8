#!/usr/bin/env python
"""Traffic-lab proof harness of the PyTorch port: trace-driven open-loop
replay (the port's counterpart of ``scripts/traffic_replay.py``, with
its legs, gates and artifact keys).

Three legs replay the SAME shaped trace — a diurnal raised-cosine ramp
with a 10x base-to-peak swing, sliding tenant churn and a burst overlay
(``serve/loadlab``) — against a freshly booted fleet of port replicas
each time:

* ``fixed``   — continuous batching OFF (head-of-line dispatch), one
  replica, no rollout: the baseline.
* ``cb``      — continuous batching ON, otherwise identical: the clean
  p95 comparison pair. The gate is STRICT: cb p95 < fixed p95.
* ``rollout`` — continuous batching ON, two replicas with supervisor
  autoscaling (scale-up under the burst), and a weighted canary
  rollout triggered mid-ramp: the gate is the SLO held (burn <= 1.0),
  the rollout reaching DONE on real traffic, and at least one autoscale
  scale-up.

Why continuous batching wins: partial groups are PADDED to
``serve_batch_tasks`` before the adapt and predict (serve/engine.py),
so a head-of-line dispatch of one request costs the same device and
host time as a full group. Near the ramp's peak the fixed-mode replica
runs at ~full utilization dispatching partial groups; the assembler
holds groups open for a short linger and dispatches fuller ones. The
harness CALIBRATES that operating point per box from the booted replica
(``calibrate``: per-dispatch cost of the hit and miss paths;
``operating_point``: the rates and linger) instead of carrying rates
from another machine.

Every replica serves the ``--config`` it is given (the flagship's width,
for one; without it the JAX script's quick serving profile) on the card
(``--device cuda``, the default; no CPU fallback) or on the CPU
(``--device cpu``). The trace's ``--duration`` is what a run cuts,
never the width. A trace shorter than 40 s rides the 2-stage 25% ->
100% canary ladder (the JAX script's ``--quick`` ladder, tied here to
the duration that forces it); a longer one the 1% -> 10% -> 100%
ladder.

Open-loop discipline (serve/loadlab/replay.py): arrivals fire off the
trace clock, never off responses, and every latency is measured from
the SCHEDULED arrival instant.

``--trace-sample-rate`` traces the sampled requests of every leg: the
frontend writes its root spans to ``events_frontend_<leg>.jsonl`` and
each replica, stopped on request rather than by signal, its own spans
to ``events_replica_<slot>.jsonl`` (``scripts/torch_slo_report.py``
reads the out dir).

Artifact: ``{"metric": "traffic_replay"}`` on the last stdout line
(schema keys ``traffic_p95_ms`` / ``traffic_slo_held`` /
``traffic_canary_weight_final`` / ``traffic_cb_groups``), plus per leg
the BN kernel's launches in each replica beside the count its adapt and
predict batches need (``kernels``, gated). Prints ``status: skipped`` +
rc 0 where localhost sockets cannot bind.

Usage:
    python scripts/torch_traffic_replay.py --quick --device cpu
    python scripts/torch_traffic_replay.py --duration 20 \
        --config experiment_config/mini-imagenet_maml++_5-way_5-shot_DA_b12.json
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

_SCRIPTS = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_SCRIPTS)
sys.path.insert(0, _SCRIPTS)
sys.path.insert(0, _REPO)

from torch_fleet_bench import (  # noqa: E402
    _MiniMetrics, _can_bind_localhost, _kernel_accounting, _run_child,
    fleet_cfg_dict, prepare_checkpoint, require_card)
from torch_fleet_bench import fleet_controller as _controller_mod  # noqa: E402
from torch_fleet_bench import fleet_router as _router_mod  # noqa: E402
from torch_chaos_fleet import (  # noqa: E402
    BOOT_TIMEOUT_S, FleetClient, _boot_fleet, make_spawn)

from howtotrainyourmamlpytorch_tpu_torch.serve.fleet import (  # noqa: E402
    supervisor as _supervisor_mod)
from howtotrainyourmamlpytorch_tpu_torch.serve.loadlab import (  # noqa: E402
    replay as _replay_mod, workloads as _workloads_mod)
from howtotrainyourmamlpytorch_tpu_torch.utils import reaper  # noqa: E402
from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import (  # noqa: E402
    JsonlLogger, nearest_rank)

_trace_mod = _workloads_mod.trace_mod()


def _pct(vals: List[float], q: float) -> Optional[float]:
    if not vals:
        return None
    return round(nearest_rank(sorted(vals), q), 3)


# ---------------------------------------------------------------------------
# trace + request synthesis
# ---------------------------------------------------------------------------

def build_trace(*, duration_s: float, base_rate: float, peak_rate: float,
                num_tenants: int, active_tenants: int,
                churn_every_s: float, bucket, seed: int
                ) -> List[Dict[str, Any]]:
    """Diurnal ramp (peak at duration/2) + a burst overlay on the
    rising edge — the burst is what trips the autoscaler BEFORE the
    mid-ramp rollout trigger, so the scaled-up replica is live (and in
    the stable cohort) when the canary bake starts."""
    records = _workloads_mod.gen_diurnal_trace(
        duration_s=duration_s, base_rate=base_rate, peak_rate=peak_rate,
        num_tenants=num_tenants, buckets=[bucket],
        active_tenants=active_tenants, churn_every_s=churn_every_s,
        seed=seed)
    # 3x the diurnal peak: under continuous batching a burst at the
    # base rate is absorbed into fuller groups without ever deepening
    # the queue — the overlay must outrun the linger-window drain so
    # per-replica depth actually rises above the diurnal-peak envelope
    # (the signal the scale-up threshold discriminates on).
    return _workloads_mod.overlay_burst(
        records, at_s=0.30 * duration_s, duration_s=0.08 * duration_s,
        rate=3.0 * peak_rate, num_tenants=num_tenants, buckets=[bucket],
        seed=seed)


def build_requests(records, pool, image_shape, num_tenants: int,
                   num_classes: int = 3):
    """Pre-materialized wire payloads, one per trace record: the
    tenant's fixed support set + per-record-seed fresh queries (repeat
    tenants ARE the workload). Done before replay starts so array
    synthesis never shows up as replay lag. ``num_classes``: the served
    config's way (the JAX script's 3 by default)."""
    import numpy as np
    reqs = []
    for i, rec in enumerate(records):
        t = int(rec["tenant"]) % num_tenants
        sx, sy, q_rows = pool[t]
        rq = np.random.RandomState(int(rec["seed"]) & 0x7FFFFFFF)
        _, _, qx = _workloads_mod.synthetic_arrays(
            image_shape, num_classes, True, rq, (1, q_rows))
        reqs.append({"tenant": t, "sx": sx, "sy": sy, "qx": qx,
                     "key": _router_mod.routing_key(sx, sy)})
    return reqs


def phase_plan(duration_s: float) -> List[Dict[str, Any]]:
    return [{"name": "trough", "until_s": 0.20 * duration_s},
            {"name": "ramp", "until_s": 0.42 * duration_s},
            {"name": "peak", "until_s": 0.70 * duration_s},
            {"name": "fall", "until_s": duration_s}]


# ---------------------------------------------------------------------------
# one leg: boot fleet, replay trace, settle, account
# ---------------------------------------------------------------------------

class TrafficLeg:
    """One fleet lifecycle around one open-loop replay.

    The pump (run from replay wait slices AND the drain/settle loops)
    does the housekeeping a real frontend runs: membership refresh,
    controller tick, signal publication -> autoscale advice ->
    supervisor tick, reconnects, and retry submission. Submission is
    cohort-aware: while the controller reports a weighted bake in
    flight, each request is deterministically assigned via
    ``assign_canary`` and routed ``among`` its cohort, and its
    completion is attributed back through ``observe_cohort``.
    """

    def __init__(self, name: str, out: str, cfg_path: str,
                 cfg_doc: dict, ckpt_dir: str, *, replicas: int,
                 device: str = "cuda",
                 scale_max: Optional[int] = None,
                 autoscale: bool = False,
                 queue_high_per_replica: float = 2.0,
                 max_retries: int = 20, trace_rate: float = 0.0):
        self.name = name
        self.out = out
        self.cfg_doc = cfg_doc
        self.device = device
        self.boot_timeout_s = BOOT_TIMEOUT_S[device]
        self.autoscale = autoscale
        self.queue_high = queue_high_per_replica
        self.max_retries = max_retries
        self.replicas = replicas
        self.fleet_dir = os.path.join(out, f"fleet_{name}")
        self.registry = _MiniMetrics()
        self.router = _router_mod.FleetRouter(
            self.fleet_dir, vnodes=int(cfg_doc["fleet_vnodes"]),
            load_factor=float(cfg_doc["fleet_load_factor"]),
            stalled_after_s=float(cfg_doc["fleet_replica_stalled_s"]),
            dead_after_s=float(cfg_doc["fleet_replica_dead_s"]),
            breaker_cooldown_s=1.0, registry=self.registry)
        self.controller = _controller_mod.FleetController(
            self.fleet_dir, self.router.refresh, registry=self.registry,
            slo_p95_ms=float(cfg_doc["fleet_slo_p95_ms"]),
            slo_target_frac=float(cfg_doc.get("fleet_slo_target_frac")
                                  or 0.95),
            canary_min_requests=int(cfg_doc.get("fleet_canary_min_requests")
                                    or 32),
            canary_burn_factor=float(cfg_doc.get("fleet_canary_burn_factor")
                                     or 2.0))
        self.sup = _supervisor_mod.ReplicaSupervisor(
            self.fleet_dir,
            make_spawn(out, cfg_path, ckpt_dir, self.fleet_dir,
                       device=device),
            desired=replicas, scale_min=replicas,
            scale_max=scale_max or replicas,
            max_restarts=5, restart_window_s=300.0,
            stalled_after_s=float(cfg_doc["fleet_replica_stalled_s"]),
            dead_after_s=float(cfg_doc["fleet_replica_dead_s"]),
            start_timeout_s=self.boot_timeout_s, backoff_base_s=0.2,
            backoff_cap_s=2.0,
            registry=self.registry,
            events_path=os.path.join(out, f"events_sup_{name}.jsonl"))
        self.client = FleetClient(self.router, self.fleet_dir)
        # request bookkeeping (cid = trace record index; warmup/topup
        # requests use negative ids so they never collide)
        self.lock = threading.Lock()
        self.results: Dict[int, dict] = {}
        self.sched: Dict[int, float] = {}
        self.tenant_of: Dict[int, int] = {}
        self.cohort_of: Dict[int, str] = {}
        self.rid_of: Dict[int, int] = {}
        self.retry_count: Dict[int, int] = {}
        self.retry_q: deque = deque()
        self.latency_ms: Dict[int, float] = {}
        self.untracked: set = set()  # warmup ids: excluded from stats
        self._stash: Dict[int, dict] = {}  # cid -> payload (for retries)
        self.split = {"weight": None, "canary": [], "stage": None}
        self.suppressed_scale_downs = 0
        self._last_pump = 0.0
        self._fire_rollout: Optional[Any] = None  # set by run_rollout
        # Request tracing (trace_rate > 0): each tracked request mints its
        # context once, under a sequence unique to this leg (the legs
        # share one out dir and reuse record indices); the root span runs
        # from the scheduled arrival to the response.
        self.trace_rate = trace_rate
        self.ctx_of: Dict[int, Any] = {}
        self.rt = self.ring = self.prev_ring = None
        if trace_rate > 0:
            self.rt = _router_mod.reqtrace_mod()
            self.ring = self.rt.SpanRing(capacity=65536)
            self.prev_ring = self.rt.install(self.ring)

    # -- lifecycle --------------------------------------------------------
    def boot(self) -> None:
        _boot_fleet(self.sup, self.client, self.router,
                    want_live=self.replicas, timeout_s=self.boot_timeout_s)
        self._attach()

    def stop(self) -> None:
        if self.rt is not None:
            # A traced replica writes its spans when it stops on request;
            # the supervisor's SIGTERM would lose them, so it comes only
            # after each stopped replica has exited (or a minute passed).
            for conn in self.client.conns.values():
                conn.stop()
            deadline = time.monotonic() + 60.0
            for rec in self.sup.slots.values():
                while (rec["proc"] is not None and rec["proc"].poll() is None
                       and time.monotonic() < deadline):
                    time.sleep(0.05)
        self.sup.stop()
        self.client.close()
        if self.rt is not None:
            self.ring.flush(JsonlLogger(os.path.join(
                self.out, f"events_frontend_{self.name}.jsonl")),
                phase="traffic_frontend", replica="frontend")
            self.rt.install(self.prev_ring)

    def _attach(self) -> None:
        for conn in self.client.conns.values():
            if conn._on_response is not self._on_response:
                conn._on_response = self._on_response

    # -- response path ----------------------------------------------------
    def _on_response(self, rid: int, msg: dict) -> None:
        cid = msg.get("id")
        with self.lock:
            self.router.complete(self.rid_of.get(cid, rid))
            err = msg.get("error")
            if not err:
                self.router.record_success(rid)
            if err and str(err).startswith("rejected") \
                    and self.retry_count.get(cid, 0) < self.max_retries:
                self.retry_count[cid] = self.retry_count.get(cid, 0) + 1
                self.retry_q.append(cid)
                return
            msg["rid"] = rid
            self.results[cid] = msg
            lat = (time.monotonic() - self.sched[cid]) * 1e3
            tenant = self.tenant_of.get(cid)
            cohort = self.cohort_of.get(cid)
            if cohort is not None:
                # Bake-stage evidence, the settle loop's top-ups included:
                # they are sent for exactly that (the JAX script returns
                # before this for them, so its top-ups feed no stage).
                self.controller.observe_cohort(cohort, tenant, lat)
            if cid in self.untracked:
                return
            self.latency_ms[cid] = lat
            ctx = self.ctx_of.get(cid)
            if ctx is not None:
                self.rt.record_root(ctx, self.sched[cid], lat / 1e3,
                                    replica=rid, error=bool(err))
            self.controller.slo.observe(tenant, lat)

    # -- submission -------------------------------------------------------
    def _send(self, cid: int, item: dict) -> bool:
        """Route + send one request under the current traffic split.
        Caller holds the lock. False = no route yet (stays queued)."""
        self._stash[cid] = item
        among = None
        w = self.split["weight"]
        if w is not None:
            canary = set(self.split["canary"])
            if _router_mod.assign_canary(item["tenant"], cid, w):
                self.cohort_of[cid] = "canary"
                among = sorted(canary)
                self.registry.counter(
                    _router_mod.CANARY_REQUESTS_COUNTER).inc()
            else:
                self.cohort_of[cid] = "stable"
                among = [r for r in self.router.routable
                         if r not in canary] or None
        rid = self.router.route(item["key"], among=among)
        if rid is None or rid not in self.client.conns:
            if rid is not None:
                self.router.complete(rid)
            return False
        self.rid_of[cid] = rid
        msg = {"op": "serve", "id": cid, "support_x": item["sx"],
               "support_y": item["sy"], "query_x": item["qx"]}
        ctx = self.ctx_of.get(cid)
        if ctx is not None:
            msg["trace"] = ctx
        try:
            self.client.conns[rid].send(msg)
        except OSError:
            self.router.complete(rid)
            self.router.record_failure(rid)
            return False
        return True

    def submit(self, cid: int, item: dict, scheduled: float) -> None:
        with self.lock:
            self.sched.setdefault(cid, scheduled)
            self.tenant_of[cid] = item["tenant"]
            if (self.rt is not None and cid not in self.ctx_of
                    and cid not in self.untracked):
                self.ctx_of[cid] = self.rt.mint(
                    item["tenant"], f"{self.name}:{cid}", self.trace_rate)
            if not self._send(cid, item):
                self.retry_count[cid] = self.retry_count.get(cid, 0)
                self.retry_q.append(cid)

    # -- housekeeping -----------------------------------------------------
    def pump(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        if now - self._last_pump < 0.05:
            return
        self._last_pump = now
        self.router.refresh()
        self.controller.tick()
        if self.autoscale:
            advice = _controller_mod.advise(
                self.controller.publish_signals(),
                live=len(self.router.routable),
                queue_per_replica_high=self.queue_high,
                p95_high_ms=0.6 * float(self.cfg_doc["fleet_slo_p95_ms"]),
                min_replicas=self.replicas)
            if advice == "scale_down":
                # The lab gates on scale-UP under load; culling capacity
                # while a rollout may be in flight is the chaos suite's
                # territory, not this proof's. Counted, not hidden.
                self.suppressed_scale_downs += 1
                advice = "hold"
            self.sup.tick(advice=advice)
        else:
            self.sup.tick()
        self.client.pump()
        self._attach()
        self.split = self.controller.traffic_split()
        if self._fire_rollout is not None:
            self._fire_rollout()
        with self.lock:
            for _ in range(len(self.retry_q)):
                cid = self.retry_q.popleft()
                if not self._send(cid, self._stash[cid]):
                    self.retry_q.append(cid)
                    break

    # -- the replay -------------------------------------------------------
    def replay(self, records, requests, *, warp: float,
               drain_timeout_s: float = 120.0) -> Dict[str, Any]:
        rep = _replay_mod.replay(
            records,
            lambda i, rec, sched: self.submit(i, requests[i], sched),
            warp=warp, pump=self.pump)
        deadline = time.monotonic() + drain_timeout_s
        total = len(records)
        while time.monotonic() < deadline:
            with self.lock:
                done = sum(1 for c in self.results
                           if c >= 0 and c not in self.untracked)
            if done >= total:
                break
            self.pump()
            time.sleep(0.02)
        return rep

    def warmup(self, items, timeout_s: float = 60.0) -> List[float]:
        """Sequential round trips outside the stats (negative ids).
        Returns per-request wall latencies ms — the calibration probe
        reads them; warmup proper ignores them."""
        out: List[float] = []
        for j, item in enumerate(items):
            cid = -(j + 1 + len(self.untracked))
            self.untracked.add(cid)
            evt = threading.Event()
            with self.lock:
                self.sched[cid] = time.monotonic()
                self.tenant_of[cid] = item["tenant"]
            t0 = time.monotonic()
            sent = False
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                with self.lock:
                    if not sent:
                        sent = self._send(cid, item)
                    if cid in self.results:
                        evt.set()
                if evt.is_set():
                    break
                self.pump()
                time.sleep(0.005)
            if not evt.is_set():
                raise TimeoutError(
                    f"{self.name}: warmup request {cid} timed out")
            out.append((time.monotonic() - t0) * 1e3)
        return out

    # -- accounting -------------------------------------------------------
    def leg_stats(self, records, phases, rep: Dict[str, Any]
                  ) -> Dict[str, Any]:
        # Every submitted request answered (the settle loop's last top-ups
        # included) before the replicas' counters are read: a replica
        # asked mid-batch would report launches its batch counts do not
        # yet include.
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            with self.lock:
                if all(c in self.results for c in self.sched):
                    break
            self.pump()
            time.sleep(0.01)
        with self.lock:
            lat = dict(self.latency_ms)
            tracked = {c: r for c, r in self.results.items()
                       if c >= 0 and c not in self.untracked}
        vals = [lat[c] for c in lat if c >= 0]
        failed = sum(1 for r in tracked.values() if r.get("error"))
        per_replica = {}
        for rid, conn in sorted(self.client.conns.items()):
            try:
                per_replica[str(rid)] = conn.stats()
            except Exception as e:  # noqa: BLE001
                per_replica[str(rid)] = {"error": str(e)}
        cb_groups = sum(
            int(((rec.get("stats") or {}).get("cb_groups")) or 0)
            for rec in per_replica.values())
        sheds = sum(int(((rec.get("stats") or {}).get("sheds")) or 0)
                    for rec in per_replica.values())
        burn = self.controller.slo.burn_rate()
        snap = self.registry.snapshot()
        return {
            "offered": len(records),
            "completed": len(tracked) - failed,
            "failed": failed,
            "dropped": len(records) - len(tracked),
            "rejected_retries": sum(self.retry_count.values()),
            "p50_ms": _pct(vals, 0.50), "p95_ms": _pct(vals, 0.95),
            "p99_ms": _pct(vals, 0.99),
            "phases": _replay_mod.phase_stats(
                records, phases, lat, nearest_rank),
            "max_lag_ms": rep.get("max_lag_ms"),
            "lag_p95_ms": _pct(list(rep.get("lag_ms") or []), 0.95),
            "wall_seconds": rep.get("wall_seconds"),
            "slo_burn_rate": burn,
            "slo_held": bool(burn is not None and burn <= 1.0),
            "cb_groups": cb_groups, "sheds": sheds,
            "cohort_fallbacks": int(snap.get(
                _router_mod.COHORT_FALLBACK_COUNTER, 0)),
            "canary_requests": int(snap.get(
                _router_mod.CANARY_REQUESTS_COUNTER, 0)),
            "scale_ups": int(snap.get(
                _supervisor_mod.SCALE_UPS_COUNTER, 0)),
            "scale_downs": int(snap.get(
                _supervisor_mod.SCALE_DOWNS_COUNTER, 0)),
            "suppressed_scale_downs": self.suppressed_scale_downs,
            "per_replica_responses": {
                str(rid): sum(1 for r in tracked.values()
                              if r.get("rid") == rid)
                for rid in sorted(self.client.conns)},
            "kernels": _kernel_accounting(per_replica, self.cfg_doc,
                                          self.device),
        }


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def calibrate(leg: TrafficLeg, image_shape, bucket, *, probes: int = 5,
              num_classes: int = 3) -> Dict[str, Any]:
    """Measure this box's per-dispatch serve cost on the booted
    baseline replica: fresh-tenant requests price the padded
    adapt-on-miss dispatch, an immediate repeat prices the cache-hit
    (predict-only) dispatch. Both are flat in group size (partial
    groups are padded), which is exactly the asymmetry the cb leg
    exploits — so the operating point is derived from them."""
    import numpy as np
    rng = np.random.RandomState(0xCA1)
    miss_items, hit_items = [], []
    for j in range(probes):
        sx, sy, _ = _workloads_mod.synthetic_arrays(
            image_shape, num_classes, True, rng, bucket)
        _, _, qx = _workloads_mod.synthetic_arrays(
            image_shape, num_classes, True, rng, (1, bucket[1]))
        item = {"tenant": 100000 + j, "sx": sx, "sy": sy, "qx": qx,
                "key": _router_mod.routing_key(sx, sy)}
        miss_items.append(item)
        hit_items.append(dict(item))
    # First round trips pay any residual warm-up; probe on a second set.
    leg.warmup(miss_items[:2])
    miss_ms = leg.warmup(miss_items[2:])
    hit_ms = leg.warmup(hit_items[2:])
    med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    return {"probe_miss_ms": round(med(miss_ms), 2),
            "probe_hit_ms": round(med(hit_ms), 2)}


def operating_point(cal: Dict[str, Any], *, miss_frac: float = 0.12
                    ) -> Dict[str, float]:
    """Rates + linger from the probed costs: peak sized so fixed-mode
    SINGLE dispatch runs past saturation (1.5x) while full groups keep
    >= 2x headroom; linger long enough to assemble most of a group at
    peak, capped so it never dominates the SLO."""
    c = (cal["probe_hit_ms"]
         + miss_frac * max(cal["probe_miss_ms"] - cal["probe_hit_ms"],
                           0.0)) / 1e3
    c = max(c, 0.010)
    peak = min(max(1.5 / c, 4.0), 40.0)
    linger_ms = min(max(2.5 * c * 1e3, 40.0), 250.0)
    return {"per_request_cost_ms": round(c * 1e3, 2),
            "peak_rate": round(peak, 2),
            "base_rate": round(peak / 10.0, 3),
            "linger_ms": round(linger_ms, 1)}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

# A trace shorter than this rides the 2-stage canary ladder: its peak
# plateau cannot feed a 1% stage (main).
SHORT_TRACE_S = 40.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="traffic lab of the PyTorch port: open-loop trace "
                    "replay (fixed / cb / rollout legs)")
    ap.add_argument("--quick", action="store_true",
                    help="short trace for CI smoke")
    ap.add_argument("--out", default=None)
    ap.add_argument("--duration", type=float, default=None,
                    help="trace duration seconds (default 60, quick 24)")
    ap.add_argument("--warp", type=float, default=1.0)
    ap.add_argument("--peak-rate", type=float, default=0.0,
                    help="peak request rate; 0 = calibrate on this box")
    ap.add_argument("--linger-ms", type=float, default=0.0,
                    help="cb linger; 0 = calibrate")
    ap.add_argument("--tenants", type=int, default=96)
    ap.add_argument("--active-tenants", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the replicas serve (the card by default)")
    ap.add_argument("--config", default=None,
                    help="experiment JSON whose model and episode shapes "
                         "the replicas serve (e.g. the flagship's); "
                         "default: the quick serving profile")
    ap.add_argument("--checkpoint", default=None,
                    help="a trainer's saved_models to serve (copied); "
                         "default: a seeded random v1")
    ap.add_argument("--trace-sample-rate", type=float, default=0.0,
                    help="head-based request-trace sampling rate in "
                         "[0, 1]; 0 (default) = tracing off")
    args = ap.parse_args(argv)
    # Every process this harness starts ends with it, on SIGTERM too.
    reaper.install()

    require_card(args.device)
    duration = args.duration or (24.0 if args.quick else 60.0)
    artifact: Dict[str, Any] = {
        "metric": "traffic_replay", "value": None, "unit": "p95_ms",
        "status": "failed", "quick": bool(args.quick),
        "duration_s": duration, "warp": args.warp,
        "backend": "torch", "device": args.device, "config": args.config,
        "trace_sample_rate": args.trace_sample_rate,
        "traffic_p95_ms": None, "traffic_slo_held": None,
        "traffic_canary_weight_final": None, "traffic_cb_groups": None,
    }
    if not _can_bind_localhost():
        artifact.update({"status": "skipped",
                         "skip_reason": "cannot bind localhost sockets"})
        print(json.dumps(artifact), flush=True)
        return 0

    out = args.out or tempfile.mkdtemp(prefix="torch_traffic_replay_")
    made_tmp = args.out is None
    os.makedirs(out, exist_ok=True)
    ckpt_dir = os.path.join(out, "saved_models")
    l2_dir = os.path.join(out, "l2")
    base = None
    if args.config:
        with open(args.config) as f:
            base = json.load(f)

    # The traffic lab measures SCHEDULING — batching, traffic split,
    # autoscale — so without --config every leg runs the quick serving
    # profile; with it, the config's width (the calibrated rates carry
    # the load shape either way).
    base_doc = fleet_cfg_dict(out, quick=True, l1_capacity=48,
                              l2_dir=l2_dir, base=base,
                              trace_sample_rate=args.trace_sample_rate)
    base_doc.update(serve_max_queue_depth=512, fleet_slo_p95_ms=2000.0)
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    mcfg = MAMLConfig.from_dict(base_doc)
    bucket = tuple(mcfg.serve_bucket_shapes[0])
    num_classes = mcfg.num_classes_per_set
    image_shape = mcfg.image_shape
    # The full run walks the config-default 1% -> 10% -> 100% ladder.
    # Evidence at 1% of a ~40 req/s peak trickles in at ~0.4/s, so the
    # minimum per-stage count is small and the rollout triggers just
    # BEFORE peak (0.45 * duration) to give stage 0 the whole peak
    # plateau. A short trace can't feed a 1% stage at all — it rides a
    # 2-stage 25% -> 100% ladder instead.
    if duration < SHORT_TRACE_S:
        weights, min_requests = [0.25, 1.0], 10
    else:
        weights, min_requests = [0.01, 0.10, 1.0], 5
    docs = {
        "fixed": dict(base_doc, serve_continuous_batching=0),
        "cb": dict(base_doc, serve_continuous_batching=1),
        "rollout": dict(base_doc, serve_continuous_batching=1,
                        fleet_canary_weights=weights,
                        fleet_canary_min_requests=min_requests,
                        fleet_canary_burn_factor=2.0),
    }
    cfg_paths = {}
    for name, doc in docs.items():
        cfg_paths[name] = os.path.join(out, f"cfg_{name}.json")
        with open(cfg_paths[name], "w") as f:
            json.dump(doc, f)

    phases = phase_plan(duration)
    legs: Dict[str, Any] = {}
    seconds: Dict[str, float] = {}
    try:
        artifact["prepare_seconds"] = prepare_checkpoint(
            out, cfg_paths["fixed"], ckpt_dir, args.checkpoint)

        # ---- leg 1: fixed (also hosts the calibration probe) ----------
        t0 = time.monotonic()
        leg = TrafficLeg("fixed", out, cfg_paths["fixed"], docs["fixed"],
                         ckpt_dir, replicas=1, device=args.device,
                         trace_rate=args.trace_sample_rate)
        leg.boot()
        cal = calibrate(leg, image_shape, bucket, num_classes=num_classes)
        op = operating_point(cal)
        if args.peak_rate > 0:
            op["peak_rate"] = args.peak_rate
            op["base_rate"] = args.peak_rate / 10.0
        if args.linger_ms > 0:
            op["linger_ms"] = args.linger_ms
        artifact["calibration"] = dict(cal, **op)

        records = build_trace(
            duration_s=duration, base_rate=op["base_rate"],
            peak_rate=op["peak_rate"], num_tenants=args.tenants,
            active_tenants=args.active_tenants,
            churn_every_s=max(duration / 30.0, 1.0), bucket=bucket,
            seed=args.seed)
        trace_path = os.path.join(out, "diurnal.trace")
        _trace_mod.write_trace(trace_path, records, meta={
            "workload": "diurnal+churn+burst",
            "base_rate": op["base_rate"], "peak_rate": op["peak_rate"],
            "duration_s": duration, "tenants": args.tenants})
        uniq = len({r["tenant"] for r in records})
        artifact["trace"] = {
            "records": len(records), "unique_tenants": uniq,
            "miss_frac_est": round(uniq / max(len(records), 1), 3),
            "base_rate": op["base_rate"], "peak_rate": op["peak_rate"],
            "swing": round(op["peak_rate"] / max(op["base_rate"], 1e-9),
                           1)}
        import numpy as np
        pool = _workloads_mod.tenant_pool(
            image_shape, num_classes, True,
            np.random.RandomState(args.seed), [bucket], args.tenants)
        requests = build_requests(records, pool, image_shape,
                                  args.tenants, num_classes)

        rep = leg.replay(records, requests, warp=args.warp)
        legs["fixed"] = leg.leg_stats(records, phases, rep)
        leg.stop()
        seconds["fixed"] = round(time.monotonic() - t0, 1)

        # ---- leg 2: cb -------------------------------------------------
        t0 = time.monotonic()
        docs["cb"]["serve_batch_linger_ms"] = op["linger_ms"]
        docs["rollout"]["serve_batch_linger_ms"] = op["linger_ms"]
        for name in ("cb", "rollout"):
            with open(cfg_paths[name], "w") as f:
                json.dump(docs[name], f)
        leg = TrafficLeg("cb", out, cfg_paths["cb"], docs["cb"],
                         ckpt_dir, replicas=1, device=args.device,
                         trace_rate=args.trace_sample_rate)
        leg.boot()
        leg.warmup([requests[0], requests[1]])
        rep = leg.replay(records, requests, warp=args.warp)
        legs["cb"] = leg.leg_stats(records, phases, rep)
        leg.stop()
        seconds["cb"] = round(time.monotonic() - t0, 1)

        # ---- leg 3: rollout (cb + autoscale + weighted canary) ---------
        t0 = time.monotonic()
        leg = TrafficLeg("rollout", out, cfg_paths["rollout"],
                         docs["rollout"], ckpt_dir, replicas=2,
                         device=args.device, scale_max=3, autoscale=True,
                         trace_rate=args.trace_sample_rate)
        leg.boot()
        leg.warmup([requests[0], requests[1]])
        # Late-ramp trigger: once the replay crosses the record whose
        # arrival is at 0.45 * duration (just before the crest),
        # publish v2 off-thread and start the WEIGHTED rollout the
        # moment the publish lands — stage 0's thin canary slice gets
        # the whole peak plateau to gather its evidence.
        trigger_idx = next((i for i, r in enumerate(records)
                            if r["t"] >= 0.45 * duration), len(records))
        box: Dict[str, Any] = {}

        def fire_when_due() -> None:
            with leg.lock:
                submitted = len(leg.sched)
            if box.get("fired") or submitted < trigger_idx:
                return
            box["fired"] = True

            def _worker():
                try:
                    _run_child("publish-v2", cfg_paths["rollout"],
                               ckpt_dir, out)
                    with open(os.path.join(out, "publish-v2.log")) as f:
                        last = [ln for ln in f.read().splitlines()
                                if ln.strip()][-1]
                    version = int(json.loads(last)["version"])
                    leg.controller.start_rollout(version, weights=weights)
                    box["version"] = version
                except Exception as e:  # noqa: BLE001 — reported
                    box["error"] = f"{type(e).__name__}: {e}"
            t = threading.Thread(target=_worker, daemon=True)
            box["thread"] = t
            t.start()

        leg._fire_rollout = fire_when_due
        rep = leg.replay(records, requests, warp=args.warp)
        worker = box.get("thread")
        if worker is not None:
            worker.join(timeout=180)
        # Settle: a bake stage needs live traffic for cohort evidence —
        # trickle trace-shaped top-up requests until the rollout exits
        # ROLLING (counted; the bulk of the rollout ran mid-trace).
        topup = 0
        settle_deadline = time.monotonic() + 120.0
        doc = leg.controller.read_rollout()
        next_send = time.monotonic()
        while (doc.get("state") == _controller_mod.ROLLING
               and time.monotonic() < settle_deadline):
            now = time.monotonic()
            if now >= next_send:
                i = topup % len(requests)
                cid = 1_000_000 + topup
                leg.untracked.add(cid)
                leg.submit(cid, requests[i], now)
                topup += 1
                # ~20/s: enough that even a 1% canary slice sees an
                # observation every few seconds if a bake stage is
                # still open when the trace runs out.
                next_send = now + 0.05
            leg.pump()
            time.sleep(0.01)
            doc = leg.controller.read_rollout()
        legs["rollout"] = leg.leg_stats(records, phases, rep)
        legs["rollout"]["topup_requests"] = topup
        legs["rollout"]["publish_error"] = box.get("error")
        legs["rollout"]["rollout"] = {
            k: doc.get(k) for k in
            ("state", "version", "mode", "stage", "phase", "canary",
             "index", "rejected", "halt_reason", "halt_detail",
             "stage_history")}
        leg.stop()
        seconds["rollout"] = round(time.monotonic() - t0, 1)

        # ---- gates -----------------------------------------------------
        fixed, cb, roll = legs["fixed"], legs["cb"], legs["rollout"]
        w_final = None
        if doc.get("mode") == "weighted":
            stage = min(int(doc.get("stage") or 0), len(weights) - 1)
            w_final = (weights[-1]
                       if doc.get("state") == _controller_mod.DONE
                       else weights[stage])
        gates = {
            "cb_beats_fixed": bool(
                cb["p95_ms"] is not None and fixed["p95_ms"] is not None
                and cb["p95_ms"] < fixed["p95_ms"]),
            "cb_structural": bool(fixed["cb_groups"] == 0
                                  and cb["cb_groups"] > 0),
            "zero_dropped": bool(fixed["dropped"] == 0
                                 and cb["dropped"] == 0
                                 and roll["dropped"] == 0
                                 and roll["failed"] == 0),
            "slo_held": bool(roll["slo_held"]),
            "rollout_done": bool(
                doc.get("state") == _controller_mod.DONE),
            "autoscaled": bool(roll["scale_ups"] >= 1),
            "kernels": all(leg_["kernels"]["ok"]
                           for leg_ in (fixed, cb, roll)),
        }
        ok = all(gates.values())
        artifact.update({
            "status": "ok" if ok else "failed",
            "value": roll["p95_ms"],
            "gates": gates, "legs": legs, "seconds": seconds,
            "canary_weights": weights,
            "traffic_p95_ms": roll["p95_ms"],
            "traffic_slo_held": roll["slo_held"],
            "traffic_canary_weight_final": w_final,
            "traffic_cb_groups": roll["cb_groups"],
            "out_dir": None if made_tmp else out,
        })
        print(json.dumps(artifact), flush=True)
        if made_tmp and ok:
            shutil.rmtree(out, ignore_errors=True)
        return 0 if ok else 1
    except Exception as e:  # noqa: BLE001 — the artifact IS the report
        artifact.update({"status": "failed",
                         "error": f"{type(e).__name__}: {e}",
                         "legs": legs, "out_dir": out})
        print(json.dumps(artifact), flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
