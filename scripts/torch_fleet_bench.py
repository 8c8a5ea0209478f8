"""Fleet benchmark of the PyTorch port: replica processes + the router on
one box (the port's counterpart of ``scripts/fleet_bench.py``).

Real OS processes, real sockets, the port's router, controller and L2
tier. Every replica (``python -m
howtotrainyourmamlpytorch_tpu_torch.serve.fleet.replica``) runs its own
``ServingEngine`` on the card (``--device cuda``, the default) or on the
CPU (``--device cpu``); with several replicas on one card each has its
own CUDA context. The checkpoint and the new version are written by
child processes (``--mode prepare`` / ``--mode publish-v2``) with the
port's trainer state and ``CheckpointManager``. Imports nothing of JAX.

Legs:

1. **single** — one replica, no L2, through the same router and sockets.
2. **fleet** — N replicas (default 3) with consistent-hash routing and
   the shared L2 tier, same workload. Mid-load, a perturbed checkpoint
   is published as a new version and the controller runs a rolling
   hot-swap through it, one replica at a time behind the router.
3. **migration** — after the rollout: serve one tenant on its ring
   primary A, drain A, route the tenant again (it lands on B) and check
   that the answer came from the L2 tier with zero adapts on B.

The workload has more tenants than one replica's L1 (``--tenants`` >
``--l1-capacity``), so a single engine re-adapts repeat tenants while
consistent hashing gives each replica a share that fits. On one card the
replicas also share the device, so the fleet's QPS against the single
leg's is printed, not claimed.

The last stdout line is a JSON artifact with the JAX script's keys
(``fleet_qps``, ``fleet_l2_hit_frac``, ``fleet_rolling_swaps``,
``fleet_rolling_swap_halts``, ``fleet_router_spills``, ``zero_dropped``,
``migration``, ...) plus ``bn_act_launches``: per replica, the BN
kernel's launches in that process beside the count its adapt and
predict batches need (warm-ups and canaries included), and their sum.
On a box that cannot bind localhost sockets the artifact says
``"status": "skipped"`` (exit 0).

Usage:
    python scripts/torch_fleet_bench.py --quick --device cpu   # 2 replicas
    python scripts/torch_fleet_bench.py --replicas 2 \\
        --config experiment_config/mini-imagenet_maml++_5-way_5-shot_DA_b12.json \\
        --out /tmp/fb                      # flagship width, on the card
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from howtotrainyourmamlpytorch_tpu_torch.serve.fleet import (  # noqa: E402
    controller as fleet_controller, router as fleet_router)
from howtotrainyourmamlpytorch_tpu_torch.serve.loadlab.workloads import (  # noqa: E402
    synthetic_arrays, tenant_pool)
from howtotrainyourmamlpytorch_tpu_torch.telemetry.registry import (  # noqa: E402
    MetricsRegistry)
from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import (  # noqa: E402
    JsonlLogger, nearest_rank, read_jsonl)


def bench_bucket(quick: bool):
    """(support, query) bucket of the small profiles: 3-way 5-shot with a
    small query set; ``--quick`` a 1-shot toy."""
    return (3, 4) if quick else (15, 2)


def _can_bind_localhost() -> bool:
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
        return True
    except OSError:
        return False


def fleet_cfg_dict(out_dir: str, *, quick: bool, l1_capacity: int,
                   l2_dir: str, trace_sample_rate: float = 0.0,
                   base: Optional[dict] = None) -> dict:
    """The serving config every process of the bench shares.

    ``base`` (an experiment JSON's dict) keeps its model and episode
    shapes (the flagship's width, for one) and its serving bucket;
    without it a small profile runs (24x24x1, 4 stages of 32 filters,
    3-way 5-shot), or with ``quick`` a toy one. The serve and fleet
    knobs below are the bench's either way."""
    if base is not None:
        model = dict(base)
    else:
        model = dict(
            dataset_name="synthetic_fleet",
            image_height=(12 if quick else 24),
            image_width=(12 if quick else 24), image_channels=1,
            num_classes_per_set=3,
            num_samples_per_class=(1 if quick else 5),
            num_target_samples=2, batch_size=4,
            cnn_num_filters=(4 if quick else 32),
            num_stages=(2 if quick else 4),
            number_of_training_steps_per_iter=2,
            number_of_evaluation_steps_per_iter=(2 if quick else 5),
            second_order=False, use_multi_step_loss_optimization=False,
            compute_dtype="float32",
            serve_buckets=[list(bench_bucket(quick))], serve_batch_tasks=4)
    model.update(
        experiment_name="fleet_bench", experiment_root=out_dir,
        bn_backend="pallas", mesh_shape=[1, 1],
        serve_cache_capacity=int(l1_capacity),
        serve_default_deadline_ms=0.0,
        serve_max_queue_depth=256,
        serve_registry_poll_s=0.0,
        # The bench's v2 is v1 with a 1e-3 weight perturbation, and its
        # probes are noise: the latency gate would compare replicas
        # sharing one box, the accuracy gate luck. Both are widened so
        # the gate that decides this rollout is finiteness.
        serve_canary_latency_factor=20.0,
        serve_canary_acc_drop=1.0,
        serve_l2_dir=l2_dir,
        fleet_lease_interval_s=0.25,
        fleet_replica_stalled_s=0.75,
        fleet_replica_dead_s=5.0,
        fleet_vnodes=128,
        fleet_load_factor=2.5,
        reqtrace_sample_rate=float(trace_sample_rate),
        fleet_slo_p95_ms=2000.0,
        fleet_slo_target_frac=0.95,
        watchdog_serve_timeout_s=600.0)
    return model


# ---------------------------------------------------------------------------
# child modes: the checkpoint and the new version
# ---------------------------------------------------------------------------

def _mode_prepare(cfg_path: str, ckpt_dir: str) -> int:
    """Save and publish the v1 checkpoint (seeded random weights)."""
    from howtotrainyourmamlpytorch_tpu_torch.ckpt.registry import (
        ModelRegistry)
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
        init_train_state)
    from howtotrainyourmamlpytorch_tpu_torch.models import make_model
    from howtotrainyourmamlpytorch_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    cfg = MAMLConfig.from_json_file(cfg_path)
    model_init, _ = make_model(cfg)
    state = init_train_state(cfg, model_init, seed=cfg.seed, device="cpu")
    manager = CheckpointManager(ckpt_dir, max_to_keep=4)
    manager.save(state, epoch=0, current_iter=1, val_acc=0.5)
    rec = ModelRegistry(ckpt_dir).publish(
        tag="0", epoch=0, iteration=1, val_acc=0.5,
        fingerprint=manager.fingerprint(0))
    print(json.dumps({"prepared": True, "version": rec["version"]}),
          flush=True)
    return 0


def _mode_publish_v2(cfg_path: str, ckpt_dir: str) -> int:
    """Publish a new version: v1's weights scaled by 1 + 1e-3 (different
    bytes and fingerprint, still finite so the canary passes)."""
    import dataclasses
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.ckpt.registry import (
        ModelRegistry)
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
        init_train_state)
    from howtotrainyourmamlpytorch_tpu_torch.models import make_model
    from howtotrainyourmamlpytorch_tpu_torch.tree import tree_map
    from howtotrainyourmamlpytorch_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    cfg = MAMLConfig.from_json_file(cfg_path)
    model_init, _ = make_model(cfg)
    template = init_train_state(cfg, model_init, seed=cfg.seed,
                                device="cpu")
    manager = CheckpointManager(ckpt_dir, max_to_keep=4)
    state, _meta = manager.load(template, 0)
    with torch.no_grad():
        state = dataclasses.replace(state, params=tree_map(
            lambda x: x * (1.0 + 1e-3), state.params))
    manager.save(state, epoch=1, current_iter=2, val_acc=0.6)
    rec = ModelRegistry(ckpt_dir).publish(
        tag="1", epoch=1, iteration=2, val_acc=0.6,
        fingerprint=manager.fingerprint(1))
    print(json.dumps({"published": True, "version": rec["version"]}),
          flush=True)
    return 0


def _run_child(mode: str, cfg_path: str, ckpt_dir: str, out: str):
    log = open(os.path.join(out, f"{mode}.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mode", mode,
         "--config-path", cfg_path, "--ckpt-dir", ckpt_dir, "--out", out],
        cwd=_REPO, stdout=log, stderr=subprocess.STDOUT)
    rc = proc.wait()
    log.close()
    if rc != 0:
        with open(log.name) as f:
            raise RuntimeError(f"child --mode {mode} failed rc={rc}:\n"
                               + f.read()[-2000:])
    return proc


# ---------------------------------------------------------------------------
# replica management (frontend side)
# ---------------------------------------------------------------------------

class ReplicaConn:
    """One persistent full-duplex connection to a replica: a sender
    (the frontend loop) and a reader thread that dispatches response
    frames to the bench's completion callback."""

    def __init__(self, rid: int, port: int, on_response):
        self.rid = rid
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=60)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._on_response = on_response
        self._send_lock = threading.Lock()
        self._stats: Optional[dict] = None
        self._stats_evt = threading.Event()
        self._stopped_evt = threading.Event()
        threading.Thread(target=self._reader, daemon=True).start()

    def _reader(self) -> None:
        try:
            while True:
                msg = fleet_router.recv_msg(self.sock)
                op = msg.get("op")
                if op == "response":
                    self._on_response(self.rid, msg)
                elif op == "stats":
                    self._stats = msg
                    self._stats_evt.set()
                elif op == "stopped":
                    self._stopped_evt.set()
                    return
        except (ConnectionError, OSError, EOFError):
            self._stopped_evt.set()

    def send(self, msg: dict) -> None:
        with self._send_lock:
            fleet_router.send_msg(self.sock, msg)

    def stats(self, timeout: float = 30.0) -> dict:
        self._stats_evt.clear()
        self.send({"op": "stats"})
        if not self._stats_evt.wait(timeout):
            raise TimeoutError(f"replica {self.rid} stats timed out")
        return self._stats or {}

    def stop(self, timeout: float = 30.0) -> None:
        try:
            self.send({"op": "stop"})
            self._stopped_evt.wait(timeout)
        except OSError:
            pass

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def start_replicas(out: str, cfg_path: str, ckpt_dir: str,
                   fleet_dir: str, ids: List[int],
                   device: str) -> Dict[int, Any]:
    """One replica process per id, started fresh (``python -m``, never a
    fork of this process), each with its own CUDA context on the card."""
    procs = {}
    for rid in ids:
        log = open(os.path.join(out, f"replica_{rid}.log"), "w")
        procs[rid] = (subprocess.Popen(
            [sys.executable, "-m",
             "howtotrainyourmamlpytorch_tpu_torch.serve.fleet.replica",
             "--config", cfg_path, "--replica-id", str(rid),
             "--fleet-dir", fleet_dir, "--checkpoint", ckpt_dir,
             "--events", os.path.join(out, f"events_replica_{rid}.jsonl"),
             "--device", device],
            cwd=_REPO, stdout=log, stderr=subprocess.STDOUT), log)
    return procs


def wait_for_replicas(fleet_dir: str, ids: List[int], procs,
                      timeout_s: float) -> Dict[int, int]:
    """Block until every replica's lease payload carries its port."""
    deadline = time.monotonic() + timeout_s
    ports: Dict[int, int] = {}
    while time.monotonic() < deadline:
        members = fleet_router.read_members(fleet_dir)
        for rid in ids:
            payload = (members.get(rid) or {}).get("payload") or {}
            if payload.get("port"):
                ports[rid] = int(payload["port"])
        if len(ports) == len(ids):
            return ports
        for rid, (proc, _log) in procs.items():
            if proc.poll() is not None:
                raise RuntimeError(
                    f"replica {rid} exited rc={proc.returncode} before "
                    f"announcing (see replica_{rid}.log)")
        time.sleep(0.1)
    raise TimeoutError(f"replicas {sorted(set(ids) - set(ports))} never "
                       f"announced within {timeout_s:.0f}s")


def stop_replicas(conns: Dict[int, ReplicaConn], procs) -> None:
    for conn in conns.values():
        conn.stop()
    for rid, (proc, log) in procs.items():
        try:
            # A replica that never got a stop frame (no conn — startup
            # failed) won't exit on its own: terminate it directly.
            proc.wait(timeout=30 if rid in conns else 0.1)
        except subprocess.TimeoutExpired:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
        log.close()
    for conn in conns.values():
        conn.close()


# ---------------------------------------------------------------------------
# load generation + the drive loop
# ---------------------------------------------------------------------------

def build_schedule(num_requests: int, num_tenants: int, seed: int,
                   image_shape, bucket, num_classes: int):
    """Mixed-tenant request schedule over a fixed tenant population
    (serve_bench's shared generators): every request is some tenant's
    fixed support set + fresh queries — repeat tenants ARE the
    workload, exactly the traffic the router's affinity exists for."""
    import numpy as np
    rng = np.random.RandomState(seed)
    pool = tenant_pool(image_shape, num_classes, True, rng, [bucket],
                       num_tenants)
    schedule = []
    for i in range(num_requests):
        t = int(rng.randint(num_tenants))
        sx, sy, q_rows = pool[t]
        _, _, qx = synthetic_arrays(image_shape, num_classes, True, rng,
                                    (1, q_rows))
        schedule.append({"cid": i, "tenant": t, "sx": sx, "sy": sy,
                         "qx": qx,
                         "key": fleet_router.routing_key(sx, sy)})
    return pool, schedule


def drive_leg(router, conns: Dict[int, ReplicaConn], schedule,
              *, max_outstanding: int, controller=None,
              swap_trigger=None, max_retries: int = 20,
              failover_max_attempts: int = 3,
              stall_timeout_s: float = 300.0, reqtrace=None,
              sample_rate: float = 0.0, slo=None, on_tick=None) -> dict:
    """Push the whole schedule through the fleet as fast as the window
    allows (backlog/throughput mode — the serve_bench rate=0 rule),
    pumping membership refresh, rollout ticks and the optional mid-load
    swap trigger from the same loop a real frontend would run.

    ``reqtrace`` (the module ``fleet_router.reqtrace_mod()`` returns —
    same object the wire protocol records into) + ``sample_rate`` turn
    on request tracing: each request mints its context ONCE (retries
    keep the original trace — the root span covers the whole e2e
    including rejection round-trips) and the root ``request`` span is
    recorded when the final response lands.  ``slo`` is an optional
    SLOLedger fed every completed request's e2e latency.

    Failover is the ROUTER's job now (router.py § FailoverPolicy): a
    dead connection's orphans are resubmitted through the policy
    (bounded ``failover_max_attempts``, counted ``fleet/failovers``,
    breaker-fed so the dead replica leaves the candidate set before
    its lease ages out); a request that exhausts its attempts lands as
    a terminal ``failover_exhausted`` result instead of orbiting the
    ring. A ``shed:`` error is TERMINAL by construction — admission
    refused it at the door, retrying would defeat overload protection.
    ``on_tick(now)`` (optional) runs on the refresh cadence — the
    chaos frontend pumps its supervisor and reconnects from it."""
    lock = threading.Lock()
    cond = threading.Condition(lock)
    results: Dict[int, dict] = {}
    rid_of: Dict[int, int] = {}
    send_ts: Dict[int, float] = {}
    ctx_of: Dict[int, Any] = {}
    retry_q: deque = deque()
    retry_count: Dict[int, int] = {}
    state = {"outstanding": 0, "retries": 0, "gave_up": 0}
    failover = fleet_router.FailoverPolicy(
        router, max_attempts=failover_max_attempts)

    def on_response(rid: int, msg: dict) -> None:
        cid = msg.get("id")
        with cond:
            router.complete(rid_of.get(cid, rid))
            err = msg.get("error")
            if not err:
                # A served answer closes the replica's breaker (the
                # half-open probe success path included).
                router.record_success(rid)
            if err and str(err).startswith("rejected") \
                    and retry_count.get(cid, 0) < max_retries:
                retry_count[cid] = retry_count.get(cid, 0) + 1
                state["retries"] += 1
                retry_q.append(cid)
            else:
                latency = time.monotonic() - send_ts[cid]
                msg["latency_s_e2e"] = latency
                msg["rid"] = rid
                results[cid] = msg
                failover.request_done(cid)
                if slo is not None:
                    slo.observe(by_cid[cid]["tenant"], latency * 1e3)
                ctx = ctx_of.get(cid)
                if reqtrace is not None and ctx is not None:
                    reqtrace.record_root(ctx, send_ts[cid], latency,
                                         replica=rid,
                                         error=bool(err))
            state["outstanding"] -= 1
            cond.notify()

    def give_up(cid: int) -> None:
        # Caller holds ``cond``. Terminal synthetic result: the request
        # chased failovers past the bound; surface the error rather
        # than stall the window (zero-dropped accounting still sees
        # it — "dropped" counts non-ok results).
        latency = time.monotonic() - send_ts.get(cid, time.monotonic())
        results[cid] = {"id": cid, "error": "failover_exhausted",
                        "status": "failed", "latency_s_e2e": latency,
                        "rid": None}
        state["gave_up"] += 1
        ctx = ctx_of.get(cid)
        if reqtrace is not None and ctx is not None:
            reqtrace.record_root(ctx, send_ts.get(cid, 0.0), latency,
                                 replica=None, error=True)

    for conn in conns.values():
        conn._on_response = on_response

    by_cid = {item["cid"]: item for item in schedule}
    pending = deque(item["cid"] for item in schedule)
    swap_fired = False
    dead_conns: set = set()  # conn OBJECT ids — a restarted replica's
    #                          fresh conn under the same rid is new.
    t0 = time.monotonic()
    last_progress = time.monotonic()
    last_refresh = 0.0
    completed_prev = 0
    while len(results) < len(schedule):
        now = time.monotonic()
        if now - last_refresh > 0.05:
            router.refresh()
            if controller is not None:
                controller.tick()
            if on_tick is not None:
                on_tick(now)
            last_refresh = now
            # Dead-socket recovery (the failure-table contract): a
            # replica whose connection died mid-flight never answers
            # its outstanding requests — hand them to the failover
            # policy, which settles the router's books, feeds the
            # breaker, and bounds per-request attempts.
            for rid, conn in list(conns.items()):
                if conn._on_response is not on_response:
                    # A conn swapped in mid-leg (chaos reconnect after
                    # a supervisor restart) joins the response path.
                    conn._on_response = on_response
                if id(conn) in dead_conns \
                        or not conn._stopped_evt.is_set():
                    continue
                dead_conns.add(id(conn))
                with cond:
                    orphans = [cid for cid, r in rid_of.items()
                               if r == rid and cid not in results
                               and cid not in retry_q
                               and cid not in pending]
                    requeue, gave_up = failover.replica_failed(
                        rid, orphans)
                    for cid in requeue:
                        retry_count[cid] = retry_count.get(cid, 0) + 1
                        state["retries"] += 1
                        retry_q.append(cid)
                        state["outstanding"] -= 1
                    for cid in gave_up:
                        give_up(cid)
                        state["outstanding"] -= 1
                    cond.notify()
        if (swap_trigger is not None and not swap_fired
                and len(results) >= swap_trigger["at_completed"]):
            swap_trigger["fire"]()
            swap_fired = True
        sent_any = False
        with cond:
            while (retry_q or pending) \
                    and state["outstanding"] < max_outstanding:
                cid = retry_q.popleft() if retry_q else pending.popleft()
                item = by_cid[cid]
                if reqtrace is not None and cid not in ctx_of:
                    # Mint ONCE per request id: the head-based decision
                    # and the trace id survive retries unchanged.
                    ctx_of[cid] = reqtrace.mint(item["tenant"], cid,
                                                sample_rate)
                ctx = ctx_of.get(cid)
                rid = router.route(item["key"], ctx)
                if rid is None or rid not in conns:
                    if rid is not None:
                        router.complete(rid)
                    (retry_q if retry_count.get(cid) else pending
                     ).appendleft(cid)
                    break
                rid_of[cid] = rid
                send_ts.setdefault(cid, time.monotonic())
                state["outstanding"] += 1
                sent_any = True
                conn = conns[rid]
                try:
                    msg = {"op": "serve", "id": cid,
                           "support_x": item["sx"],
                           "support_y": item["sy"],
                           "query_x": item["qx"]}
                    if ctx is not None:
                        # Unsampled requests carry NO trace key at all
                        # (rate=0 wire bytes identical to pre-trace).
                        msg["trace"] = ctx
                    conn.send(msg)
                except OSError:
                    # Replica vanished mid-send (SIGKILL class): the
                    # failover policy settles the books (complete +
                    # breaker failure) and decides requeue vs give-up.
                    state["outstanding"] -= 1
                    requeue, gave_up = failover.replica_failed(
                        rid, [cid])
                    if requeue:
                        retry_count[cid] = retry_count.get(cid, 0) + 1
                        state["retries"] += 1
                        retry_q.append(cid)
                    else:
                        give_up(cid)
                    break
            completed = len(results)
            if completed > completed_prev:
                last_progress = time.monotonic()
                completed_prev = completed
            if not sent_any:
                cond.wait(timeout=0.02)
        if time.monotonic() - last_progress > stall_timeout_s:
            raise TimeoutError(
                f"fleet made no progress for {stall_timeout_s:.0f}s "
                f"({len(results)}/{len(schedule)} done)")
    wall = time.monotonic() - t0
    ok = [r for r in results.values() if not r.get("error")]
    lat_ms = sorted(r["latency_s_e2e"] * 1e3 for r in ok)

    def pct(q, vals=lat_ms):
        # Nearest-rank, the repo's one pinned quantile definition
        # (utils/tracing.py § nearest_rank).
        if not vals:
            return None
        return round(nearest_rank(vals, q), 3)

    # Per-cache-tier latency split: WHERE a request's latency came from
    # is tier-shaped (an L1 hit skips adapt entirely, a miss pays it).
    tier_lat: Dict[str, List[float]] = {"l1": [], "l2": [], "miss": []}
    for r in ok:
        tier_lat[r.get("cache_tier") or "miss"].append(
            r["latency_s_e2e"] * 1e3)
    tier_latency_ms = {
        tier: ({"count": len(vals), "p50_ms": pct(0.50, sorted(vals)),
                "p95_ms": pct(0.95, sorted(vals)),
                "p99_ms": pct(0.99, sorted(vals))} if vals else None)
        for tier, vals in tier_lat.items()}

    tiers = [r.get("cache_tier") for r in ok]
    shed = sum(1 for r in results.values()
               if r.get("status") == "shed"
               or str(r.get("error") or "").startswith("shed"))
    status_counts: Dict[str, int] = {}
    for r in results.values():
        st = r.get("status") or ("ok" if not r.get("error") else "failed")
        status_counts[st] = status_counts.get(st, 0) + 1
    return {
        "status_counts": status_counts,
        "wall_seconds": round(wall, 3),
        "max_outstanding": int(max_outstanding),
        "qps": round(len(ok) / wall, 3) if wall > 0 else None,
        "responses_ok": len(ok),
        "dropped": len(schedule) - len(ok) - shed,
        "shed": shed,
        "failover_gave_up": state["gave_up"],
        "rejected_retries": state["retries"],
        "p50_ms": pct(0.50), "p95_ms": pct(0.95), "p99_ms": pct(0.99),
        "tier_latency_ms": tier_latency_ms,
        "l1_hit_frac": (round(tiers.count("l1") / len(ok), 4)
                        if ok else None),
        "l2_hit_frac": (round(tiers.count("l2") / len(ok), 4)
                        if ok else None),
        "adapt_frac": (round(tiers.count(None) / len(ok), 4)
                       if ok else None),
        "per_replica_responses": {
            str(rid): sum(1 for r in ok if r.get("rid") == rid)
            for rid in sorted(conns)},
    }


# ---------------------------------------------------------------------------
# the migration leg
# ---------------------------------------------------------------------------

def migration_check(router, controller, conns: Dict[int, ReplicaConn],
                    pool, seed: int, image_shape, num_classes: int) -> dict:
    """Prove the L2 tier across a drain: serve one tenant on its ring
    primary A, drain A (lease tombstone), serve the SAME tenant again —
    it must land on a different replica AND come back from the l2 tier
    with zero new adapt dispatches on the target."""
    import numpy as np
    rng = np.random.RandomState(seed + 999)
    router.refresh()
    sx, sy, q_rows = pool[0]
    key = fleet_router.routing_key(sx, sy)
    primary = router.ring.primary(key)
    if primary is None or primary not in conns:
        return {"ok": False, "reason": "no primary for tenant"}

    done = threading.Event()
    box: Dict[str, Any] = {}

    def on_response(rid, msg):
        router.complete(rid)
        box["resp"] = msg
        box["rid"] = rid
        done.set()

    def ask(rid: int, cid: int) -> dict:
        _, _, qx = synthetic_arrays(image_shape, num_classes, True, rng,
                                    (1, q_rows))
        box["qx"] = qx
        for conn in conns.values():
            conn._on_response = on_response
        done.clear()
        conns[rid].send({"op": "serve", "id": cid, "support_x": sx,
                         "support_y": sy, "query_x": qx})
        if not done.wait(120):
            raise TimeoutError("migration request timed out")
        return dict(box["resp"], rid=box["rid"], query_x=box["qx"])

    # Warm the tenant on its primary (adapts or hits there; publishes
    # the adaptation to L2 either way — a fresh adapt publishes, a hit
    # means an earlier adapt already did).
    first = ask(primary, 10_000_000)
    controller.drain(primary, reason="migration_check")
    router.refresh()
    target = router.ring.primary(key)
    if target is None or target == primary:
        controller.undrain(primary)
        return {"ok": False, "reason": f"drain did not move the tenant "
                                       f"(target={target})"}
    before = conns[target].stats()["stats"]["adapt_invocations"]
    second = ask(target, 10_000_001)
    after = conns[target].stats()["stats"]["adapt_invocations"]
    controller.undrain(primary)
    router.refresh()
    return {
        "ok": bool(second.get("cache_tier") == "l2"
                   and after == before and not second.get("error")),
        "tenant_key": key[:16],
        "from_replica": primary, "to_replica": target,
        "first_tier": first.get("cache_tier"),
        "second_tier": second.get("cache_tier"),
        "target_adapt_delta": int(after - before),
        # The request and its answer, for a caller that recomputes it
        # (chip_smoke.py holds the logits against the plain version).
        "probe": {"support_x": sx, "support_y": sy,
                  "query_x": second["query_x"],
                  "logits": second.get("logits"),
                  "version": second.get("version")},
    }


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def _kernel_accounting(per_replica: Dict[str, Any], cfg_doc: dict,
                       device: str) -> Dict[str, Any]:
    """Each replica's BN-kernel launches beside the count its own adapt
    and predict batches need: a VGG forward on ``bn_backend='pallas'``
    launches the kernel once per stage on the card (none on the CPU,
    where the wrapper runs its plain version), an adapt batch runs one
    forward per inner step, a predict batch one."""
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    cfg = MAMLConfig.from_dict(cfg_doc)
    per_forward = (cfg.num_stages if device == "cuda"
                   and cfg.backbone == "vgg"
                   and cfg.norm_layer == "batch_norm" else 0)
    per_adapt = per_forward * cfg.effective_serve_adapt_steps
    out: Dict[str, Any] = {"per_adapt_batch": per_adapt,
                           "per_predict_batch": per_forward,
                           "replicas": {}, "total": 0, "ok": True}
    for rid, snap in per_replica.items():
        k = (snap or {}).get("kernels") or {}
        if "bn_act_launches" not in k:
            out["ok"] = False
            out["replicas"][rid] = {"error": "no stats"}
            continue
        want = per_adapt * k["adapt_runs"] + per_forward * k["predict_runs"]
        out["replicas"][rid] = dict(k, expected=want)
        out["total"] += k["bn_act_launches"]
        out["ok"] = out["ok"] and k["bn_act_launches"] == want
    return out


def run_leg(out, cfg_path, ckpt_dir, fleet_dir, ids, schedule, registry,
            *, image_shape, num_classes, device,
            swap_spec=None, pool=None, migration=False,
            startup_timeout_s=420.0):
    """Boot a replica set, drive the schedule, optionally swap/migrate,
    tear down. Returns (leg stats, per-replica stats, extras). The
    router's ring and lease thresholds come from the same config JSON
    the replicas run."""
    with open(cfg_path) as f:
        cfg_doc = json.load(f)
    interval = float(cfg_doc.get("fleet_lease_interval_s") or 0.5)
    stalled = float(cfg_doc.get("fleet_replica_stalled_s") or 0.0) \
        or 3.0 * interval
    dead = max(float(cfg_doc.get("fleet_replica_dead_s") or 0.0)
               or 6.0 * interval, stalled)
    os.makedirs(fleet_dir, exist_ok=True)
    rate = float(cfg_doc.get("reqtrace_sample_rate") or 0.0)
    rt = fleet_router.reqtrace_mod() if rate > 0 else None
    ring = prev_ring = None
    if rt is not None:
        ring = rt.SpanRing(capacity=16384, registry=registry)
        prev_ring = rt.install(ring)
    procs = start_replicas(out, cfg_path, ckpt_dir, fleet_dir, ids, device)
    extras: Dict[str, Any] = {}
    conns: Dict[int, ReplicaConn] = {}
    try:
        t_boot = time.monotonic()
        ports = wait_for_replicas(fleet_dir, ids, procs,
                                  startup_timeout_s)
        extras["startup_seconds"] = round(time.monotonic() - t_boot, 3)
        for rid, port in ports.items():
            conns[rid] = ReplicaConn(rid, port, lambda *_: None)
        router = fleet_router.FleetRouter(
            fleet_dir, vnodes=int(cfg_doc.get("fleet_vnodes") or 64),
            load_factor=float(cfg_doc.get("fleet_load_factor") or 1.25),
            stalled_after_s=stalled, dead_after_s=dead,
            registry=registry)
        controller = fleet_controller.FleetController(
            fleet_dir, router.refresh, registry=registry,
            slo_p95_ms=float(cfg_doc.get("fleet_slo_p95_ms") or 2000.0),
            slo_target_frac=float(cfg_doc.get("fleet_slo_target_frac")
                                  or 0.95))
        router.refresh()

        swap_trigger = None
        child_box: Dict[str, Any] = {}
        if swap_spec is not None:
            def fire():
                # Publish v2 off the frontend's loop (a child process takes
                # seconds to start); the rollout starts when the publish
                # lands, while load keeps flowing.
                def _worker():
                    try:
                        _run_child("publish-v2", cfg_path, ckpt_dir, out)
                        with open(os.path.join(out,
                                               "publish-v2.log")) as f:
                            last = [ln for ln in f.read().splitlines()
                                    if ln.strip()][-1]
                        version = int(json.loads(last)["version"])
                        child_box["t_published"] = time.monotonic()
                        controller.start_rollout(version)
                        child_box["version"] = version
                    except Exception as e:  # noqa: BLE001 — reported
                        child_box["error"] = f"{type(e).__name__}: {e}"
                t = threading.Thread(target=_worker, daemon=True)
                child_box["thread"] = t
                t.start()
            swap_trigger = {"at_completed": swap_spec["at_completed"],
                            "fire": fire}
        stats = drive_leg(router, conns, schedule,
                          max_outstanding=swap_spec["max_outstanding"]
                          if swap_spec else 4 * len(ids),
                          controller=controller,
                          swap_trigger=swap_trigger,
                          reqtrace=rt, sample_rate=rate,
                          slo=controller.slo)
        if swap_spec is not None:
            # The publish may still be landing when the load drains:
            # wait for it, then tick the rollout to its end.
            worker = child_box.get("thread")
            if worker is not None:
                worker.join(timeout=180)
            deadline = time.monotonic() + 180
            doc = controller.read_rollout()
            while doc["state"] == fleet_controller.ROLLING \
                    and time.monotonic() < deadline:
                router.refresh()
                doc = controller.tick()
                time.sleep(0.1)
            extras["rollout"] = {k: doc.get(k) for k in
                                 ("state", "version", "index", "rejected",
                                  "halt_reason", "halt_detail",
                                  "halt_replica")}
            if "t_published" in child_box:
                extras["rollout"]["seconds_publish_to_end"] = round(
                    time.monotonic() - child_box["t_published"], 3) \
                    if doc["state"] != fleet_controller.ROLLING else None
            extras["swap_version"] = child_box.get("version")
            extras["swap_error"] = child_box.get("error")
        if migration and pool is not None:
            extras["migration"] = migration_check(
                router, controller, conns, pool, seed=0,
                image_shape=image_shape, num_classes=num_classes)
        controller.publish_signals()
        per_replica = {}
        for rid, conn in conns.items():
            try:
                per_replica[str(rid)] = conn.stats()
            except Exception as e:  # noqa: BLE001
                per_replica[str(rid)] = {"error": str(e)}
        extras["kernels"] = _kernel_accounting(per_replica, cfg_doc, device)
        extras["advice"] = fleet_controller.advise(
            controller.publish_signals(), live=len(router.routable))
        extras["slo"] = controller.slo.snapshot()
        extras["slo_burn_rate"] = controller.slo.burn_rate()
        return stats, per_replica, extras
    finally:
        stop_replicas(conns, procs)
        if rt is not None:
            ring.flush(JsonlLogger(os.path.join(out, "events_frontend.jsonl")),
                       phase="fleet_frontend", replica="frontend")
            rt.install(prev_ring)


def _trace_summary(out: str) -> Dict[str, Any]:
    """Linked-trace verdict over every events file of the run: each
    sampled request's spans across frontend and replicas, and the latency
    tier sums."""
    rt = fleet_router.reqtrace_mod()
    rows = []
    for name in sorted(os.listdir(out)):
        if name.endswith(".jsonl"):
            rows += [r for r in read_jsonl(os.path.join(out, name))
                     if r.get("event") == rt.REQUEST_TRACE_EVENT]
    traces = rt.assemble(rows)
    n_linked = sum(1 for t in traces.values() if rt.linked(t))
    tier_seconds = {tier: 0.0 for tier in rt.TIERS}
    for t in traces.values():
        if rt.linked(t):
            attr = rt.attribute(t)
            for tier in rt.TIERS:
                tier_seconds[tier] += attr[tier]
    return {
        "count": len(traces), "linked": n_linked,
        "linked_frac": (round(n_linked / len(traces), 4)
                        if traces else 0.0),
        "dominant_tier": (max(rt.TIERS, key=lambda k: tier_seconds[k])
                          if n_linked else None),
        "tier_seconds": {k: round(v, 4) for k, v in tier_seconds.items()},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="multi-replica serving fleet benchmark (PyTorch port)")
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--tenants", type=int, default=24)
    ap.add_argument("--l1-capacity", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the replicas serve (the card by default)")
    ap.add_argument("--config", default=None,
                    help="experiment JSON whose model and episode shapes "
                         "the replicas serve (e.g. the flagship's)")
    ap.add_argument("--quick", action="store_true",
                    help="2-replica smoke: no single leg, no hot-swap, "
                         "small load")
    ap.add_argument("--trace-sample-rate", type=float, default=0.0,
                    help="head-based request-trace sampling rate in "
                         "[0, 1]; 0 (default) = tracing off")
    ap.add_argument("--skip-single", action="store_true")
    ap.add_argument("--no-swap", action="store_true")
    # child plumbing (internal)
    ap.add_argument("--mode", default="bench",
                    choices=["bench", "prepare", "publish-v2"])
    ap.add_argument("--config-path", default=None)
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)

    if args.mode == "prepare":
        return _mode_prepare(args.config_path, args.ckpt_dir)
    if args.mode == "publish-v2":
        return _mode_publish_v2(args.config_path, args.ckpt_dir)

    if args.quick:
        args.replicas = min(args.replicas, 2)
        args.requests = min(args.requests, 36)
        args.tenants = min(args.tenants, 8)
        args.skip_single = True
        args.no_swap = True

    artifact: Dict[str, Any] = {
        "metric": "fleet_bench", "backend": "torch", "value": None,
        "unit": "requests/s", "status": "failed",
        "replicas": args.replicas, "requests": args.requests,
        "tenants": args.tenants, "l1_capacity": args.l1_capacity,
        "quick": bool(args.quick), "device": args.device,
        "config": args.config,
        "trace_sample_rate": float(args.trace_sample_rate),
    }
    if not _can_bind_localhost():
        artifact.update({"status": "skipped",
                         "skip_reason": "cannot bind localhost sockets"})
        print(json.dumps(artifact), flush=True)
        return 0

    out = args.out or tempfile.mkdtemp(prefix="torch_fleet_bench_")
    made_tmp = args.out is None
    os.makedirs(out, exist_ok=True)
    ckpt_dir = os.path.join(out, "saved_models")
    l2_dir = os.path.join(out, "l2")
    cfg_fleet = os.path.join(out, "cfg_fleet.json")
    cfg_single = os.path.join(out, "cfg_single.json")
    base = None
    if args.config:
        with open(args.config) as f:
            base = json.load(f)
    common = dict(quick=args.quick, l1_capacity=args.l1_capacity,
                  base=base)
    cfg_doc = fleet_cfg_dict(out, l2_dir=l2_dir,
                             trace_sample_rate=args.trace_sample_rate,
                             **common)
    with open(cfg_fleet, "w") as f:
        json.dump(cfg_doc, f)
    # The single leg is the baseline: untraced, no L2.
    with open(cfg_single, "w") as f:
        json.dump(fleet_cfg_dict(out, l2_dir="", **common), f)

    registry = MetricsRegistry()
    try:
        t_prep = time.monotonic()
        _run_child("prepare", cfg_fleet, ckpt_dir, out)
        artifact["prepare_seconds"] = round(time.monotonic() - t_prep, 1)
        from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
        mcfg = MAMLConfig.from_dict(cfg_doc)
        image_shape = mcfg.image_shape
        num_classes = mcfg.num_classes_per_set
        bucket = tuple(mcfg.serve_bucket_shapes[0])
        pool, schedule = build_schedule(args.requests, args.tenants,
                                        args.seed, image_shape, bucket,
                                        num_classes)

        single = single_extras = None
        if not args.skip_single:
            single, _, single_extras = run_leg(
                out, cfg_single, ckpt_dir,
                os.path.join(out, "fleet_single"), [0], schedule,
                MetricsRegistry(), image_shape=image_shape,
                num_classes=num_classes, device=args.device)

        ids = list(range(args.replicas))
        swap_spec = None
        if not args.no_swap:
            # Fire early: the publish child needs seconds to start, and
            # the rolling swap must run under load.
            swap_spec = {"at_completed": max(args.requests // 6, 1),
                         "max_outstanding": 4 * len(ids)}
        fleet, per_replica, extras = run_leg(
            out, cfg_fleet, ckpt_dir, os.path.join(out, "fleet"),
            ids, schedule, registry, image_shape=image_shape,
            num_classes=num_classes, device=args.device,
            swap_spec=swap_spec, pool=pool, migration=True)

        reg_snap = registry.snapshot()
        speedup = (round(fleet["qps"] / single["qps"], 2)
                   if single and single.get("qps") else None)
        migration = dict(extras.get("migration") or {})
        probe = migration.pop("probe", None)
        if probe is not None and not made_tmp:
            import numpy as np
            np.savez(os.path.join(out, "fleet_probe.npz"),
                     **{k: np.asarray(v if v is not None else -1)
                        for k, v in probe.items()})
        rollout = extras.get("rollout") or {}
        zero_dropped = (fleet["dropped"] == 0
                        and (single is None or single["dropped"] == 0))
        trace_summary = (_trace_summary(out)
                         if args.trace_sample_rate > 0 else None)
        trace_ok = (trace_summary is None
                    or (trace_summary["count"] > 0
                        and trace_summary["linked_frac"] >= 0.95))
        kernels = extras["kernels"]
        single_kernels = (single_extras or {}).get("kernels")
        kernels_ok = kernels["ok"] and (single_kernels is None
                                        or single_kernels["ok"])
        ok = bool(fleet["responses_ok"] == args.requests
                  and zero_dropped
                  and migration.get("ok", args.quick)
                  and (args.no_swap or rollout.get("state") == "done")
                  and trace_ok and kernels_ok)
        artifact.update({
            "status": "ok" if ok else "failed",
            "value": fleet["qps"],
            "single": single, "fleet": fleet,
            "single_qps": single["qps"] if single else None,
            "fleet_qps": fleet["qps"],
            "fleet_speedup_vs_single": speedup,
            "fleet_l2_hit_frac": fleet["l2_hit_frac"],
            "fleet_rolling_swaps": int(
                reg_snap.get(fleet_controller.SWAPS_COUNTER, 0)),
            "fleet_rolling_swap_halts": int(
                reg_snap.get(fleet_controller.HALTS_COUNTER, 0)),
            "fleet_router_spills": int(
                reg_snap.get(fleet_router.SPILLS_COUNTER, 0)),
            "fleet_failover_count": int(
                reg_snap.get(fleet_router.FAILOVERS_COUNTER, 0)),
            "fleet_shed_count": None,
            "fleet_restarts": None,
            "fleet_trace_count": (trace_summary["count"]
                                  if trace_summary else None),
            "fleet_trace_linked_frac": (trace_summary["linked_frac"]
                                        if trace_summary else None),
            "fleet_trace_dominant_tier": (trace_summary["dominant_tier"]
                                          if trace_summary else None),
            "fleet_trace_tier_seconds": (trace_summary["tier_seconds"]
                                         if trace_summary else None),
            "fleet_slo_burn_rate": extras.get("slo_burn_rate"),
            "fleet_slo_tenants": extras.get("slo"),
            "traffic_p95_ms": None,
            "traffic_slo_held": None,
            "traffic_canary_weight_final": None,
            "traffic_cb_groups": None,
            "alerts_fired": None,
            "alerts_resolved": None,
            "alerts_active_final": None,
            "rollout": rollout or None,
            "swap_version": extras.get("swap_version"),
            "swap_error": extras.get("swap_error"),
            "migration": migration or None,
            "zero_dropped": zero_dropped,
            "startup_seconds": {
                "single": (single_extras or {}).get("startup_seconds"),
                "fleet": extras.get("startup_seconds")},
            "bn_act_launches": {"fleet": kernels, "single": single_kernels,
                                "total": kernels["total"] + (
                                    single_kernels["total"]
                                    if single_kernels else 0)},
            "per_replica": per_replica,
            "autoscale_advice": extras.get("advice"),
            "fleet_metrics": reg_snap,
            "out_dir": None if made_tmp else out,
        })
        print(json.dumps(artifact), flush=True)
        if made_tmp:
            shutil.rmtree(out, ignore_errors=True)
        return 0 if ok else 1
    except Exception as e:  # noqa: BLE001 — the artifact is the report
        artifact.update({"status": "failed",
                         "error": f"{type(e).__name__}: {e}",
                         "out_dir": out})
        print(json.dumps(artifact), flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
