"""Fleet replica worker: one ServingEngine behind a localhost socket
(the port's counterpart of the JAX package's ``serve/fleet/replica.py``).

The process the router routes TO. Each replica owns a full
``ServingEngine`` (checkpoint-loaded, so hot-swap is armed), announces
itself through a membership lease (``router.py § ReplicaLease`` — the
payload carries the bound port and live serving stats), serves
length-prefixed requests from any number of frontend connections, and
cooperates with the fleet controller's rolling swaps by watching its
drain tombstone:

* tombstone present -> stop being routable (the ROUTER enforces that;
  this process just observes), finish the queued work, and — when the
  rollout record targets a newer version — run the engine's own
  canary + hot-swap exactly once per target, reporting the outcome in
  the lease payload (``version`` on success, ``swap_failed`` on a
  canary rejection). The controller reads the payload and advances or
  halts the rollout.
* every loop, fleet-wide rejected versions from ``ROLLOUT.json`` are
  pinned into the engine, so a version canary-failed on ANY replica is
  never retried here.

Request wire protocol (``router.py § send_msg/recv_msg``):

    {"op": "serve", "id": caller_id, "support_x", "support_y",
     "query_x"}                      -> one response frame per request
    {"op": "stats"}                  -> one stats snapshot frame
    {"op": "stop"}                   -> ack frame, then process exit

Responses: ``{"op": "response", "id", "predictions", "logits",
"version", "cache_hit", "cache_tier", "latency_s", "error",
"replica"}``. A full queue answers
``error="rejected"`` immediately (the router-side load shed); the
connection's submit thread never blocks on the engine.

Threading: one acceptor + one reader thread per connection feed
``engine.submit`` (thread-safe by the batcher's contract); the main
loop alone calls ``engine.step`` / hot-swap / lease touches — the
single-dispatcher discipline the engine already assumes.

The engine runs on the card unless ``--device cpu`` is given; without a
card and without it, the replica raises (no fallback). Each replica is
its own process with its own CUDA context: several share one card.
The stats frame also reports the BN kernel's launches in this process
and the adapt and predict batches behind them (warm-ups and canaries
included), and the device's peak memory.

Started by ``scripts/torch_fleet_bench.py`` (and, through the port's
supervisor, by ``scripts/torch_chaos_fleet.py`` and
``scripts/torch_traffic_replay.py``) as::

    python -m howtotrainyourmamlpytorch_tpu_torch.serve.fleet.replica \
        --config cfg.json --replica-id 0 --fleet-dir <dir> \
        --checkpoint <saved_models> [--port 0] [--events PATH] \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import threading
import time
import weakref
from typing import Any, Dict, Optional, Tuple

import numpy as np

from howtotrainyourmamlpytorch_tpu_torch.serve.fleet import (
    router as fleet_router)
from howtotrainyourmamlpytorch_tpu_torch.serve.fleet.controller import (
    ROLLING, ROLLOUT_FILE)


def _kernel_stats(engine) -> Dict[str, Any]:
    """The BN kernel's launches in this process, the adapt and predict
    batches the engine ran (every one: warm-ups and canaries included),
    and the device's peak memory."""
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    dev = engine.device
    return {"bn_act_launches": bn_act.launches,
            "adapt_runs": engine.adapt_runs,
            "predict_runs": engine.predict_runs,
            "device": str(dev),
            "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else None)}


def _read_rollout(fleet_dir: str) -> Dict[str, Any]:
    try:
        with open(os.path.join(fleet_dir, ROLLOUT_FILE)) as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else {}
    except (OSError, ValueError):
        return {}


def avoid_fleet_rejected(engine, fleet_dir: str) -> Optional[int]:
    """Startup guard: never SERVE a fleet-rejected version.

    A restarted replica loads the LATEST checkpoint — which, after a
    halted rollout, may be exactly the version the fleet pinned
    rejected (the canary never ran for this process, and the registry
    still lists it live). Pin every rejected version into the engine,
    and if the version it booted on is among them, roll back to the
    newest non-rejected live registry version WITHOUT a canary (it was
    the previously-serving known-good). Returns the version rolled
    back to, or None when nothing had to change. Fail-soft throughout:
    serving the newest bytes beats not serving at all, so a rollback
    that cannot load keeps the boot state.
    """
    rollout = _read_rollout(fleet_dir)
    rejected = {int(v) for v in rollout.get("rejected") or []}
    for v in rejected:
        engine.pin_rejected(v)
    if not rejected or int(engine._model_version or 0) not in rejected:
        return None
    try:
        from howtotrainyourmamlpytorch_tpu_torch.ckpt.registry import (
            ModelRegistry)
        live = [r for r in ModelRegistry(engine._registry_dir).versions
                if r.get("status") == "live"
                and int(r.get("version") or 0) not in rejected]
        if not live:
            return None
        rec = max(live, key=lambda r: int(r.get("version") or 0))
        engine.adopt_version(rec, engine.load_registry_version(rec))
        return int(rec["version"])
    except Exception:  # noqa: BLE001 — keep serving the boot state
        return None


class ReplicaServer:
    """Socket front + engine loop for one replica."""

    def __init__(self, engine, replica_id: int, fleet_dir: str,
                 lease_interval_s: float, port: int = 0):
        self.engine = engine
        self.replica_id = int(replica_id)
        self.fleet_dir = fleet_dir
        self.lease = fleet_router.ReplicaLease(
            fleet_dir, replica_id, lease_interval_s)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", int(port)))
        self.sock.listen(16)
        self.port = self.sock.getsockname()[1]
        self.running = True
        # req_id -> (conn, caller_id, trace ctx or None)
        self._pending: Dict[int, Tuple[Any, Any, Any]] = {}
        self._pending_lock = threading.Lock()
        # Per-connection send locks, weakly keyed on the socket itself:
        # entries die with their connection (no manual cleanup, no
        # id()-reuse aliasing between a dead conn and a new one).
        self._send_locks: "weakref.WeakKeyDictionary[Any, threading.Lock]" \
            = weakref.WeakKeyDictionary()
        self._swap_attempted: set = set()
        self._swap_backoff_until = 0.0
        self._swap_failed: Optional[int] = None
        self._swap_reason: Optional[str] = None
        self._pinned: set = set()
        self._last_payload: Dict[str, Any] = {"port": self.port}

    # -- socket side ------------------------------------------------------
    def _send(self, conn, obj: Dict[str, Any]) -> None:
        lock = self._send_locks.setdefault(conn, threading.Lock())
        try:
            with lock:
                fleet_router.send_msg(conn, obj)
        except OSError:
            pass  # a vanished frontend loses its own responses only

    def _reader(self, conn) -> None:
        try:
            while self.running:
                msg = fleet_router.recv_msg(conn)
                op = msg.get("op")
                if op == "serve":
                    self._submit(conn, msg)
                elif op == "stats":
                    self._send(conn, {"op": "stats",
                                      **self._stats_snapshot()})
                elif op == "stop":
                    self._send(conn, {"op": "stopped"})
                    self.running = False
                    return
        except (ConnectionError, OSError, EOFError):
            return

    def _submit(self, conn, msg: Dict[str, Any]) -> None:
        from howtotrainyourmamlpytorch_tpu_torch.serve import (
            FewShotRequest, ShedError)
        caller_id = msg.get("id")
        trace = msg.get("trace")
        try:
            req = FewShotRequest(
                support_x=msg["support_x"], support_y=msg["support_y"],
                query_x=msg["query_x"], deadline=msg.get("deadline"),
                trace=trace, tenant=msg.get("tenant"))
            with self._pending_lock:
                self._pending[req.request_id] = (conn, caller_id, trace)
            try:
                if trace is not None and trace.get("recv_t") is not None:
                    # Socket-queue span: frame received (recv_msg's
                    # stamp, this process's clock) -> engine admission.
                    rt = fleet_router.reqtrace_mod()
                    t_sub = time.monotonic()
                    rt.record_span(trace, rt.SPAN_SOCKET_QUEUE,
                                   trace["recv_t"],
                                   t_sub - trace["recv_t"],
                                   replica=self.replica_id)
                self.engine.submit(req)
            except Exception as e:
                with self._pending_lock:
                    self._pending.pop(req.request_id, None)
                raise e
        except Exception as e:  # noqa: BLE001 — a bad/overflow request
            # answers THAT caller; the serve loop never sees it. A shed
            # gets its DISTINCT status (the overload contract: refused
            # at the door, not retryable like "rejected" — the frontend's
            # retry loop keys on the error prefix).
            shed = isinstance(e, ShedError)
            resp = {
                "op": "response", "id": caller_id, "predictions": None,
                "cache_hit": False, "cache_tier": None, "latency_s": 0.0,
                "error": (f"shed: {e}" if shed
                          else f"rejected: {type(e).__name__}"),
                "status": ("shed" if shed else "rejected"),
                "replica": self.replica_id}
            if trace is not None:
                resp["trace"] = trace
            self._send(conn, resp)

    def _acceptor(self) -> None:
        while self.running:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._reader, args=(conn,),
                             daemon=True).start()

    # -- stats / lease ----------------------------------------------------
    def _stats_snapshot(self) -> Dict[str, Any]:
        eng = self.engine
        reg = eng.registry
        lat = reg.histogram("serve/latency_seconds")
        p95 = lat.quantile(0.95) if lat.count else None
        hits, misses = eng.cache.hits, eng.cache.misses
        l2 = getattr(eng, "l2", None)
        return {
            "version": eng._model_version,
            "stats": {
                "queue_depth": eng.batcher.depth,
                "responses": reg.counter("serve/responses_total").value,
                "adapt_invocations": eng.adapt_invocations,
                "cache_hit_frac": (hits / (hits + misses)
                                   if hits + misses else None),
                "p95_ms": (p95 * 1e3 if p95 is not None else None),
                "l2_hits": (l2.hits if l2 is not None else 0),
                "l2_misses": (l2.misses if l2 is not None else 0),
                "l2_errors": (l2.errors if l2 is not None else 0),
                # Guarded read: shedding off must stay structurally
                # zero-cost — reading via reg.counter() would CREATE
                # the counter and change the registry snapshot.
                "sheds": (reg.counter("serve/shed_total").value
                          if getattr(eng.batcher, "admission", None)
                          is not None else 0),
                # Same guarded-read rule for continuous batching: the
                # assembler's dispatch tallies are plain ints, and an
                # uninstalled assembler reports 0 without creating
                # anything.
                "cb_groups": (eng.batcher.assembler.groups_dispatched
                              if getattr(eng.batcher, "assembler", None)
                              is not None else 0),
            },
            # Ops-plane visibility: the peer's own firing alerts
            # (count + max severity) ride the lease so the supervisor
            # and console see a replica's alert state even after the
            # process dies. Null when alerting is off — honest, and
            # schema-stable for every lease reader.
            "alerts_firing": eng.alerts_firing_summary(),
            "kernels": _kernel_stats(eng),
        }

    def _touch_lease(self, force: bool = False) -> None:
        if not force and not self.lease.due:
            # The stats snapshot (histogram quantile + counter reads)
            # is not free; don't build a payload the lease's rate
            # limit would discard — this runs every serve-loop tick.
            return
        payload = self._stats_snapshot()
        payload["port"] = self.port
        if self._swap_failed is not None:
            payload["swap_failed"] = self._swap_failed
            payload["swap_reason"] = self._swap_reason
        self._last_payload = payload
        self.lease.touch(payload, force=force)

    def _heartbeat(self) -> None:
        """Side-thread lease touches — the resilience/cluster.py rule
        (its watchdog poll thread touches the host lease): the lease
        must prove the PROCESS is alive even while the main loop is
        legitimately blocked for seconds in a hot-swap load + canary,
        or the controller reads the swap it ordered as a death and
        halts the rollout. Re-touches the last payload; only the main
        loop produces fresh stats."""
        while self.running:
            self.lease.touch(self._last_payload)
            time.sleep(self.lease.interval_s / 2.0)

    # -- drain / rolling swap ---------------------------------------------
    def _maybe_swap(self) -> None:
        """Under a drain tombstone with an armed rollout: drain the
        queue, then canary+swap toward the rollout's target version —
        once per target; the outcome rides the lease payload."""
        rollout = _read_rollout(self.fleet_dir)
        for v in rollout.get("rejected") or []:
            if v not in self._pinned:
                self.engine.pin_rejected(int(v))
                self._pinned.add(v)
        if rollout.get("state") != ROLLING:
            return
        target = int(rollout.get("version") or 0)
        if (not target or target in self._swap_attempted
                or int(self.engine._model_version or 0) >= target):
            return
        if self.engine.batcher.depth:
            return  # drain first: swap only between steps, queue empty
        if time.monotonic() < self._swap_backoff_until:
            return
        # Before the old version's cache keys die, make sure this
        # replica's queued L2 publishes landed — its drained tenants
        # re-home to other replicas and must find their adaptations.
        self.engine.l2_flush(timeout_s=10.0)
        result = self.engine.maybe_hot_swap(force=True)
        # Only a DECIDED attempt ON THE TARGET is final: a canary
        # verdict, a permanent (pinned) load failure, or a swap — for
        # the rollout's version. None (torn registry read, version not
        # yet visible) and transient load errors retry after a short
        # backoff — marking them attempted would wedge the rollout
        # forever with the controller waiting on an ack that can never
        # come. And the engine always tries the registry's NEWEST live
        # version: if something newer than the target was published
        # mid-rollout, ITS verdict must not be attributed to the
        # target (a v3 canary fail pinning v2 fleet-wide would ban a
        # version whose canary never ran); a newer-version SWAP still
        # acks (the main loop reports model_version >= target).
        tried = int((result or {}).get("version") or 0)
        decided = (result is not None and tried == target
                   and (result.get("swapped") or "canary" in result
                        or target in self.engine._rejected_versions))
        if not decided:
            self._swap_backoff_until = time.monotonic() + 1.0
            return
        self._swap_attempted.add(target)
        if not result.get("swapped") \
                and int(self.engine._model_version or 0) < target:
            self._swap_failed = target
            # Surface WHY through the lease (the controller's halt and
            # the bench artifact would otherwise say only "failed").
            canary = result.get("canary") or {}
            self._swap_reason = (canary.get("reason")
                                 or result.get("reason"))
        self._touch_lease(force=True)

    # -- main loop --------------------------------------------------------
    def serve_forever(self) -> None:
        threading.Thread(target=self._acceptor, daemon=True).start()
        self._touch_lease(force=True)
        threading.Thread(target=self._heartbeat, daemon=True).start()
        while self.running:
            responses = self.engine.step()
            for resp in responses:
                with self._pending_lock:
                    dest = self._pending.pop(resp.request_id, None)
                if dest is None:
                    continue
                conn, caller_id, trace = dest
                out = {
                    "op": "response", "id": caller_id,
                    "predictions": (None if resp.predictions is None
                                    else np.asarray(resp.predictions)),
                    "logits": (None if resp.logits is None
                               else np.asarray(resp.logits)),
                    "version": self.engine._model_version,
                    "cache_hit": resp.cache_hit,
                    "cache_tier": resp.cache_tier,
                    "latency_s": resp.latency_seconds,
                    "error": resp.error,
                    "status": getattr(resp, "status", "ok"),
                    "replica": self.replica_id}
                if trace is not None:
                    # The context rides the response too: the send
                    # itself records wire_send here, the frontend's
                    # recv_msg records wire_recv on its side.
                    out["trace"] = trace
                    t_resp = time.monotonic()
                    self._send(conn, out)
                    rt = fleet_router.reqtrace_mod()
                    rt.record_span(trace, rt.SPAN_RESPOND, t_resp,
                                   time.monotonic() - t_resp,
                                   replica=self.replica_id,
                                   tier=resp.cache_tier or "miss")
                else:
                    self._send(conn, out)
            draining = os.path.exists(
                fleet_router.drain_path(self.fleet_dir, self.replica_id))
            if draining:
                self._maybe_swap()
            self._touch_lease()
            if not responses and (
                    not self.engine.batcher.depth
                    or getattr(self.engine.batcher, "assembler", None)
                    is not None):
                # Idle — or continuous batching is holding partial groups
                # open (depth > 0 yet nothing dispatchable until a linger
                # deadline ~ tens of ms away): yield the (possibly 1-core)
                # box instead of spinning the serve loop through the
                # whole linger window.
                time.sleep(0.002)

    def close(self) -> None:
        self.running = False
        try:
            self.sock.close()
        except OSError:
            pass
        try:
            os.remove(self.lease.path)  # clean exit leaves no ghost member
        except OSError:
            pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="fleet replica worker")
    ap.add_argument("--config", required=True)
    ap.add_argument("--replica-id", type=int, required=True)
    ap.add_argument("--fleet-dir", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--events", default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' to serve on the CPU; the card by default")
    args = ap.parse_args(argv)

    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    from howtotrainyourmamlpytorch_tpu_torch.serve import ServingEngine
    from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import (
        JsonlLogger)

    cfg = MAMLConfig.from_json_file(args.config)
    engine = ServingEngine.from_checkpoint(cfg, args.checkpoint,
                                           device=args.device)
    engine.warmup()
    # Adopt the currently published version number (the bytes already
    # loaded) so rollout acks compare against a real version, then make
    # sure that version is not one the fleet canary-rejected.
    engine.maybe_hot_swap(force=True)
    avoid_fleet_rejected(engine, args.fleet_dir)
    server = ReplicaServer(engine, args.replica_id, args.fleet_dir,
                           cfg.fleet_lease_interval_s, port=args.port)
    try:
        server.serve_forever()
    finally:
        server.close()
        if args.events:
            engine.flush_metrics(JsonlLogger(args.events,
                                             max_bytes=64 * 1024 * 1024),
                                 phase="fleet_replica",
                                 replica=args.replica_id)
        engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
