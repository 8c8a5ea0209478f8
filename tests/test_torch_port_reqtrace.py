"""The port's request tracing (``telemetry/reqtrace.py``) against the JAX
package's, on the same inputs: head-based sampling, span rows, the
ring, assembly, linkage and tier attribution; the wire protocol's spans
through the port's router; both engines' spans for the same requests;
and a traced port fleet (``scripts/torch_fleet_bench.py``) read by the
JAX package's ``scripts/slo_report.py``.
"""

import importlib
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from helpers import _can_bind_localhost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = {"jax": "howtotrainyourmamlpytorch_tpu.telemetry.reqtrace",
           "port": "howtotrainyourmamlpytorch_tpu_torch.telemetry.reqtrace"}

needs_sockets = pytest.mark.skipif(
    not _can_bind_localhost(),
    reason="fleet replicas serve over localhost sockets, which this "
           "sandbox cannot bind")


@pytest.fixture(params=sorted(MODULES))
def rt(request):
    """One package's reqtrace module; its installed ring is restored."""
    mod = importlib.import_module(MODULES[request.param])
    prev = mod.get()
    yield mod
    mod.install(prev)


@pytest.fixture
def both():
    mods = [importlib.import_module(MODULES[k]) for k in sorted(MODULES)]
    prev = [m.get() for m in mods]
    yield mods
    for m, p in zip(mods, prev):
        m.install(p)


class _Capture:
    def __init__(self):
        self.rows = []

    def log(self, event, **payload):
        self.rows.append({"event": event, **payload})


class _Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self.counts = {}

    def counter(self, name):
        reg = self

        class _C:
            def inc(self, n=1.0):
                with reg._lock:
                    reg.counts[name] = reg.counts.get(name, 0) + n
        return _C()

    def gauge(self, name):
        class _G:
            def set(self, v):
                pass
        return _G()


def test_constants_and_schema_match(both):
    jax_rt, port_rt = both
    for name in ("REQUEST_TRACE_EVENT", "SPAN_REQUEST", "SPAN_ROUTE",
                 "SPAN_WIRE_SEND", "SPAN_WIRE_RECV", "SPAN_SOCKET_QUEUE",
                 "SPAN_ADMIT", "SPAN_BATCH_WAIT", "SPAN_CACHE_PROBE",
                 "SPAN_ADAPT", "SPAN_PREDICT", "SPAN_RESPOND",
                 "QUEUE_SPANS", "WIRE_SPANS", "TIERS"):
        assert getattr(port_rt, name) == getattr(jax_rt, name), name


def test_mint_sampling_matches_jax(both):
    pairs = [(f"tenant{t}", s) for t in range(10) for s in range(30)]
    for rate in (0.0, 0.1, 0.5, 1.0):
        got = []
        for mod in both:
            got.append({p: mod.mint(p[0], p[1], rate)["trace_id"]
                        for p in pairs
                        if mod.mint(p[0], p[1], rate) is not None})
        assert got[0] == got[1], rate
    port = both[1]
    assert (set(port.mint("a", 1, 1.0)) == {"trace_id", "span_id",
                                             "tenant"})


def test_span_ring_bounds_and_counts(rt):
    reg = _Registry()
    ring = rt.SpanRing(capacity=100, registry=reg)
    threads = [threading.Thread(target=lambda: [
        ring.record({"trace_id": "t", "i": i}) for i in range(100)])
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(ring) == 100 and ring.dropped == 700
    assert reg.counts["reqtrace/spans"] == 800
    assert reg.counts["reqtrace/dropped"] == 700
    with pytest.raises(ValueError):
        rt.SpanRing(capacity=0)


def test_span_rows_match_jax(both):
    """The same hop and root spans, recorded through each module: the
    same keys, parents and values (ids and clocks aside), and the same
    flushed rows."""
    rows = []
    for mod in both:
        ring = mod.SpanRing(capacity=8)
        mod.install(ring)
        ctx = mod.mint("tenantA", 1, 1.0)
        t0 = time.monotonic()
        hop = mod.record_span(ctx, mod.SPAN_ROUTE, t0, 0.01, frame_bytes=42)
        root = mod.record_root(ctx, t0, 0.5, replica=1)
        assert hop["parent_id"] == ctx["span_id"] == root["span_id"]
        assert root["parent_id"] is None
        sink = _Capture()
        assert ring.flush(sink, replica="r9", name="CLOBBER") == 2
        rows.append(sink.rows)
        mod.install(None)
        assert mod.record_span(ctx, mod.SPAN_ROUTE, t0, 0.01) is None
        assert mod.flush(_Capture()) == 0
    volatile = {"span_id", "parent_id", "t_mono", "ts_start", "pid"}
    for a, b in zip(*rows):
        assert set(a) == set(b)
        assert ({k: v for k, v in a.items() if k not in volatile}
                == {k: v for k, v in b.items() if k not in volatile})


def _hop(mod, tid, parent, name, dur):
    return {"trace_id": tid, "span_id": f"{name}.1", "parent_id": parent,
            "name": name, "dur_s": dur}


def test_assemble_linked_attribute_match_jax(both):
    outs = []
    for mod in both:
        root = {"trace_id": "abc", "span_id": "r.1", "parent_id": None,
                "name": mod.SPAN_REQUEST, "dur_s": 1.0, "tenant": "t3"}
        spans = [_hop(mod, "abc", "r.1", n, d) for n, d in (
            (mod.SPAN_SOCKET_QUEUE, 0.15), (mod.SPAN_ADMIT, 0.05),
            (mod.SPAN_WIRE_SEND, 0.1), (mod.SPAN_ADAPT, 0.4),
            (mod.SPAN_PREDICT, 0.1), (mod.SPAN_RESPOND, 0.05))]
        bad = dict(spans[0], parent_id="elsewhere")
        full = mod.assemble([root] + spans)
        outs.append({
            "assembled": full,
            "linked": [mod.linked(full["abc"]),
                       mod.linked(mod.assemble([root, bad] + spans[1:])[
                           "abc"]),
                       mod.linked(mod.assemble([root, spans[0]])["abc"]),
                       mod.linked(mod.assemble(spans)["abc"])],
            "attribute": mod.attribute(full["abc"]),
            "orphan": mod.attribute(mod.assemble(spans)["abc"])})
    assert outs[0] == outs[1]
    assert outs[1]["linked"] == [True, False, False, False]
    assert outs[1]["attribute"]["dominant"] == "adapt"
    assert outs[1]["attribute"]["queue"] == pytest.approx(0.2)


def test_port_router_records_wire_spans_into_the_port_ring():
    from howtotrainyourmamlpytorch_tpu_torch.serve.fleet import router
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import reqtrace
    assert router.reqtrace_mod() is reqtrace
    prev = reqtrace.get()
    ring = reqtrace.SpanRing(capacity=16)
    reqtrace.install(ring)
    try:
        ctx = reqtrace.mint("tenantW", 3, 1.0)
        a, b = socket.socketpair()
        try:
            router.send_msg(a, {"trace": ctx, "x": np.arange(3)})
            msg = router.recv_msg(b)
            router.send_msg(a, {"x": 1})
            assert router.recv_msg(b) == {"x": 1}
        finally:
            a.close()
            b.close()
        assert msg["trace"]["trace_id"] == ctx["trace_id"]
        assert isinstance(msg["trace"]["recv_t"], float)
        names = sorted(r["name"] for r in ring.drain())
        assert names == [reqtrace.SPAN_WIRE_RECV, reqtrace.SPAN_WIRE_SEND]
    finally:
        reqtrace.install(prev)


def test_engines_record_the_same_spans(tmp_path, both):
    """``reqtrace_sample_rate=1.0`` on both engines: each request leaves
    the same hop spans (admit, batch wait, cache probe with its tier,
    adapt, predict), linked once the caller records the root; an
    unsampled request leaves none."""
    import jax
    from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JC
    from howtotrainyourmamlpytorch_tpu.meta.outer import init_train_state
    from howtotrainyourmamlpytorch_tpu.models import make_model
    from howtotrainyourmamlpytorch_tpu.serve import (
        FewShotRequest as JaxRequest, ServingEngine as JaxEngine)
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    from howtotrainyourmamlpytorch_tpu_torch.convert import state_from_jax
    from howtotrainyourmamlpytorch_tpu_torch.serve import (
        FewShotRequest, ServingEngine)
    kw = dict(dataset_name="synthetic_serve", image_height=10,
              image_width=10, image_channels=1, num_classes_per_set=3,
              num_samples_per_class=1, num_target_samples=2, batch_size=2,
              cnn_num_filters=4, num_stages=2,
              number_of_training_steps_per_iter=2,
              number_of_evaluation_steps_per_iter=2, second_order=False,
              use_multi_step_loss_optimization=False, bn_fast_math=False,
              compute_dtype="float32", serve_batch_tasks=2,
              serve_default_deadline_ms=0.0, reqtrace_sample_rate=1.0,
              experiment_root=str(tmp_path))
    jcfg, cfg = JC(**kw), MAMLConfig(**kw)
    init, _ = make_model(jcfg)
    jstate = init_train_state(jcfg, init, jax.random.PRNGKey(0))
    params, lslr, bn = jax.device_get(
        (jstate.params, jstate.lslr, jstate.bn_state))
    engines = [JaxEngine(jcfg, jstate, devices=jax.devices()[:1]),
               ServingEngine(cfg, state_from_jax(params, lslr, bn,
                                                 device="cpu"),
                             device="cpu")]
    rng = np.random.default_rng(0)
    arrays = [(rng.integers(0, 256, (3, 10, 10, 1), dtype=np.uint8),
               np.arange(3, dtype=np.int32),
               rng.integers(0, 256, (6, 10, 10, 1), dtype=np.uint8))
              for _ in range(3)]
    arrays.append((arrays[0][0], arrays[0][1], arrays[1][2]))
    per_engine = []
    try:
        for mod, eng, req_cls in zip(both, engines,
                                     (JaxRequest, FewShotRequest)):
            ctxs = []
            for i, (sx, sy, qx) in enumerate(arrays):
                ctx = mod.mint("tenant", i, 1.0)
                ctxs.append((ctx, time.monotonic()))
                eng.submit(req_cls(support_x=sx, support_y=sy, query_x=qx,
                                   trace=ctx))
                if i == 2:
                    eng.drain()
            eng.submit(req_cls(support_x=sx, support_y=sy, query_x=qx))
            eng.drain()
            for ctx, t in ctxs:
                mod.record_root(ctx, t, time.monotonic() - t)
            sink = _Capture()
            eng.flush_metrics(sink, replica=0)
            rows = [r for r in sink.rows
                    if r["event"] == mod.REQUEST_TRACE_EVENT]
            traces = mod.assemble(rows)
            assert len(traces) == len(arrays)
            assert all(mod.linked(t) for t in traces.values())
            per_engine.append({
                tid: sorted((s["name"], s.get("tier"))
                            for s in t["spans"])
                for tid, t in traces.items()})
    finally:
        for eng in engines:
            eng.close()
    assert per_engine[0] == per_engine[1]
    tiers = [tier for spans in per_engine[1].values()
             for name, tier in spans if name == "cache_probe"]
    assert sorted(tiers) == ["l1", "miss", "miss", "miss"]


@needs_sockets
def test_traced_port_fleet_read_by_slo_report(tmp_path):
    """A traced 2-replica port fleet (--quick, on the CPU): every sampled
    request assembles into a linked trace, and the JAX package's
    ``scripts/slo_report.py`` reads the port's events files."""
    out = tmp_path / "fb"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "torch_fleet_bench.py"),
         "--quick", "--device", "cpu", "--trace-sample-rate", "1.0",
         "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    art = json.loads(proc.stdout.strip().splitlines()[-1])
    assert proc.returncode == 0 and art["status"] == "ok", art
    assert art["fleet_trace_count"] == art["requests"]
    assert art["fleet_trace_linked_frac"] >= 0.95
    report = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "slo_report.py"),
         str(out)], cwd=REPO, capture_output=True, text=True, timeout=120)
    summary = json.loads(report.stdout.strip().splitlines()[-1])
    assert report.returncode == 0, report.stdout + report.stderr
    assert summary["traces"] == art["fleet_trace_count"]
    assert summary["linked_frac"] >= 0.95
    assert summary["dominant_tier"] in ("queue", "wire", "adapt",
                                        "predict", "other")
