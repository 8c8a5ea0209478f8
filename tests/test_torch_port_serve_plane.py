"""The port's serving plane against the JAX package's engine, on the CPU.

One tiny checkpoint (2 stages of 8 filters, 12x12x3, 3-way 2-shot, f32,
``bn_fast_math=False``) is written by either package's trainer-side
``CheckpointManager`` and published to its ``REGISTRY.json``; the JAX
``ServingEngine.from_checkpoint`` and the port's then serve the same
requests, made with numpy from a seed:

* logits equal to rtol 1e-4 / atol 2e-4 (the repo's forward f32
  tolerance, tests/test_torch_parity.py) with the same hit/miss/tier
  sequence;
* a flush row with the JAX engine's metric names (less its XLA compile
  counters: eager PyTorch compiles nothing), rendered by the JAX
  package's ``scripts/telemetry_report.py``;
* the same hot-swap decisions on the same publish sequences (mirroring
  tests/test_ckpt.py's hot-swap tests), and zero dropped requests
  through a swap under load;
* the same shedding and continuous-batching decisions on scripted
  ``now=`` arrival times, and the same alert transitions;
* with every knob at its default, the request path computes exactly what
  the batched adapt + predict compute (bitwise), and installs nothing.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.ckpt.registry import (
    ModelRegistry as JaxRegistry)
from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.meta.outer import (
    init_train_state as jax_init_train_state)
from howtotrainyourmamlpytorch_tpu.models import make_model as jax_model
from howtotrainyourmamlpytorch_tpu.serve import FewShotRequest as JaxRequest
from howtotrainyourmamlpytorch_tpu.serve import ServingEngine as JaxEngine
from howtotrainyourmamlpytorch_tpu.serve import ShedError as JaxShedError
from howtotrainyourmamlpytorch_tpu.utils.checkpoint import (
    CheckpointManager as JaxCheckpointManager)
from howtotrainyourmamlpytorch_tpu.utils.tracing import (
    JsonlLogger as JaxJsonlLogger)
from howtotrainyourmamlpytorch_tpu_torch.ckpt.registry import ModelRegistry
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.convert import state_from_jax
from howtotrainyourmamlpytorch_tpu_torch.serve import (
    FewShotRequest, ServingEngine, ShedError, pad_group)
from howtotrainyourmamlpytorch_tpu_torch.serve.adapt import (
    adapt_task, predict_tasks)
from howtotrainyourmamlpytorch_tpu_torch.tree import index, stack
from howtotrainyourmamlpytorch_tpu_torch.utils.checkpoint import (
    CheckpointManager)
from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import JsonlLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 12
N_WAY, SHOTS, QUERY = 3, 2, 2
S, Q = N_WAY * SHOTS, N_WAY * QUERY
RTOL, ATOL = 1e-4, 2e-4


def _kw(root, **kw):
    base = dict(experiment_name="plane", experiment_root=str(root),
                dataset_name="synthetic_serve", image_height=H,
                image_width=W, image_channels=3,
                num_classes_per_set=N_WAY, num_samples_per_class=SHOTS,
                num_target_samples=QUERY, batch_size=2, cnn_num_filters=8,
                num_stages=2, number_of_training_steps_per_iter=2,
                number_of_evaluation_steps_per_iter=2,
                task_learning_rate=0.1, second_order=False,
                use_multi_step_loss_optimization=False, bn_backend="pallas",
                bn_fast_math=False, compute_dtype="float32",
                serve_batch_tasks=2, serve_default_deadline_ms=0.0,
                serve_cache_capacity=8, serve_registry_poll_s=30.0,
                # Probes are noise: both versions sit near chance, so the
                # canary gates on finiteness (tests/test_ckpt.py's rule).
                serve_canary_acc_drop=1.0, serve_canary_latency_factor=50.0)
    base.update(kw)
    return base


def _cfgs(root, **kw):
    return JaxConfig(**_kw(root, **kw)), MAMLConfig(**_kw(root, **kw))


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (S, H, W, 3), dtype=np.uint8),
            (np.arange(S) % N_WAY).astype(np.int32),
            rng.integers(0, 256, (Q, H, W, 3), dtype=np.uint8))


def _pair(seed, support_seed=None, **kw):
    """The same request for both engines (optionally another request's
    support set with fresh queries)."""
    sx, sy, qx = _arrays(seed)
    if support_seed is not None:
        sx, sy, _ = _arrays(support_seed)
    return (JaxRequest(support_x=sx, support_y=sy, query_x=qx, **kw),
            FewShotRequest(support_x=sx, support_y=sy, query_x=qx, **kw))


def _serve(jeng, eng, pairs):
    for jr, pr in pairs:
        jeng.submit(jr)
        eng.submit(pr)
    return (sorted(jeng.drain(), key=lambda r: r.request_id),
            sorted(eng.drain(), key=lambda r: r.request_id))


def _assert_same(jout, pout):
    assert len(jout) == len(pout)
    for jr, pr in zip(jout, pout):
        assert pr.status == jr.status == "ok"
        assert (pr.cache_hit, pr.cache_tier) == (jr.cache_hit, jr.cache_tier)
        np.testing.assert_allclose(pr.logits, np.asarray(jr.logits),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(pr.predictions, jr.predictions)


def _jax_state(jcfg, seed=0):
    init, _ = jax_model(jcfg)
    return jax_init_train_state(jcfg, init, jax.random.PRNGKey(seed))


def _poison_nan(state):
    return jax.tree.map(
        lambda x: (np.full_like(np.asarray(x), np.nan)
                   if np.issubdtype(np.asarray(x).dtype, np.floating)
                   else np.asarray(x)), state)


def _nudge(state):
    return jax.tree.map(
        lambda x: (np.asarray(x) + np.float32(0.01)
                   if np.issubdtype(np.asarray(x).dtype, np.floating)
                   else np.asarray(x)), state)


def _write_checkpoint(writer, jcfg, cfg, directory):
    """Epoch 0 of a fresh state, saved and published by ``writer``'s
    package; returns the JAX state (the weights both engines serve)."""
    jstate = _jax_state(jcfg)
    if writer == "jax":
        mgr = JaxCheckpointManager(directory, max_to_keep=5)
        mgr.save(jstate, epoch=0, current_iter=10, val_acc=0.5)
        JaxRegistry(directory).publish(tag="0", epoch=0, iteration=10,
                                       val_acc=0.5,
                                       fingerprint=mgr.fingerprint(0))
    else:
        params, lslr, bn = jax.device_get(
            (jstate.params, jstate.lslr, jstate.bn_state))
        mgr = CheckpointManager(directory, max_to_keep=5)
        mgr.save(state_from_jax(params, lslr, bn, device="cpu"), epoch=0,
                 current_iter=10, val_acc=0.5)
        ModelRegistry(directory).publish(tag="0", epoch=0, iteration=10,
                                         val_acc=0.5,
                                         fingerprint=mgr.fingerprint(0))
    return jstate


@pytest.fixture(scope="module")
def plane(tmp_path_factory):
    """Both engines from one JAX-written checkpoint, each with its own L2
    directory, warmed up."""
    root = tmp_path_factory.mktemp("plane")
    directory = str(root / "saved_models")
    jcfg = JaxConfig(**_kw(root, serve_l2_dir=str(root / "l2_jax")))
    cfg = MAMLConfig(**_kw(root, serve_l2_dir=str(root / "l2_port")))
    jstate = _write_checkpoint("jax", jcfg, cfg, directory)
    jeng = JaxEngine.from_checkpoint(jcfg, directory,
                                     devices=jax.devices()[:1])
    eng = ServingEngine.from_checkpoint(cfg, directory, device="cpu")
    jeng.warmup()
    eng.warmup()
    yield {"jeng": jeng, "eng": eng, "jcfg": jcfg, "cfg": cfg,
           "dir": directory, "root": root, "jstate": jstate}
    jeng.close()
    eng.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_from_checkpoint_serves_either_package_checkpoint(tmp_path, writer):
    """A checkpoint either package wrote: the port's engine serves it with
    the JAX engine's logits, and adopts the registry's version of the
    bytes it loaded without a swap, as the JAX engine does."""
    jcfg, cfg = _cfgs(tmp_path)
    directory = str(tmp_path / "saved_models")
    _write_checkpoint(writer, jcfg, cfg, directory)
    jeng = JaxEngine.from_checkpoint(jcfg, directory,
                                     devices=jax.devices()[:1])
    eng = ServingEngine.from_checkpoint(cfg, directory, device="cpu")
    try:
        assert eng._state_fingerprint == jeng._state_fingerprint
        assert eng.maybe_hot_swap(force=True) is None
        assert jeng.maybe_hot_swap(force=True) is None
        assert eng._model_version == jeng._model_version == 1
        _assert_same(*_serve(jeng, eng, [_pair(1), _pair(2)]))
    finally:
        jeng.close()
        eng.close()


def test_request_path_tiers_and_logits_match_jax(plane):
    """Fresh adapts, an L1 repeat, then a second engine of each package
    on the same L2 directory serving a repeat from the tier with no
    adapt: same logits, same (hit, tier) sequence."""
    jeng, eng = plane["jeng"], plane["eng"]
    _assert_same(*_serve(jeng, eng, [_pair(10), _pair(11)]))
    jout, pout = _serve(jeng, eng, [_pair(12, support_seed=10)])
    _assert_same(jout, pout)
    assert pout[0].cache_tier == "l1"
    assert jeng.l2_flush() and eng.l2_flush()
    jeng2 = JaxEngine.from_checkpoint(plane["jcfg"], plane["dir"],
                                      devices=jax.devices()[:1])
    eng2 = ServingEngine.from_checkpoint(plane["cfg"], plane["dir"],
                                         device="cpu")
    try:
        jout, pout = _serve(jeng2, eng2, [_pair(13, support_seed=11)])
        _assert_same(jout, pout)
        assert pout[0].cache_tier == "l2"
        assert eng2.adapt_invocations == jeng2.adapt_invocations == 0
    finally:
        jeng2.close()
        eng2.close()


def _metrics_row(path):
    rows = [json.loads(line) for line in open(path)]
    return [r for r in rows if r["event"] == "metrics"][-1]["metrics"]


def test_flush_row_has_the_jax_metric_names_and_reports(plane, tmp_path):
    jeng, eng = plane["jeng"], plane["eng"]
    _serve(jeng, eng, [_pair(20), _pair(21, support_seed=20)])
    jpath, ppath = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    jeng.flush_metrics(JaxJsonlLogger(jpath), phase="serve")
    eng.flush_metrics(JsonlLogger(ppath), phase="serve")
    jnames = {k for k in _metrics_row(jpath) if not k.startswith("compile/")}
    assert set(_metrics_row(ppath)) == jnames
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "telemetry_report.py"),
         ppath, "--json"], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    serving = json.loads(out.stdout.strip().splitlines()[-1])["serving"]
    assert isinstance(serving, dict)
    assert serving["responses"] == eng.registry.counter(
        "serve/responses_total").value > 0
    assert eng.write_profile_json() is None


def test_hot_swap_decisions_match_jax(plane):
    """tests/test_ckpt.py's hot-swap sequence on both engines at once:
    the published version of the loaded bytes is adopted, the poll is
    rate-limited, a NaN version rolls back and is pinned, a nudged
    version swaps and invalidates the cache."""
    jeng, eng, directory = plane["jeng"], plane["eng"], plane["dir"]
    both = (jeng, eng)
    for e in both:
        assert e.maybe_hot_swap(force=True) is None
        assert e._model_version == 1
        assert e.registry.counter("serve/hot_swaps").value == 0
        e._last_registry_poll = 1000.0
        assert e.maybe_hot_swap(now=1001.0) is None
        assert e._last_registry_poll == 1000.0
        assert e.maybe_hot_swap(now=1001.0, force=True) is None
        assert e._last_registry_poll == 1001.0

    mgr = JaxCheckpointManager(directory, max_to_keep=5)
    mgr.save(_poison_nan(plane["jstate"]), epoch=1, current_iter=20,
             val_acc=0.9)
    JaxRegistry(directory).publish(tag="1", epoch=1, iteration=20,
                                   val_acc=0.9,
                                   fingerprint=mgr.fingerprint(1))
    outs = [e.maybe_hot_swap(force=True) for e in both]
    for e, out in zip(both, outs):
        assert out["swapped"] is False and "non-finite" in out[
            "canary"]["reason"]
        assert e.registry.counter("serve/hot_swap_rollbacks").value == 1
        assert e._model_version == 1 and 2 in e._rejected_versions
        assert e.maybe_hot_swap(force=True) is None
    _assert_same(*_serve(jeng, eng, [_pair(30)]))

    _serve(jeng, eng, [_pair(31)])
    jout, pout = _serve(jeng, eng, [_pair(32, support_seed=31)])
    assert pout[0].cache_hit and jout[0].cache_hit
    mgr.save(_nudge(plane["jstate"]), epoch=2, current_iter=30, val_acc=0.6)
    JaxRegistry(directory).publish(tag="2", epoch=2, iteration=30,
                                   val_acc=0.6,
                                   fingerprint=mgr.fingerprint(2))
    contexts = [e._fp_context for e in both]
    outs = [e.maybe_hot_swap(force=True) for e in both]
    for e, out, ctx in zip(both, outs, contexts):
        assert out["swapped"] is True, out
        assert e._fp_context != ctx and e._model_version == 3
        assert e.registry.counter("serve/hot_swaps").value == 1
    adapts = [e.adapt_invocations for e in both]
    jout, pout = _serve(jeng, eng, [_pair(33, support_seed=31)])
    _assert_same(jout, pout)
    assert not pout[0].cache_hit
    assert [e.adapt_invocations for e in both] == [a + 1 for a in adapts]


def test_hot_swap_under_load_drops_nothing(tmp_path):
    """A swap decided between steps under live load: every submitted
    request is answered, by both engines alike."""
    jcfg, cfg = _cfgs(tmp_path)
    directory = str(tmp_path / "saved_models")
    jstate = _write_checkpoint("jax", jcfg, cfg, directory)
    jeng = JaxEngine.from_checkpoint(jcfg, directory,
                                     devices=jax.devices()[:1])
    eng = ServingEngine.from_checkpoint(cfg, directory, device="cpu")
    mgr = JaxCheckpointManager(directory, max_to_keep=5)
    try:
        responses = {id(jeng): [], id(eng): []}
        swapped = []
        for i in range(12):
            jr, pr = _pair(100 + i)
            jeng.submit(jr)
            eng.submit(pr)
            if i == 6:
                mgr.save(_nudge(jstate), epoch=1, current_iter=20,
                         val_acc=0.6)
                JaxRegistry(directory).publish(
                    tag="1", epoch=1, iteration=20, val_acc=0.6,
                    fingerprint=mgr.fingerprint(1))
                swapped = [e.maybe_hot_swap(force=True)["swapped"]
                           for e in (jeng, eng)]
            for e in (jeng, eng):
                responses[id(e)].extend(e.step())
        for e in (jeng, eng):
            responses[id(e)].extend(e.drain())
        assert swapped == [True, True]
        for e in (jeng, eng):
            out = responses[id(e)]
            assert len(out) == 12
            assert all(r.status == "ok" and np.isfinite(r.logits).all()
                       for r in out)
        _assert_same(sorted(responses[id(jeng)], key=lambda r: r.request_id),
                     sorted(responses[id(eng)], key=lambda r: r.request_id))
    finally:
        jeng.close()
        eng.close()


def test_canary_verdict_logic_matches_jax(plane, monkeypatch):
    """The accuracy / latency / finiteness gates on stubbed canary
    measurements (tests/test_ckpt.py's table), both engines."""
    cases = []
    ok = {"accuracy": 0.9, "adapt_seconds": 0.1, "finite": True}
    for cand in (dict(ok), {**ok, "accuracy": 0.85, "adapt_seconds": 0.15},
                 {**ok, "accuracy": 0.7}, {**ok, "adapt_seconds": 0.5},
                 {**ok, "finite": False}):
        cases.append((ok, cand))
    cases.append(({**ok, "accuracy": 0.4}, {**ok, "accuracy": 0.0}))
    verdicts = []
    for e in (plane["jeng"], plane["eng"]):
        monkeypatch.setattr(e, "cfg", e.cfg.replace(
            serve_canary_acc_drop=0.1, serve_canary_latency_factor=2.0))
        live, cand = object(), object()
        monkeypatch.setattr(e, "state", live, raising=False)
        got = []
        for live_m, cand_m in cases:
            table = {id(live): live_m, id(cand): cand_m}
            monkeypatch.setattr(e, "_canary_eval",
                                lambda state, t=table: t[id(state)])
            v = e._run_canary(cand)
            got.append((v["pass"], v["reason"]))
        verdicts.append(got)
    assert verdicts[0] == verdicts[1]
    assert [p for p, _ in verdicts[1]] == [True, True, False, False, False,
                                           True]


def test_shedding_and_continuous_batching_match_jax(tmp_path):
    """Both engines with the deadline shed policy and continuous
    batching, on the same scripted arrival times: the same requests are
    shed, the same groups dispatch at the same ``now``, and the counters
    agree."""
    kw = dict(fleet_shed_policy="deadline", serve_continuous_batching=1,
              serve_batch_linger_ms=5.0, serve_max_queue_depth=8)
    jcfg, cfg = _cfgs(tmp_path, **kw)
    jstate = _jax_state(jcfg)
    jeng = JaxEngine(jcfg, jstate, devices=jax.devices()[:1])
    params, lslr, bn = jax.device_get(
        (jstate.params, jstate.lslr, jstate.bn_state))
    eng = ServingEngine(cfg, state_from_jax(params, lslr, bn, device="cpu"),
                        device="cpu")
    try:
        for e in (jeng, eng):
            # The same service-time estimate (no measured batch feeds it
            # before the burst below).
            e.batcher.admission.record_service((S, Q), 0.1)
        decisions, groups = [], []
        t0 = 5000.0
        for i in range(7):
            now = t0 + 0.001 * i
            deadline = now + (0.5 if i % 2 else 0.2)
            jr, pr = _pair(200 + i, deadline=deadline)
            got = []
            for e, r, err in ((jeng, jr, JaxShedError), (eng, pr, ShedError)):
                try:
                    e.submit(r, now=now)
                    got.append("admit")
                except err:
                    got.append("shed")
            decisions.append(got)
        assert all(j == p for j, p in decisions), decisions
        assert {"admit", "shed"} <= {d[0] for d in decisions}
        for now in (t0 + 0.002, t0 + 0.004, t0 + 0.020, t0 + 0.040):
            step = []
            for e in (jeng, eng):
                out = e.step(now=now)
                step.append(sorted((r.status, r.error) for r in out))
            assert step[0] == step[1], (now, step)
            groups.append(len(step[1]))
        assert sum(groups) > 0
        names = ("serve/shed_total", "serve/cb_groups",
                 "serve/cb_fill_dispatch", "serve/cb_linger_dispatch")
        for e in (jeng, eng):
            e._mirror_cache_counters()
        assert ([jeng.registry.counter(n).value for n in names]
                == [eng.registry.counter(n).value for n in names])
        assert eng.registry.counter("serve/shed_total").value > 0
        assert eng.registry.counter("serve/cb_groups").value > 0
    finally:
        jeng.close()
        eng.close()


def test_alert_rules_fire_like_jax(tmp_path):
    """``alert_rules_path``: evaluated at flush, the same transitions
    and firing summary as the JAX engine's."""
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps({"rules": [
        {"name": "served", "type": "threshold",
         "metric": "serve/responses_total", "op": ">", "value": 0.0,
         "severity": "warn"},
        {"name": "rejected", "type": "threshold",
         "metric": "serve/rejected_total", "op": ">", "value": 0.0,
         "severity": "critical"}]}))
    jcfg, cfg = _cfgs(tmp_path, alert_rules_path=str(rules))
    jstate = _jax_state(jcfg)
    jeng = JaxEngine(jcfg, jstate, devices=jax.devices()[:1])
    params, lslr, bn = jax.device_get(
        (jstate.params, jstate.lslr, jstate.bn_state))
    eng = ServingEngine(cfg, state_from_jax(params, lslr, bn, device="cpu"),
                        device="cpu")
    try:
        _serve(jeng, eng, [_pair(300)])
        jp, pp = str(tmp_path / "j.jsonl"), str(tmp_path / "p.jsonl")
        jeng.flush_metrics(JaxJsonlLogger(jp))
        eng.flush_metrics(JsonlLogger(pp))

        def alerts(path):
            return [(r["rule"], r["state"]) for r in map(
                json.loads, open(path)) if r["event"] == "alert"]
        assert alerts(pp) == alerts(jp) == [("served", "firing")]
        assert eng.alerts_firing_summary() == jeng.alerts_firing_summary()
        assert _metrics_row(pp)["maml_alert_firing"] == 1.0
    finally:
        jeng.close()
        eng.close()


def test_default_request_path_is_the_plain_batched_compute(tmp_path):
    """Every knob at its default: the engine installs no shed policy,
    assembler, L2 tier, span ring or alert evaluator, registers none of
    their metrics, and its responses are bitwise the batched adapt +
    predict on the same padded batch (the request path as it was)."""
    jcfg, cfg = _cfgs(tmp_path)
    jstate = _jax_state(jcfg)
    params, lslr, bn = jax.device_get(
        (jstate.params, jstate.lslr, jstate.bn_state))
    state = state_from_jax(params, lslr, bn, device="cpu")
    eng = ServingEngine(cfg, state, device="cpu")
    try:
        from howtotrainyourmamlpytorch_tpu_torch.telemetry import reqtrace
        assert eng.batcher.admission is None
        assert eng.batcher.assembler is None
        assert eng.l2 is None and eng._alerts is None
        assert reqtrace.get() is None
        reqs = [_pair(400)[1], _pair(401)[1]]
        for r in reqs:
            eng.submit(r)
        out = sorted(eng.drain(), key=lambda r: r.request_id)
        snap = eng.registry.snapshot()
        assert not [k for k in snap if k.startswith(("serve/shed",
                                                     "serve/cb_", "fleet/"))]
        batch = pad_group(reqs, (S, Q), cfg.serve_batch_tasks,
                          cfg.image_shape)
        steps = cfg.effective_serve_adapt_steps
        ad = adapt_task(cfg, eng.model_apply, eng.state.params,
                        eng.state.lslr, eng.state.bn_state,
                        torch.from_numpy(batch["support_x"]),
                        torch.from_numpy(batch["support_y"]).long(),
                        torch.from_numpy(batch["support_w"]),
                        num_steps=steps)
        entries = [(index(ad.fast, j), index(ad.bn_state, j))
                   for j in range(len(reqs))]
        qx = np.stack([r.query_x for r in reqs])
        want = predict_tasks(cfg, eng.model_apply, eng.state.params,
                             stack([e[0] for e in entries]),
                             stack([e[1] for e in entries]),
                             torch.from_numpy(qx), num_steps=steps).numpy()
        for i, r in enumerate(out):
            np.testing.assert_array_equal(r.logits, want[i])
    finally:
        eng.close()
