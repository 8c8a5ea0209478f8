"""The port's serving slice against the JAX package: batched adapt +
predict, and both ServingEngines on the same requests and weights; then
the engine's behaviour (cache hit, batch neighbours, wire dtype,
deadlines, device selection) on the port alone.

Tolerances:
* f32 logits after 2 first-order adapt steps: rtol 1e-4 / atol 2e-4,
  the repo's forward tolerance (tests/test_torch_parity.py).
* bf16 logits: cosine >= 0.999 and equal argmax — conv accumulation
  order differs between XLA:CPU and torch's CPU convolutions.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.meta import inner as jinner
from howtotrainyourmamlpytorch_tpu.meta.outer import (
    init_train_state as jax_init_train_state)
from howtotrainyourmamlpytorch_tpu.models import make_model as jax_model
from howtotrainyourmamlpytorch_tpu.ops.episode import (
    normalize_images as jax_normalize)
from howtotrainyourmamlpytorch_tpu.serve import FewShotRequest as JaxRequest
from howtotrainyourmamlpytorch_tpu.serve import ServingEngine as JaxEngine
from howtotrainyourmamlpytorch_tpu.serve.adapt import (
    adapt_task as jax_adapt_task)
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.convert import state_from_jax
from howtotrainyourmamlpytorch_tpu_torch.meta.outer import init_train_state
from howtotrainyourmamlpytorch_tpu_torch.models import make_model
from howtotrainyourmamlpytorch_tpu_torch.serve import (
    BucketError, FewShotRequest, ServingEngine)
from howtotrainyourmamlpytorch_tpu_torch.serve.adapt import (
    adapt_task, predict_tasks)

H = W = 12
N_WAY, SHOTS, QUERY = 3, 2, 2
S, Q = N_WAY * SHOTS, N_WAY * QUERY
STEPS = 2


def _kw(**kw):
    base = dict(dataset_name="synthetic_serve", image_height=H,
                image_width=W, image_channels=3,
                num_classes_per_set=N_WAY, num_samples_per_class=SHOTS,
                num_target_samples=QUERY, batch_size=2, cnn_num_filters=8,
                num_stages=2, number_of_training_steps_per_iter=STEPS,
                number_of_evaluation_steps_per_iter=STEPS,
                task_learning_rate=0.1, second_order=False,
                use_multi_step_loss_optimization=False, bn_backend="pallas",
                bn_fast_math=True, serve_buckets=((S, Q),),
                serve_batch_tasks=2, serve_default_deadline_ms=0.0,
                serve_cache_capacity=8)
    base.update(kw)
    return base


def _req(s=S, q=Q, seed=0, deadline=None):
    rng = np.random.default_rng(seed)
    return FewShotRequest(
        support_x=rng.integers(0, 256, (s, H, W, 3), dtype=np.uint8),
        support_y=(np.arange(s) % N_WAY).astype(np.int32),
        query_x=rng.integers(0, 256, (q, H, W, 3), dtype=np.uint8),
        deadline=deadline)


def _jax_state(jcfg):
    init, _ = jax_model(jcfg)
    return jax_init_train_state(jcfg, init, jax.random.PRNGKey(0))


def _port_state(jstate):
    return state_from_jax(*jax.device_get(
        (jstate.params, jstate.lslr, jstate.bn_state)), device="cpu")


def _assert_logits(got, want, dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)
    else:
        cos = (got * want).sum() / np.linalg.norm(got) / np.linalg.norm(want)
        assert cos >= 0.999, cos
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_adapt_predict_matches_jax(dtype):
    """Two tasks, the second with a padded (smaller-than-bucket) support
    set: the port's batched adapt + predict against jax.vmap of the JAX
    adapt_task and the JAX predict on the same weights."""
    jcfg, cfg = JaxConfig(**_kw(compute_dtype=dtype)), MAMLConfig(
        **_kw(compute_dtype=dtype))
    jstate = _jax_state(jcfg)
    _, japply = jax_model(jcfg)
    rng = np.random.default_rng(1)
    sx = rng.integers(0, 256, (2, S, H, W, 3), dtype=np.uint8)
    sy = np.tile(np.arange(S, dtype=np.int32) % N_WAY, (2, 1))
    sw = np.ones((2, S), np.float32)
    sx[1, 4:], sy[1, 4:], sw[1, 4:] = 0, 0, 0.0     # 4 real rows of 6
    qx = rng.integers(0, 256, (2, Q, H, W, 3), dtype=np.uint8)

    params, lslr, bn = jstate.params, jstate.lslr, jstate.bn_state
    adapted = jax.vmap(lambda a, b, c: jax_adapt_task(
        jcfg, japply, params, lslr, bn, a, b, c, num_steps=STEPS))(sx, sy, sw)
    _, slow = jinner.split_fast_slow(jcfg, params)
    want = jax.vmap(lambda f, b, q: japply(
        jinner.merge_fast_slow(f, slow), b, jax_normalize(jcfg, q),
        jnp.int32(STEPS - 1), True)[0])(adapted.fast, adapted.bn_state, qx)

    st = _port_state(jstate)
    _, apply = make_model(cfg)
    ours = adapt_task(cfg, apply, st.params, st.lslr, st.bn_state,
                      torch.from_numpy(sx), torch.from_numpy(sy).long(),
                      torch.from_numpy(sw), num_steps=STEPS)
    got = predict_tasks(cfg, apply, st.params, ours.fast, ours.bn_state,
                        torch.from_numpy(qx), num_steps=STEPS)
    _assert_logits(got.numpy(), want, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(ours.support_loss.numpy(),
                                   np.asarray(adapted.support_loss),
                                   rtol=1e-4, atol=2e-4)


@pytest.fixture(scope="module")
def engines():
    """The JAX engine as tests/test_serve.py builds it, and the port's
    engine on the CPU, from the same weights (f32 compute)."""
    jcfg = JaxConfig(**_kw(compute_dtype="float32"))
    jstate = _jax_state(jcfg)
    jeng = JaxEngine(jcfg, jstate, devices=jax.devices()[:1])
    jeng.warmup()
    cfg = MAMLConfig(**_kw(compute_dtype="float32"))
    eng = ServingEngine(cfg, _port_state(jstate), device="cpu")
    eng.warmup()
    yield jeng, eng
    jeng.close()


def test_both_engines_serve_the_same_responses(engines):
    """Same requests through both engines: a full and a padded support
    set, a request with fewer query rows, then a cache hit."""
    jeng, eng = engines
    reqs = [_req(seed=10), _req(s=4, q=3, seed=11), _req(seed=12)]
    out = []
    for engine, request_cls in ((jeng, JaxRequest), (eng, FewShotRequest)):
        for r in reqs:
            engine.submit(request_cls(support_x=r.support_x,
                                      support_y=r.support_y,
                                      query_x=r.query_x))
        out.append(sorted(engine.drain(), key=lambda r: r.request_id))
    for jr, pr, req in zip(out[0], out[1], reqs):
        assert pr.status == jr.status == "ok"
        assert pr.logits.shape == (req.num_query, N_WAY)
        _assert_logits(pr.logits, jr.logits, "float32")
        np.testing.assert_array_equal(pr.predictions, jr.predictions)
    for engine, request_cls in ((jeng, JaxRequest), (eng, FewShotRequest)):
        engine.submit(request_cls(support_x=reqs[0].support_x,
                                  support_y=reqs[0].support_y,
                                  query_x=reqs[2].query_x))
    (jhit,), (phit,) = jeng.drain(), eng.drain()
    assert jhit.cache_hit and phit.cache_hit and phit.cache_tier == "l1"
    _assert_logits(phit.logits, jhit.logits, "float32")


def test_engine_cache_hit_skips_adapt(engines):
    _, eng = engines
    r1 = _req(seed=20)
    eng.submit(r1)
    (resp,) = eng.drain()
    assert resp.error is None and not resp.cache_hit
    before = eng.adapt_invocations
    eng.submit(FewShotRequest(support_x=r1.support_x, support_y=r1.support_y,
                              query_x=_req(q=3, seed=21).query_x))
    (resp2,) = eng.drain()
    assert resp2.cache_hit and resp2.predictions.shape == (3,)
    assert eng.adapt_invocations == before
    eng.submit(_req(seed=22))
    (resp3,) = eng.drain()
    assert not resp3.cache_hit and eng.adapt_invocations == before + 1


def test_engine_batch_neighbors_do_not_affect_results(engines):
    """A request predicts identically alone or beside another task: the
    task axis keeps statistics and fast weights per task."""
    _, eng = engines
    ra, rb = _req(s=4, seed=30), _req(q=4, seed=31)
    eng.submit(ra)
    eng.submit(rb)
    together = {r.request_id: r for r in eng.drain()}
    eng.cache.clear()
    eng.submit(FewShotRequest(support_x=ra.support_x, support_y=ra.support_y,
                              query_x=ra.query_x))
    (solo,) = eng.drain()
    np.testing.assert_allclose(solo.logits, together[ra.request_id].logits,
                               rtol=1e-5, atol=1e-6)


def test_engine_rejects_off_wire_dtype(engines):
    _, eng = engines
    bad = _req(seed=40)
    bad.support_x = bad.support_x.astype(np.float32) / 255.0
    bad.query_x = bad.query_x.astype(np.float32) / 255.0
    rejected = eng.registry.counter("serve/rejected_total")
    before = rejected.value
    with pytest.raises(BucketError, match="dtype"):
        eng.submit(bad)
    assert eng.batcher.depth == 0
    assert rejected.value == before + 1


def test_engine_deadline_miss_is_a_failed_response(engines):
    _, eng = engines
    misses = eng.registry.counter("serve/deadline_misses")
    before = misses.value
    eng.submit(_req(seed=50, deadline=time.monotonic() - 1.0))
    (resp,) = eng.step()
    assert resp.status == "failed" and resp.error == "deadline_exceeded"
    assert resp.predictions is None and resp.logits is None
    assert misses.value == before + 1


def test_engine_needs_a_device_unless_cpu_is_asked_for():
    """No CUDA device and no explicit device="cpu": the engine and the
    state initializer raise instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = MAMLConfig(**_kw())
    init, _ = make_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(cfg, init, seed=0)
    state = init_train_state(cfg, init, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, state)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, state, device="cuda")


@pytest.mark.parametrize("knob", [{"aot_store_dir": "aot"},
                                  {"compilation_cache_dir": "xla_cache"},
                                  {"aot_store_dir": "aot",
                                   "compilation_cache_dir": "xla_cache"}])
def test_engine_refuses_unported_knobs(knob):
    """The AOT store and the persistent compile cache are not ported
    (eager PyTorch has no executables): the engine refuses them, naming
    each knob and the roadmap item, as the trainer does."""
    cfg = MAMLConfig(**_kw(**knob))
    init, _ = make_model(cfg)
    state = init_train_state(cfg, init, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1 "
                                                  "item 7") as err:
        ServingEngine(cfg, state, device="cpu")
    assert all(k in str(err.value) for k in knob)


# The port keeps its own copies of the numpy-only batcher and cache:
# the same behaviour, pinned on both packages.
@pytest.fixture(params=["jax", "port"])
def serve_mods(request):
    if request.param == "jax":
        from howtotrainyourmamlpytorch_tpu.serve import batcher, cache
    else:
        from howtotrainyourmamlpytorch_tpu_torch.serve import batcher, cache
    return batcher, cache


def test_batcher_buckets_backpressure_and_fifo(serve_mods):
    batcher, _ = serve_mods
    b = batcher.RequestBatcher([(6, 4), (3, 4)], max_queue_depth=3)
    assert b.bucket_for(3, 2) == (3, 4) and b.bucket_for(4, 2) == (6, 4)
    with pytest.raises(batcher.BucketError):
        b.bucket_for(7, 2)
    small1, big, small2 = (batcher.FewShotRequest(
        support_x=np.zeros((s, H, W, 3), np.uint8),
        support_y=np.zeros(s, np.int32),
        query_x=np.zeros((2, H, W, 3), np.uint8)) for s in (3, 6, 3))
    for r in (small1, big, small2):
        b.submit(r)
    with pytest.raises(batcher.QueueFullError):
        b.submit(small1)
    bucket, group, expired = b.next_group(max_tasks=4)
    assert bucket == (3, 4) and not expired
    assert [r.request_id for r in group] == [small1.request_id,
                                             small2.request_id]
    padded = batcher.pad_group(group, bucket, 4, (H, W, 3))
    assert padded["support_x"].shape == (4, 3, H, W, 3)
    assert padded["occupancy"] == 0.5


def test_fingerprint_and_lru(serve_mods):
    _, cache = serve_mods
    x = np.arange(2 * H * W * 3, dtype=np.uint8).reshape(2, H, W, 3)
    y = np.array([0, 1], np.int32)
    fp = cache.support_fingerprint(x, y, 5)
    assert cache.support_fingerprint(x.copy(), y.copy(), 5) == fp
    assert cache.support_fingerprint(x, y, 4) != fp
    assert cache.support_fingerprint(x, y, 5, context="ckpt:1") != fp
    lru = cache.AdaptedParamsLRU(capacity=2)
    lru.put("a", 1)
    lru.put("b", 2)
    assert lru.get("a") == 1
    lru.put("c", 3)
    assert lru.get("b") is None
    assert (lru.hits, lru.misses, lru.evictions) == (1, 1, 1)


@pytest.mark.parametrize("name, family", [
    ("void at::native::(anonymous namespace)::max_pool_forward_nhwc<float>",
     "pool"),
    ("max_pool_backward_nhwc", "pool"),
    ("sm90_xmma_fprop_implicit_gemm_bf16_nhwc", "conv"),
    ("nchwToNhwcKernel", "conv"),
    ("bn_act_persistent", "bn_act"),
    ("ampere_sgemm_32x32_sliced1x4_tn", "gemm"),
    ("reduce_kernel<512, 1>", "reduce"),
    ("vectorized_elementwise_kernel", "elementwise/other")])
def test_profile_families(name, family):
    """The profile script's kernel families, first match wins: max-pool
    kernels (whose names also hold "nhwc", a conv fragment) count as
    pool."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "torch_serve_profile.py")
    spec = importlib.util.spec_from_file_location("torch_serve_profile",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.family(name) == family
