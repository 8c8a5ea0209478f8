"""The port's shared L2 adapted-params tier (``serve/fleet/l2cache.py``)
against the JAX package's, on the same numpy trees: round trips with
byte-equal files, damage as a counted fail-soft miss, GC by recency and
the stale-tmp sweep; entries either package wrote read by the other.
Then the port engine's L2 probe and writer-thread publish, its tiers,
and the key that keeps the two packages' entries apart (``backend=torch``
in the engine's fingerprint context: both packages fingerprint a
checkpoint by its bytes, but their adapted leaves differ in layout).
"""

import importlib
import os
import threading
import time

import numpy as np
import pytest

MODULES = {"jax": "howtotrainyourmamlpytorch_tpu.serve.fleet.l2cache",
           "port": "howtotrainyourmamlpytorch_tpu_torch.serve.fleet.l2cache"}
REGISTRIES = {
    "jax": "howtotrainyourmamlpytorch_tpu.telemetry.registry",
    "port": "howtotrainyourmamlpytorch_tpu_torch.telemetry.registry"}


@pytest.fixture(params=sorted(MODULES))
def pkg(request):
    """(l2cache module, a fresh MetricsRegistry) of one package."""
    mod = importlib.import_module(MODULES[request.param])
    reg = importlib.import_module(REGISTRIES[request.param])
    return mod, reg.MetricsRegistry()


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    fast = {"conv0": {"w": rng.standard_normal((4, 3, 3, 3)).astype(
                np.float32), "b": np.zeros(4, np.float32)},
            "head": [rng.standard_normal(5).astype(np.float16),
                     np.arange(3, dtype=np.int32)]}
    bn = {"bn": {"mean": rng.standard_normal(4), "tuple": (
        np.float32(1.5), np.ones((2, 2), np.float32))}}
    return fast, bn


def test_round_trip_preserves_trees_and_dtypes(tmp_path, pkg):
    l2c, reg = pkg
    l2 = l2c.L2AdaptedParamsCache(str(tmp_path), registry=reg)
    fast, bn = _tree()
    assert l2.put("a" * 64, fast, bn)
    entry = l2.get("a" * 64)
    np.testing.assert_array_equal(entry["fast"]["conv0"]["w"],
                                  fast["conv0"]["w"])
    assert entry["fast"]["head"][0].dtype == np.float16
    assert entry["bn_state"]["bn"]["mean"].dtype == np.float64
    assert isinstance(entry["bn_state"]["bn"]["tuple"], tuple)
    assert (l2.hits, l2.misses, l2.errors) == (1, 0, 0)
    assert reg.counter(l2c.PUBLISHES).value == 1
    assert l2.get("b" * 64) is None
    assert (l2.misses, l2.errors) == (1, 0)


def test_files_are_byte_equal_and_cross_read(tmp_path):
    """Equal numpy trees encode to the same bytes in both packages, and
    each package decodes the other's files."""
    jl2c, pl2c = (importlib.import_module(MODULES[k]) for k in ("jax",
                                                                "port"))
    fast, bn = _tree(1)
    assert jl2c.encode_entry(fast, bn) == pl2c.encode_entry(fast, bn)
    assert (jl2c.ENTRY_SUFFIX, jl2c.HITS, jl2c.PUBLISHES) == (
        pl2c.ENTRY_SUFFIX, pl2c.HITS, pl2c.PUBLISHES)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jl2 = jl2c.L2AdaptedParamsCache(str(jdir))
    pl2 = pl2c.L2AdaptedParamsCache(str(pdir))
    key = "d" * 64
    assert jl2.put(key, fast, bn) and pl2.put(key, fast, bn)
    assert open(jl2.path(key), "rb").read() == open(pl2.path(key),
                                                    "rb").read()
    for reader, other in ((pl2c.L2AdaptedParamsCache(str(jdir)), fast),
                          (jl2c.L2AdaptedParamsCache(str(pdir)), fast)):
        got = reader.get(key)
        np.testing.assert_array_equal(got["fast"]["conv0"]["w"],
                                      other["conv0"]["w"])


@pytest.mark.parametrize("damage", ["truncate", "bitflip", "magic"])
def test_damage_is_counted_fail_soft_miss(tmp_path, pkg, damage):
    l2c, reg = pkg
    l2 = l2c.L2AdaptedParamsCache(str(tmp_path), registry=reg)
    fast, bn = _tree()
    key = "c" * 64
    assert l2.put(key, fast, bn)
    path = l2.path(key)
    blob = open(path, "rb").read()
    if damage == "truncate":
        open(path, "wb").write(blob[:len(blob) // 2])
    elif damage == "bitflip":
        flipped = bytearray(blob)
        flipped[len(flipped) - 8] ^= 0x10
        open(path, "wb").write(bytes(flipped))
    else:
        open(path, "wb").write(b"NOTL2AAA" + blob[8:])
    assert l2.get(key) is None
    assert (l2.errors, l2.misses) == (1, 1)
    assert reg.counter(l2c.ERRORS).value == 1
    assert not os.path.exists(path)
    assert l2.put(key, fast, bn) and l2.get(key) is not None


def test_gc_by_recency_and_stale_tmp_sweep(tmp_path, pkg):
    l2c, _ = pkg
    l2 = l2c.L2AdaptedParamsCache(str(tmp_path), max_entries=100)
    fast, bn = _tree()
    keys = [f"{i:064d}" for i in range(5)]
    now = time.time()
    for i, k in enumerate(keys):
        assert l2.put(k, fast, bn)
        os.utime(l2.path(k), (now + i, now + i))
    assert l2.gc(max_entries=3) == 2
    assert {k for k, _ in l2.entries()} == set(keys[2:])
    assert l2.evictions == 2
    assert l2.get(keys[2]) is not None
    os.utime(l2.path(keys[2]), (now + 10, now + 10))
    assert l2.gc(max_entries=2) == 1
    assert keys[2] in {k for k, _ in l2.entries()}
    stale = os.path.join(str(tmp_path), "x.l2.tmp.999")
    fresh = os.path.join(str(tmp_path), "y.l2.tmp.998")
    open(stale, "wb").write(b"x")
    open(fresh, "wb").write(b"y")
    os.utime(stale, (now - 7200, now - 7200))
    assert l2.sweep() == 1
    assert not os.path.exists(stale) and os.path.exists(fresh)


# ---------------------------------------------------------------------------
# the engine's tier

def _engine_cfgs(tmp_path, l2_dir):
    from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    kw = dict(experiment_name="l2", experiment_root=str(tmp_path),
              dataset_name="synthetic_serve", image_height=10,
              image_width=10, image_channels=1, num_classes_per_set=3,
              num_samples_per_class=1, num_target_samples=2, batch_size=2,
              cnn_num_filters=4, num_stages=2,
              number_of_training_steps_per_iter=2,
              number_of_evaluation_steps_per_iter=2, second_order=False,
              use_multi_step_loss_optimization=False, bn_fast_math=False,
              compute_dtype="float32", serve_batch_tasks=2,
              serve_default_deadline_ms=0.0, serve_l2_dir=str(l2_dir))
    return JaxConfig(**kw), MAMLConfig(**kw)


@pytest.fixture
def checkpoint(tmp_path):
    """A JAX-written, published checkpoint both packages serve, and the
    two configs (one shared L2 directory)."""
    import jax
    from howtotrainyourmamlpytorch_tpu.ckpt.registry import ModelRegistry
    from howtotrainyourmamlpytorch_tpu.meta.outer import init_train_state
    from howtotrainyourmamlpytorch_tpu.models import make_model
    from howtotrainyourmamlpytorch_tpu.utils.checkpoint import (
        CheckpointManager)
    jcfg, cfg = _engine_cfgs(tmp_path, tmp_path / "l2")
    directory = str(tmp_path / "saved_models")
    init, _ = make_model(jcfg)
    mgr = CheckpointManager(directory)
    mgr.save(init_train_state(jcfg, init, jax.random.PRNGKey(0)), epoch=0,
             current_iter=1, val_acc=0.5)
    ModelRegistry(directory).publish(tag="0", epoch=0, iteration=1,
                                     val_acc=0.5,
                                     fingerprint=mgr.fingerprint(0))
    return jcfg, cfg, directory


def _request(cls, seed, support_seed=None):
    rng = np.random.default_rng(seed)
    sx = rng.integers(0, 256, (3, 10, 10, 1), dtype=np.uint8)
    if support_seed is not None:
        sx = np.random.default_rng(support_seed).integers(
            0, 256, (3, 10, 10, 1), dtype=np.uint8)
    return cls(support_x=sx, support_y=np.arange(3, dtype=np.int32),
               query_x=rng.integers(0, 256, (6, 10, 10, 1), dtype=np.uint8))


def test_engine_l2_probe_publish_and_tiers(checkpoint):
    """A fresh adapt is published from the writer thread; a second engine
    on the tier serves the repeat as ``l2`` with no adapt (and
    back-fills its L1: the next repeat is ``l1``); the registry counts
    the tier's publishes, hits and misses."""
    from howtotrainyourmamlpytorch_tpu_torch.serve import (
        FewShotRequest, ServingEngine)
    from howtotrainyourmamlpytorch_tpu_torch.serve.fleet import l2cache
    _, cfg, directory = checkpoint
    a = ServingEngine.from_checkpoint(cfg, directory, device="cpu")
    b = ServingEngine.from_checkpoint(cfg, directory, device="cpu")
    try:
        a.submit(_request(FewShotRequest, 1))
        (first,) = a.drain()
        assert first.cache_tier is None and a.l2_flush(10.0)
        assert a.registry.counter(l2cache.PUBLISHES).value == 1
        b.submit(_request(FewShotRequest, 2, support_seed=1))
        (hit,) = b.drain()
        assert hit.cache_tier == "l2" and b.adapt_invocations == 0
        assert np.isfinite(hit.logits).all()
        b.submit(_request(FewShotRequest, 3, support_seed=1))
        (again,) = b.drain()
        assert again.cache_tier == "l1" and b.adapt_invocations == 0
        assert b.registry.counter(l2cache.HITS).value == 1
        assert a.registry.counter(l2cache.MISSES).value == 1
        assert a.l2_dropped_publishes == 0
    finally:
        a.close()
        b.close()


def test_jax_entry_is_a_miss_in_the_port(checkpoint):
    """Both packages on one checkpoint file (the same fingerprint) and
    one L2 directory: the JAX engine's published entry is never a hit
    in the port, nor the port's in the JAX engine: their keys differ by
    ``backend=torch``."""
    import jax
    from howtotrainyourmamlpytorch_tpu.serve import (
        FewShotRequest as JaxRequest, ServingEngine as JaxEngine)
    from howtotrainyourmamlpytorch_tpu_torch.serve import (
        FewShotRequest, ServingEngine)
    jcfg, cfg, directory = checkpoint
    jeng = JaxEngine.from_checkpoint(jcfg, directory,
                                     devices=jax.devices()[:1])
    eng = ServingEngine.from_checkpoint(cfg, directory, device="cpu")
    try:
        assert jeng._state_fingerprint == eng._state_fingerprint
        assert "backend=torch" in eng._fp_context
        assert "backend=torch" not in jeng._fp_context
        jeng.submit(_request(JaxRequest, 1))
        jeng.drain()
        assert jeng.l2_flush(10.0) and jeng.l2.publishes == 1
        eng.submit(_request(FewShotRequest, 2, support_seed=1))
        (resp,) = eng.drain()
        assert resp.cache_tier is None and eng.adapt_invocations == 1
        assert eng.l2.hits == 0 and eng.l2.errors == 0
        assert eng.l2_flush(10.0) and eng.l2.publishes == 1
        jeng.submit(_request(JaxRequest, 3, support_seed=1))
        (jresp,) = jeng.drain()
        assert jresp.cache_tier == "l1"
        assert len(os.listdir(cfg.serve_l2_dir)) == 2
    finally:
        jeng.close()
        eng.close()


def test_full_publish_queue_drops_and_close_does_not_wait(checkpoint,
                                                          monkeypatch):
    """A writer wedged on a hung publish: further publishes past the
    queue's bound are dropped and counted, and ``close`` returns after
    its bounded flush instead of joining the writer."""
    from howtotrainyourmamlpytorch_tpu_torch.serve import (
        FewShotRequest, ServingEngine)
    from howtotrainyourmamlpytorch_tpu_torch.serve import engine as eng_mod
    _, cfg, directory = checkpoint
    monkeypatch.setattr(eng_mod, "_L2_QUEUE_DEPTH", 1)
    eng = ServingEngine.from_checkpoint(cfg, directory, device="cpu")
    release = threading.Event()
    monkeypatch.setattr(eng.l2, "put",
                        lambda *a, **k: release.wait(60) and False)
    try:
        for seed in range(4):
            eng.submit(_request(FewShotRequest, 10 + seed))
        eng.drain()
        assert eng.l2_dropped_publishes >= 1
        assert eng.registry.counter("resilience/cache_errors").value >= 1
        t0 = time.monotonic()
        eng.close()
        assert time.monotonic() - t0 < 8.0
    finally:
        release.set()
        eng.close()
