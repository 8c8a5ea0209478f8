"""The port's checkpoints against the JAX package's, on the CPU: the msgpack
codec against flax's, checkpoints written by one package and loaded by
the other (bitwise, Adam's state and the step included), CRC damage and
the quarantine fallback, the manifest's pending records, top-k pruning,
``rewind_to``, the load-time shape helpers, and ``state_to_jax`` as the
inverse of ``state_from_jax``.

States are the JAX package's tiny VGG (2 stages of 8 filters, 12x12x3,
2-way) with every leaf replaced by seeded random values, so that the
layout transposes and Adam's moments are exercised; no step is compiled.
All comparisons are bitwise.
"""

import json
import os
import subprocess
import sys
import warnings

import jax
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.meta import outer as jouter
from howtotrainyourmamlpytorch_tpu.models import make_model as jax_model
from howtotrainyourmamlpytorch_tpu.utils.checkpoint import (
    CheckpointManager as JaxManager)
from howtotrainyourmamlpytorch_tpu_torch.ckpt.writer import CheckpointWriter
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.convert import (state_from_jax,
                                                         state_to_jax,
                                                         to_state_dict)
from howtotrainyourmamlpytorch_tpu_torch.meta import outer
from howtotrainyourmamlpytorch_tpu_torch.utils import checkpoint as ckpt_mod
from howtotrainyourmamlpytorch_tpu_torch.utils import msgpack
from howtotrainyourmamlpytorch_tpu_torch.utils.checkpoint import (
    LATEST, CheckpointManager, CorruptCheckpointError)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(dataset_name="synthetic", image_height=12, image_width=12,
             image_channels=3, num_classes_per_set=2,
             num_samples_per_class=2, num_target_samples=2,
             cnn_num_filters=8, num_stages=2,
             number_of_training_steps_per_iter=2,
             number_of_evaluation_steps_per_iter=2, batch_size=4)
VAL_ACCS = (0.5, 0.7, 0.6, 0.9, 0.4, 0.7)


def _random_jax_state(seed=0, **kw):
    """A JAX ``MetaTrainState`` of the tiny VGG with every float leaf
    random and both Adam counts and the step set to ``7 + seed``."""
    jcfg = JaxConfig(**{**SMALL, **kw})
    init, _ = jax_model(jcfg)
    js = jax.device_get(jouter.init_train_state(jcfg, init,
                                                jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            return rng.standard_normal(x.shape).astype(x.dtype)
        return np.full(x.shape, 7 + seed, x.dtype)
    return jcfg, jax.tree.map(fill, js)


def _port(js):
    return state_from_jax(js.params, js.lslr, js.bn_state, int(js.step),
                          device="cpu", opt_state=js.opt_state)


def _assert_jax_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _assert_port_equal(a, b):
    ta, tb = outer._state_trees(a), outer._state_trees(b)
    flat_a = dict(outer.state_leaf_shapes(a))
    assert flat_a == dict(outer.state_leaf_shapes(b))
    for key in ("params", "lslr", "bn_state"):
        for layer, sub in ta[key].items():
            for leaf, t in sub.items():
                assert torch.equal(t, tb[key][layer][leaf]), (key, layer,
                                                              leaf)
    for name in ("mu", "nu"):
        for top in ("params", "lslr"):
            for layer, sub in getattr(a.opt_state, name)[top].items():
                for leaf, t in sub.items():
                    assert torch.equal(
                        t, getattr(b.opt_state, name)[top][layer][leaf])
    assert a.opt_state.count == b.opt_state.count and a.step == b.step


# ---------------------------------------------------------------------------
# the msgpack codec
# ---------------------------------------------------------------------------

def test_msgpack_codec_matches_flax():
    """The port's bytes for a JAX state are flax's bytes; flax's bytes
    decode in the port, and the port's with ``msgpack_restore``, to equal
    arrays."""
    _, js = _random_jax_state(1)
    flax_bytes = serialization.to_bytes(js)
    port_bytes = msgpack.packb(to_state_dict(_port(js)))
    assert port_bytes == flax_bytes
    want = serialization.to_state_dict(js)
    _assert_jax_equal(msgpack.unpackb(flax_bytes), want)
    _assert_jax_equal(serialization.msgpack_restore(port_bytes), want)
    assert np.asarray(msgpack.unpackb(flax_bytes)["step"]).shape == ()


def test_msgpack_codec_scalars_and_limits():
    """Every msgpack form the codec writes round-trips through flax's
    msgpack; trailing bytes and flax's chunked arrays raise."""
    tree = {"ints": [0, 127, 128, 255, 256, 65536, 2 ** 32, -1, -32, -33,
                     -129, -40000, -2 ** 40],
            "misc": [1.25, -0.0, None, True, False, "x" * 40, b"q" * 300,
                     "é"],
            "arrays": {str(i): np.arange(i, dtype=np.float64)
                       for i in range(18)},
            "zero_d": np.array(3, np.int32), "scalar": np.int32(4)}
    port = msgpack.packb(tree)
    assert port == serialization.msgpack_serialize(tree, in_place=True)
    back = msgpack.unpackb(port)
    assert back["ints"] == tree["ints"] and back["misc"][:5] == [
        1.25, -0.0, None, True, False]
    assert back["misc"][5:] == ["x" * 40, b"q" * 300, "é"]
    assert back["scalar"].shape == () and int(back["scalar"]) == 4
    with pytest.raises(msgpack.MsgpackError, match="trailing"):
        msgpack.unpackb(port + b"\x00")
    chunked = serialization.msgpack_serialize(
        {"a": {"__msgpack_chunked_array__": True, "shape": {"0": 1}}})
    with pytest.raises(msgpack.MsgpackError, match="chunked"):
        msgpack.unpackb(chunked)


# ---------------------------------------------------------------------------
# cross-loading
# ---------------------------------------------------------------------------

def test_jax_checkpoint_loads_in_the_port_bitwise(tmp_path):
    """JAX ``CheckpointManager.save`` → port ``load`` equals
    ``convert.state_from_jax`` of the saved state, bit for bit: HWIO →
    OIHW and (in, out) → (out, in) in the weights and in Adam's ``mu`` /
    ``nu``, both counts and the step."""
    _, js = _random_jax_state(2)
    JaxManager(str(tmp_path)).save(js, 0, 5, 0.5)
    mgr = CheckpointManager(str(tmp_path))
    template = _port(_random_jax_state(3)[1])
    got, meta = mgr.load(template, 0)
    _assert_port_equal(got, _port(js))
    assert got.step == 9 and got.opt_state.count == 9
    assert meta["current_iter"] == 5
    latest, _ = mgr.load(template, LATEST)
    _assert_port_equal(latest, got)


def test_port_checkpoint_loads_in_jax_bitwise(tmp_path):
    """Port ``save`` → JAX ``CheckpointManager.load(template)`` equals the
    source JAX state bit for bit; the file bytes are those the JAX
    package writes for that state, so the manifests match too."""
    jcfg, js = _random_jax_state(4)
    CheckpointManager(str(tmp_path / "port")).save(_port(js), 0, 5, 0.5)
    JaxManager(str(tmp_path / "jax")).save(js, 0, 5, 0.5)
    init, _ = jax_model(jcfg)
    template = jouter.init_train_state(jcfg, init, jax.random.PRNGKey(0))
    got, meta = JaxManager(str(tmp_path / "port")).load(template, LATEST)
    _assert_jax_equal(jax.device_get(got), js)
    assert meta["current_iter"] == 5
    for name in ("train_model_0.ckpt", "MANIFEST.json", "state.json"):
        with open(tmp_path / "port" / name, "rb") as a, \
                open(tmp_path / "jax" / name, "rb") as b:
            assert a.read() == b.read(), name
    # The JAX package's jax-free admin CLI verifies the port's directory.
    out = subprocess.run([sys.executable,
                          os.path.join(REPO, "scripts", "ckpt_admin.py"),
                          "verify", str(tmp_path / "port")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1])["ok"] is True


def test_missing_or_extra_key_raises(tmp_path):
    """Restore is guided by the template by key name: a checkpoint with a
    layer the template lacks, or without one it has, raises."""
    _, js = _random_jax_state(5)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_port(js), 0, 1, 0.5)
    _, other = _random_jax_state(5, num_stages=3)
    with pytest.raises(ValueError, match="do not match"):
        mgr.load(_port(other), 0)


def test_state_to_jax_inverts_state_from_jax():
    _, js = _random_jax_state(6)
    st = _port(js)
    params, lslr, bn, opt, step = state_to_jax(st)
    _assert_jax_equal(params, jax.device_get(js.params))
    _assert_jax_equal(lslr, js.lslr)
    _assert_jax_equal(bn, js.bn_state)
    assert step.dtype == np.int32 and int(step) == int(js.step)
    _assert_jax_equal(opt, serialization.to_state_dict(js.opt_state))
    _assert_port_equal(state_from_jax(params, lslr, bn, int(step),
                                      device="cpu", opt_state=opt), st)


# ---------------------------------------------------------------------------
# damage, the manifest, retention
# ---------------------------------------------------------------------------

def _two_epochs(directory):
    mgr = CheckpointManager(str(directory))
    states = [_port(_random_jax_state(s)[1]) for s in (7, 8)]
    for epoch, st in enumerate(states):
        mgr.save(st, epoch, 5 * (epoch + 1), 0.5 + 0.1 * epoch)
    return mgr, states


def test_flipped_byte_raises_and_fallback_quarantines(tmp_path):
    """A flipped payload byte raises ``CorruptCheckpointError``; 'latest'
    is a hard link to epoch 1, so the fallback quarantines both and
    resumes from epoch 0, whose bookkeeping it keeps."""
    mgr, states = _two_epochs(tmp_path)
    path = mgr.path(LATEST)
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(CorruptCheckpointError, match="CRC"):
        mgr.load(states[0], LATEST)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got, meta, tag = CheckpointManager(
            str(tmp_path)).load_latest_or_fallback(states[1])
    assert tag == 0 and meta["current_iter"] == 5
    _assert_port_equal(got, states[0])
    assert any("unreadable" in str(r.message) for r in rec)
    assert os.path.exists(path + ".corrupt")
    assert os.path.exists(str(tmp_path / "train_model_1.ckpt.corrupt"))
    with open(tmp_path / "state.json") as f:
        assert "1" not in json.load(f)["iter_at_epoch"]


def test_pending_manifest_record_is_skipped_without_a_read(tmp_path,
                                                          monkeypatch):
    """A 'latest' whose manifest record is still pending (a writer killed
    mid-save) is skipped without reading it and without quarantine by a
    reader; the newest committed epoch loads instead."""
    mgr, states = _two_epochs(tmp_path)
    mgr.manifest.begin(LATEST, iteration=12)
    # A reader that does not sweep (the writer's sweep drops the record).
    mgr = CheckpointManager(str(tmp_path), quarantine=False)
    reads = []
    real = ckpt_mod._read_bytes
    monkeypatch.setattr(ckpt_mod, "_read_bytes",
                        lambda p: reads.append(os.path.basename(p))
                        or real(p))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got, _, tag = mgr.load_latest_or_fallback(states[0])
    assert tag == 1 and reads == ["train_model_1.ckpt"]
    _assert_port_equal(got, states[1])
    assert os.path.exists(mgr.path(LATEST))
    # The writer's startup sweep drops the pending record.
    with pytest.warns(UserWarning, match="pending record"):
        CheckpointManager(str(tmp_path))
    with open(tmp_path / "MANIFEST.json") as f:
        assert LATEST not in json.load(f)["records"]


def test_pruning_and_rewind_match_the_jax_manager(tmp_path):
    """The same val accuracies keep the same top-k files in both
    packages, and ``rewind_to`` leaves the same bookkeeping."""
    _, js = _random_jax_state(9)
    st = _port(js)
    port = CheckpointManager(str(tmp_path / "port"), max_to_keep=3)
    ref = JaxManager(str(tmp_path / "jax"), max_to_keep=3)
    for epoch, acc in enumerate(VAL_ACCS):
        port.save(st, epoch, 10 * (epoch + 1), acc)
        ref.save(js, epoch, 10 * (epoch + 1), acc)
        assert (sorted(os.listdir(tmp_path / "port"))
                == sorted(os.listdir(tmp_path / "jax")))
    assert port.top_epochs() == ref.top_epochs() == [3, 5, 1]
    port.rewind_to(3)
    ref.rewind_to(3)
    for name in ("state.json", "MANIFEST.json"):
        with open(tmp_path / "port" / name) as a, \
                open(tmp_path / "jax" / name) as b:
            assert json.load(a) == json.load(b), name
    assert port.meta["current_iter"] == 40 and port.top_epochs() == [3, 1,
                                                                     2]
    with pytest.raises(KeyError):
        port.rewind_to(4)


@pytest.mark.parametrize("async_saves", [False, True],
                         ids=["sync", "async"])
def test_writer_publishes_to_the_registry(tmp_path, async_saves):
    """Each epoch save publishes a live version with the file's
    fingerprint, read by the JAX package's registry; pruned epochs are
    retired. The async writer (``ckpt_async=1``, the JAX package's
    ``CheckpointWriter``) publishes from its thread after the files are
    committed, and writes the bytes the synchronous one writes."""
    from howtotrainyourmamlpytorch_tpu.ckpt.registry import ModelRegistry
    _, js = _random_jax_state(10)
    mgr = CheckpointManager(str(tmp_path / "w"), max_to_keep=1)
    writer = CheckpointWriter(mgr, async_saves=async_saves, publish=True)
    writer.save(_port(js), 0, 5, 0.5)
    writer.save(_port(js), 1, 10, 0.7)
    writer.close()
    assert writer.last_save_bytes == os.path.getsize(mgr.path(1))
    reg = ModelRegistry(str(tmp_path / "w"))
    assert [(v["tag"], v["status"]) for v in reg.versions] == [
        ("0", "retired"), ("1", "live")]
    assert reg.latest()["fingerprint"] == mgr.fingerprint(1)
    ref = JaxManager(str(tmp_path / "jax"), max_to_keep=1)
    ref.save(js, 0, 5, 0.5)
    ref.save(js, 1, 10, 0.7)
    for name in ("train_model_1.ckpt", "train_model_latest.ckpt",
                 "MANIFEST.json", "state.json"):
        assert ((tmp_path / "w" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    with pytest.raises(ValueError):
        CheckpointWriter(mgr, async_saves=True, queue_policy="drop")


# ---------------------------------------------------------------------------
# load-time shape helpers
# ---------------------------------------------------------------------------

def _trim_lslr(js, rows):
    """``js`` with every LSLR vector and its Adam moments cut to
    ``rows``."""
    cut = lambda t: jax.tree.map(lambda x: np.asarray(x)[:rows], t)
    adam, sched = js.opt_state
    adam = adam._replace(mu={**adam.mu, "lslr": cut(adam.mu["lslr"])},
                         nu={**adam.nu, "lslr": cut(adam.nu["lslr"])})
    return js.replace(lslr=cut(js.lslr), opt_state=(adam, sched))


def test_migrate_lslr_rows_matches_jax():
    jcfg, js = _random_jax_state(11)
    cfg = MAMLConfig(**SMALL)
    k = cfg.lslr_num_steps
    old = _trim_lslr(js, k - 1)
    want = jax.device_get(jouter.migrate_lslr_rows(jcfg, old))
    got = outer.migrate_lslr_rows(cfg, _port(old))
    _assert_port_equal(got, _port(want))
    assert got.lslr["conv0"]["w"].shape == (k,)
    same = _port(js)
    assert outer.migrate_lslr_rows(cfg, same) is same
    bad = _trim_lslr(js, k - 2)
    with pytest.raises(ValueError, match="refusing"):
        jouter.migrate_lslr_rows(jcfg, bad)
    with pytest.raises(ValueError, match="refusing"):
        outer.migrate_lslr_rows(cfg, _port(bad))


def _ln_state(gamma_shape, conv_shape=(3, 3, 3, 8)):
    """A hand-built JAX state with one layer-norm γ/β of
    ``gamma_shape``, old or current format (the model-built case is in
    tests/test_torch_port_backbones.py)."""
    rng = np.random.default_rng(12)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    params = {"conv0": {"w": r(*conv_shape), "b": r(conv_shape[-1])},
              "norm0": {"gamma": r(*gamma_shape), "beta": r(*gamma_shape)},
              "linear": {"w": r(32, 2), "b": r(2)}}
    lslr = {"conv0": {"w": r(3), "b": r(3)}, "linear": {"w": r(3),
                                                        "b": r(3)}}
    moments = lambda: {"params": jax.tree.map(lambda x: r(*x.shape), params),
                       "lslr": jax.tree.map(lambda x: r(*x.shape), lslr)}
    count = np.array(4, np.int32)
    opt = (optax.ScaleByAdamState(count=count, mu=moments(), nu=moments()),
           optax.ScaleByScheduleState(count=count))
    return jouter.MetaTrainState(params=params, lslr=lslr,
                                 bn_state={"norm0": {"mean": r(2, 8)}},
                                 opt_state=opt, step=count)


def test_reconcile_loaded_shapes_matches_jax():
    """The per-channel (1, C) layer-norm γ/β of an old checkpoint is
    broadcast to (1, H, W, C) in the parameters and both moments, as the
    JAX package does; any other mismatch refuses in both."""
    kw = dict(SMALL, norm_layer="layer_norm")
    jcfg, cfg = JaxConfig(**kw), MAMLConfig(**kw)
    template, old = _ln_state((1, 4, 4, 8)), _ln_state((1, 8))
    jshapes = jouter.state_leaf_shapes(template)
    want = jax.device_get(jouter.reconcile_loaded_shapes(jcfg, old, jshapes))
    pshapes = outer.state_leaf_shapes(_port(template))
    got = outer.reconcile_loaded_shapes(cfg, _port(old), pshapes)
    _assert_port_equal(got, _port(want))
    assert got.params["norm0"]["gamma"].shape == (1, 4, 4, 8)
    wrong = _ln_state((1, 4, 4, 8), conv_shape=(3, 3, 3, 6))
    with pytest.raises(ValueError, match="refusing"):
        jouter.reconcile_loaded_shapes(jcfg, wrong, jshapes)
    with pytest.raises(ValueError, match="refusing"):
        outer.reconcile_loaded_shapes(cfg, _port(wrong), pshapes)


# ---------------------------------------------------------------------------
# the storage helpers around the checkpoint
# ---------------------------------------------------------------------------

def test_retry_and_guard_match_jax(monkeypatch):
    """``backoff_delay`` and ``DivergenceGuard`` decide as the JAX
    package's do; ``retry_io`` retries a transient ``OSError`` and gives
    up on a missing file at once."""
    import random
    from howtotrainyourmamlpytorch_tpu.resilience import (
        DivergenceGuard as JaxGuard, backoff_delay as jax_backoff)
    from howtotrainyourmamlpytorch_tpu_torch.resilience import (
        DivergenceGuard, backoff_delay, retry)
    for attempt in range(8):
        assert backoff_delay(attempt, rng=random.Random(attempt)) == \
            jax_backoff(attempt, rng=random.Random(attempt))
    losses = [1.0, 0.9, 0.95, 0.8, 0.85, 0.9, 9.0, 0.7, float("nan"),
              float("inf"), 0.6, 30.0, 40.0, 0.5]
    ours, ref = DivergenceGuard(2, 3.0), JaxGuard(2, 3.0)
    assert ([ours.observe(x, i) for i, x in enumerate(losses)]
            == [ref.observe(x, i) for i, x in enumerate(losses)])
    monkeypatch.setattr(retry.time, "sleep", lambda s: None)
    calls = []

    @retry.retry_io("flaky")
    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert flaky() == "ok" and len(calls) == 3

    @retry.retry_io("missing")
    def missing():
        calls.append(1)
        raise FileNotFoundError("gone")
    with pytest.raises(FileNotFoundError):
        missing()
    assert len(calls) == 4


def test_event_log_and_step_timer_match_jax(tmp_path):
    """NaN/Inf are written as null, the size cap rotates into one spare,
    and the step timer's nearest-rank quantiles are the JAX package's."""
    from howtotrainyourmamlpytorch_tpu.utils.tracing import (
        StepTimer as JaxTimer)
    from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import (
        JsonlLogger, StepTimer, read_jsonl)
    log = JsonlLogger(str(tmp_path / "events.jsonl"), max_bytes=300)
    log.log("a", loss=float("nan"), acc=np.float32(0.5),
            t=torch.tensor(2.0), v=[float("inf"), 1])
    (row,) = read_jsonl(str(tmp_path / "events.jsonl"))
    assert row["loss"] is None and row["acc"] == 0.5 and row["t"] == 2.0
    assert row["v"] == [None, 1]
    for i in range(5):
        log.log("b", i=i, pad="x" * 50)
    assert os.path.exists(str(tmp_path / "events.jsonl.1"))
    ours, ref = StepTimer(), JaxTimer()
    ours._durations = [0.3, 0.1, 0.2, 0.5, 0.4, 0.25, 0.15]
    ref._durations = list(ours._durations)
    got, want = ours.summary(12), ref.summary(12)
    assert {k: got[k] for k in want} == want


def test_async_writer_queue_policies_and_write_errors(tmp_path):
    """The depth-1 queue (the JAX writer's): with one write in flight and
    one waiting, a third save is skipped under ``skip`` (counted, its
    bookkeeping kept) and waits under ``block`` (counted as blocked
    seconds); a failed background write is counted and warned, and the
    worker goes on."""
    import threading
    import time
    from howtotrainyourmamlpytorch_tpu_torch import resilience
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import MetricsRegistry
    _, js = _random_jax_state(11)
    reg = MetricsRegistry()
    prev = resilience.set_registry(reg)
    try:
        for policy in ("skip", "block"):
            mgr = CheckpointManager(str(tmp_path / policy), max_to_keep=5)
            gate, real = threading.Event(), mgr.write_epoch_files

            def gated(*a, **k):
                gate.wait(10)
                return real(*a, **k)
            mgr.write_epoch_files = gated
            writer = CheckpointWriter(mgr, async_saves=True,
                                      queue_policy=policy)
            writer.save(_port(js), 0, 5, 0.5)
            deadline = time.monotonic() + 5
            while writer._queue.qsize() and time.monotonic() < deadline:
                time.sleep(0.01)  # the worker took epoch 0
            writer.save(_port(js), 1, 10, 0.6)
            if policy == "skip":
                with pytest.warns(UserWarning, match="skipped epoch 2"):
                    writer.save(_port(js), 2, 15, 0.7)
                gate.set()
            else:
                threading.Timer(0.3, gate.set).start()
                writer.save(_port(js), 2, 15, 0.7)
            writer.close()
            on_disk = [e for e in range(3) if mgr.has_checkpoint(e)]
            assert on_disk == ([0, 1] if policy == "skip" else [0, 1, 2])
            assert sorted(mgr.meta["iter_at_epoch"]) == ["0", "1", "2"]
        snap = reg.snapshot()
        assert snap["ckpt/skipped_saves"] == 1.0
        assert snap["ckpt/blocked_seconds"] > 0.1
        mgr = CheckpointManager(str(tmp_path / "err"))

        def broken(*a, **k):
            raise OSError("disk gone")
        mgr.write_epoch_files = broken
        writer = CheckpointWriter(mgr, async_saves=True)
        with pytest.warns(UserWarning, match="async checkpoint write failed"):
            writer.save(_port(js), 0, 5, 0.5)
            writer.drain()
        assert writer.last_error == "OSError: disk gone"
        writer.close()
        assert reg.snapshot()["ckpt/write_errors"] == 1.0
    finally:
        resilience.set_registry(prev)
