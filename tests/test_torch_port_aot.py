"""The port's warm-start store (``parallel/aot.py``) against the JAX
package's, on the CPU.

The port's executables are CUDA graphs, which need the card: here the
store layer runs through an injected capture function, and the card's
capture and replay are held by ``tests/test_torch_port_cuda.py`` and
``chip_smoke.py`` phases 2 and 14. Held here:

* the fingerprint moves for exactly the config changes that move the JAX
  package's, and stays put for its runtime-only keys, on every shipped
  JSON; the executable names are the JAX module's;
* the store's contract, case by case as ``tests/test_aot.py`` holds the
  JAX one: round trip and counters, a foreign fingerprint, a corrupt
  record quarantined, an unwritable root, ``GuardedExec`` demotion, GC
  and the co-writer sweep (the last two on both packages' stores over
  the same directory layout);
* the tensor-valued step scalars (``meta/outer.py § StepScalars``) give
  today's meta-LR, Adam bias corrections and MSL weights, bitwise, over
  counts 0-12 and epochs 0-60, and an Adam step through them is bitwise
  the Python-number formula;
* the BN kernel's launch counter under capture and replay, with a stub
  graph; the prewarm script's refusal on the CPU; the CPU refusal of
  ``aot_store_dir`` by the trainer and the engine.
"""

import dataclasses
import glob
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.parallel import aot as jaot
from howtotrainyourmamlpytorch_tpu.parallel.mesh import make_mesh
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.meta import inner, outer
from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
from howtotrainyourmamlpytorch_tpu_torch.parallel import aot
from howtotrainyourmamlpytorch_tpu_torch.telemetry.registry import (
    MetricsRegistry)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "experiment_config",
                                        "*.json")))
FLAGSHIP = os.path.join(REPO, "experiment_config",
                        "mini-imagenet_maml++_5-way_5-shot_DA_b12.json")
RUNTIME_KW = (dict(experiment_name="other"),
              dict(continue_from_epoch="latest"),
              dict(watchdog_step_timeout_s=5.0), dict(ckpt_async=1),
              dict(aot_store_dir="/elsewhere"),
              dict(compilation_cache_dir="/cache"),
              dict(dispatch_sync_every=7))
STRUCTURAL_KW = (dict(cnn_num_filters=8), dict(meta_learning_rate=0.02),
                 dict(number_of_training_steps_per_iter=2),
                 dict(health_metrics_every_n_steps=1),
                 dict(transfer_images_uint8=False))


def _load(path):
    with open(path) as f:
        doc = json.load(f)
    return MAMLConfig.from_dict(doc), JaxConfig.from_dict(doc)


def _fingerprints(port_cfg, jax_cfg):
    mesh = make_mesh(jax_cfg.replace(mesh_shape=(1, 1)), jax.devices()[:1])
    return (aot.store_fingerprint(port_cfg, "cpu"),
            jaot.store_fingerprint(jax_cfg, mesh))


def test_runtime_only_keys_are_the_jax_modules():
    assert aot._RUNTIME_ONLY_KEYS == jaot._RUNTIME_ONLY_KEYS
    fields = {f.name for f in dataclasses.fields(MAMLConfig)}
    assert aot._RUNTIME_ONLY_KEYS <= fields


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_fingerprint_moves_with_the_jax_one(path):
    """Per shipped JSON: each runtime-only change leaves both
    fingerprints put, each structural change moves both."""
    p_cfg, j_cfg = _load(path)
    p0, j0 = _fingerprints(p_cfg, j_cfg)
    assert aot.store_fingerprint(p_cfg, "cpu") == p0   # deterministic
    for kw in RUNTIME_KW + STRUCTURAL_KW:
        p1, j1 = _fingerprints(p_cfg.replace(**kw), j_cfg.replace(**kw))
        assert (p1 == p0) == (j1 == j0), kw
        (key, value), = kw.items()
        if kw in RUNTIME_KW:
            assert p1 == p0, kw
        elif getattr(p_cfg, key) != value:   # a change, not a no-op
            assert p1 != p0, kw


def test_fingerprint_doc_hashes_the_jax_config_part():
    """The structural config the port hashes is the JAX module's, key
    for key; what stands beside it is the port's (torch, CUDA, cuDNN,
    the device, the world size, the layout)."""
    p_cfg, j_cfg = _load(FLAGSHIP)
    mesh = make_mesh(j_cfg.replace(mesh_shape=(1, 1)), jax.devices()[:1])
    pdoc = aot.fingerprint_doc(p_cfg, "cpu")
    jdoc = jaot.fingerprint_doc(j_cfg, mesh)
    assert json.dumps(pdoc["config"], sort_keys=True, default=str) == \
        json.dumps(jdoc["config"], sort_keys=True, default=str)
    assert {"torch", "cuda", "cudnn", "device_name", "world_size",
            "layout"} <= set(pdoc)
    assert aot.store_fingerprint(p_cfg, "cpu", world_size=2) != \
        aot.store_fingerprint(p_cfg, "cpu")


@pytest.mark.parametrize("arg", [(False, True), (True, False), (1, 0)])
def test_executable_names_are_the_jax_modules(arg):
    assert aot.train_exec_name(arg) == jaot.train_exec_name(arg)
    n = 25 + arg[0]
    assert aot.serve_adapt_name(n) == jaot.serve_adapt_name(n)
    assert aot.serve_predict_name(n) == jaot.serve_predict_name(n)


# ---------------------------------------------------------------------------
# The store contract, through an injected capture function.


class StubExec:
    """What a capture returns: called like the step, with a record."""

    def __init__(self, fn, launches=3, reject=False):
        self.fn, self.launches, self.reject = fn, launches, reject
        self.calls = 0

    def record(self):
        return {"name": "stub", "signature": None, "launches": self.launches,
                "capture_seconds": 0.0}

    def __call__(self, *args):
        if self.reject:
            raise TypeError("captured for another signature")
        self.calls += 1
        return self.fn(*args)


SIG = aot.signature_of(torch.zeros(4), {"w": torch.zeros(2, 3)})


def test_store_roundtrip_and_counters(tmp_path):
    reg = MetricsRegistry()
    store = aot.AOTStore(str(tmp_path / "store"), "ab" * 32, doc={"k": 1},
                         registry=reg)
    assert store.writable and store.readable
    captures = []

    def capture():
        captures.append(1)
        return StubExec(lambda x: x * 2)

    fn, hit = aot.load_or_compile(store, "double", capture, SIG,
                                  registry=reg, fallback=lambda x: x)
    assert not hit and len(captures) == 1
    assert torch.equal(fn(torch.ones(4)), 2 * torch.ones(4))
    rec = store.manifest.get("double")
    assert rec["status"] == "committed" and rec["bytes"] > 0
    record = store.load("double", count=False)
    assert record["signature"] == SIG and record["launches"] == 3
    # A second process's store on the same root: a hit, captured from
    # the record, nothing written.
    store2 = aot.AOTStore(str(tmp_path / "store"), "ab" * 32, doc={"k": 1},
                          registry=reg)
    fn2, hit2 = aot.load_or_compile(store2, "double", capture, SIG,
                                    registry=reg, fallback=lambda x: x)
    assert hit2 and len(captures) == 2
    assert reg.counter(aot.HITS).value == 1
    assert reg.counter(aot.MISSES).value == 1
    assert reg.counter(aot.SAVE_SECONDS).value > 0
    assert reg.counter(aot.COMPILE_SECONDS).value >= 0
    assert reg.counter(aot.LOAD_SECONDS).value > 0
    # Another signature under the same name is a miss, recorded anew.
    other = aot.signature_of(torch.zeros(5))
    _, hit3 = aot.load_or_compile(store2, "double", capture, other)
    assert not hit3
    assert store2.load("double", count=False)["signature"] == other
    assert reg.counter(aot.MISSES).value == 2
    # compile_on_miss=False: nothing captured, the fallback returned.
    fb = lambda x: x  # noqa: E731
    out, hit4 = aot.load_or_compile(store2, "absent", capture, SIG,
                                    fallback=fb, compile_on_miss=False)
    assert out is fb and not hit4 and len(captures) == 3
    # The subsystem off: the fallback itself.
    assert aot.load_or_compile(None, "x", capture, SIG, fallback=fb) == (
        fb, False)


def test_foreign_fingerprint_is_counted_miss_never_a_load(tmp_path):
    root = str(tmp_path / "store")
    store = aot.AOTStore(root, "aa" * 32, doc={})
    assert store.save("x", StubExec(lambda x: x).record())
    with open(os.path.join(store.dir, aot.STORE_FILE), "w") as f:
        json.dump({"fingerprint": "bb" * 32}, f)   # hand-copied dir
    reg = MetricsRegistry()
    with pytest.warns(UserWarning, match="fingerprint"):
        foreign = aot.AOTStore(root, "aa" * 32, doc={}, registry=reg)
    assert not foreign.readable and not foreign.writable
    assert foreign.load("x") is None
    assert not foreign.save("y", {"launches": 0})
    # One for the foreign directory, one for the save it refused.
    assert reg.counter(aot.ERRORS).value == 2
    assert reg.counter(aot.MISSES).value == 1


def test_corrupt_record_quarantined_and_recaptured(tmp_path):
    reg = MetricsRegistry()
    store = aot.AOTStore(str(tmp_path / "store"), "cc" * 32, doc={},
                         registry=reg)
    assert store.save("x", StubExec(lambda x: x).record())
    path = os.path.join(store.dir, store.manifest.get("x")["file"])
    with open(path, "r+b") as f:
        f.seek(3)
        f.write(b"#")   # a flipped byte: the CRC fails
    assert store.load("x") is None
    assert reg.counter(aot.QUARANTINED).value == 1
    assert os.path.exists(path + ".corrupt") and not os.path.exists(path)
    assert store.manifest.get("x") is None
    # The next adoption captures and records it again.
    _, hit = aot.load_or_compile(store, "x",
                                 lambda: StubExec(lambda x: x), SIG)
    assert not hit and store.manifest.get("x")["status"] == "committed"


def test_unparsable_record_is_a_counted_miss(tmp_path):
    """Bytes whose CRC matches but which are no record (written by hand):
    quarantined, an error and a miss, never an exception."""
    reg = MetricsRegistry()
    store = aot.AOTStore(str(tmp_path / "store"), "c1" * 32, doc={},
                         registry=reg)
    payload = b"not json"
    name = "x"
    path = os.path.join(store.dir, f"{name}{aot.RECORD_SUFFIX}")
    with open(path, "wb") as f:
        f.write(payload)
    store.manifest.begin(name, flush=False)["file"] = os.path.basename(path)
    import zlib
    store.manifest.commit(name, nbytes=len(payload), crc=zlib.crc32(payload))
    assert store.load(name) is None
    assert reg.counter(aot.ERRORS).value == 1
    assert reg.counter(aot.QUARANTINED).value == 1


def test_unwritable_store_root_degrades_to_the_eager_step(tmp_path):
    root = tmp_path / "not_a_dir"
    root.write_text("occupied")
    reg = MetricsRegistry()
    store = aot.AOTStore(str(root), "dd" * 32, doc={}, registry=reg)
    assert not store.writable and not store.readable
    assert store.load("x") is None
    assert not store.save("x", {"launches": 0})
    assert reg.counter(aot.MISSES).value == 1
    assert reg.counter(aot.ERRORS).value >= 1
    # load_or_compile still gives a working executable.
    fn, hit = aot.load_or_compile(store, "x",
                                  lambda: StubExec(lambda x: x + 1), SIG)
    assert not hit and torch.equal(fn(torch.zeros(2)), torch.ones(2))


def test_failed_capture_leaves_the_eager_step(tmp_path):
    reg = MetricsRegistry()
    store = aot.AOTStore(str(tmp_path / "store"), "d1" * 32, doc={},
                         registry=reg)

    def capture():
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    fb = lambda x: x  # noqa: E731
    assert aot.load_or_compile(store, "x", capture, SIG, registry=reg,
                               fallback=fb) == (fb, False)
    assert reg.counter(aot.ERRORS).value == 1
    assert store.manifest.get("x") is None


def test_guarded_exec_demotes_on_signature_mismatch():
    reg = MetricsRegistry()
    stub = StubExec(lambda x: x * 2)
    guarded = aot.GuardedExec(stub, lambda x: x * 3, "t", registry=reg)
    assert torch.equal(guarded(torch.ones(4)), 2 * torch.ones(4))
    stub.reject = True
    with pytest.warns(UserWarning, match="demoted"):
        out = guarded(torch.ones(8))
    assert torch.equal(out, 3 * torch.ones(8))
    assert reg.counter(aot.EXEC_FALLBACKS).value == 1
    assert guarded.compiled is None
    assert torch.equal(guarded(torch.ones(2)), 3 * torch.ones(2))
    assert stub.calls == 1


def _fingerprint_dirs(root, store_file):
    for i in range(6):
        d = root / f"{i:02d}fingerprint0000"
        d.mkdir(parents=True)
        with open(d / store_file, "w") as f:
            json.dump({"fingerprint": f"{i:02d}" * 32}, f)
        stamp = time.time() - aot.GC_MIN_AGE_S - (600 - 60 * i)
        os.utime(d, (stamp, stamp))
    fresh = root / "fffresh000000000"
    fresh.mkdir()
    with open(fresh / store_file, "w") as f:
        json.dump({"fingerprint": "f0" * 32}, f)


def test_gc_keeps_what_the_jax_store_keeps(tmp_path):
    """The same directory layout, GC'd by each package's store: the same
    directories survive (the newest stale ones up to the budget, and a
    fresh neighbour whatever its age rank)."""
    kept = {}
    for pkg, mod in (("port", aot), ("jax", jaot)):
        root = tmp_path / pkg
        _fingerprint_dirs(root, mod.STORE_FILE)
        mod.AOTStore(str(root), "ee" * 32, doc={})
        kept[pkg] = sorted(os.listdir(root))
    assert kept["port"] == kept["jax"]
    assert "00fingerprint0000" not in kept["port"]
    assert "05fingerprint0000" in kept["port"]
    assert "fffresh000000000" in kept["port"]
    assert len(kept["port"]) == aot.GC_KEEP_FINGERPRINTS + 1


def test_sweep_spares_a_live_cowriter_like_the_jax_store(tmp_path,
                                                          monkeypatch):
    """A tmp whose pid is alive survives the startup sweep, so does a
    young one of a dead pid (another host's writer); old wreckage and
    pending records go: the same on both packages' stores."""
    dead_pid = 987654321
    real_kill = os.kill

    def fake_kill(pid, sig):
        if pid == dead_pid:
            raise ProcessLookupError(pid)
        return real_kill(pid, sig)

    survivors = {}
    for pkg, mod in (("port", aot), ("jax", jaot)):
        monkeypatch.setattr(mod.os, "kill", fake_kill)
        root = str(tmp_path / pkg)
        store = mod.AOTStore(root, "ab" * 32, doc={})
        store.manifest.begin("half", flush=True)   # a killed save
        paths = {"live": f"x.tmp.{os.getpid()}",
                 "dead_old": f"y.tmp.{dead_pid}",
                 "dead_young": f"z.tmp.{dead_pid}"}
        for name in paths.values():
            with open(os.path.join(store.dir, name), "wb") as f:
                f.write(b"half-written")
        old = time.time() - aot.SWEEP_TMP_GRACE_S - 60
        for key in ("dead_old", "live"):
            os.utime(os.path.join(store.dir, paths[key]), (old, old))
        again = mod.AOTStore(root, "ab" * 32, doc={})
        survivors[pkg] = (sorted(k for k, n in paths.items()
                                 if os.path.exists(os.path.join(
                                     store.dir, n))),
                          again.manifest.get("half"))
    assert survivors["port"] == survivors["jax"] == (
        ["dead_young", "live"], None)


def test_flatten_round_trip_and_signature():
    state = outer.MetaTrainState(
        params={"b": {"w": torch.ones(2)}, "a": {"w": torch.zeros(3)}},
        lslr={}, bn_state={"n": {"mean": torch.zeros(1)}},
        opt_state=outer.AdamState(count=3, mu={}, nu={}), step=7)
    leaves, spec = aot.flatten((state, [torch.ones(1)], None))
    back = aot.unflatten(spec, leaves)
    assert back[0].opt_state.count == 3 and back[0].step == 7
    assert back[2] is None and torch.equal(back[1][0], torch.ones(1))
    # dict order does not matter; shapes and dtypes do.
    swapped = dataclasses.replace(state, params={"a": state.params["a"],
                                                 "b": state.params["b"]})
    assert aot.signature_of(swapped) == aot.signature_of(state)
    assert aot._structure(aot.flatten(swapped)[1]) == aot._structure(
        aot.flatten(state)[1])
    assert aot.signature_of(torch.zeros(2, dtype=torch.uint8)) == [
        [[2], "uint8"]]


def test_zero_episode_has_the_loaders_wire_dtypes():
    from howtotrainyourmamlpytorch_tpu_torch.data.loader import (
        MetaLearningDataLoader)
    cfg = MAMLConfig.from_json_file(FLAGSHIP).replace(
        image_height=8, image_width=8)
    ep = aot.zero_episode(cfg, 3, "cpu")
    want = MetaLearningDataLoader(cfg, device="cpu")._zero_episodes(3)
    assert [(tuple(t.shape), t.dtype) for t in ep] == [
        (a.shape, torch.from_numpy(a).dtype) for a in want]


# ---------------------------------------------------------------------------
# The step's scalars as device tensors.


@pytest.mark.parametrize("count", range(13))
def test_step_scalars_are_todays_values(count):
    cfg = MAMLConfig.from_json_file(FLAGSHIP).replace(total_iter_per_epoch=2)
    f32 = np.float32
    sc = outer.StepScalars("cpu").fill(cfg, count, count * 5)
    lr = outer.meta_lr_schedule(cfg)(count)
    bc1 = float(f32(1.0) - f32(cfg.meta_adam_beta1) ** f32(count + 1))
    bc2 = float(f32(1.0) - f32(cfg.meta_adam_beta2) ** f32(count + 1))
    assert sc.neg_lr.dtype == torch.float32 and sc.neg_lr.dim() == 0
    assert float(sc.neg_lr) == -lr and float(sc.bc1) == bc1
    assert float(sc.bc2) == bc2 and float(sc.epoch) == count * 5
    assert float(sc.inv_bc1) == float(f32(1.0) / f32(bc1))
    assert float(sc.inv_bc2) == float(f32(1.0) / f32(bc2))
    # An Adam step through them: bitwise the Python-number formula.
    gen = torch.Generator().manual_seed(count)
    tr = {"params": {"w": torch.randn(5, 3, generator=gen)},
          "lslr": {"w": torch.rand(6, generator=gen)}}
    g = {k: {"w": torch.randn_like(v["w"])} for k, v in tr.items()}
    opt = outer.AdamState(
        count=count, mu={k: {"w": torch.randn_like(v["w"]) * 0.1}
                         for k, v in tr.items()},
        nu={k: {"w": torch.rand_like(v["w"]) * 0.1} for k, v in tr.items()})
    new, nopt = outer.adam_update(cfg, g, opt, tr, sc)
    b1, b2, eps = cfg.meta_adam_beta1, cfg.meta_adam_beta2, cfg.meta_adam_eps
    for k in tr:
        mu = (1 - b1) * g[k]["w"] + b1 * opt.mu[k]["w"]
        nu = (1 - b2) * (g[k]["w"] * g[k]["w"]) + b2 * opt.nu[k]["w"]
        want = tr[k]["w"] + -lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + eps))
        assert torch.equal(new[k]["w"], want)
        assert torch.equal(nopt.mu[k]["w"], mu)
    assert nopt.count == count + 1
    # Without scalars the step fills its own: the same bits.
    new2, _ = outer.adam_update(cfg, g, opt, tr)
    assert all(torch.equal(new[k]["w"], new2[k]["w"]) for k in tr)


@pytest.mark.parametrize("epoch", range(0, 61, 3))
def test_msl_weights_from_the_epoch_tensor_are_todays(epoch):
    cfg = MAMLConfig.from_json_file(FLAGSHIP)
    sc = outer.StepScalars("cpu").fill(cfg, 0, epoch)
    got = inner.per_step_loss_importance(cfg, sc.epoch)
    want = inner.per_step_loss_importance(cfg, epoch)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The BN kernel's launch counter under capture and replay (a stub graph:
# the launch path with the card's calls stubbed out).


def _stub_launch_path(monkeypatch, capturing):
    monkeypatch.setattr(bn_act, "_kernel_fn", lambda: (lambda *a: 0))
    monkeypatch.setattr(bn_act, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "_exchange_device", lambda i: -1)
    monkeypatch.setattr(torch.cuda, "_maybe_exchange_device", lambda i: -1)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda i: 0, raising=False)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])


class StubGraph:
    """Captures ``n`` launches of the wrapper, replays by count."""

    def __init__(self, capturing, n):
        x, g = torch.ones(4, 8), torch.ones(8)
        before = bn_act.captured
        capturing[0] = True
        try:
            for _ in range(n):
                bn_act._launch(x, g, torch.zeros(8), 1e-5, 0.0)
        finally:
            capturing[0] = False
        self.launches = bn_act.captured - before

    def replay(self):
        bn_act.count_replay(self.launches)


def test_launch_counter_accounts_capture_and_replay(monkeypatch):
    capturing = [False]
    _stub_launch_path(monkeypatch, capturing)
    bn_act.reset_launches()
    x, g = torch.ones(4, 8), torch.ones(8)
    bn_act._launch(x, g, torch.zeros(8), 1e-5, 0.0)   # eager: counted
    assert bn_act.launches == 1
    graph = StubGraph(capturing, 3)
    assert graph.launches == 3 and bn_act.launches == 1  # capture: not
    for _ in range(4):
        graph.replay()
    assert bn_act.launches == 1 + 4 * 3
    bn_act.reset_launches()
    assert bn_act.launches == 0


# ---------------------------------------------------------------------------
# The entry points on the CPU.


def test_prewarm_refuses_the_cpu_with_the_jax_keys(tmp_path):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_aot_prewarm.py"),
         "--config", FLAGSHIP, "--store", str(tmp_path / "store"),
         "--device", "cpu"], capture_output=True, text=True, timeout=120,
        cwd=REPO)
    assert proc.returncode != 0
    art = json.loads(proc.stdout.strip().splitlines()[-1])
    jax_keys = {"metric", "value", "unit", "ok", "hits", "misses",
                "failures", "seconds", "store_dir", "fingerprint",
                "fingerprints", "xla_compiler_options", "workload",
                "executables"}
    assert jax_keys <= set(art)
    assert art["metric"] == "aot_prewarm" and art["ok"] is False
    assert "needs the card" in art["status"]
    assert not os.path.exists(tmp_path / "store")


def test_prewarm_needs_a_store(tmp_path):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_aot_prewarm.py"),
         "--config", FLAGSHIP], capture_output=True, text=True, timeout=120,
        cwd=REPO)
    assert proc.returncode == 1
    art = json.loads(proc.stdout.strip().splitlines()[-1])
    assert art["metric"] == "aot_prewarm" and "no store" in art["error"]


def test_require_card_names_the_card():
    cfg = MAMLConfig(aot_store_dir="/s")
    with pytest.raises(ValueError, match="CUDA graphs, which need the card"):
        aot.require_card(cfg, torch.device("cpu"))
    aot.require_card(MAMLConfig(), torch.device("cpu"))   # off: nothing
