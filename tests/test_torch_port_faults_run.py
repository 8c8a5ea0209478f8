"""The port's trainer under injected faults, on the CPU: tiny runs of
``ExperimentBuilder`` and the CLI (``device="cpu"``), and one run of the
JAX package beside the port's on the same config, seed and spec.

Geometry: the JAX chaos harness's tiny config (``scripts/chaos_run.py §
tiny_cfg``: 3-way 1-shot, 10x10x1, 2 stages of 4 filters, batch 2, K=2,
first order, 2 epochs x 4 iterations, a loss fetch and a health snapshot
every iteration, divergence patience 1).

* Each fault kind the port runs is recovered the reference's way: the
  ``io_write`` retry, the ``nan_loss`` rewind, ``kill`` then resume,
  ``ckpt_corrupt`` quarantine and fallback, ``episode_corrupt``
  replacement, ``kill_in_ckpt_write`` (exit 137; the restart resumes
  from the committed entry), ``hang_feed`` and ``hang_step`` (exit 74
  and a crash bundle); an unhandled exception and a second signal each
  write a bundle.
* ``ckpt_async=1`` writes the same bytes as ``ckpt_async=0``; a run with
  the watchdog on ends bitwise the run with it off; the engine's
  ``serve_request`` scope hands the beacon its phase back.
* Against the JAX package (``io_write@1;nan_loss@5;kill@6``, then a
  restart): the same ``checkpoint``/``health_grad_norm_warn``/``rewind``
  /``preempt_checkpoint`` rows at the same iterations, the same fault
  and recovery counters, and restarted weights within the trajectory
  floors of ``tests/test_torch_port_experiment.py`` (per weight leaf,
  the update from the shared initial state as a vector: cosine > 0.90,
  relative L2 < 0.6; conv biases excluded).
"""

import glob
import json
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.experiment import (
    ExperimentBuilder as JaxBuilder)
from howtotrainyourmamlpytorch_tpu_torch import experiment
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.convert import (params_to_jax,
                                                         state_from_jax)
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentBuilder
from howtotrainyourmamlpytorch_tpu_torch.parallel import mesh as mesh_mod
from howtotrainyourmamlpytorch_tpu_torch.meta.outer import init_train_state
from howtotrainyourmamlpytorch_tpu_torch.models import make_model
from howtotrainyourmamlpytorch_tpu_torch.resilience import flightrec, watchdog
from howtotrainyourmamlpytorch_tpu_torch.serve import (FewShotRequest,
                                                       ServingEngine)
from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import read_jsonl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(
    experiment_name="chaos", dataset_name="synthetic_chaos",
    image_height=10, image_width=10, image_channels=1,
    num_classes_per_set=3, num_samples_per_class=1, num_target_samples=2,
    batch_size=2, cnn_num_filters=4, num_stages=2,
    number_of_training_steps_per_iter=2,
    number_of_evaluation_steps_per_iter=2, second_order=False,
    use_multi_step_loss_optimization=False, total_epochs=2,
    total_iter_per_epoch=4, num_evaluation_tasks=4, max_models_to_save=2,
    compute_dtype="float32", meta_learning_rate=0.005,
    dispatch_sync_every=1, live_progress=False, divergence_patience=1,
    health_metrics_every_n_steps=1)
EVENTS = ("checkpoint", "health_grad_norm_warn", "rewind",
          "preempt_checkpoint")
# The child: the port's CLI on the CPU, on one thread as this module runs
# (a CPU reduction's order depends on the thread count).
CHILD = ("import sys, torch; torch.set_num_threads(1); "
         "sys.path.insert(0, sys.argv[2]); "
         "from howtotrainyourmamlpytorch_tpu_torch import "
         "train_maml_system as t; "
         "sys.exit(t.main(['--name_of_args_json_file', sys.argv[1]], "
         "device='cpu'))")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(root, **kw):
    return MAMLConfig(**{**BASE, "experiment_root": str(root), **kw})


def _run(root, **kw):
    builder = ExperimentBuilder(_cfg(root, **kw), device="cpu")
    return builder, builder.run_experiment()


def _events(builder, names=EVENTS):
    return [(r["event"], r.get("iter")) for r in read_jsonl(
        os.path.join(builder.paths["logs"], "events.jsonl"))
        if r["event"] in names]


def _leaves(state):
    out = {"step": torch.as_tensor(state.step)}

    def walk(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(f"{prefix}/{k}", v)
            else:
                out[f"{prefix}/{k}"] = v
    walk("", {"params": state.params, "lslr": state.lslr,
              "bn_state": state.bn_state, "mu": state.opt_state.mu,
              "nu": state.opt_state.nu})
    return out


def _assert_bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert set(la) == set(lb)
    assert [n for n in la if not torch.equal(la[n], lb[n])] == []


def _spawn(root, env=None, **kw):
    """The CLI in a subprocess on ``kw``'s config (the fault plan from the
    config only)."""
    path = os.path.join(str(root), "cfg.json")
    os.makedirs(str(root), exist_ok=True)
    with open(path, "w") as f:
        json.dump(_cfg(root, **kw).to_dict(), f)
    child_env = {k: v for k, v in os.environ.items() if k != "MAML_FAULTS"}
    child_env.update(env or {})
    return subprocess.run([sys.executable, "-c", CHILD, path, REPO],
                          env=child_env, capture_output=True, text=True,
                          timeout=300)


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """The fault-free run every recovery is held against."""
    return _run(tmp_path_factory.mktemp("baseline"))


def test_io_write_is_retried(tmp_path):
    """``io_write@1`` fails the first storage write (``config.json``); the
    backoff layer retries it and the run finishes."""
    builder, result = _run(tmp_path, fault_spec="io_write@1")
    snap = builder.registry.snapshot()
    assert snap["resilience/io_retries"] == 1.0
    assert snap["resilience/faults_injected"] == 1.0
    assert result["num_models"] == 2
    assert os.path.isfile(os.path.join(builder.paths["base"], "config.json"))


def test_nan_loss_rewinds(tmp_path):
    """``nan_loss@5``: the health warning, then the rewind to epoch 0's
    checkpoint (iteration 4), epoch 1 trained again on a re-seeded
    stream."""
    builder, result = _run(tmp_path, fault_spec="nan_loss@5")
    assert result["num_models"] == 2 and builder.current_iter == 8
    assert _events(builder) == [
        ("checkpoint", 4), ("health_grad_norm_warn", 5), ("rewind", 4),
        ("checkpoint", 8)]
    assert builder.registry.snapshot()["resilience/rewinds"] == 1.0
    assert builder.data._train_salt == 1


def test_kill_then_resume_matches_the_uninterrupted_run(tmp_path,
                                                        baseline):
    """``kill@6`` raises SIGTERM at iteration 6: 'latest' is saved there,
    a preemption bundle is written, and the resume ends bitwise where the
    uninterrupted run ends."""
    handler = signal.getsignal(signal.SIGTERM)
    builder, result = _run(tmp_path, fault_spec="kill@6")
    assert result == {"preempted_at_iter": 6}
    assert signal.getsignal(signal.SIGTERM) is handler
    crash = json.load(open(os.path.join(builder.paths["logs"],
                                        "crash_bundle", "crash.json")))
    assert crash["reason"] == "preempted" and crash["iter"] == 6
    resumed, result = _run(tmp_path, continue_from_epoch="latest")
    assert result["num_models"] == 2
    _assert_bitwise(resumed.state, baseline[0].state)


def test_ckpt_corrupt_is_quarantined_and_resume_falls_back(tmp_path):
    """``ckpt_corrupt@2`` flips a byte of epoch 1's file after its write
    ('latest' is its hard link) in a run paused there: the resume
    quarantines both and falls back to epoch 0's checkpoint."""
    _, result = _run(tmp_path, fault_spec="ckpt_corrupt@2", total_epochs=3,
                     total_epochs_before_pause=2)
    assert result == {"paused_at_iter": 8}
    with pytest.warns(UserWarning, match="quarantined"):
        builder = ExperimentBuilder(_cfg(tmp_path, total_epochs=3,
                                         continue_from_epoch="latest"),
                                    device="cpu")
    assert builder.current_iter == 4
    assert sorted(os.path.basename(p) for p in glob.glob(os.path.join(
        builder.paths["saved_models"], "*.corrupt"))) == [
        "train_model_1.ckpt.corrupt", "train_model_latest.ckpt.corrupt"]
    assert builder.registry.snapshot()["resilience/quarantined"] == 2.0
    assert builder.run_experiment()["num_models"] == 2


def test_episode_corrupt_draws_a_replacement(tmp_path):
    """``episode_corrupt@3`` fails the first draw of episode 3; a
    deterministic replacement keeps the batch full."""
    with pytest.warns(UserWarning, match="corrupt/unreadable episode"):
        builder, result = _run(tmp_path, fault_spec="episode_corrupt@3")
    assert builder.registry.snapshot()["data/corrupt_episodes"] == 1.0
    assert result["num_models"] == 2 and builder.current_iter == 8


def test_kill_in_ckpt_write_resumes_from_the_committed_entry(tmp_path,
                                                             baseline):
    """A SIGKILL between epoch 1's fsynced tmp and its rename (exit 137):
    epoch 0 committed, epoch 1 pending; the restart resumes from
    iteration 4, sweeps the pending record and the tmp, quarantines
    nothing and ends bitwise the uninterrupted run."""
    proc = _spawn(tmp_path, fault_spec="kill_in_ckpt_write@2")
    assert proc.returncode == 137, proc.stderr[-2000:]
    saved = os.path.join(str(tmp_path), "chaos", "saved_models")
    records = json.load(open(os.path.join(saved, "MANIFEST.json")))[
        "records"]
    assert {t: r["status"] for t, r in records.items()} == {
        "0": "committed", "latest": "committed", "1": "pending"}
    assert glob.glob(os.path.join(saved, "*.tmp"))
    with pytest.warns(UserWarning, match="swept"):
        builder = ExperimentBuilder(_cfg(tmp_path,
                                         continue_from_epoch="latest"),
                                    device="cpu")
    assert builder.current_iter == 4
    assert builder.run_experiment()["num_models"] == 2
    assert not glob.glob(os.path.join(saved, "*.tmp"))
    assert not glob.glob(os.path.join(saved, "*.corrupt"))
    snap = builder.registry.snapshot()
    assert snap.get("resilience/quarantined", 0) == 0
    assert snap["ckpt/gc_deletes"] == 2.0
    _assert_bitwise(builder.state, baseline[0].state)


@pytest.mark.parametrize("kind,phase", [("hang_feed", "feed"),
                                        ("hang_step", "step")])
def test_hang_trips_the_watchdog(kind, phase, tmp_path):
    """A hang at iteration 5 under a 2 s deadline: exit 74 and a crash
    bundle whose ``crash.json`` names the phase; one ``watchdog_trip``
    row; the trip counted in the last metrics row."""
    proc = _spawn(tmp_path, env={"MAML_HANG_SECONDS": "60"},
                  fault_spec=f"{kind}@5", watchdog_poll_interval_s=0.2,
                  **{f"watchdog_{phase}_timeout_s": 2.0})
    assert proc.returncode == 74, proc.stderr[-2000:]
    logs = os.path.join(str(tmp_path), "chaos", "logs")
    bundle = os.path.join(logs, "crash_bundle")
    assert sorted(os.listdir(bundle)) == ["crash.json", "flight.jsonl",
                                          "stacks.txt", "trace.json"]
    crash = json.load(open(os.path.join(bundle, "crash.json")))
    assert crash["reason"] == f"hung_{phase}"
    assert 2.0 < crash["age_seconds"] < 2.0 + 2 * 0.2 + 1.0
    assert crash["metrics"]["watchdog/trips"] == 1.0
    rows = read_jsonl(os.path.join(logs, "events.jsonl"))
    assert [r["event"] for r in rows][-2:] == ["watchdog_trip", "metrics"]
    assert rows[-1]["metrics"]["watchdog/trips"] == 1.0
    flight = [json.loads(line) for line in open(os.path.join(
        bundle, "flight.jsonl"))]
    assert {"kind": "fault", "fault": kind, "step": 5}.items() <= next(
        r for r in flight if r["kind"] == "fault").items()
    assert "Thread" in open(os.path.join(bundle, "stacks.txt")).read()


def test_unhandled_exception_writes_a_bundle(tmp_path, monkeypatch):
    real = mesh_mod.make_train_step
    calls = []

    def make(cfg, apply, **kw):
        step = real(cfg, apply, **kw)

        def failing(*a, **k):
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("injected step failure")
            return step(*a, **k)
        return failing
    monkeypatch.setattr(mesh_mod, "make_train_step", make)
    builder = ExperimentBuilder(_cfg(tmp_path), device="cpu")
    before = (watchdog.get_beacon(), flightrec.get())
    with pytest.raises(RuntimeError, match="injected"):
        builder.run_experiment()
    bundle = os.path.join(builder.paths["logs"], "crash_bundle")
    crash = json.load(open(os.path.join(bundle, "crash.json")))
    assert crash["reason"] == "exception:RuntimeError"
    assert crash["iter"] == 2 and "injected" in crash["error"]
    assert os.path.isfile(os.path.join(bundle, "flight.jsonl"))
    assert (watchdog.get_beacon(), flightrec.get()) == before


class _Exited(SystemExit):
    pass


def test_second_signal_writes_a_bundle_then_exits_75(tmp_path,
                                                     monkeypatch):
    """Two SIGTERMs in one step: the second escalates, writing a
    ``signal_escalation`` bundle before ``os._exit(75)``."""
    codes = []

    def fake_exit(code):
        codes.append(code)
        raise _Exited(code)
    monkeypatch.setattr(experiment.os, "_exit", fake_exit)
    real = mesh_mod.make_train_step

    def make(cfg, apply, **kw):
        step = real(cfg, apply, **kw)

        def signalled(*a, **k):
            out = step(*a, **k)
            if int(a[0].step) == 2:
                signal.raise_signal(signal.SIGTERM)
                signal.raise_signal(signal.SIGTERM)
            return out
        return signalled
    monkeypatch.setattr(mesh_mod, "make_train_step", make)
    builder = ExperimentBuilder(_cfg(tmp_path), device="cpu")
    with pytest.raises(_Exited):
        builder.run_experiment()
    assert codes == [75]
    bundle = os.path.join(builder.paths["logs"], "crash_bundle")
    crash = json.load(open(os.path.join(bundle, "crash.json")))
    assert crash["reason"] == "signal_escalation"
    assert crash["signum"] == signal.SIGTERM
    flight = [json.loads(line) for line in open(os.path.join(
        bundle, "flight.jsonl"))]
    assert flight[-1]["kind"] == "signal_escalation"


def _saved_files(builder):
    models = builder.paths["saved_models"]
    return {n: open(os.path.join(models, n), "rb").read()
            for n in sorted(os.listdir(models))
            if n.endswith(".ckpt") or n in ("MANIFEST.json", "state.json")}


def test_async_saves_write_the_sync_bytes(tmp_path, baseline):
    """``ckpt_async=1`` (both queue policies): the same checkpoint files,
    manifest and ``state.json`` as the synchronous baseline, bitwise the
    same final state, the writer thread stopped at the end."""
    for policy in ("block", "skip"):
        builder, result = _run(tmp_path / policy, ckpt_async=1,
                               ckpt_queue_policy=policy)
        assert result["num_models"] == 2
        assert _saved_files(builder) == _saved_files(baseline[0])
        assert builder.ckpt_writer._thread is None
        snap = builder.registry.snapshot()
        assert snap["ckpt/saves"] == 2.0 and snap["ckpt/skipped_saves"] == 0
        _assert_bitwise(builder.state, baseline[0].state)


def test_watchdog_on_and_off_end_bitwise_equal(tmp_path, baseline):
    """Every deadline 0 installs nothing (no beacon, no ring, no bundle,
    no flight.jsonl); the run ends bitwise the run with the watchdog
    on, whose flight ring shows the step, feed and compile phases."""
    off = {f: 0.0 for f in watchdog.PHASE_TIMEOUT_FIELDS.values()}
    builder, result = _run(tmp_path, **off)
    assert result["num_models"] == 2
    _assert_bitwise(builder.state, baseline[0].state)
    assert not os.path.exists(os.path.join(builder.paths["logs"],
                                           "flight.jsonl"))
    logs = baseline[0].paths["logs"]
    phases = {r["phase"] for r in map(json.loads, open(os.path.join(
        logs, "flight.jsonl"))) if r["kind"] == "phase"}
    assert {"step", "feed", "ckpt"} <= phases
    beats = [r for r in read_jsonl(os.path.join(logs, "events.jsonl"))
             if r["event"] == "heartbeat"]
    assert all(r["progress_age_seconds"] >= 0 for r in beats)
    with open(os.path.join(logs, "trace.json")) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"step", "feed"} <= names


def _tiny_engine(root):
    cfg = MAMLConfig(**{**BASE, "experiment_root": str(root),
                        "serve_buckets": ((3, 6),),
                        "serve_batch_tasks": 2})
    state = init_train_state(cfg, make_model(cfg)[0], seed=0, device="cpu")
    return cfg, ServingEngine(cfg, state, device="cpu")


def _request(cfg, rng):
    h, w, c = cfg.image_shape
    return FewShotRequest(
        support_x=rng.integers(0, 256, (3, h, w, c), dtype=np.uint8),
        support_y=np.arange(3, dtype=np.int32),
        query_x=rng.integers(0, 256, (6, h, w, c), dtype=np.uint8))


def test_engine_serve_request_scope_restores_the_beacon(tmp_path):
    """Inside a training process (a beacon installed) the engine installs
    nothing and each submit/step hands the beacon its phase back; alone,
    it installs its own idle beacon, which never trips, and ``close``
    restores the process's state."""
    rng = np.random.default_rng(0)
    beacon, rec = watchdog.ProgressBeacon(), flightrec.FlightRecorder()
    prev_b, prev_r = watchdog.install_beacon(beacon), flightrec.install(rec)
    # This test owns the process's beacon and recorder (another module's
    # engine may still hold them until it is collected).
    try:
        beacon.stamp("step", detail=11)
        cfg, engine = _tiny_engine(tmp_path)
        assert engine._watchdog is None
        engine.submit(_request(cfg, rng))
        assert len(engine.step()) == 1
        assert beacon.current()[0::2] == ("step", 11)
        assert [e["phase"] for e in rec.events() if e["kind"] == "phase"
                ] == ["step"] + ["serve_request", "step"] * 2
    finally:
        watchdog.install_beacon(None)
        flightrec.install(None)
    cfg, engine = _tiny_engine(tmp_path)
    own = watchdog.get_beacon()
    assert engine._watchdog is not None and own is not None
    assert own.current()[0] == "idle"
    engine.submit(_request(cfg, rng))
    engine.drain()
    assert own.current()[0] == "idle"
    dog = engine._watchdog
    assert dog.deadlines == {"serve_request": 600.0, "compile": 7200.0}
    assert dog.check(now=own.current()[1] + 1e6) is None  # idle never trips
    own.stamp("feed")  # a stamp another layer leaves: not the engine's
    assert dog.check(now=own.current()[1] + 1e6) is None
    engine.close()
    assert watchdog.get_beacon() is None and flightrec.get() is None
    engine.close()
    watchdog.install_beacon(prev_b)
    flightrec.install(prev_r)


def _jax_run(root, **kw):
    builder = JaxBuilder(JaxConfig(**{**BASE, "experiment_root": str(root),
                                      **kw}))
    return builder, builder.run_experiment()


def test_faulted_run_and_restart_match_the_jax_package(tmp_path):
    """``io_write@1;nan_loss@5;kill@6`` then a restart, in both packages
    from the JAX package's initial state: the same events at the same
    iterations, the same counters, restarted weights within the
    trajectory floors."""
    spec = "io_write@1;nan_loss@5;kill@6"
    jax_builder = JaxBuilder(JaxConfig(**{
        **BASE, "experiment_root": str(tmp_path / "jax"),
        "fault_spec": spec}))
    js = jax.device_get(jax_builder.state)
    start = jax.tree.map(np.asarray, js.params)
    port_builder = ExperimentBuilder(_cfg(tmp_path / "port",
                                          fault_spec=spec), device="cpu")
    port_builder.state = state_from_jax(js.params, js.lslr, js.bn_state,
                                        int(js.step), device="cpu",
                                        opt_state=js.opt_state)
    runs = {"jax": (jax_builder, jax_builder.run_experiment()),
            "port": (port_builder, port_builder.run_experiment())}
    assert runs["port"][1] == runs["jax"][1] == {"preempted_at_iter": 6}
    seq = {k: _events(b) for k, (b, _) in runs.items()}
    assert seq["port"] == seq["jax"] == [
        ("checkpoint", 4), ("health_grad_norm_warn", 5), ("rewind", 4),
        ("preempt_checkpoint", 6)]
    keys = ("resilience/faults_injected", "resilience/rewinds",
            "resilience/io_retries", "resilience/io_giveups",
            "resilience/quarantined", "data/corrupt_episodes",
            "health/grad_norm_warnings")
    snaps = {k: b.registry.snapshot() for k, (b, _) in runs.items()}
    assert ({k: snaps["port"].get(k) for k in keys}
            == {k: snaps["jax"].get(k) for k in keys})
    assert snaps["port"]["resilience/faults_injected"] == 3.0
    jax_restart, jr = _jax_run(tmp_path / "jax",
                               continue_from_epoch="latest")
    port_restart, pr = _run(tmp_path / "port", continue_from_epoch="latest")
    assert jr["num_models"] == pr["num_models"] == 2
    assert jax_restart.current_iter == port_restart.current_iter == 8
    got = params_to_jax(port_restart.state.params)
    want = jax.tree.map(np.asarray, jax.device_get(jax_restart.state.params))
    for layer, sub in want.items():
        for leaf, w in sub.items():
            if layer.startswith("conv") and leaf == "b":
                continue
            du = got[layer][leaf] - start[layer][leaf]
            dw = w - start[layer][leaf]
            cos = float(np.dot(du.ravel(), dw.ravel())
                        / (np.linalg.norm(du) * np.linalg.norm(dw)))
            rel = float(np.linalg.norm(du - dw) / np.linalg.norm(dw))
            assert cos > 0.90 and rel < 0.6, (layer, leaf, cos, rel)
