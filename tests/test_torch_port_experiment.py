"""The port's trainer entry point against the JAX package's, on the CPU:
``ExperimentBuilder`` runs, the CLI's argument parsing, each package
resuming the other's paused run, the ensemble test protocol on a JAX
run's checkpoints, pause/resume and SIGTERM/resume exactness, the
divergence rewind, and the knobs the port does not have yet.

Geometry: the JAX package's own end-to-end smoke config
(``tests/test_experiment.py § _cfg``: 3-way 1-shot, 10x10x1, 2 stages of
8 filters, batch 4, K=2, 2 epochs x 5 iterations, epoch 0 MSL, second
order throughout) on the f32 exact path (``compute_dtype=float32``,
``bn_fast_math=false``, composite BN), the parity rules of ROADMAP.md.

Tolerances: a run paused by one package and resumed by the other,
against the first package's uninterrupted run — epoch-1 ``train_loss``
rtol 1e-4 / atol 2e-4, and per weight leaf the epoch-1 update as a
vector: cosine > 0.90 and relative L2 < 0.6 (the floors of
``tests/test_torch_port_train.py § test_train_step_trajectory_matches_jax``;
conv biases excluded, their meta-gradient is analytically zero). Port
against port: rtol 1e-5 / atol 1e-6. Ensemble: the JAX predictions on
every query row whose top-two summed probabilities differ by more than
1e-4, and ``test_accuracy_mean`` within 0.01.
"""

import glob
import json
import os
import shutil
import signal

import jax
import numpy as np
import pytest
import torch

import train_maml_system as jax_cli
from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.experiment import (
    ExperimentBuilder as JaxBuilder)
from howtotrainyourmamlpytorch_tpu.parallel.mesh import replicate_state
from howtotrainyourmamlpytorch_tpu_torch import experiment
from howtotrainyourmamlpytorch_tpu_torch import train_maml_system as cli
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.convert import params_to_jax
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentBuilder
from howtotrainyourmamlpytorch_tpu_torch.parallel import mesh as mesh_mod
from howtotrainyourmamlpytorch_tpu_torch.utils.storage import (
    load_statistics)
from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import read_jsonl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "experiment_config", "*.json")))
BASE = dict(
    experiment_name="smoke", dataset_name="synthetic_smoke",
    image_height=10, image_width=10, image_channels=1,
    num_classes_per_set=3, num_samples_per_class=1,
    num_target_samples=2, batch_size=4, cnn_num_filters=8, num_stages=2,
    number_of_training_steps_per_iter=2,
    number_of_evaluation_steps_per_iter=2,
    total_epochs=2, total_iter_per_epoch=5,
    num_evaluation_tasks=6, max_models_to_save=2,
    second_order=True, use_multi_step_loss_optimization=True,
    multi_step_loss_num_epochs=1,  # epoch 0 MSL, epoch 1 final-only
    meta_learning_rate=0.005,
    compute_dtype="float32", bn_fast_math=False, bn_backend="composite")


def _kw(root, **kw):
    return {**BASE, "experiment_root": str(root), **kw}


def _run_port(root, **kw):
    builder = ExperimentBuilder(MAMLConfig(**_kw(root, **kw)), device="cpu")
    return builder, builder.run_experiment()


def _run_jax(root, **kw):
    builder = JaxBuilder(JaxConfig(**_kw(root, **kw)))
    return builder, builder.run_experiment()


def _jax_params(builder):
    return jax.tree.map(np.asarray, jax.device_get(builder.state.params))


def _copy_run(src_root, dst_root):
    shutil.copytree(os.path.join(src_root, "smoke"),
                    os.path.join(dst_root, "smoke"))
    return dst_root


def _csv(root, name="summary_statistics.csv"):
    return load_statistics(os.path.join(root, "smoke", "logs"), name)


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _assert_updates_agree(got, want, start):
    """Per weight leaf (JAX layout, conv biases excluded): the update from
    ``start`` as a vector, cosine > 0.90 and relative L2 < 0.6."""
    for layer, sub in want.items():
        for leaf, w in sub.items():
            if layer.startswith("conv") and leaf == "b":
                continue
            du, dw = got[layer][leaf] - start[layer][leaf], w - start[
                layer][leaf]
            assert _cos(du, dw) > 0.90, (layer, leaf, _cos(du, dw))
            assert _rel(du, dw) < 0.6, (layer, leaf, _rel(du, dw))


def _assert_params_close(got, want, **tol):
    for layer, sub in want.items():
        for leaf, w in sub.items():
            np.testing.assert_allclose(got[layer][leaf], w, **tol)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is as fast and keeps CPU runs
    deterministic across the pause/resume comparisons."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The module's reference runs, each computed once on first use."""
    root = tmp_path_factory.mktemp("runs")
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _RUNS[name](root / name)
        return cache[name]
    return get


def _jax_full(root):
    """JAX, uninterrupted, plus its ensemble's summed probabilities."""
    builder, result = _run_jax(root)
    logits = []
    for epoch in builder.ckpt.top_epochs(BASE["max_models_to_save"]):
        state, _ = builder.ckpt.load(builder.state, epoch)
        state = replicate_state(state, builder.mesh)
        logits.append(builder._evaluate(builder._eval_batches("test"), state,
                                        collect_logits=True)["logits"])
    probs = sum(np.asarray(jax.nn.softmax(lg, axis=-1)) for lg in logits)
    return dict(root=root, params=_jax_params(builder), result=result,
                probs=probs)


def _jax_paused(root):
    builder, result = _run_jax(root, total_epochs_before_pause=1)
    assert result == {"paused_at_iter": 5}
    return dict(root=root, params=_jax_params(builder))


def _port_full(root):
    builder, result = _run_port(root)
    return dict(root=root, builder=builder, result=result,
                params=params_to_jax(builder.state.params))


def _port_paused(root):
    builder, result = _run_port(root, total_epochs_before_pause=1)
    assert result == {"paused_at_iter": 5}
    return dict(root=root, params=params_to_jax(builder.state.params))


_RUNS = {"jax_full": _jax_full, "jax_paused": _jax_paused,
         "port_full": _port_full, "port_paused": _port_paused}


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

def test_full_port_run_writes_the_jax_packages_files(runs):
    """Two epochs (across the MSL boundary) then the ensemble test: the
    CSVs, config.json, checkpoints, a committed manifest and the model
    registry, in the JAX package's formats."""
    run = runs("port_full")
    result, base = run["result"], os.path.join(run["root"], "smoke")
    assert result["num_models"] == 2 and result["num_episodes"] == 6
    assert 0.0 <= result["test_accuracy_mean"] <= 1.0
    stats = _csv(run["root"])
    assert stats["epoch"] == ["0", "1"]
    assert all(np.isfinite(float(x)) for x in stats["train_loss"])
    jax_stats = _csv(runs("jax_full")["root"])
    assert list(stats) == list(jax_stats)
    test_stats = _csv(run["root"], "test_summary.csv")
    assert list(test_stats) == list(_csv(runs("jax_full")["root"],
                                         "test_summary.csv"))
    assert test_stats["num_models"] == ["2"]
    with open(os.path.join(base, "config.json")) as f:
        assert json.load(f)["experiment_name"] == "smoke"
    models = os.path.join(base, "saved_models")
    assert {"train_model_0.ckpt", "train_model_1.ckpt",
            "train_model_latest.ckpt", "state.json", "MANIFEST.json",
            "REGISTRY.json"} <= set(os.listdir(models))
    with open(os.path.join(models, "MANIFEST.json")) as f:
        records = json.load(f)["records"]
    assert {r["status"] for r in records.values()} == {"committed"}
    with open(os.path.join(models, "REGISTRY.json")) as f:
        assert [v["tag"] for v in json.load(f)["versions"]] == ["0", "1"]
    events = [r["event"] for r in read_jsonl(
        os.path.join(base, "logs", "events.jsonl"))]
    assert events.count("checkpoint") == 2 and "test_protocol" in events


def test_port_pause_and_resume_equals_uninterrupted(runs, tmp_path):
    root = _copy_run(runs("port_paused")["root"], tmp_path / "r")
    builder, result = _run_port(root, continue_from_epoch="latest")
    assert result["num_models"] == 2
    assert _csv(root)["epoch"] == ["0", "1"]
    _assert_params_close(params_to_jax(builder.state.params),
                         runs("port_full")["params"], rtol=1e-5, atol=1e-6)


def test_resume_from_an_epoch_rewinds_and_retrains(runs, tmp_path):
    """``continue_from_epoch=0`` on a finished run starts at epoch 0's
    iteration with epoch 1 dropped from the ensemble bookkeeping, and
    retraining epoch 1 ends where the first run ended."""
    root = _copy_run(runs("port_full")["root"], tmp_path / "r")
    builder = ExperimentBuilder(MAMLConfig(**_kw(
        root, continue_from_epoch=0)), device="cpu")
    assert builder.current_iter == 5
    assert set(builder.ckpt.meta["iter_at_epoch"]) == {"0"}
    assert builder.run_experiment()["num_models"] == 2
    _assert_params_close(params_to_jax(builder.state.params),
                         runs("port_full")["params"], rtol=1e-5, atol=1e-6)


def _sigterm_on_call(monkeypatch, n):
    """Make the builder's train step raise SIGTERM during its ``n``-th
    call (the real signal path: handler → flag → snapshot)."""
    real = mesh_mod.make_train_step
    calls = {"n": 0}

    def make(cfg, apply, **kw):
        step = real(cfg, apply, **kw)

        def wrapped(*a, **k):
            calls["n"] += 1
            if calls["n"] == n:
                signal.raise_signal(signal.SIGTERM)
            return step(*a, **k)
        return wrapped
    monkeypatch.setattr(mesh_mod, "make_train_step", make)


def _json_config(tmp_path, **kw):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(_kw(tmp_path / "exp", **kw)))
    return str(path)


def test_sigterm_snapshots_latest_and_resume_is_exact(runs, tmp_path,
                                                      monkeypatch):
    """SIGTERM during iteration 3 of epoch 0: the CLI snapshots 'latest' at
    iteration 3 and returns 75; the resume does the remainder and ends
    where the uninterrupted run ends."""
    cfg_path = _json_config(tmp_path)
    handler = signal.getsignal(signal.SIGTERM)
    _sigterm_on_call(monkeypatch, 3)
    builders = []
    assert cli.main(["--name_of_args_json_file", cfg_path], device="cpu",
                    builders=builders) == 75
    models = os.path.join(tmp_path, "exp", "smoke", "saved_models")
    with open(os.path.join(models, "state.json")) as f:
        assert json.load(f)["current_iter"] == 3
    with open(os.path.join(models, "MANIFEST.json")) as f:
        assert json.load(f)["records"]["latest"]["iter"] == 3
    monkeypatch.undo()
    assert signal.getsignal(signal.SIGTERM) is handler
    assert cli.main(["--name_of_args_json_file", cfg_path,
                     "--continue_from_epoch", "latest"], device="cpu",
                    builders=builders) == 0
    assert builders[1].current_iter == 10
    assert _csv(tmp_path / "exp")["epoch"] == ["0", "1"]
    _assert_params_close(params_to_jax(builders[1].state.params),
                         runs("port_full")["params"], rtol=1e-5, atol=1e-6)


def test_nan_outer_loss_rewinds_and_resalts_the_stream(tmp_path):
    """A non-finite outer loss at two consecutive sync points of epoch 1
    (divergence_patience=2) rewinds to the epoch-0 checkpoint, persists
    the rewind count, re-seeds the train stream and retrains epoch 1."""
    builder = ExperimentBuilder(MAMLConfig(**_kw(
        tmp_path, dispatch_sync_every=1)), device="cpu")
    real, seen = builder.train_step, []

    def poisoned(state, batch, epoch, **kw):
        new, metrics = real(state, batch, epoch, **kw)
        seen.append((state.step, float(batch.support_x.float().sum())))
        if len(seen) in (6, 7):   # iterations 5 and 6, the first time
            metrics = metrics._replace(loss=torch.tensor(float("nan")))
        return new, metrics
    builder.train_step = poisoned
    result = builder.run_experiment()
    assert result["num_models"] == 2
    assert builder.current_iter == 10 and builder.data._train_salt == 1
    with open(os.path.join(builder.paths["saved_models"],
                           "state.json")) as f:
        assert json.load(f)["rewinds"] == 1
    rows = read_jsonl(os.path.join(builder.paths["logs"], "events.jsonl"))
    assert [(r["epoch"], r["iter"]) for r in rows
            if r["event"] == "rewind"] == [(0, 5)]
    assert _csv(tmp_path)["epoch"] == ["0", "1"]
    # Iteration 5 ran twice: from the same state, on a re-seeded batch.
    assert [s for s, _ in seen].count(5) == 2
    first, again = (x for s, x in seen if s == 5)
    assert first != again


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_port_resumes_a_jax_run(runs, tmp_path):
    """The JAX package pauses after epoch 0; the port resumes from its
    checkpoint and trains epoch 1, ending where the JAX package's
    uninterrupted run ends."""
    root = _copy_run(runs("jax_paused")["root"], tmp_path / "r")
    builder, result = _run_port(root, continue_from_epoch="latest")
    assert result["num_models"] == 2
    got, want = _csv(root), _csv(runs("jax_full")["root"])
    assert got["epoch"] == ["0", "1"]
    np.testing.assert_allclose(float(got["train_loss"][1]),
                               float(want["train_loss"][1]),
                               rtol=1e-4, atol=2e-4)
    _assert_updates_agree(params_to_jax(builder.state.params),
                          runs("jax_full")["params"],
                          runs("jax_paused")["params"])


def test_jax_resumes_a_port_run(runs, tmp_path):
    """The mirror: the port pauses after epoch 0, the JAX package resumes
    and trains epoch 1, ending where the port's uninterrupted run ends."""
    root = _copy_run(runs("port_paused")["root"], tmp_path / "r")
    builder, result = _run_jax(root, continue_from_epoch="latest")
    assert builder.current_iter == 10 and result["num_models"] == 2
    got, want = _csv(root), _csv(runs("port_full")["root"])
    assert got["epoch"] == ["0", "1"]
    np.testing.assert_allclose(float(got["train_loss"][1]),
                               float(want["train_loss"][1]),
                               rtol=1e-4, atol=2e-4)
    _assert_updates_agree(_jax_params(builder), runs("port_full")["params"],
                          runs("port_paused")["params"])


def test_test_protocol_on_a_jax_run_matches_the_jax_ensemble(runs,
                                                             tmp_path):
    """``evaluate_on_test_set_only`` in the port, on the JAX run's
    directory: the JAX package's ensemble prediction on every query row
    it decides by more than 1e-4 of summed probability."""
    ref = runs("jax_full")
    root = _copy_run(ref["root"], tmp_path / "r")
    builder, result = _run_port(root, evaluate_on_test_set_only=True,
                                continue_from_epoch="latest")
    assert result["num_models"] == ref["result"]["num_models"] == 2
    assert result["num_episodes"] == 6
    assert abs(result["test_accuracy_mean"]
               - ref["result"]["test_accuracy_mean"]) <= 0.01
    top2 = np.sort(ref["probs"], axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 1e-4
    assert decided.mean() > 0.5
    np.testing.assert_array_equal(
        builder.ensemble_predictions[decided],
        ref["probs"].argmax(-1)[decided])
    assert len(_csv(root, "test_summary.csv")["num_models"]) == 2


# ---------------------------------------------------------------------------
# the CLI and the knobs
# ---------------------------------------------------------------------------

OVERRIDES = ["--batch_size", "8", "--second_order", "False",
             "--experiment_name", "cli_test", "--mesh_shape", "1", "1",
             "--train_val_test_split=[0.6, 0.2, 0.2]",
             "--continue_from_epoch", "latest"]


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_get_args_matches_jax(path):
    """Every shipped JSON with overrides of each kind (int, bool spelled
    Python-style, bare string, multi-token and inline-JSON tuples) parses
    to the same config in both packages."""
    argv = ["--name_of_args_json_file", path] + OVERRIDES
    assert cli.get_args(argv).to_dict() == jax_cli.get_args(argv).to_dict()


@pytest.mark.parametrize("argv", [
    ["--not_a_field", "3"], ["--second_order", "Flase"],
    ["--batch_size", "many"], ["--batch_size", "4", "8"],
    ["--mesh_shape", "--batch_size", "4"], ["stray"]])
def test_get_args_rejects_what_jax_rejects(argv):
    with pytest.raises(SystemExit):
        jax_cli.get_args(argv)
    with pytest.raises(SystemExit):
        cli.get_args(argv)


@pytest.mark.parametrize("knob", [
    dict(mesh_shape=(1, 2), require_mesh=1),
    dict(cluster_collective_timeout_s=5.0),
    dict(cluster_collective_timeout_s=5.0, elastic_mode=1)],
    ids=lambda k: next(iter(k)))
def test_unported_knob_raises(knob, tmp_path):
    """The mesh is ported: a mesh_shape that one process cannot realize
    raises under require_mesh=1, with the JAX package's message. The pod
    fault domain is ported too: its knobs build, as the JAX package's
    builder does. (The warm-start knobs: the next test.)"""
    if "cluster_collective_timeout_s" in knob:
        cfg = MAMLConfig(**_kw(tmp_path, **knob))
        builder = ExperimentBuilder(cfg, device="cpu")
        assert builder.cfg.cluster_collective_timeout_s == 5.0
        assert builder.cfg.elastic_mode == knob.get("elastic_mode", 0)
        return
    with pytest.raises(ValueError,
                       match="only 1 are visible and require_mesh=1"):
        ExperimentBuilder(MAMLConfig(**_kw(tmp_path, **knob)), device="cpu")


@pytest.mark.parametrize("knob", ["aot_store_dir", "compilation_cache_dir"])
def test_warm_start_knobs_on_the_cpu(knob, tmp_path):
    """``aot_store_dir`` is CUDA graphs: on the CPU the builder refuses it
    with a ``ValueError`` naming the card. ``compilation_cache_dir`` is
    the kernel build cache for the run (set while it runs, restored
    after); the run logs its ``warm_start`` row (no kernel built, nothing
    captured: the CPU runs the plain version) and ends as without it."""
    from howtotrainyourmamlpytorch_tpu_torch.ops import build
    cfg = MAMLConfig(**_kw(tmp_path, **{knob: str(tmp_path / knob)}))
    if knob == "aot_store_dir":
        with pytest.raises(ValueError, match="which need the card"):
            ExperimentBuilder(cfg, device="cpu")
        return
    before = build.cache_dir()
    seen = []
    builder = ExperimentBuilder(cfg.replace(total_epochs=1), device="cpu")
    step = builder.train_step

    def spy(*args, **kw):
        seen.append(build.cache_dir())
        return step(*args, **kw)

    builder.train_step = spy
    builder.run_experiment()
    assert seen and set(seen) == {str(tmp_path / knob)}
    assert build.cache_dir() == before
    rows = [r for r in read_jsonl(os.path.join(builder.paths["logs"],
                                               "events.jsonl"))
            if r["event"] == "warm_start"]
    assert len(rows) == 1 and rows[0]["compiles_before_first_step"] == 0
    assert rows[0]["iter"] == 0 and "aot_hits" not in rows[0]
    assert rows[0]["bitwise_resume"] is True


@pytest.mark.parametrize("knob", [
    "alert_rules_path", dict(profile_every_n_steps=1),
    dict(profile_dir="prof"), dict(use_tensorboard=True),
    dict(health_metrics_every_n_steps=1, dispatch_sync_every=1),
    dict(fault_spec="io_write@1"), "MAML_FAULTS", dict(ckpt_async=1)],
    ids=lambda k: k if isinstance(k, str) else next(iter(k)))
def test_ported_knob_builds_and_runs_one_step(knob, tmp_path, monkeypatch):
    """The telemetry and resilience slices' knobs no longer raise: a
    builder with each one set runs one train step (one epoch of one
    iteration, its validation and test) and does what the knob asks for
    (an injected write fault is retried; the async writer's files are on
    disk and its thread stopped)."""
    if knob == "MAML_FAULTS":
        monkeypatch.setenv("MAML_FAULTS", "io_write@1")
        knob = dict(fault_spec="")
    if knob == "alert_rules_path":
        rules = tmp_path / "rules.json"
        rules.write_text(json.dumps({"rules": [
            {"name": "loss", "type": "threshold",
             "metric": "train/train_loss", "op": ">", "value": 0.0}]}))
        knob = dict(alert_rules_path=str(rules))
    if "profile_dir" in knob:
        knob = dict(profile_dir=str(tmp_path / "prof"))
    builder, result = _run_port(tmp_path, total_epochs=1,
                                total_iter_per_epoch=1, **knob)
    assert builder.current_iter == 1 and result["num_models"] == 1
    logs = builder.paths["logs"]
    events = {r["event"] for r in read_jsonl(f"{logs}/events.jsonl")}
    want = {"alert_rules_path": "alert",
            "health_metrics_every_n_steps": "health"}
    name = next(iter(knob))
    if name in want:
        assert want[name] in events
    if name == "profile_every_n_steps":
        # A phase's first step counts its FLOPs; the sampler skips it.
        with open(f"{logs}/PROFILE.json") as f:
            assert json.load(f)["cards"]["train_so1_msl1"]["flops"] > 0
    if name == "profile_dir":
        assert os.path.isfile(tmp_path / "prof" / "epoch0" / "trace.json")
    if name == "fault_spec":
        snap = builder.registry.snapshot()
        assert snap["resilience/io_retries"] == 1.0
        assert snap["resilience/faults_injected"] == 1.0
    if name == "ckpt_async":
        assert builder.ckpt_writer._thread is None
        assert builder.ckpt.has_checkpoint(0)
        assert builder.registry.snapshot()["ckpt/saves"] == 1.0


def test_run_holds_the_numerics_policy_and_restores_it(tmp_path,
                                                       monkeypatch):
    """``run_experiment`` runs every train step of an f32 config with TF32
    off for cuDNN and cuBLAS and cuDNN deterministic without autotuning,
    and hands torch's flags back as it found them."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    for flag, value in ((cudnn, "allow_tf32"), (matmul, "allow_tf32"),
                        (cudnn, "deterministic"), (cudnn, "benchmark")):
        monkeypatch.setattr(flag, value, getattr(flag, value))
    cudnn.allow_tf32, matmul.allow_tf32 = True, True
    cudnn.deterministic, cudnn.benchmark = False, True
    builder = ExperimentBuilder(MAMLConfig(**_kw(
        tmp_path, total_epochs=1, total_iter_per_epoch=2)), device="cpu")
    seen = []
    step = builder.train_step

    def watched(*args, **kwargs):
        seen.append((cudnn.allow_tf32, matmul.allow_tf32,
                     cudnn.deterministic, cudnn.benchmark))
        return step(*args, **kwargs)

    builder.train_step = watched
    builder.run_experiment()
    assert seen == [(False, False, True, False)] * 2
    assert (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
            cudnn.benchmark) == (True, True, False, True)


def test_cli_refuses_downloads_and_needs_the_card_by_default(tmp_path):
    cfg_path = _json_config(tmp_path, download_datasets=True)
    with pytest.raises(NotImplementedError, match="fetcher"):
        cli.main(["--name_of_args_json_file", cfg_path], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ExperimentBuilder(MAMLConfig(**_kw(tmp_path)))
