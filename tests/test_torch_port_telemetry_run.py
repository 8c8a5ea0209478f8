"""A port run with the telemetry plane on, read by the JAX package's
readers, on the CPU.

One tiny CLI run (``train_maml_system.main``, 2 epochs x 2 iterations,
``dispatch_sync_every=1``) with training health every step, a perf
sample every step, a device trace of epoch 1, TensorBoard and two alert
rules (one fires, one does not). The JAX package's
``telemetry/report.py § summarize_events`` and
``scripts/telemetry_report.py`` read its ``events.jsonl`` with the step,
feed, health, perf, checkpoint and alerts sections filled in, compile and
memory "unavailable" on the CPU; its ``trace.json`` passes the JAX
package's ``validate_trace``; its ``perf_profile`` rows carry the JAX
keys. Also: TensorBoard without its writer warns and goes on, a profiler
that cannot start is counted in ``perf/errors`` and ends nothing, and
``FlopCounterMode`` counts a tiny VGG forward's FLOPs as its convolutions
and linear layer need them.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.telemetry import profiler as jprof
from howtotrainyourmamlpytorch_tpu.telemetry import report as jreport
from howtotrainyourmamlpytorch_tpu.telemetry import trace as jtrace
from howtotrainyourmamlpytorch_tpu_torch import train_maml_system as cli
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentBuilder
from howtotrainyourmamlpytorch_tpu_torch.models import make_model
from howtotrainyourmamlpytorch_tpu_torch.telemetry import profiler
from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import read_jsonl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(
    experiment_name="telemetry", dataset_name="synthetic_smoke",
    image_height=10, image_width=10, image_channels=1,
    num_classes_per_set=3, num_samples_per_class=1, num_target_samples=2,
    batch_size=4, task_microbatches=2, cnn_num_filters=8, num_stages=2,
    number_of_training_steps_per_iter=2,
    number_of_evaluation_steps_per_iter=2, total_epochs=2,
    total_iter_per_epoch=2, num_evaluation_tasks=4, max_models_to_save=2,
    second_order=True, use_multi_step_loss_optimization=True,
    multi_step_loss_num_epochs=1, compute_dtype="float32",
    bn_fast_math=False, bn_backend="composite")
TELEMETRY = ["--dispatch_sync_every", "1",
             "--health_metrics_every_n_steps", "1",
             "--profile_every_n_steps", "1", "--profile_epoch", "1",
             "--profile_num_steps", "1", "--use_tensorboard", "True"]
RULES = {"rules": [
    {"name": "loss_reported", "type": "threshold",
     "metric": "train/train_loss", "op": ">", "value": 0.0},
    {"name": "feed_stalled", "type": "threshold",
     "metric": "feed/stall_frac", "op": ">", "value": 1.0,
     "severity": "critical"}]}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The run's builder, events and logs directory."""
    root = tmp_path_factory.mktemp("telemetry")
    cfg_path, rules = root / "cfg.json", root / "rules.json"
    cfg_path.write_text(json.dumps(BASE))
    rules.write_text(json.dumps(RULES))
    builders = []
    argv = (["--name_of_args_json_file", str(cfg_path),
             "--experiment_root", str(root), "--alert_rules_path",
             str(rules), "--profile_dir", str(root / "trace")] + TELEMETRY)
    assert cli.main(argv, device="cpu", builders=builders) == 0
    builder = builders[0]
    logs = builder.paths["logs"]
    return builder, read_jsonl(os.path.join(logs, "events.jsonl")), logs


def test_jax_report_reads_a_port_run(run):
    _, events, _ = run
    summary = jreport.summarize_events(events)
    assert summary["epochs"] == 2 and summary["steps"] == 4
    assert isinstance(summary["step_seconds_p50"], float)
    assert 0.0 <= summary["feed_stall_frac"] <= 1.0
    for key in ("compile_count", "compile_seconds", "peak_memory_bytes",
                "live_memory_bytes"):
        assert summary[key] == jreport.UNAVAILABLE, key
    for key in ("health", "perf", "checkpoint", "alerts", "resilience",
                "host_skew", "algo"):
        assert isinstance(summary[key], dict), key
    assert summary["checkpoint"]["saves"] == 2
    assert summary["perf"]["samples"] == 2
    assert summary["health"]["msl_importance"] != jreport.UNAVAILABLE
    assert summary["alerts"]["fired"] == 1
    assert summary["alerts"]["most_fired_rule"] == "loss_reported"
    assert summary["host_skew"]["heartbeats"] == 2


def test_report_script_reads_a_port_run(run):
    """``scripts/telemetry_report.py`` on the run directory, as an
    operator would call it."""
    builder, _, _ = run
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "telemetry_report.py"),
         builder.paths["base"], "--json"], capture_output=True, text=True,
        timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["epochs"] == 2 and summary["perf"]["samples"] == 2


def test_rows_files_and_keys(run):
    """One telemetry and one heartbeat row per epoch, a health row per
    step, perf rows with the JAX summary keys whose fractions sum to 1,
    a valid trace.json, metrics.prom, PROFILE.json, the device trace and
    TensorBoard scalars."""
    builder, events, logs = run
    by = lambda name: [e for e in events if e["event"] == name]
    assert [e["epoch"] for e in by("telemetry")] == [0, 1]
    assert [e["epoch"] for e in by("heartbeat")] == [0, 1]
    assert all(e["memory"] is None and e["compile_count_total"] is None
               for e in by("telemetry"))
    assert [e["iter"] for e in by("health")] == [1, 2, 3, 4]
    perf = by("perf_profile")
    # Each phase's first step counts its FLOPs and is not sampled.
    assert [e["iter"] for e in perf] == [1, 3]
    jax_keys = set(jprof.summarize_trace_events([], 1.0)) | {"roofline"}
    for e in perf:
        assert jax_keys <= set(e)
        assert e["device_lane"] == "cpu" and e["device_spans"] > 0
        total = (e["device_compute_frac"] + e["device_idle_frac"]
                 + e["dispatch_gap_frac"])
        assert abs(total - 1) < 1e-6
        assert e["flops"] > 0 and e["top_executable"] == (
            profiler.phase_card_name(True, e["epoch"] == 0))
        assert "meta_update" in e["per_region_seconds"]
    with open(os.path.join(logs, "trace.json")) as f:
        jtrace.validate_trace(json.load(f))
    prom = open(os.path.join(logs, "metrics.prom")).read()
    assert "# TYPE perf_errors counter\nperf_errors 0.0" in prom
    assert "# TYPE ckpt_saves counter\nckpt_saves 2.0" in prom
    cards = jprof.load_profile(os.path.join(logs, "PROFILE.json"))["cards"]
    assert set(cards) == {"train_so1_msl1", "train_so1_msl0"}
    root = os.path.dirname(builder.paths["base"])
    with open(os.path.join(root, "trace", "epoch1", "trace.json")) as f:
        assert json.load(f)["traceEvents"]
    assert os.listdir(os.path.join(logs, "tensorboard"))


def test_tensorboard_missing_warns_and_goes_on(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    builder = ExperimentBuilder(MAMLConfig(
        **{**BASE, "experiment_root": str(tmp_path), "total_epochs": 1,
           "total_iter_per_epoch": 1, "use_tensorboard": True}),
        device="cpu")
    with pytest.warns(UserWarning, match="SummaryWriter"):
        result = builder.run_experiment()
    assert result["num_models"] == 1
    assert not os.path.exists(os.path.join(builder.paths["logs"],
                                           "tensorboard"))


def test_profiler_failure_is_counted_and_ends_nothing(tmp_path,
                                                      monkeypatch):
    def refuse(*args, **kwargs):
        raise RuntimeError("profiler unavailable")
    monkeypatch.setattr(torch.profiler, "profile", refuse)
    builder = ExperimentBuilder(MAMLConfig(
        **{**BASE, "experiment_root": str(tmp_path), "total_epochs": 1,
           "total_iter_per_epoch": 3, "profile_every_n_steps": 1}),
        device="cpu")
    with pytest.warns(UserWarning, match="perf profiling sample failed"):
        builder.run_experiment()
    snap = builder.registry.snapshot()
    assert snap["perf/errors"] == 2 and snap["perf/samples"] == 0
    assert builder.current_iter == 3


def test_flop_counter_counts_a_forward_analytically():
    """FlopCounterMode's count of one tiny VGG forward (2 tasks x 6
    images) equals 2 x MACs of its two 3x3 convolutions (SAME, 8
    filters) and its linear layer."""
    cfg = MAMLConfig(**{**BASE, "num_stages": 2})
    assert cfg.image_shape == (10, 10, 1) and cfg.max_pooling
    init, apply = make_model(cfg)
    params, state = init(torch.Generator().manual_seed(0))
    tasks, images = 2, 6
    stack = lambda t: t.unsqueeze(0).expand(tasks, *t.shape)
    params = {k: {n: stack(t) for n, t in v.items()}
              for k, v in params.items()}
    state = {k: {n: stack(t) for n, t in v.items()}
             for k, v in state.items()}
    x = torch.rand(tasks, images, 10, 10, 1)
    (_, _), flops = profiler.count_flops(
        lambda: apply(params, state, x, 0, True))
    f = cfg.cnn_num_filters
    conv = 2 * tasks * images * (10 * 10 * f * 1 * 9 + 5 * 5 * f * f * 9)
    linear = 2 * tasks * images * (2 * 2 * f) * cfg.num_output_units
    assert flops == conv + linear
    assert JaxConfig(**BASE).image_shape == cfg.image_shape
