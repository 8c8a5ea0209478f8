"""The port's autotune trial leg (``tune/trial.py``) against the JAX
package's ``bench.py`` pieces it copies, on the CPU: ``quick_shrink``,
``load_workload``, ``synthetic_batch`` and the tuned-record helpers give
the same configs and arrays (exact equality); the leg, run at a tiny
size with ``--device cpu``, prints the artifact contract with a rate
and no MFU (a CPU has no peak), which the harness ranks on tasks/s as
the JAX harness does; an unknown backend option fails it with the
marker before its first step, and the CLI's trainer likewise."""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import bench
from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu_torch import device as dev
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.tune import harness, record, space
from howtotrainyourmamlpytorch_tpu_torch.tune import trial as leg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "experiment_config", "*.json")))
FLAGSHIP = os.path.join(REPO, "experiment_config",
                        "mini-imagenet_maml++_5-way_5-shot_DA_b12.json")
# The flagship at one inner step: a trial child's step takes well under
# a second on the CPU at the quick shapes.
TINY = {"total_epochs": 3, "first_order_to_second_order_epoch": 1,
        "multi_step_loss_num_epochs": 1,
        "number_of_training_steps_per_iter": 1,
        "number_of_evaluation_steps_per_iter": 1,
        "compute_dtype": "float32", "bn_fast_math": False}


def tiny_config(tmp_path, **extra):
    with open(FLAGSHIP) as f:
        doc = {**json.load(f), **TINY, **extra}
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(doc))
    return str(path)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_workload_and_quick_shrink_equal_bench(path):
    ours = leg.load_workload(path)
    ref = bench.load_workload(path, 0, 1)
    assert ours.to_dict() == ref.to_dict()
    assert leg.quick_shrink(ours, 1).to_dict() == bench.quick_shrink(
        ref, 1).to_dict()


@pytest.mark.parametrize("kw", [dict(batch_size=16, task_microbatches=4),
                                dict(batch_size=3, task_microbatches=3),
                                dict(compute_dtype="float32")])
def test_quick_shrink_table_equals_bench(kw):
    ours = leg.quick_shrink(MAMLConfig(**kw), 1)
    ref = bench.quick_shrink(JaxConfig(**kw), 1)
    assert ours.to_dict() == ref.to_dict()


@pytest.mark.parametrize("path", [FLAGSHIP, os.path.join(
    REPO, "experiment_config", "sinusoid_maml_5-shot.json")])
def test_synthetic_batch_equals_bench(path):
    cfg = leg.quick_shrink(leg.load_workload(path), 1)
    ours = leg.synthetic_batch(cfg, 3)
    ref = bench.synthetic_batch(bench.quick_shrink(
        bench.load_workload(path, 0, 1), 1), 3)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype


def test_tuned_record_helpers_equal_bench(tmp_path):
    p = record.write_tuned(str(tmp_path), {
        "adopted": True,
        "xla_compiler_options": {"cudnn_deterministic": "false"},
        "config_overrides": {"remat_policy": "dots",
                             "task_microbatches": 12}})
    assert leg.read_tuned_record(p) == bench.read_tuned_record(p)
    opts, overrides = leg.read_tuned_record(p)
    kw = dict(batch_size=2, compute_dtype="float32")
    ours = leg.apply_tuned_overrides(MAMLConfig(**kw), overrides, 1)
    ref = bench.apply_tuned_overrides(JaxConfig(**kw), overrides, 1)
    assert ours.to_dict() == ref.to_dict()
    assert ours.task_microbatches == 2
    with pytest.raises(ValueError, match="config_overrides"):
        leg.apply_tuned_overrides(MAMLConfig(**kw), {"not_a_field": 1}, 1)


def test_trial_leg_on_the_cpu_and_its_ranking(tmp_path):
    """The real leg as the harness runs it: an ``ok`` row ranked on
    tasks/s (no MFU on the CPU) with the artifact's keys, and an
    unknown option counted ``invalid_flag`` with the marker, from a
    child that failed before its first step."""
    base = json.loads(open(tiny_config(tmp_path)).read())
    sweep = str(tmp_path / "sweep")
    ok = harness.run_trial(
        space.Trial("baseline", {}, {}, {}), base_config=base,
        sweep_dir=sweep, steps=2, quick=True, timeout_s=300,
        device="cpu")
    assert ok["outcome"] == "ok", ok
    assert ok["objective_key"] == "tasks_per_sec_per_chip"
    assert ok["objective"] == ok["value"] > 0
    assert "mfu" not in ok and ok["bn_launches"] == 0
    assert ok["device_kind"] == "cpu" and ok["flops_per_task"] > 0
    log = open(os.path.join(sweep, ok["log"])).read()
    art = harness.last_json_line(log.split("--- stderr ---")[0])
    assert art["metric"] == "meta_tasks_per_sec_per_chip"
    assert art["mfu"] is None and art["steps"] == 2
    assert (art["second_order"], art["use_msl"]) == (True, False)
    bad = space.Trial("x", {"cudnn_fastest": "true"},
                      {"cudnn_fastest": "true"}, {})
    row = harness.run_trial(bad, base_config=base, sweep_dir=sweep,
                            steps=2, quick=True, timeout_s=300,
                            device="cpu")
    assert row["outcome"] == "invalid_flag" and row["returncode"] == 1
    assert row["error"].startswith("ValueError: " + dev.NO_SUCH_OPTION)


def test_trial_leg_without_a_card_refuses(tmp_path):
    """No ``--device cpu`` and no card: the leg raises (no quiet CPU
    run)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", harness.TRIAL_MODULE, "--config",
         tiny_config(tmp_path), "--quick"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1
    assert "no CUDA device" in json.loads(
        proc.stdout.strip().splitlines()[-1])["error"]


def test_cli_with_an_unknown_option_fails_before_its_first_step(tmp_path):
    """The trainer CLI on the CPU with ``--xla_compiler_options`` naming
    no backend option raises the marker before any train step (no
    ``warm_start`` row, which the first step writes)."""
    from howtotrainyourmamlpytorch_tpu_torch import train_maml_system
    args = ["--name_of_args_json_file", tiny_config(tmp_path),
            "--experiment_root", str(tmp_path / "exp"),
            "--image_height", "12", "--image_width", "12",
            "--cnn_num_filters", "4", "--num_stages", "2",
            "--batch_size", "2", "--task_microbatches", "1",
            "--total_epochs", "1", "--total_iter_per_epoch", "1",
            "--num_evaluation_tasks", "2",
            "--xla_compiler_options", "cudnn_fastest=true"]
    with pytest.raises(ValueError, match=dev.NO_SUCH_OPTION):
        train_maml_system.main(args, device="cpu")
    events = glob.glob(str(tmp_path / "exp" / "**" / "events.jsonl"),
                       recursive=True)
    rows = [json.loads(line) for p in events for line in open(p)]
    assert not [r for r in rows if r.get("event") in ("warm_start",
                                                      "train_epoch")]


def test_trial_leg_applies_an_adopted_record(tmp_path, capsys):
    """``--tuned`` applies an adopted record's options and structural
    overrides (the artifact says which ran); a rejected record, or
    ``--tuned`` beside ``--backend-option``, fails the leg."""
    cfg = tiny_config(tmp_path)
    tuned = record.write_tuned(str(tmp_path), {
        "adopted": True,
        "xla_compiler_options": {"cudnn_deterministic": "false"},
        "config_overrides": {"remat_policy": "nothing"}})
    (tmp_path / "no").mkdir()
    argv = ["--config", cfg, "--quick", "--device", "cpu", "--steps", "1"]
    assert leg.main(argv + ["--tuned", tuned]) == 0
    art = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert art["backend_options"] == {"cudnn_deterministic": "false"}
    assert art["value"] > 0
    for extra in (["--tuned", tuned, "--backend-option",
                   "cudnn_benchmark=true"],
                  ["--tuned", record.write_tuned(
                      str(tmp_path / "no"), {"adopted": False,
                                             "reason": "parity"})]):
        assert leg.main(argv + extra) == 1
        err = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert err["error"].startswith("ValueError")
