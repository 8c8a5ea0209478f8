"""``scripts/torch_accuracy_gate.py`` against the JAX package's
``scripts/accuracy_gate.py`` (the counterparts of
``tests/test_accuracy_gate.py``'s seven tests), on the CPU: the same
refusals with the same exit codes (synthetic data, a missing dataset
with its provisioning instructions, a workload with no paper row, usage
errors as exit 1), the same paper tables and thresholds, and the
verdict end to end on a small real PNG tree through the port's trainer
(``--device cpu``): a pass at ``--min-accuracy 0`` (exit 0) and a run
below the paper's gate (exit 2)."""

import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import accuracy_gate  # noqa: E402
import torch_accuracy_gate  # noqa: E402

FLAGSHIP = os.path.join(
    REPO, "experiment_config", "mini-imagenet_maml++_5-way_5-shot_DA.json")
POD = os.path.join(REPO, "experiment_config",
                   "tiered-imagenet_maml++_5-way_5-shot_resnet12_pod.json")


def _both(argv, capsys):
    out = []
    for mod in (torch_accuracy_gate, accuracy_gate):
        rc = mod.main(list(argv))
        out.append((rc, json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])))
    return out


def test_gate_refuses_synthetic(capsys):
    for rc, verdict in _both(["--config", FLAGSHIP, "--dataset_name",
                              "synthetic_mini"], capsys):
        assert rc == 1 and verdict["pass"] is False
        assert "synthetic" in verdict["error"]


def test_gate_requires_real_dataset(tmp_path, capsys):
    for rc, verdict in _both(["--config", FLAGSHIP, "--dataset_path",
                              str(tmp_path / "nonexistent")], capsys):
        assert rc == 1 and verdict["pass"] is False
        assert "no real dataset" in verdict["error"]
        assert "zip" in verdict["error"]


def test_gate_requires_threshold_for_unknown_workload(capsys):
    for rc, verdict in _both(["--config", POD], capsys):
        assert rc == 1 and "min-accuracy" in verdict["error"]


@pytest.mark.parametrize("argv", [
    ["--config", FLAGSHIP, "--min-accuracy", "abc"], [],
    ["--config", FLAGSHIP, "--no_such_field", "1"]])
def test_gate_usage_errors_exit_1_not_2(argv, capsys):
    for rc, verdict in _both(argv, capsys):
        assert rc == 1 and verdict["pass"] is False


def test_gate_paper_tables_equal_jax_and_baseline_md():
    assert torch_accuracy_gate.PAPER_GATES == accuracy_gate.PAPER_GATES
    assert (torch_accuracy_gate.FIRST_ORDER_GATES
            == accuracy_gate.FIRST_ORDER_GATES)
    md = open(os.path.join(REPO, "BASELINE.md")).read()
    for (acc, ci) in torch_accuracy_gate.PAPER_GATES.values():
        assert f"{100 * acc:.2f}" in md
        if ci:
            assert f"± {100 * ci:.2f}" in md


@pytest.mark.parametrize("dataset", ["mini_imagenet_full_size",
                                     "omniglot_dataset",
                                     "tiered_imagenet", "sinusoid"])
@pytest.mark.parametrize("algo", ["maml++", "fomaml", "reptile"])
@pytest.mark.parametrize("way_shot", [(5, 1), (5, 5), (20, 1), (20, 5)])
def test_gate_threshold_equals_jax(dataset, algo, way_shot):
    class C:
        dataset_name = dataset
        meta_algorithm = algo
        num_classes_per_set, num_samples_per_class = way_shot
    assert torch_accuracy_gate.paper_gate(C) == accuracy_gate.paper_gate(C)


def test_gate_end_to_end_on_real_png_tree(tmp_path, capsys):
    """The port's trainer on the CPU through the full (shrunk) schedule
    and the ensemble test on random-noise PNGs: a pass at
    ``--min-accuracy 0`` with the protocol's evidence, then the paper's
    gate missed with exit 2 (ran and missed, not an error)."""
    from helpers import make_png_split_tree
    data = tmp_path / "pngset"
    make_png_split_tree(data, {"train": 6, "val": 5, "test": 5},
                        np.random.default_rng(0), size=(12, 12),
                        images_per_class=8)
    small = ["--dataset_path", str(data), "--device", "cpu",
             "--image_height", "12", "--image_width", "12",
             "--cnn_num_filters", "4", "--num_stages", "2",
             "--batch_size", "4", "--task_microbatches", "1",
             "--number_of_training_steps_per_iter", "1",
             "--number_of_evaluation_steps_per_iter", "1",
             "--multi_step_loss_num_epochs", "1",
             "--first_order_to_second_order_epoch", "-1",
             "--eval_batch_size", "8"]
    rc = torch_accuracy_gate.main(
        ["--config", FLAGSHIP, "--min-accuracy", "0.0",
         "--experiment_root", str(tmp_path / "exp"),
         "--total_epochs", "2", "--total_iter_per_epoch", "2",
         "--num_evaluation_tasks", "16", *small])
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, verdict
    assert verdict["pass"] is True
    assert verdict["threshold_source"] == "--min-accuracy"
    assert verdict["dataset_path"] == str(data)
    assert verdict["num_episodes"] == 16 and verdict["num_models"] == 2
    assert 0.0 <= verdict["test_accuracy_mean"] <= 1.0
    rc = torch_accuracy_gate.main(
        ["--config", FLAGSHIP, "--experiment_root", str(tmp_path / "exp2"),
         "--total_epochs", "1", "--total_iter_per_epoch", "1",
         "--num_evaluation_tasks", "8", *small])
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 2 and verdict["pass"] is False
    assert verdict["threshold"] == pytest.approx(0.6832 - 0.0044)
    assert verdict["paper_mean"] == pytest.approx(0.6832)
    assert verdict["margin"] == pytest.approx(0.0044)
    assert verdict["strict_pass"] is False
    assert verdict["threshold_source"] == \
        "BASELINE.md MAML++ paper table, mean - CI"
