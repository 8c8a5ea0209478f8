"""The port's run report (``telemetry/report.py``,
``scripts/torch_telemetry_report.py``) against the JAX package's, on the
CPU: ``summarize_events`` and ``format_table`` give the same summary and
table for the same rows (a port CLI run trained from a packed shard, and
the JAX report tests' fixture streams), the two CLIs print the same last
line, the port's report resolves the port's ``telemetry/reqtrace.py``,
and a pack quarantine reads through the port's report.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import test_telemetry_report as jfixtures
from helpers import make_png_split_tree
from howtotrainyourmamlpytorch_tpu.telemetry import report as jreport
from howtotrainyourmamlpytorch_tpu_torch import resilience
from howtotrainyourmamlpytorch_tpu_torch import train_maml_system as cli
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.data import (
    DiskImageSource, build_source, pack_shard_path)
from howtotrainyourmamlpytorch_tpu_torch.datastore import write_shard
from howtotrainyourmamlpytorch_tpu_torch.telemetry import (MetricsRegistry,
                                                           report)
from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import (JsonlLogger,
                                                               read_jsonl)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CLI = os.path.join(REPO, "scripts", "torch_telemetry_report.py")
JAX_CLI = os.path.join(REPO, "scripts", "telemetry_report.py")
RUN = dict(
    experiment_name="report", dataset_name="packed_smoke",
    image_height=12, image_width=12, image_channels=1,
    num_classes_per_set=3, num_samples_per_class=1, num_target_samples=2,
    batch_size=2, cnn_num_filters=4, num_stages=2,
    number_of_training_steps_per_iter=1,
    number_of_evaluation_steps_per_iter=1, total_epochs=2,
    total_iter_per_epoch=2, num_evaluation_tasks=2, max_models_to_save=1,
    dispatch_sync_every=1, health_metrics_every_n_steps=1,
    compute_dtype="float32", bn_fast_math=False, bn_backend="composite")


def _packed_png_dataset(root, name):
    """A PNG tree of three splits under ``root/name``, each packed next
    to its split dir."""
    make_png_split_tree(root / name, {"train": 6, "val": 4, "test": 4},
                        np.random.default_rng(5), images_per_class=4)
    cfg = MAMLConfig(**{**RUN, "dataset_path": str(root)})
    for split in ("train", "val", "test"):
        disk = DiskImageSource(str(root / name / split), cfg.image_shape)
        write_shard(pack_shard_path(cfg, split),
                    ((n, disk.class_images(n)) for n in disk.class_names))
    return cfg


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A tiny port CLI run trained from packed shards: its run dir and
    events."""
    root = tmp_path_factory.mktemp("report")
    _packed_png_dataset(root / "data", RUN["dataset_name"])
    cfg_path = root / "cfg.json"
    cfg_path.write_text(json.dumps({**RUN,
                                    "dataset_path": str(root / "data")}))
    builders = []
    assert cli.main(["--name_of_args_json_file", str(cfg_path),
                     "--experiment_root", str(root / "runs")],
                    device="cpu", builders=builders) == 0
    base = builders[0].paths["base"]
    return base, read_jsonl(os.path.join(base, "logs", "events.jsonl"))


def test_summary_and_table_equal_jax_on_a_port_run(run):
    _, events = run
    ours, theirs = report.summarize_events(events), jreport.summarize_events(
        events)
    assert ours == theirs
    assert report.format_table(ours) == jreport.format_table(theirs)
    assert ours["schema"] == jreport.SCHEMA
    assert ours["epochs"] == 2 and ours["steps"] == 4
    assert ours["data"]["source_kind"] == "packed"
    assert isinstance(ours["feed_stall_frac"], float)


FIXTURES = [dict(), dict(with_failsoft=False), dict(with_serving=True),
            dict(with_resilience=True), dict(with_data=True),
            dict(with_watchdog=True), dict(with_health=True),
            dict(with_checkpoint=True), dict(with_cluster=True)]


@pytest.mark.parametrize("kw", FIXTURES,
                         ids=lambda kw: next(iter(kw), "default"))
def test_summary_and_table_equal_jax_on_fixtures(tmp_path, kw):
    """The JAX report tests' synthetic streams, section by section."""
    path = tmp_path / "events.jsonl"
    jfixtures.write_fixture_events(path, **kw)
    events = read_jsonl(str(path))
    ours, theirs = report.summarize_events(events), jreport.summarize_events(
        events)
    assert ours == theirs
    assert report.format_table(ours) == jreport.format_table(theirs)


def _cli(script, *args):
    return subprocess.run([sys.executable, script, *args],
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)


def test_cli_last_lines_equal(run, tmp_path):
    base, _ = run
    for args in ([base], [base, "--json"],
                 [os.path.join(base, "logs", "events.jsonl")]):
        ours, theirs = _cli(PORT_CLI, *args), _cli(JAX_CLI, *args)
        assert ours.returncode == theirs.returncode == 0, ours.stderr
        assert ours.stdout == theirs.stdout
        summary = json.loads(ours.stdout.strip().splitlines()[-1])
        assert summary["steps"] == 4
    missing = str(tmp_path / "absent")
    ours, theirs = _cli(PORT_CLI, missing), _cli(JAX_CLI, missing)
    assert ours.returncode == theirs.returncode == 1
    assert ours.stdout == theirs.stdout and "error" in ours.stdout


def test_report_resolves_the_ports_reqtrace():
    """The requests section reads the port's ``telemetry/reqtrace.py``
    (the package module when imported, else a file-path load under the
    port's own alias), never the JAX package's."""
    mod = report._reqtrace()
    assert os.path.samefile(
        mod.__file__, os.path.join(REPO, "howtotrainyourmamlpytorch_tpu_torch",
                                   "telemetry", "reqtrace.py"))
    code = ("import importlib.util, sys\n"
            "spec = importlib.util.spec_from_file_location('r', "
            "'howtotrainyourmamlpytorch_tpu_torch/telemetry/report.py')\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            "print(m._reqtrace().__name__, 'torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["_maml_torch_report_reqtrace", "False"]


def test_corrupt_pack_quarantine_visible_in_telemetry_report(tmp_path):
    """A quarantined shard counts ``resilience/quarantined``, which the
    port's report surfaces beside the source that fed the split."""
    cfg = _packed_png_dataset(tmp_path, RUN["dataset_name"])
    with open(pack_shard_path(cfg, "train"), "r+b") as f:
        f.seek(30)
        b = f.read(1)
        f.seek(30)
        f.write(bytes([b[0] ^ 0xFF]))
    reg = MetricsRegistry()
    prev = resilience.set_registry(reg)
    try:
        with pytest.warns(UserWarning, match="quarantined"):
            build_source(cfg, "train")
    finally:
        resilience.set_registry(prev)
    log = JsonlLogger(str(tmp_path / "events.jsonl"))
    reg.flush_jsonl(log)
    s = report.summarize_events(read_jsonl(log.path))
    assert s["resilience"]["quarantined"] == 1
    assert s["data"]["source_kind"] == "disk"
