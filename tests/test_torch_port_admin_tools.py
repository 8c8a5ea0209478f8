"""The port's operator tools that the JAX package's load by path —
``scripts/torch_ckpt_admin.py`` and ``scripts/torch_perf_report.py`` —
against ``scripts/ckpt_admin.py`` and ``scripts/perf_report.py`` on one
port run, on the CPU.

Each subcommand runs through both tools on identical copies of the run's
``saved_models`` (the port's with ``jax`` and the JAX package blocked):
the same last line (its directory aside), exit code and resulting files
(``MANIFEST.json`` records, ``REGISTRY.json`` versions without their
timestamps). The perf reports read the run's ``PROFILE.json`` and
``perf_profile`` rows to the same artifact; the port's table says why
the roofline verdict is "unknown" (the CPU has no peaks on record).
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentBuilder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
# Runs a script with jax and the JAX package unimportable.
BLOCKED = ("import sys, runpy\n"
           "for n in ('jax', 'jaxlib', 'flax', 'optax',\n"
           "          'howtotrainyourmamlpytorch_tpu'):\n"
           "    sys.modules[n] = None\n"
           "sys.argv = sys.argv[1:]\n"
           "runpy.run_path(sys.argv[0], run_name='__main__')\n")
RUN = dict(
    experiment_name="admin", dataset_name="synthetic_admin",
    image_height=10, image_width=10, image_channels=1,
    num_classes_per_set=3, num_samples_per_class=1, num_target_samples=2,
    batch_size=2, cnn_num_filters=4, num_stages=2,
    number_of_training_steps_per_iter=1,
    number_of_evaluation_steps_per_iter=1, second_order=False,
    use_multi_step_loss_optimization=False, total_epochs=3,
    total_iter_per_epoch=3, num_evaluation_tasks=2, max_models_to_save=3,
    dispatch_sync_every=1, profile_every_n_steps=2, ckpt_publish=1,
    compute_dtype="float32")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("admin")
    ExperimentBuilder(MAMLConfig(experiment_root=str(root), **RUN),
                      device="cpu").run_experiment()
    return os.path.join(str(root), "admin")


def _tool(script, args, blocked):
    cmd = ([sys.executable, "-c", BLOCKED] if blocked else [sys.executable])
    proc = subprocess.run(cmd + [os.path.join(SCRIPTS, script)] + args,
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    lines = proc.stdout.strip().splitlines()
    return proc.returncode, json.loads(lines[-1]), proc.stdout


def _files(saved):
    out = {}
    for name in ("MANIFEST.json", "REGISTRY.json"):
        path = os.path.join(saved, name)
        if os.path.exists(path):
            with open(path) as f:
                doc = json.load(f)
            for v in doc.get("versions", []):
                for key in ("published_ts", "rolled_back_ts"):
                    v.pop(key, None)
            out[name] = doc
    out["files"] = sorted(os.listdir(saved))
    return out


@pytest.mark.parametrize("args", [
    ["list"], ["verify"], ["gc", "--max-to-keep", "1", "--dry-run"],
    ["gc", "--max-to-keep", "1"], ["publish", "--tag", "0"],
    ["publish", "--tag", "nope"], ["rollback", "--version", "1"],
    ["rollback", "--version", "99"], ["verify", "--corrupt"]],
    ids=lambda a: "_".join(x.strip("-") for x in a))
def test_ckpt_admin_equals_jax(run, tmp_path, args):
    """Both tools on identical copies: the same artifact, exit code and
    files; a damaged checkpoint fails verify in both."""
    results = {}
    for name, script, blocked in (("jax", "ckpt_admin.py", False),
                                  ("port", "torch_ckpt_admin.py", True)):
        copy = os.path.join(str(tmp_path), name)
        shutil.copytree(os.path.join(run, "saved_models"), copy)
        cmd = [a for a in args if a != "--corrupt"]
        if "--corrupt" in args:
            with open(os.path.join(copy, "train_model_1.ckpt"), "r+b") as f:
                f.seek(40)
                f.write(b"\xff\xfe")
        rc, art, out = _tool(script, [cmd[0], copy] + cmd[1:], blocked)
        art.pop("directory")
        results[name] = (rc, art, _files(copy))
    assert results["port"] == results["jax"]
    rc, art, _ = results["port"]
    assert art["metric"] == "ckpt_admin" and art["command"] == args[0]
    want_ok = not ({"nope", "99", "--corrupt"} & set(args))
    assert (rc == 0) == want_ok and art["ok"] == want_ok


def test_perf_report_equals_jax_and_names_the_unknown_bound(run):
    ours_rc, ours, table = _tool("torch_perf_report.py", [run], True)
    ref_rc, ref, _ = _tool("perf_report.py", [run], False)
    assert ours_rc == ref_rc == 0
    assert ours == ref
    assert ours["metric"] == "perf_report" and ours["cards"] >= 1
    assert ours["samples"] >= 1
    assert ours["top_executable_bound"] == "unknown"
    assert "no peak FLOP/s or HBM bandwidth" in table
    assert _tool("torch_perf_report.py", [run, "--json"], True)[1] == ours
    # Nothing to read: exit 1, as the JAX tool.
    empty = os.path.join(run, "saved_models")
    assert _tool("torch_perf_report.py", [empty], True)[0] == \
        _tool("perf_report.py", [empty], False)[0] == 1
