"""The port's launch-script generator (``utils/script_gen.py``,
``scripts/torch_generate_scripts.py``) against the JAX package's over the
shipped ``experiment_config/*.json``: the same script set, each launching
the same config with the same arguments through the port's CLI; the
cluster variant a ``torchrun`` launch of the JSON's ``mesh_shape``; every
script parses (``bash -n``); the CLI never writes the JAX generator's
``experiment_scripts/``."""

import json
import os
import re
import shlex
import subprocess
import sys

import pytest

from howtotrainyourmamlpytorch_tpu.utils import script_gen as jgen
from howtotrainyourmamlpytorch_tpu_torch.utils import script_gen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "experiment_config")


def _exec_args(text):
    """The argument words of a script's ``exec`` command (continuation
    lines joined; shell expansions kept as written)."""
    cmd = text[text.index("exec "):].replace("\\\n", " ")
    return shlex.split(cmd.splitlines()[0])[1:]


def _after(args, flag):
    return args[args.index(flag) + 1]


@pytest.mark.parametrize("cluster", [False, True])
def test_script_set_and_arguments_match_the_jax_generator(tmp_path,
                                                          cluster):
    want = jgen.generate_launch_scripts(CONFIGS, str(tmp_path / "jax"),
                                        cluster=cluster)
    got = script_gen.generate_launch_scripts(CONFIGS, str(tmp_path / "pt"),
                                             cluster=cluster)
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    assert len(got) == len([f for f in os.listdir(CONFIGS)
                            if f.endswith(".json")])
    for g, w in zip(got, want):
        assert os.access(g, os.X_OK)
        subprocess.run(["bash", "-n", g], check=True)
        ga, wa = (_exec_args(open(p).read()) for p in (g, w))
        cfg_path = _after(wa, "--name_of_args_json_file")
        assert _after(ga, "--name_of_args_json_file") == cfg_path
        assert ga[-1] == wa[-1] == "$@"
        assert ("--continue_from_epoch" in ga) == cluster == (
            "--continue_from_epoch" in wa)
        assert _after(ga, "-m") == script_gen.CLI_MODULE
        with open(os.path.join(REPO, cfg_path)) as f:
            dcn, tasks = (int(v) for v in json.load(f).get(
                "mesh_shape", (1, 1)))
        if cluster:
            assert ga[0] == "torchrun"
            assert (int(_after(ga, "--nnodes")),
                    int(_after(ga, "--nproc_per_node"))) == (dcn, tasks)
        else:
            assert ga[0] == "python"
            assert _after(ga, "--device") == "${DEVICE:-cuda}"


def test_pod_config_is_a_four_node_torchrun(tmp_path):
    out = script_gen.generate_launch_scripts(CONFIGS, str(tmp_path),
                                             cluster=True)
    pod = [p for p in out if "resnet12_pod" in p][0]
    text = open(pod).read()
    assert re.search(r"torchrun --nnodes 4 --nproc_per_node 8", text)


def test_cli_writes_its_own_directory_only(tmp_path):
    out_dir = os.path.relpath(tmp_path / "scripts", REPO)
    proc = subprocess.run(
        [sys.executable, "scripts/torch_generate_scripts.py", "--cluster",
         "--out", out_dir], cwd=REPO, capture_output=True, text=True,
        timeout=60, check=True)
    listed = proc.stdout.split()
    assert len(listed) == 2 * len([f for f in os.listdir(CONFIGS)
                                   if f.endswith(".json")])
    assert all(p.startswith(out_dir) for p in listed)
    refused = subprocess.run(
        [sys.executable, "scripts/torch_generate_scripts.py", "--out",
         "experiment_scripts"], cwd=REPO, capture_output=True, text=True,
        timeout=60)
    assert refused.returncode == 2 and "JAX generator" in refused.stderr


def test_config_variant_grid_equals_jax(tmp_path):
    base = {"dataset_name": "omniglot_dataset", "batch_size": 16}
    grid = {"num_classes_per_set": [5, 20], "num_samples_per_class": [1, 5]}
    name = "omniglot_{num_classes_per_set}-way_{num_samples_per_class}-shot"
    want = jgen.generate_config_variants(base, grid, name,
                                         str(tmp_path / "jax"))
    got = script_gen.generate_config_variants(base, grid, name,
                                              str(tmp_path / "pt"))
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        assert open(g).read() == open(w).read()
