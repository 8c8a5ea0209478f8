"""The PyTorch/CUDA port stands alone: import isolation and config parity.

* Every module of ``howtotrainyourmamlpytorch_tpu_torch`` imports in a
  process where ``jax`` cannot be imported.
* No module of the port, nor ``chip_smoke.py``, imports ``jax``, ``flax``,
  ``optax``, ``msgpack`` or the JAX package — compared on the exact
  top-level module name, since the port's own name begins with the JAX
  package's.
* The port's own copy of ``MAMLConfig`` resolves every shipped experiment
  JSON to the same values as the JAX package's, field by field.
"""

import ast
import dataclasses
import glob
import os
import subprocess
import sys

import pytest

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "howtotrainyourmamlpytorch_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack",
             "howtotrainyourmamlpytorch_tpu"}

PORT_FILES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True)
) + ["chip_smoke.py"]
CONFIGS = sorted(os.path.basename(p) for p in glob.glob(
    os.path.join(REPO, "experiment_config", "*.json")))


def _imported_top_levels(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("relpath", PORT_FILES)
def test_no_jax_or_jax_package_import(relpath):
    tops = set(_imported_top_levels(os.path.join(REPO, relpath)))
    assert not tops & FORBIDDEN, f"{relpath} imports {tops & FORBIDDEN}"


def test_every_port_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack',\n"
        "             'howtotrainyourmamlpytorch_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import howtotrainyourmamlpytorch_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__,\n"
        "                                              p.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a CUDA card, and alone in a directory, the smoke
    script exits non-zero and prints no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    for cwd, script in ((REPO, os.path.join(REPO, "chip_smoke.py")),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


@pytest.mark.parametrize("name", CONFIGS)
def test_config_matches_jax_package(name):
    path = os.path.join(REPO, "experiment_config", name)
    ours, ref = MAMLConfig.from_json_file(path), JaxConfig.from_json_file(path)
    assert ours.to_dict() == ref.to_dict()
    for prop in ("image_shape", "image_norm_resolved", "bn_num_steps",
                 "lslr_num_steps", "effective_serve_adapt_steps",
                 "serve_bucket_shapes", "num_output_units",
                 "num_support_per_task", "num_target_per_task"):
        assert getattr(ours, prop) == getattr(ref, prop), prop
    assert dataclasses.asdict(ours.algo) == dataclasses.asdict(ref.algo)


def test_config_validation_matches_jax_package():
    """The locally copied validators reject what the JAX package's do."""
    for bad in ({"bn_backend": "cuda"}, {"fault_spec": "nan_loss"},
                {"xla_compiler_options": ["k=1", "k=2"]},
                {"meta_algorithm": "mamll++"},
                {"bn_backend": "pallas", "norm_layer": "layer_norm"}):
        with pytest.raises(ValueError):
            JaxConfig.from_dict(bad)
        with pytest.raises(ValueError):
            MAMLConfig.from_dict(bad)
    ok = {"fault_spec": "io_write@1;nan_loss@5:2",
          "xla_compiler_options": {"b": "1", "a": "2"}}
    assert MAMLConfig.from_dict(ok).to_dict() == JaxConfig.from_dict(
        ok).to_dict()
