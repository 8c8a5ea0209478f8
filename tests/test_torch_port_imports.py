"""The PyTorch/CUDA port stands alone: import isolation and config parity.

* Every module of ``howtotrainyourmamlpytorch_tpu_torch``, and the port's
  scripts (``scripts/torch_*.py``), import in a process where ``jax``
  cannot be imported.
* No module of the port, nor ``chip_smoke.py`` or a port script,
  imports ``jax``, ``flax``, ``optax``, ``msgpack`` or the JAX package —
  compared on the exact top-level module name, since the port's own
  name begins with the JAX package's — nor names a JAX-package module,
  or one of the private aliases the JAX package's file-path loaders
  register, in a string literal: a loader that looks such a name up in
  ``sys.modules`` would run the JAX package's module in a process that
  imported it first.
* The port's own copy of ``MAMLConfig`` resolves every shipped experiment
  JSON to the same values as the JAX package's, field by field.
"""

import ast
import dataclasses
import glob
import os
import re
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
) + ["chip_smoke.py"] + sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "scripts", "torch_*.py")))
PORT_SCRIPTS = ("torch_accuracy_gate", "torch_aot_prewarm",
                "torch_autotune", "torch_bf16_drift", "torch_chaos_fleet",
                "torch_chaos_pod", "torch_chaos_run",
                "torch_ckpt_admin", "torch_dataset_pack",
                "torch_fleet_bench", "torch_generate_scripts",
                "torch_ops_console", "torch_perf_eval", "torch_perf_msl",
                "torch_perf_microbatch_sweep", "torch_perf_report",
                "torch_perf_resnet12_sweep", "torch_perf_sweep",
                "torch_perf_variants", "torch_perf_window_probe",
                "torch_serve_bench", "torch_serve_profile",
                "torch_slo_report", "torch_telemetry_report",
                "torch_trace_export", "torch_traffic_replay",
                "torch_tune_parity")
# A dotted JAX-package module name (or the bare package name), and the
# aliases of the JAX package's file-path loaders.
JAX_MODULE_NAME = re.compile(
    r"(?<![\w.])howtotrainyourmamlpytorch_tpu(?:\.\w|$)")
# A string that IS a path to a JAX-package source file (what a file-path
# loader opens); a citation with a line number or prose is not.
JAX_MODULE_PATH = re.compile(
    r"(?:.*[/\\])?howtotrainyourmamlpytorch_tpu[/\\][\w/\\.]*\.py")
JAX_ALIASES = ("_maml_fleet_router_sup", "_maml_fleet_retry_sup",
               "_maml_fleet_reqtrace", "_maml_loadlab_trace",
               "_report_reqtrace_impl", "_telemetry_report_impl",
               "_telemetry_tracing_impl", "_dataset_pack_sources")
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


def _jax_names_in_strings(source):
    """String literals of ``source`` that name a JAX-package module or
    one of its loader aliases."""
    out = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if (JAX_MODULE_NAME.search(node.value)
                    or JAX_MODULE_PATH.fullmatch(node.value)
                    or any(a in node.value for a in JAX_ALIASES)):
                out.append(node.value)
    return out


@pytest.mark.parametrize("relpath", PORT_FILES)
def test_no_jax_or_jax_package_import(relpath):
    tops = set(_imported_top_levels(os.path.join(REPO, relpath)))
    assert not tops & FORBIDDEN, f"{relpath} imports {tops & FORBIDDEN}"
    named = _jax_names_in_strings(open(os.path.join(REPO, relpath)).read())
    assert not named, f"{relpath} names JAX-package modules: {named}"


def test_string_guard_catches_jax_module_names():
    """The string check flags what the JAX package's fleet loaders and
    its jax-free scripts use (module names, aliases, paths to its source
    files) and passes what the port's use, a kernel citation with its
    line and prose."""
    bad = ['_PKG = "howtotrainyourmamlpytorch_tpu.serve.fleet.router"',
           'importlib.import_module("howtotrainyourmamlpytorch_tpu")',
           'sys.modules.get("_maml_fleet_router_sup")',
           'load("_maml_fleet_retry_sup")',
           'spec("_maml_fleet_reqtrace", p)', 'spec("_maml_loadlab_trace")',
           'spec("_report_reqtrace_impl", p)',
           'load("_telemetry_report_impl", rel)',
           'sys.modules.get("howtotrainyourmamlpytorch_tpu.telemetry'
           '.reqtrace")',
           'os.path.join("howtotrainyourmamlpytorch_tpu", "telemetry",'
           ' "alerts.py")',
           'os.path.join(REPO, "howtotrainyourmamlpytorch_tpu/utils/'
           'tracing.py")',
           'spec(n, f"{root}/howtotrainyourmamlpytorch_tpu/serve/fleet/'
           'router.py")']
    good = ['_PKG = "howtotrainyourmamlpytorch_tpu_torch.serve.fleet.router"',
            '"_maml_torch_fleet_router_sup"', '"_maml_torch_report_reqtrace"',
            'sys.modules.get("howtotrainyourmamlpytorch_tpu_torch.telemetry"'
            ' ".reqtrace")',
            '"howtotrainyourmamlpytorch_tpu/ops/pallas_fused.py:67"',
            '"howtotrainyourmamlpytorch_tpu_torch/telemetry/alerts.py"',
            '"""A copy of ``howtotrainyourmamlpytorch_tpu/config.py``."""',
            '"""the JAX package ``howtotrainyourmamlpytorch_tpu``."""']
    assert all(_jax_names_in_strings(src) for src in bad)
    assert not any(_jax_names_in_strings(src) for src in good)


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
        "import importlib.util as u\n"
        f"for name in {PORT_SCRIPTS!r}:\n"
        "    spec = u.spec_from_file_location(name, f'scripts/{name}.py')\n"
        "    spec.loader.exec_module(u.module_from_spec(spec))\n"
        "print(' '.join(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) >= 30
    assert {f"howtotrainyourmamlpytorch_tpu_torch.resilience.{m}"
            for m in ("faults", "flightrec", "watchdog", "cluster",
                      "elastic")} <= mods
    assert {f"howtotrainyourmamlpytorch_tpu_torch.{m}" for m in (
        "parallel", "parallel.mesh", "parallel.multihost",
        "utils.script_gen")} <= mods
    assert {f"howtotrainyourmamlpytorch_tpu_torch.{m}" for m in (
        "telemetry.reqtrace", "serve.fleet.l2cache", "serve.fleet.router",
        "serve.fleet.controller", "serve.fleet.supervisor",
        "serve.fleet.replica", "serve.loadlab.trace",
        "serve.loadlab.workloads", "serve.loadlab.replay",
        "datastore", "datastore.format", "datastore.packed",
        "telemetry.report", "tune", "tune.space", "tune.record",
        "tune.harness", "tune.trial")} <= mods


def test_autotune_driver_and_tune_modules_import_no_torch():
    """The autotune driver runs where torch cannot be imported, as the
    JAX package's runs without jax: it, ``tune/`` (but the trial leg)
    and what they load are stdlib only."""
    code = (
        "import sys\n"
        "for name in ('torch', 'jax', 'jaxlib', 'numpy',\n"
        "             'howtotrainyourmamlpytorch_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib.util as u\n"
        "spec = u.spec_from_file_location('d', 'scripts/torch_autotune.py')\n"
        "spec.loader.exec_module(u.module_from_spec(spec))\n"
        "import howtotrainyourmamlpytorch_tpu_torch.tune.harness\n"
        "print(sorted(m for m in sys.modules if m.startswith("
        "'howtotrainyourmamlpytorch_tpu_torch.tune')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "tune.trial" not in out.stdout and "tune.record" in out.stdout


def test_port_scripts_are_all_checked():
    """Every ``scripts/torch_*.py`` is imported with jax blocked above."""
    assert sorted(PORT_SCRIPTS) == sorted(
        os.path.basename(p)[:-3]
        for p in glob.glob(os.path.join(REPO, "scripts", "torch_*.py")))


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
