"""The port's bf16-vs-f32 drift script (``scripts/torch_bf16_drift.py``)
against the JAX package's (``scripts/bf16_drift.py``) on the CPU.

* Its helpers ``rel_l2``, ``group_drift`` and ``separable_batch`` equal
  the JAX script's on the same inputs and seeds (exactly).
* At ``quick_shrink`` shapes in f32 (``compute_dtype=float32``,
  ``bn_fast_math=false``), from the JAX package's init carried across by
  ``convert.state_from_jax``, the script's f32 variant gives the JAX
  package's eval logits at the reference's forward tolerance (rtol 1e-4
  / atol 2e-4) and, after one steady-state (second-order) train step,
  its parameter updates at the flagship floors of docs/PARITY.md: per
  weight leaf, update cosine > 0.90 and rel-L2 < 0.6; conv biases, dead
  under batch-statistics BN, are left out of those.
* ``main(["--quick", "--device", "cpu", "--steps", "2"])`` prints the
  four probe lines in the JAX script's order, with its keys, finite.
"""

import importlib.util
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.meta import inner as jinner
from howtotrainyourmamlpytorch_tpu.meta import outer as jouter
from howtotrainyourmamlpytorch_tpu.models import make_model as jax_model
from howtotrainyourmamlpytorch_tpu_torch.convert import (params_from_jax,
                                                         state_from_jax)
from howtotrainyourmamlpytorch_tpu_torch.tune import trial

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "experiment_config",
                        "mini-imagenet_maml++_5-way_5-shot_DA_b12.json")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the quick runs are tiny, and beside other test
    workers more threads only oversubscribe the cores (ten times slower
    or worse)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port():
    return _load("torch_bf16_drift",
                 os.path.join(REPO, "scripts", "torch_bf16_drift.py"))


@pytest.fixture(scope="module")
def ref():
    return _load("bf16_drift", os.path.join(REPO, "scripts", "bf16_drift.py"))


def test_helpers_equal_the_jax_scripts(port, ref):
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(3, 4, 5)), rng.normal(size=(3, 4, 5))
    assert port.rel_l2(a, b) == ref.rel_l2(a, b)
    assert port.rel_l2(a, np.zeros_like(b)) == ref.rel_l2(
        a, np.zeros_like(b))
    tree_a = {"conv0": {"w": a, "b": a[0, 0]}, "linear": {"w": b[0]}}
    tree_b = {"conv0": {"w": b, "b": b[0, 0]}, "linear": {"w": a[0]}}
    assert port.group_drift(tree_a, tree_b) == ref.group_drift(tree_a,
                                                               tree_b)
    small = dict(image_height=6, image_width=5, image_channels=3,
                 num_classes_per_set=3, num_samples_per_class=2,
                 num_target_samples=4, batch_size=2)
    ours = port.separable_batch(trial.MAMLConfig(**small), 7)
    theirs = ref.separable_batch(JaxConfig(**small), 7)
    for got, want in zip(ours, theirs):
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, np.asarray(want))


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_f32_variant_matches_the_jax_package(port):
    import torch
    _, cfg_f = port.configs(FLAGSHIP, quick=True, device=torch.device("cpu"))
    jcfg = JaxConfig.from_dict(cfg_f.to_dict())
    assert jcfg.to_dict() == cfg_f.to_dict()
    init, apply = jax_model(jcfg)
    js = jouter.init_train_state(jcfg, init, jax.random.PRNGKey(0))
    variant = port.Variant(cfg_f, torch.device("cpu"))
    variant.state = state_from_jax(js.params, js.lslr, js.bn_state,
                                   int(js.step), device="cpu",
                                   opt_state=js.opt_state)
    ep = trial.synthetic_batch(cfg_f, 123)
    jep = jinner.Episode(*map(jnp.asarray, ep))
    jlogits = np.asarray(jax.jit(jouter.make_eval_step(jcfg, apply))(
        js, jep).target_logits)
    np.testing.assert_allclose(variant.logits(ep), jlogits, rtol=1e-4,
                               atol=2e-4)

    steady = cfg_f.total_epochs - 1
    so, msl = cfg_f.use_second_order(steady), cfg_f.use_msl(steady)
    assert so and not msl
    before = {k: {leaf: t.clone() for leaf, t in sub.items()}
              for k, sub in variant.state.params.items()}
    jstep = jax.jit(jouter.make_train_step(jcfg, apply),
                    static_argnames=("second_order", "use_msl"))
    jnew, jm = jstep(js, jep, steady, second_order=so, use_msl=msl)
    m = variant.step(ep, steady, so, msl)
    np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=1e-4,
                               atol=2e-4)
    want = params_from_jax(jax.tree.map(np.asarray, jnew.params))
    held = 0
    for layer, sub in variant.state.params.items():
        for leaf, t in sub.items():
            if layer.startswith("conv") and leaf == "b":
                continue
            du = (t - before[layer][leaf]).numpy()
            dw = (want[layer][leaf] - before[layer][leaf]).numpy()
            if not np.abs(dw).max():
                continue
            assert _cos(du, dw) > 0.90, (layer, leaf, _cos(du, dw))
            assert _rel(du, dw) < 0.6, (layer, leaf, _rel(du, dw))
            held += 1
    assert held >= 3


PROBE_KEYS = {
    "eval_logits": {"workload", "batch", "max_abs_diff", "mean_abs_diff",
                    "logit_scale_mean_abs", "argmax_agreement",
                    "n_predictions"},
    "one_step": {"second_order", "use_msl", "loss_bf16", "loss_f32",
                 "post_update_param_rel_l2_max",
                 "post_update_param_rel_l2"},
    "trajectory": {"stream", "steps", "loss_gap_max", "loss_gap_final",
                   "loss_final_bf16", "loss_final_f32",
                   "train_acc_final_bf16", "train_acc_final_f32",
                   "final_param_rel_l2_max", "final_param_rel_l2_median",
                   "final_param_rel_l2", "end_state_argmax_agreement",
                   "end_state_eval_acc_bf16", "end_state_eval_acc_f32"},
}


def _finite(value):
    if isinstance(value, dict):
        return all(_finite(v) for v in value.values())
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return math.isfinite(value)
    return True


def test_quick_run_prints_the_four_probes(port, capsys):
    assert port.main(["--quick", "--device", "cpu", "--steps", "2"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [(r["probe"], r.get("stream")) for r in rows] == [
        ("eval_logits", None), ("one_step", None),
        ("trajectory", "noise"), ("trajectory", "separable")]
    for r in rows:
        assert PROBE_KEYS[r["probe"]] <= set(r), r
        assert r["device_kind"] == "cpu" and r["bn_launches"] == 0
        assert _finite(r), r
    groups = set(rows[1]["post_update_param_rel_l2"])
    assert {"params.conv0.w", "params.linear.w", "lslr.conv0.w"} <= groups
    assert rows[2]["steps"] == 2


def test_without_a_card_the_script_raises(port):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main(["--steps", "1"])
