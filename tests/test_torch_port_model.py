"""The port's layers and VGG forward against the JAX package, on the
same numpy inputs and the same weights (carried across by
``convert.state_from_jax``).

Tolerances:
* f32: rtol 1e-4 / atol 2e-4 — the repo's forward tolerance
  (tests/test_torch_parity.py); conv/matmul reassociation only.
* bf16 logits: cosine >= 0.999 and equal argmax — conv accumulation
  order differs between XLA:CPU and torch's CPU convolutions, and bf16
  rounds each difference to 2^-8 relative.
* BN running stats are f32 in both: rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.meta import inner as jinner
from howtotrainyourmamlpytorch_tpu.models import layers as jlayers
from howtotrainyourmamlpytorch_tpu.models import make_model as jax_model
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.convert import state_from_jax
from howtotrainyourmamlpytorch_tpu_torch.models import layers, make_model
from howtotrainyourmamlpytorch_tpu_torch.tree import stack_tasks, tree_map

SMALL = dict(dataset_name="synthetic", image_height=12, image_width=12,
             image_channels=3, num_classes_per_set=3,
             num_samples_per_class=2, num_target_samples=2,
             cnn_num_filters=8, num_stages=2, task_learning_rate=0.1,
             number_of_training_steps_per_iter=2,
             number_of_evaluation_steps_per_iter=2)
VARIANTS = [("composite", False, "float32"), ("composite", False, "bfloat16"),
            ("composite", True, "float32"), ("composite", True, "bfloat16"),
            ("pallas", True, "float32"), ("pallas", True, "bfloat16")]


def _configs(**kw):
    kw = {**SMALL, **kw}
    return JaxConfig(**kw), MAMLConfig(**kw)


def _jax_state(jcfg, seed=0):
    init, apply = jax_model(jcfg)
    params, bn = init(jax.random.PRNGKey(seed))
    fast, _ = jinner.split_fast_slow(jcfg, params)
    lslr = jinner.lslr_init(jcfg, fast)
    return apply, params, lslr, bn


def _port_state(params, lslr, bn):
    return state_from_jax(*jax.device_get((params, lslr, bn)), device="cpu")


def _assert_logits(got, want, dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)
    else:
        cos = (got * want).sum() / np.linalg.norm(got) / np.linalg.norm(want)
        assert cos >= 0.999, cos
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("backend,fast_math,dtype", VARIANTS)
def test_vgg_forward_and_running_stats_match_jax(backend, fast_math, dtype):
    """Two tasks through the port's task-batched forward against jax.vmap
    of the JAX apply: logits and the per-step running-stat update."""
    jcfg, cfg = _configs(bn_backend=backend, bn_fast_math=fast_math,
                         compute_dtype=dtype)
    apply, params, lslr, bn = _jax_state(jcfg)
    x = np.random.default_rng(0).standard_normal(
        (2, 6, 12, 12, 3)).astype(np.float32)
    want, want_state = jax.vmap(
        lambda xx: apply(params, bn, xx, jnp.int32(1), True))(jnp.asarray(x))
    st = _port_state(params, lslr, bn)
    _, port_apply = make_model(cfg)
    got, got_state = port_apply(stack_tasks(st.params, 2),
                                stack_tasks(st.bn_state, 2),
                                torch.from_numpy(x), 1, True)
    assert got.dtype == torch.float32 and got.shape == (2, 6, 3)
    _assert_logits(got.numpy(), want, dtype)
    for name in want_state:
        for key in ("mean", "var"):
            np.testing.assert_allclose(
                got_state[name][key].numpy(),
                np.asarray(want_state[name][key]), rtol=1e-5, atol=1e-6,
                err_msg=f"{name}/{key}")


def test_vgg_plain_flag_equals_kernel_path_on_cpu():
    """``plain=True`` and the wrapper's CPU path run the same plain
    version: bitwise equal on the CPU."""
    _, cfg = _configs(bn_backend="pallas", bn_fast_math=True)
    init, apply = make_model(cfg)
    params, bn = init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 6, 12, 12, 3)).astype(np.float32))
    a, _ = apply(stack_tasks(params, 2), stack_tasks(bn, 2), x, 0, True)
    b, _ = apply(stack_tasks(params, 2), stack_tasks(bn, 2), x, 0, True,
                 plain=True)
    assert torch.equal(a, b)


def test_port_init_shapes_match_jax():
    """The port's own initializer gives the JAX init's tree in torch's
    layout, with xavier-uniform bounds."""
    jcfg, cfg = _configs()
    _, params, lslr, bn = _jax_state(jcfg)
    st = _port_state(params, lslr, bn)
    init, _ = make_model(cfg)
    p2, bn2 = init(torch.Generator().manual_seed(0))
    assert tree_map(lambda t: tuple(t.shape), p2) == tree_map(
        lambda t: tuple(t.shape), st.params)
    assert tree_map(lambda t: tuple(t.shape), bn2) == tree_map(
        lambda t: tuple(t.shape), st.bn_state)
    w = p2["conv0"]["w"]
    assert w.abs().max() <= np.sqrt(6.0 / (3 * 9 + 8 * 9))
    assert torch.all(p2["norm0"]["gamma"] == 1)


@pytest.mark.parametrize("size", [(4, 4), (5, 3)])
def test_max_pool_matches_and_raises_on_too_small(size):
    x = np.random.default_rng(2).standard_normal(
        (2, *size, 6)).astype(np.float32)
    want = jlayers.max_pool2d(jnp.asarray(x))
    got = layers.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))
    with pytest.raises(ValueError, match="too small"):
        layers.max_pool2d(torch.zeros(1, 6, 1, 5))
    with pytest.raises(ValueError, match="too small"):
        jlayers.max_pool2d(jnp.zeros((1, 1, 5, 6)))


@pytest.mark.parametrize("kernel,stride,padding", [
    (3, 1, "SAME"), (3, 2, "SAME"), (3, 2, "VALID"), (1, 1, "SAME")])
def test_conv_matches_jax(kernel, stride, padding):
    """Per-task conv (grouped over tasks) against vmap of the JAX conv,
    including SAME's asymmetric padding at stride 2 and the 1x1 matmul
    branch."""
    rng = np.random.default_rng(3)
    t, n, h, w, ci, co = 2, 3, 9, 8, 4, 5
    x = rng.standard_normal((t, n, h, w, ci)).astype(np.float32)
    wk = rng.standard_normal((t, kernel, kernel, ci, co)).astype(np.float32)
    b = rng.standard_normal((t, co)).astype(np.float32)
    want = jax.vmap(lambda xx, ww, bb: jlayers.conv2d_apply(
        {"w": ww, "b": bb}, xx, stride=stride, padding=padding,
        compute_dtype=jnp.float32))(x, wk, b)
    got = layers.conv2d_apply(
        {"w": torch.from_numpy(wk.transpose(0, 4, 3, 1, 2).copy()),
         "b": torch.from_numpy(b)},
        layers.to_task_channels(torch.from_numpy(x)), stride=stride,
        padding=padding, compute_dtype=torch.float32)
    nn, tc, hh, ww = got.shape
    got = got.permute(0, 2, 3, 1).reshape(nn, hh, ww, t, co).permute(
        3, 0, 1, 2, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=2e-4)


def test_layout_helpers_round_trip():
    x = torch.arange(2 * 3 * 4 * 5 * 6, dtype=torch.float32).reshape(
        2, 3, 4, 5, 6)
    folded = layers.to_task_channels(x)
    assert folded.shape == (3, 12, 4, 5)
    assert folded.is_contiguous(memory_format=torch.channels_last)
    flat = layers.flatten_tasks(folded, 2)
    np.testing.assert_array_equal(flat.numpy(), x.reshape(2, 3, -1).numpy())


@pytest.mark.parametrize("kw,match", [
    (dict(backbone="resnet13"), "unknown backbone"),
    (dict(backbone="resnet12", norm_layer="layer_norm"), "batch_norm"),
    (dict(bn_backend="pallas", norm_layer="layer_norm"),
     "requires norm_layer")],
    ids=["unknown_backbone", "resnet12_layer_norm", "pallas_layer_norm"])
def test_make_model_refusals(kw, match):
    """What ``make_model`` still refuses, as the JAX package does: an
    unknown backbone, ResNet-12 with layer norm; the fused BN kernel with
    layer norm is refused by the config itself."""
    jcfg, cfg = _configs()
    if "norm_layer" in kw and "backbone" not in kw:
        for make in (jcfg.replace, cfg.replace):
            with pytest.raises(ValueError, match=match):
                make(**kw)
        return
    for build, c in ((make_model, cfg), (jax_model, jcfg)):
        if kw["backbone"] == "resnet12":
            c = c.replace(**kw)
        else:
            # The config refuses the name too; force it past that check
            # to reach the dispatch's own refusal.
            with pytest.raises(ValueError, match=match):
                c.replace(**kw)
            object.__setattr__(c, "backbone", kw["backbone"])
        with pytest.raises(ValueError, match=match):
            build(c)
