"""The port's losses, image decode and inner-loop pieces against the JAX
package, on the same numpy inputs and weights (``convert.state_from_jax``).

Tolerances:
* losses and decode are f32 in both: rtol 1e-5 / atol 1e-6 (1e-6 for the
  decode's /255, which XLA rewrites as a reciprocal multiply).
* one inner step: f32 rtol 1e-4 / atol 2e-4, the repo's forward
  tolerance (tests/test_torch_parity.py); bf16 rtol 1.6e-2 (about 2 bf16
  ulp) / atol 1e-3, since the conv accumulation order differs between
  XLA:CPU and torch's CPU convolutions.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.meta import inner as jinner
from howtotrainyourmamlpytorch_tpu.models import make_model as jax_model
from howtotrainyourmamlpytorch_tpu.ops import episode as jepisode
from howtotrainyourmamlpytorch_tpu.ops import losses as jlosses
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.convert import state_from_jax
from howtotrainyourmamlpytorch_tpu_torch.meta import inner
from howtotrainyourmamlpytorch_tpu_torch.models import make_model
from howtotrainyourmamlpytorch_tpu_torch.ops import episode, losses
from howtotrainyourmamlpytorch_tpu_torch.tree import stack_tasks, tree_map

SMALL = dict(dataset_name="synthetic", image_height=12, image_width=12,
             image_channels=3, num_classes_per_set=3,
             num_samples_per_class=2, num_target_samples=2,
             cnn_num_filters=8, num_stages=2, task_learning_rate=0.1,
             number_of_training_steps_per_iter=2,
             number_of_evaluation_steps_per_iter=2)


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


@pytest.mark.parametrize("name", ["cross_entropy", "accuracy", "mse",
                                  "regression_score"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 7, 3)).astype(np.float32)
    labels = rng.integers(0, 3, (2, 7)).astype(np.int32)
    if name in ("mse", "regression_score"):
        labels = rng.standard_normal((2, 7)).astype(np.float32)
        logits = logits[..., :1]
    want = jax.vmap(getattr(jlosses, name))(logits, labels)
    got = getattr(losses, name)(torch.from_numpy(logits),
                                torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["weighted_cross_entropy", "weighted_mse"])
def test_weighted_losses_match_jax_and_ignore_pad_rows(name):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 6, 3)).astype(np.float32)
    labels = rng.integers(0, 3, (2, 6)).astype(np.int32)
    if name == "weighted_mse":
        labels = rng.standard_normal((2, 6)).astype(np.float32)
        logits = logits[..., :1]
    weights = np.ones((2, 6), np.float32)
    weights[1, 4:] = 0.0
    want = jax.vmap(getattr(jlosses, name))(logits, labels, weights)
    fn = getattr(losses, name)
    got = fn(torch.from_numpy(logits), torch.from_numpy(labels),
             torch.from_numpy(weights))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    unpadded = fn(torch.from_numpy(logits[1, :4]),
                  torch.from_numpy(labels[1, :4]), torch.ones(4))
    np.testing.assert_allclose(got[1].numpy(), unpadded.numpy(), rtol=1e-6)


@pytest.mark.parametrize("config", [
    "mini-imagenet_maml++_5-way_5-shot_DA_b12.json",
    "omniglot_maml++_5-way_1-shot.json"])
def test_normalize_images_matches_jax(config):
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "experiment_config", config)
    if not os.path.exists(path):
        pytest.skip(f"{config} not shipped")
    jcfg, cfg = (JaxConfig.from_json_file(path),
                 MAMLConfig.from_json_file(path))
    jcfg = jcfg.replace(reverse_channels=True)
    cfg = cfg.replace(reverse_channels=True)
    h, w, c = cfg.image_shape
    x = np.random.default_rng(6).integers(0, 256, (2, 3, 6, 5, c),
                                          dtype=np.uint8)
    want = jepisode.normalize_images(jcfg, jnp.asarray(x))
    got = episode.normalize_images(cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    f = torch.zeros(2, 2, dtype=torch.float32)
    assert episode.normalize_images(cfg, f) is f


@pytest.mark.parametrize("algo,bn_inner", [("maml++", False),
                                           ("maml++", True),
                                           ("anil", False)])
def test_fast_slow_split_and_lslr_match_jax(algo, bn_inner):
    jcfg, cfg = _configs(meta_algorithm=algo,
                         enable_inner_loop_optimizable_bn_params=bn_inner)
    _, params, lslr, bn = _jax_state(jcfg)
    st = _port_state(params, lslr, bn)
    fast, slow = inner.split_fast_slow(cfg, st.params)
    jfast, jslow = jinner.split_fast_slow(jcfg, params)
    assert sorted(fast) == sorted(jfast) and sorted(slow) == sorted(jslow)
    assert inner.adapted_param_counts(cfg, st.params) == \
        jinner.adapted_param_counts(jcfg, params)
    ours = inner.lslr_init(cfg, fast)
    assert tree_map(lambda t: t.numpy().tolist(), ours) == jax.tree.map(
        lambda a: np.asarray(a).tolist(), jinner.lslr_init(jcfg, jfast))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_support_adapt_step_matches_jax(dtype):
    """One inner step on two tasks: the port's summed-loss gradient over
    task-stacked fast weights equals each task's own JAX gradient step."""
    jcfg, cfg = _configs(bn_backend="pallas", bn_fast_math=True,
                         compute_dtype=dtype)
    apply, params, lslr, bn = _jax_state(jcfg)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, 12, 12, 3)).astype(np.float32)
    y = rng.integers(0, 3, (2, 6)).astype(np.int32)
    fast, slow = jinner.split_fast_slow(jcfg, params)

    def one(xx, yy):
        return jinner.support_adapt_step(jcfg, apply, slow, lslr, xx, yy,
                                         fast, bn, jnp.int32(0),
                                         second_order=False)
    jfast, _, jloss = jax.vmap(one)(x, y)
    st = _port_state(params, lslr, bn)
    _, port_apply = make_model(cfg)
    pfast, pslow = inner.split_fast_slow(cfg, st.params)
    tfast, _, tloss = inner.support_adapt_step(
        cfg, port_apply, stack_tasks(pslow, 2), st.lslr,
        torch.from_numpy(x), torch.from_numpy(y).long(),
        stack_tasks(pfast, 2), stack_tasks(st.bn_state, 2), 0,
        second_order=False)
    rtol, atol = (1e-4, 2e-4) if dtype == "float32" else (1.6e-2, 1e-3)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=rtol,
                               atol=atol)
    # The updated linear head, (in, out) in JAX vs (out, in) in the port.
    np.testing.assert_allclose(
        tfast["linear"]["w"].numpy(),
        np.asarray(jfast["linear"]["w"]).transpose(0, 2, 1), rtol=rtol,
        atol=atol)
    assert not tfast["linear"]["w"].requires_grad
