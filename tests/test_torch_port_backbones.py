"""The port's other backbones against the JAX package on the CPU: ResNet-12
(through the BN kernel's plain version at slopes 0.1 and 1.0), the
layer-norm VGG, and the MLP with the sinusoid regression workload. Both
packages start from the same JAX-initialized weights
(``convert.state_from_jax``) and the same numpy inputs.

Tiny geometry: ResNet-12 at ``cnn_num_filters=4`` (widths 4/10/20/40) on
16x16x3 images, the layer-norm VGG at 2 stages of 8 filters on 12x12x3,
the MLP at the sinusoid JSON's 2 x 40 units; 2 tasks, K=2.

Tolerances (those of tests/test_torch_port_model.py and
tests/test_torch_port_train.py):
* f32 logits and losses: rtol 1e-4 / atol 2e-4 (conv/matmul
  reassociation only); bf16 logits: cosine >= 0.999 and equal argmax;
  BN running stats: rtol 1e-5 / atol 1e-6.
* f32 meta-gradients: 1e-3 relative L2 per leaf. Conv biases sit before
  a batch-statistics BN (every conv of ResNet-12, skips included): their
  meta-gradient, and their LSLR vector's, is analytically zero and holds
  only rounding noise, so they are checked to be that small instead.
* Checkpoints: bitwise, both ways.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.experiment import (
    ExperimentBuilder as JaxBuilder)
from howtotrainyourmamlpytorch_tpu.meta import inner as jinner
from howtotrainyourmamlpytorch_tpu.meta import outer as jouter
from howtotrainyourmamlpytorch_tpu.models import make_model as jax_model
from howtotrainyourmamlpytorch_tpu.ops import episode as jepisode
from howtotrainyourmamlpytorch_tpu.serve.adapt import (
    adapt_task as jax_adapt_task)
from howtotrainyourmamlpytorch_tpu.utils.checkpoint import (
    CheckpointManager as JaxManager)
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.convert import (params_from_jax,
                                                         state_from_jax)
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentBuilder
from howtotrainyourmamlpytorch_tpu_torch.meta import inner, outer
from howtotrainyourmamlpytorch_tpu_torch.models import layers, make_model
from howtotrainyourmamlpytorch_tpu_torch.models.resnet12 import (
    NORMS_PER_FORWARD)
from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
from howtotrainyourmamlpytorch_tpu_torch.serve import (FewShotRequest,
                                                       ServingEngine)
from howtotrainyourmamlpytorch_tpu_torch.tree import stack_tasks, tree_map
from howtotrainyourmamlpytorch_tpu_torch.utils.checkpoint import (
    LATEST, CheckpointManager)
from howtotrainyourmamlpytorch_tpu_torch.utils.storage import (
    load_statistics)
from test_torch_port_ckpt import (_assert_jax_equal, _assert_port_equal,
                                  _port, _random_jax_state)
from test_torch_port_train import _assert_grads, _cos, _leaf_items, _np

TASKS, STEPS = 2, 2
COMMON = dict(dataset_name="synthetic", num_classes_per_set=3,
              num_samples_per_class=2, num_target_samples=2,
              task_learning_rate=0.1, batch_size=TASKS,
              number_of_training_steps_per_iter=STEPS,
              number_of_evaluation_steps_per_iter=STEPS,
              multi_step_loss_num_epochs=10, total_iter_per_epoch=1,
              total_epochs=4)
FAMILIES = {
    "resnet12": dict(COMMON, backbone="resnet12", image_height=16,
                     image_width=16, image_channels=3, cnn_num_filters=4),
    "layer_norm_vgg": dict(COMMON, norm_layer="layer_norm", image_height=12,
                           image_width=12, image_channels=3,
                           cnn_num_filters=8, num_stages=2),
    # The sinusoid JSON's network and episode shape (1 task of 5 + 10
    # points per episode "class"), at K=2.
    "mlp": dict(COMMON, backbone="mlp", task_type="regression",
                dataset_name="sinusoid_synthetic", image_height=1,
                image_width=1, image_channels=1, cnn_num_filters=40,
                num_stages=2, num_classes_per_set=1,
                num_samples_per_class=5, num_target_samples=10,
                transfer_images_uint8=False,
                use_multi_step_loss_optimization=False,
                learnable_per_layer_per_step_inner_loop_learning_rate=False),
}
EXACT = dict(compute_dtype="float32", bn_fast_math=False,
             bn_backend="composite")
VARIANTS = [("composite", False, "float32"), ("composite", False, "bfloat16"),
            ("composite", True, "float32"), ("composite", True, "bfloat16"),
            ("pallas", True, "float32"), ("pallas", True, "bfloat16")]


def _configs(family, **kw):
    kw = {**FAMILIES[family], **kw}
    return JaxConfig(**kw), MAMLConfig(**kw)


def _jax_state(jcfg, seed=0):
    init, apply = jax_model(jcfg)
    params, bn = init(jax.random.PRNGKey(seed))
    fast, _ = jinner.split_fast_slow(jcfg, params)
    return apply, params, jinner.lslr_init(jcfg, fast), bn


def _port_state(params, lslr, bn):
    return state_from_jax(*_np((params, lslr, bn)), device="cpu")


def _images(cfg, seed, tasks=TASKS, rows=6):
    h, w, c = cfg.image_shape
    return np.random.default_rng(seed).standard_normal(
        (tasks, rows, h, w, c)).astype(np.float32)


def _batch(cfg, seed, tasks=TASKS):
    """A numpy meta-batch: uint8 images and int32 labels, or for
    regression float x points in [-5, 5] and sinusoid targets."""
    rng = np.random.default_rng(seed)
    h, w, c = cfg.image_shape
    n, k, q = (cfg.num_classes_per_set, cfg.num_samples_per_class,
               cfg.num_target_samples)
    if cfg.task_type == "regression":
        amp = rng.uniform(0.1, 5.0, (tasks, 1)).astype(np.float32)
        phase = rng.uniform(0.0, np.pi, (tasks, 1)).astype(np.float32)

        def points(rows):
            x = rng.uniform(-5.0, 5.0, (tasks, rows)).astype(np.float32)
            return (x.reshape(tasks, rows, 1, 1, 1),
                    (amp * np.sin(x - phase)).astype(np.float32))
        return jinner.Episode(*points(n * k), *points(n * q))
    return jinner.Episode(
        rng.integers(0, 256, (tasks, n * k, h, w, c), dtype=np.uint8),
        np.tile(np.repeat(np.arange(n, dtype=np.int32), k), (tasks, 1)),
        rng.integers(0, 256, (tasks, n * q, h, w, c), dtype=np.uint8),
        np.tile(np.repeat(np.arange(n, dtype=np.int32), q), (tasks, 1)))


def _torch_batch(batch):
    return inner.Episode(*(torch.from_numpy(np.asarray(f)) for f in batch))


def _assert_logits(got, want, dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)
    else:
        assert _cos(got, want) >= 0.999, _cos(got, want)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is as fast and does not
    oversubscribe the cores when test files run in parallel processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,fast_math,dtype", VARIANTS)
def test_resnet12_forward_and_running_stats_match_jax(backend, fast_math,
                                                      dtype):
    """Two tasks through the port's task-batched ResNet-12 against jax.vmap
    of the JAX apply (its Pallas kernel interpreted on the CPU for
    ``pallas``): logits and all 16 per-step running-stat updates."""
    jcfg, cfg = _configs("resnet12", bn_backend=backend,
                         bn_fast_math=fast_math, compute_dtype=dtype)
    apply, params, lslr, bn = _jax_state(jcfg)
    x = _images(cfg, 0)
    want, want_state = jax.jit(jax.vmap(
        lambda xx: apply(params, bn, xx, jnp.int32(1), True)))(
        jnp.asarray(x))
    st = _port_state(params, lslr, bn)
    _, port_apply = make_model(cfg)
    got, got_state = port_apply(stack_tasks(st.params, TASKS),
                                stack_tasks(st.bn_state, TASKS),
                                torch.from_numpy(x), 1, True)
    assert got.dtype == torch.float32 and got.shape == (TASKS, 6, 3)
    _assert_logits(got.numpy(), want, dtype)
    assert sorted(got_state) == sorted(want_state)
    assert len(got_state) == NORMS_PER_FORWARD
    for name in want_state:
        for key in ("mean", "var"):
            np.testing.assert_allclose(
                got_state[name][key].numpy(),
                np.asarray(want_state[name][key]), rtol=1e-5, atol=1e-6,
                err_msg=f"{name}/{key}")


def test_resnet12_remat_and_plain_flag_on_cpu():
    """``remat=True`` (one checkpoint segment per residual block) computes
    the same forward and gradient as the default call, and ``plain=True``
    the same forward: bitwise on the CPU, where the kernel's wrapper runs
    its plain version (the gradients differ there by design: the
    wrapper's hand-written VJP against autograd of the plain version)."""
    _, cfg = _configs("resnet12", bn_backend="pallas", bn_fast_math=True)
    init, apply = make_model(cfg)
    params, bn = init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_images(cfg, 1))
    outs = []
    for kw in ({}, {"remat": True}, {"plain": True}):
        p = tree_map(lambda t: t.clone().requires_grad_(True), params)
        logits, _ = apply(stack_tasks(p, TASKS), stack_tasks(bn, TASKS), x,
                          0, True, **kw)
        (g,) = torch.autograd.grad(logits.square().sum(),
                                   [p["block0_conv1"]["w"]])
        outs.append((logits, g))
    (base, g0), (remat, g1), (plain, _) = outs
    assert torch.equal(remat, base) and torch.equal(g1, g0)
    assert torch.equal(plain, base)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_vgg_forward_matches_jax(dtype):
    """The layer-norm VGG: per (example, task) statistics over (H, W, C),
    the elementwise (H, W, C) affine in the JAX package's NHWC order, ReLU;
    the norm state stays empty."""
    jcfg, cfg = _configs("layer_norm_vgg", compute_dtype=dtype)
    apply, params, lslr, bn = _jax_state(jcfg)
    # Non-trivial γ/β, so a wrong affine layout shows.
    rng = np.random.default_rng(3)
    params = {k: ({leaf: rng.standard_normal(np.shape(v)).astype(np.float32)
                   for leaf, v in sub.items()} if k.startswith("norm")
                  else sub) for k, sub in params.items()}
    assert params["norm0"]["gamma"].shape == (1, 12, 12, 8)
    x = _images(cfg, 2)
    want, want_state = jax.jit(jax.vmap(
        lambda xx: apply(params, bn, xx, jnp.int32(0), True)))(
        jnp.asarray(x))
    st = _port_state(params, lslr, bn)
    init, port_apply = make_model(cfg)
    assert tree_map(lambda t: tuple(t.shape), init(
        torch.Generator().manual_seed(0))[0]) == tree_map(
        lambda t: tuple(t.shape), st.params)
    got, got_state = port_apply(stack_tasks(st.params, TASKS),
                                stack_tasks(st.bn_state, TASKS),
                                torch.from_numpy(x), 0, True)
    _assert_logits(got.numpy(), want, dtype)
    assert got_state == want_state == {"norm0": {}, "norm1": {}}


def test_layer_norm_migration_matches_jax():
    """A layer-norm VGG checkpoint from before the elementwise affine holds
    per-channel ``(1, C)`` γ/β: both packages broadcast them (and their
    Adam moments) to ``(1, H, W, C)``, bitwise alike, and the migrated
    state's forward agrees."""
    jcfg, cfg = _configs("layer_norm_vgg", **EXACT)
    init, japply = jax_model(jcfg)
    template = jouter.init_train_state(jcfg, init, jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)

    def per_channel(tree):
        return {k: ({leaf: rng.standard_normal((1, np.shape(v)[-1])).astype(
            np.float32) for leaf, v in sub.items()}
            if k.startswith("norm") else sub) for k, sub in tree.items()}
    adam, sched = template.opt_state
    old = template.replace(
        params=per_channel(template.params),
        opt_state=(adam._replace(
            mu={**adam.mu, "params": per_channel(adam.mu["params"])},
            nu={**adam.nu, "params": per_channel(adam.nu["params"])}),
            sched))
    want = _np(jouter.reconcile_loaded_shapes(
        jcfg, old, jouter.state_leaf_shapes(template)))
    port_template = state_from_jax(*_np((template.params, template.lslr,
                                         template.bn_state)), device="cpu")
    o = _np(old)
    got = outer.reconcile_loaded_shapes(
        cfg, state_from_jax(o.params, o.lslr, o.bn_state, int(o.step),
                            device="cpu", opt_state=o.opt_state),
        outer.state_leaf_shapes(port_template))
    for name in ("params", "mu", "nu"):
        a = got.params if name == "params" else getattr(got.opt_state,
                                                        name)["params"]
        b = (want.params if name == "params"
             else getattr(want.opt_state[0], name)["params"])
        for layer in ("norm0", "norm1"):
            for leaf in ("gamma", "beta"):
                assert a[layer][leaf].shape == np.shape(
                    template.params[layer][leaf])
                np.testing.assert_array_equal(a[layer][leaf].numpy(),
                                              b[layer][leaf])
    x = _images(cfg, 5)
    ref = jax.vmap(lambda xx: japply(want.params, want.bn_state, xx,
                                     jnp.int32(0), True)[0])(jnp.asarray(x))
    _, apply = make_model(cfg)
    out, _ = apply(stack_tasks(got.params, TASKS),
                   stack_tasks(got.bn_state, TASKS), torch.from_numpy(x), 0,
                   True)
    _assert_logits(out.numpy(), ref, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_forward_matches_jax(dtype):
    jcfg, cfg = _configs("mlp", compute_dtype=dtype)
    apply, params, lslr, bn = _jax_state(jcfg)
    assert bn == {} and sorted(params) == ["dense0", "dense1", "linear"]
    x = _batch(cfg, 6).support_x
    want = jax.vmap(lambda xx: apply(params, bn, xx, jnp.int32(0),
                                     True)[0])(jnp.asarray(x))
    st = _port_state(params, lslr, bn)
    assert st.bn_state == {} and sorted(st.lslr) == sorted(params)
    _, port_apply = make_model(cfg)
    got, state = port_apply(stack_tasks(st.params, TASKS), {},
                            torch.from_numpy(x), 0, True)
    assert state == {} and got.shape == (TASKS, 5, 1)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=2e-4)
    else:
        assert _cos(got.numpy(), want) >= 0.999


def test_composite_leaky_relu_rounds_slope_like_jax():
    """``jax.nn.leaky_relu`` on bf16 multiplies by the slope rounded to
    bf16 (a weakly typed scalar); ``F.leaky_relu`` multiplies by the f32
    slope and rounds once, which differs in the last bit on many inputs.
    The port's composite BN path and the ResNet-12 residual join use
    ``layers.leaky_relu``: bitwise JAX's."""
    x = np.random.default_rng(7).standard_normal(4096).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(jax.nn.leaky_relu(jnp.asarray(x, jnp.bfloat16), 0.1)
                      .astype(jnp.float32))
    np.testing.assert_array_equal(layers.leaky_relu(xb, 0.1).float().numpy(),
                                  want)
    assert not np.array_equal(F.leaky_relu(xb, 0.1).float().numpy(), want)
    # The composite path applies it after BN (slope 0.1, as ResNet-12).
    _, cfg = _configs("resnet12", bn_backend="composite", bn_fast_math=True,
                      compute_dtype="bfloat16")
    norm, state = layers.batch_norm_init(8, 2)
    norm, state = stack_tasks(norm, 2), stack_tasks(state, 2)
    h = layers.to_task_channels(torch.from_numpy(
        np.random.default_rng(8).standard_normal((2, 3, 5, 5, 8)).astype(
            np.float32)).to(torch.bfloat16))
    y, _ = layers.batch_norm_act_apply(cfg, norm, state, h, 0,
                                       training=True, negative_slope=0.1)
    y1, _ = layers.batch_norm_act_apply(cfg, norm, state, h, 0,
                                        training=True, negative_slope=1.0)
    np.testing.assert_array_equal(
        y.float().numpy(), np.asarray(jax.nn.leaky_relu(
            jnp.asarray(y1.float().numpy(), jnp.bfloat16), 0.1).astype(
            jnp.float32)))


# ---------------------------------------------------------------------------
# meta-gradients, the BN kernel's calls, the sinusoid trajectory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("second_order,use_msl", [(False, True),
                                                  (True, False)])
def test_resnet12_meta_gradients_match_jax(second_order, use_msl):
    """The gradient of the batch's mean meta-loss with respect to θ and
    the LSLR vectors through ResNet-12, f32 exact path, both orders."""
    jcfg, cfg = _configs("resnet12", **EXACT)
    japply, params, lslr, bn = _jax_state(jcfg)
    nb = _batch(cfg, 1)
    batch = jepisode.normalize_episode(
        jcfg, jinner.Episode(*map(jnp.asarray, nb)))
    msl_w = jinner.per_step_loss_importance(jcfg, 3) if use_msl else None

    @jax.jit
    def loss_fn(trainable):
        res = jax.vmap(lambda ep: jinner.task_forward(
            jcfg, japply, trainable["params"], trainable["lslr"], bn, ep,
            num_steps=STEPS, second_order=second_order, use_msl=use_msl,
            msl_weights=msl_w))(batch)
        return jnp.mean(res.loss)
    loss, jgrads = jax.value_and_grad(loss_fn)({"params": params,
                                                "lslr": lslr})
    jgrads = _np(jgrads)
    st = _port_state(params, lslr, bn)
    _, apply = make_model(cfg)
    got_loss, _, _, _, grads = outer.make_meta_gradients(cfg, apply)(
        st, _torch_batch(nb), 3, second_order=second_order, use_msl=use_msl)
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(loss),
                               rtol=1e-4, atol=2e-4)
    _assert_grads(grads, {"params": params_from_jax(jgrads["params"]),
                          "lslr": tree_map(torch.from_numpy,
                                           jgrads["lslr"])}, rel=1e-3)


@pytest.mark.parametrize("second_order,use_msl", [(False, True),
                                                  (True, False)])
def test_resnet12_bn_kernel_calls_per_train_step(monkeypatch, second_order,
                                                 use_msl):
    """Calls reaching the BN kernel's entry (its plain version stands in
    on the CPU) on the kernel path: 16 per forward; K support forwards,
    the targets (K under MSL, else 1), and 'block_outs' recomputes each
    target forward once. chip_smoke.py asserts the same count of launches
    on the card."""
    jcfg, cfg = _configs("resnet12", bn_backend="pallas", bn_fast_math=True,
                         task_microbatches=2)
    _, params, lslr, bn = _jax_state(jcfg)
    st = _port_state(params, lslr, bn)
    _, apply = make_model(cfg)
    calls = []
    real = bn_act.bn_act_plain
    monkeypatch.setattr(bn_act, "bn_act_plain",
                        lambda *a: calls.append(1) or real(*a))
    outer.make_train_step(cfg, apply)(
        st, _torch_batch(_batch(cfg, 2)), 0, second_order=second_order,
        use_msl=use_msl)
    targets = STEPS if use_msl else 1
    assert len(calls) == 2 * NORMS_PER_FORWARD * (STEPS + 2 * targets)
    calls.clear()
    outer.make_eval_step(cfg, apply)(st, _torch_batch(_batch(cfg, 3)))
    assert len(calls) == NORMS_PER_FORWARD * (STEPS + 1)


@pytest.mark.parametrize("policy", ["block_outs", "nothing"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_equals_no_remat(family, policy):
    """Each remat policy gives every backbone the loss and meta-gradients
    of the run without remat (second order, MSL where the family has it):
    the recompute repeats the forward's ops on the same inputs."""
    jcfg, _ = _configs(family, **EXACT)
    _, params, lslr, bn = _jax_state(jcfg)
    use_msl = jcfg.use_msl(0)
    outs = []
    for remat in (False, True):
        _, cfg = _configs(family, **EXACT, remat_inner_steps=remat,
                          remat_policy=policy)
        _, apply = make_model(cfg)
        outs.append(outer.make_meta_gradients(cfg, apply)(
            _port_state(params, lslr, bn), _torch_batch(_batch(cfg, 4)), 0,
            second_order=True, use_msl=use_msl))
    (l0, *_, g0), (l1, *_, g1) = outs
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=1e-7)
    for (name, a), (_, b) in zip(_leaf_items(g1), _leaf_items(g0)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=name)


def test_sinusoid_trajectory_matches_jax():
    """Three second-order MAML outer steps of the sinusoid workload (the
    MLP, no norm state, every parameter fast, LSLR frozen): the loss per
    step, Adam's first moment after the last step (linear in the
    meta-gradients) per leaf, and the eval step on the result."""
    jcfg, cfg = _configs("mlp", **EXACT)
    init, japply = jax_model(jcfg)
    js = jouter.init_train_state(jcfg, init, jax.random.PRNGKey(5))
    step = jax.jit(jouter.make_train_step(jcfg, japply),
                   static_argnames=("second_order", "use_msl"))
    n = _np(js)
    st = state_from_jax(n.params, n.lslr, n.bn_state, device="cpu",
                        opt_state=n.opt_state)
    _, apply = make_model(cfg)
    port_step = outer.make_train_step(cfg, apply)
    so, msl = cfg.use_second_order(0), cfg.use_msl(0)
    assert (so, msl) == (True, False) == (jcfg.use_second_order(0),
                                          jcfg.use_msl(0))
    for i in range(3):
        nb = _batch(cfg, 20 + i)
        js, jm = step(js, jinner.Episode(*map(jnp.asarray, nb)), i,
                      second_order=so, use_msl=msl)
        st, m = port_step(st, _torch_batch(nb), i, second_order=so,
                          use_msl=msl)
        np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=1e-4,
                                   atol=2e-4)
    js = _np(js)
    assert st.bn_state == {} and js.bn_state == {}
    mu = {"params": params_from_jax(js.opt_state[0].mu["params"]),
          "lslr": tree_map(torch.from_numpy, js.opt_state[0].mu["lslr"])}
    _assert_grads(st.opt_state.mu, mu, rel=1e-3)
    nb = _batch(cfg, 30)
    want = jax.jit(jouter.make_eval_step(jcfg, japply))(
        js, jinner.Episode(*map(jnp.asarray, nb)))
    got = outer.make_eval_step(cfg, apply)(st, _torch_batch(nb))
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.accuracy.numpy(),
                               -got.loss.numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# serving, checkpoints, the regression test protocol
# ---------------------------------------------------------------------------

def test_engine_serves_resnet12_like_jax():
    """Two requests through the port's ``ServingEngine`` on a ResNet-12
    state (f32, the kernel path) against jax.vmap of the JAX package's
    adapt + predict on the same weights."""
    serve = dict(compute_dtype="float32", bn_fast_math=True,
                 serve_buckets=((6, 6),), serve_batch_tasks=2,
                 serve_default_deadline_ms=0.0)
    # The JAX side runs the kernel's plain reference (the fast-math
    # composite); differentiating its interpreted Pallas kernel inside
    # the adapt loop would take most of a minute to compile here.
    jcfg, _ = _configs("resnet12", bn_backend="composite", **serve)
    _, cfg = _configs("resnet12", bn_backend="pallas", **serve)
    japply, params, lslr, bn = _jax_state(jcfg)
    b = _batch(cfg, 9)
    sw = np.ones(b.support_y.shape, np.float32)
    _, slow = jinner.split_fast_slow(jcfg, params)

    @jax.jit
    def reference(sx, sy, w, qx):
        adapted = jax.vmap(lambda a, y, ww: jax_adapt_task(
            jcfg, japply, params, lslr, bn, a, y, ww, num_steps=STEPS))(
            sx, sy, w)
        return jax.vmap(lambda f, s, q: japply(
            jinner.merge_fast_slow(f, slow), s,
            jepisode.normalize_images(jcfg, q), jnp.int32(STEPS - 1),
            True)[0])(adapted.fast, adapted.bn_state, qx)
    want = reference(b.support_x, b.support_y, sw, b.target_x)
    engine = ServingEngine(cfg, _port_state(params, lslr, bn), device="cpu")
    for t in range(TASKS):
        engine.submit(FewShotRequest(support_x=b.support_x[t],
                                     support_y=b.support_y[t],
                                     query_x=b.target_x[t]))
    responses = sorted(engine.drain(), key=lambda r: r.request_id)
    assert engine.adapt_invocations == engine.predict_invocations == 1
    for t, resp in enumerate(responses):
        assert resp.status == "ok"
        _assert_logits(resp.logits, np.asarray(want[t]), "float32")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_checkpoints_cross_load_bitwise(family, tmp_path):
    """JAX save → port load equals ``state_from_jax`` of the saved state
    bit for bit; port save → JAX load equals the JAX state, and the file,
    manifest and state.json are the bytes the JAX package writes (the
    MLP's empty ``bn_state`` and layer norm's empty norm states
    included)."""
    jcfg, js = _random_jax_state(1, **FAMILIES[family])
    JaxManager(str(tmp_path / "jax")).save(js, 0, 5, 0.5)
    template = _port(_random_jax_state(2, **FAMILIES[family])[1])
    got, meta = CheckpointManager(str(tmp_path / "jax")).load(template, 0)
    want = _port(js)
    _assert_port_equal(got, want)
    assert family == "resnet12" or got.bn_state == want.bn_state
    assert got.step == 8 and meta["current_iter"] == 5
    CheckpointManager(str(tmp_path / "port")).save(want, 0, 5, 0.5)
    init, _ = jax_model(jcfg)
    jtemplate = jouter.init_train_state(jcfg, init, jax.random.PRNGKey(0))
    back, _ = JaxManager(str(tmp_path / "port")).load(jtemplate, LATEST)
    _assert_jax_equal(jax.device_get(back), js)
    for name in ("train_model_0.ckpt", "MANIFEST.json", "state.json"):
        with open(tmp_path / "port" / name, "rb") as f, \
                open(tmp_path / "jax" / name, "rb") as g:
            assert f.read() == g.read(), name


SINUSOID_RUN = dict(
    FAMILIES["mlp"], experiment_name="sine", number_of_training_steps_per_iter=2,
    number_of_evaluation_steps_per_iter=2, batch_size=4, total_epochs=1,
    total_iter_per_epoch=3, num_evaluation_tasks=6, max_models_to_save=1,
    second_order=True, **EXACT)


def test_regression_test_protocol_matches_jax(tmp_path):
    """A JAX builder run of the sinusoid workload, then the port's test
    protocol on its checkpoint (``evaluate_on_test_set_only``): the same
    test episodes, the mean prediction scored by per-episode MSE —
    ``test_mse_mean`` rtol 1e-4 — in the result and in
    ``test_summary.csv``. The port's own run writes them too."""
    kw = dict(SINUSOID_RUN, experiment_root=str(tmp_path / "jax"))
    ref = JaxBuilder(JaxConfig(**kw)).run_experiment()
    assert ref["num_models"] == 1 and ref["test_mse_mean"] > 0
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    kw["experiment_root"] = str(tmp_path / "port")
    builder = ExperimentBuilder(MAMLConfig(
        **kw, evaluate_on_test_set_only=True, continue_from_epoch="latest"),
        device="cpu")
    result = builder.run_experiment()
    assert result["num_models"] == 1 and result["num_episodes"] == 6
    np.testing.assert_allclose(result["test_mse_mean"],
                               ref["test_mse_mean"], rtol=1e-4)
    assert result["test_mse_mean"] == -result["test_accuracy_mean"]
    np.testing.assert_allclose(result["test_accuracy_std"],
                               ref["test_accuracy_std"], rtol=1e-3)
    assert len(load_statistics(builder.paths["logs"], "test_summary.csv")[
        "test_mse_mean"]) == 2
    kw["experiment_root"] = str(tmp_path / "own")
    own = ExperimentBuilder(MAMLConfig(**kw), device="cpu").run_experiment()
    assert np.isfinite(own["test_mse_mean"]) and own["test_mse_mean"] > 0
