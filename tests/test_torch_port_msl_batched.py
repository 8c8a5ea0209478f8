"""Batched MSL target forwards (``msl_target_batching='on'``) in the port
against the JAX package's ``'on'`` and against the port's own serial
path, on the CPU.

Under ``'on'``, where it is exact (MSL, per-step BN statistics, batch
norm), the K target forwards of a batch of T tasks run as one forward
over K·T instances, instance (s, t) at BN row s of task t, and row s is
folded back into task t's norm state (JAX ``meta/inner.py:246-340``).
Both packages start from the same JAX-initialized weights
(``convert.state_from_jax``) and the same numpy episodes.

Tiny geometry: 2 stages of 8 filters at 12x12x3 (VGG), or ResNet-12 at
widths 4/10/20/40 on 16x16x3; 2-way 2-shot, 2 targets per class, 2
tasks, K=3.

Tolerances (f32 exact path, composite BN): forward values rtol 1e-4 /
atol 2e-4 (tests/test_torch_parity.py), post-task BN state rtol 1e-4 /
atol 1e-5, meta-gradients 1e-3 relative L2 per leaf, conv biases
excluded (their meta-gradient is analytically zero: docs/PARITY.md, the
dead-bias degeneracy). The port's batched path against its serial path
differs only in the grouped convolutions' group count: rtol 1e-5 on
values, 1e-4 relative on meta-gradients.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.meta import inner as jinner
from howtotrainyourmamlpytorch_tpu.models import make_model as jax_model
from howtotrainyourmamlpytorch_tpu.ops import episode as jepisode
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.convert import (params_from_jax,
                                                         state_from_jax)
from howtotrainyourmamlpytorch_tpu_torch.meta import inner, outer
from howtotrainyourmamlpytorch_tpu_torch.models import layers, make_model
from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
from howtotrainyourmamlpytorch_tpu_torch.ops.episode import normalize_episode
from howtotrainyourmamlpytorch_tpu_torch.tree import tree_leaves, tree_map

TASKS, STEPS, EPOCH = 2, 3, 2
BASE = dict(dataset_name="synthetic", image_height=12, image_width=12,
            image_channels=3, num_classes_per_set=2,
            num_samples_per_class=2, num_target_samples=2,
            cnn_num_filters=8, num_stages=2, task_learning_rate=0.1,
            number_of_training_steps_per_iter=STEPS,
            number_of_evaluation_steps_per_iter=STEPS, batch_size=TASKS,
            multi_step_loss_num_epochs=10, compute_dtype="float32",
            bn_fast_math=False, bn_backend="composite")
BACKBONES = {"vgg": {},
             "resnet12": dict(backbone="resnet12", image_height=16,
                              image_width=16, cnn_num_filters=4)}
TOL = dict(rtol=1e-4, atol=2e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kw(backbone, **kw):
    return {**BASE, **BACKBONES[backbone], **kw}


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    h, w, c = cfg.image_shape
    n, k, q = (cfg.num_classes_per_set, cfg.num_samples_per_class,
               cfg.num_target_samples)
    return jinner.Episode(
        rng.integers(0, 256, (TASKS, n * k, h, w, c), dtype=np.uint8),
        np.tile(np.repeat(np.arange(n, dtype=np.int32), k), (TASKS, 1)),
        rng.integers(0, 256, (TASKS, n * q, h, w, c), dtype=np.uint8),
        np.tile(np.repeat(np.arange(n, dtype=np.int32), q), (TASKS, 1)))


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@functools.lru_cache(maxsize=None)
def _jax_ref(backbone, second_order):
    """JAX under ``'on'``: per-task results and the gradient of the mean
    meta-loss, from the same seeded init the port starts from."""
    jcfg = JaxConfig(**_kw(backbone, msl_target_batching="on"))
    init, apply = jax_model(jcfg)
    params, bn = init(jax.random.PRNGKey(0))
    fast, _ = jinner.split_fast_slow(jcfg, params)
    lslr = jinner.lslr_init(jcfg, fast)
    batch = jepisode.normalize_episode(
        jcfg, jinner.Episode(*map(jnp.asarray, _batch(jcfg))))
    w = jinner.per_step_loss_importance(jcfg, EPOCH)

    @jax.jit
    def loss_fn(trainable):
        res = jax.vmap(lambda ep: jinner.task_forward(
            jcfg, apply, trainable["params"], trainable["lslr"], bn, ep,
            num_steps=STEPS, second_order=second_order, use_msl=True,
            msl_weights=w))(batch)
        return jnp.mean(res.loss), res
    (_, res), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        {"params": params, "lslr": lslr})
    return _np(res), _np(grads), _np((params, lslr, bn))


def _port_forward(backbone, second_order, trees, **kw):
    """The port's ``task_forward`` on the JAX init: (TaskResult, grads of
    the mean meta-loss in the port's layout)."""
    cfg = MAMLConfig(**_kw(backbone, **kw))
    _, apply = make_model(cfg)
    st = state_from_jax(*trees, device="cpu")
    trainable = tree_map(lambda t: t.clone().requires_grad_(True),
                         {"params": st.params, "lslr": st.lslr})
    batch = normalize_episode(cfg, inner.Episode(
        *(torch.from_numpy(np.asarray(f)) for f in _batch(cfg))))
    res = inner.task_forward(
        cfg, apply, trainable["params"], trainable["lslr"], st.bn_state,
        batch, num_steps=STEPS, second_order=second_order, use_msl=True,
        msl_weights=inner.per_step_loss_importance(cfg, EPOCH))
    flat = torch.autograd.grad(res.loss.mean(), tree_leaves(trainable))
    it = iter(flat)
    return res, tree_map(lambda _: next(it), trainable)


def _leaves(grads):
    return {f"{top}/{layer}/{leaf}": t.detach().numpy()
            for top in ("params", "lslr")
            for layer, sub in grads[top].items() for leaf, t in sub.items()}


def _dead_bias(name):
    return "conv" in name.split("/")[1] and name.endswith("/b")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _assert_grads(got, want, rel):
    got, want = _leaves(got), _leaves(want)
    scale = max(np.abs(a).max() for a in want.values())
    for name, g in got.items():
        if _dead_bias(name):
            assert np.abs(g).max() <= 1e-3 * scale, name
        else:
            assert _rel(g, want[name]) <= rel, (name, _rel(g, want[name]))


def _assert_results(res, want, tol, bn_tol):
    np.testing.assert_allclose(res.loss.detach().numpy(), want.loss, **tol)
    np.testing.assert_allclose(res.target_logits.detach().numpy(),
                               want.target_logits, **tol)
    np.testing.assert_allclose(res.per_step_target_losses.numpy(),
                               want.per_step_target_losses, **tol)
    np.testing.assert_allclose(res.per_step_support_losses.numpy(),
                               want.per_step_support_losses, **tol)
    np.testing.assert_allclose(res.target_accuracy.numpy(),
                               want.target_accuracy, **tol)
    for layer, sub in want.bn_state.items():
        for key, arr in sub.items():
            got = res.bn_state[layer][key]
            np.testing.assert_allclose(
                got.numpy() if torch.is_tensor(got) else got, arr, **bn_tol,
                err_msg=f"{layer}/{key}")


@pytest.mark.parametrize("backbone,second_order", [
    ("vgg", False), ("vgg", True), ("resnet12", True)])
def test_batched_msl_matches_jax_on(backbone, second_order):
    """The port's ``'on'`` against the JAX package's ``'on'``: loss,
    per-step target and support losses, final logits, accuracy, the
    post-task BN state and the meta-gradients. ResNet-12 at second
    order, its pod recipe's (its first order is held against the port's
    serial path below, which is held against JAX by
    tests/test_torch_port_backbones.py); a JAX compile of it takes ~30 s
    here."""
    want, jgrads, trees = _jax_ref(backbone, second_order)
    res, grads = _port_forward(backbone, second_order, trees,
                               msl_target_batching="on")
    _assert_results(res, want, TOL, dict(rtol=1e-4, atol=1e-5))
    _assert_grads(grads, {"params": params_from_jax(jgrads["params"]),
                          "lslr": tree_map(torch.from_numpy,
                                           jgrads["lslr"])}, rel=1e-3)


@pytest.mark.parametrize("second_order", [False, True])
@pytest.mark.parametrize("backbone", ["vgg", "resnet12"])
def test_msl_batched_target_path_equals_serial(backbone, second_order):
    """The port's batched path equals its serial path ('auto'): same
    loss, per-step losses, final logits, running statistics and
    meta-gradients (the counterpart of tests/test_inner.py §
    test_msl_batched_target_path_equals_serial)."""
    trees = _init_trees(backbone)
    out = {mode: _port_forward(backbone, second_order, trees,
                               msl_target_batching=mode)
           for mode in ("on", "auto")}
    (res_b, g_b), (res_s, g_s) = out["on"], out["auto"]
    tight = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res_b.loss.detach().numpy(),
                               res_s.loss.detach().numpy(), **tight)
    np.testing.assert_allclose(res_b.per_step_target_losses.numpy(),
                               res_s.per_step_target_losses.numpy(), **tight)
    np.testing.assert_allclose(res_b.target_logits.detach().numpy(),
                               res_s.target_logits.detach().numpy(), **tight)
    assert torch.equal(res_b.per_step_support_losses,
                       res_s.per_step_support_losses)
    for a, b in zip(tree_leaves(res_b.bn_state), tree_leaves(res_s.bn_state)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)
    _assert_grads(g_b, g_s, rel=1e-4)
    weights = inner.per_step_loss_importance(MAMLConfig(**_kw(backbone)),
                                             EPOCH)
    np.testing.assert_allclose(
        res_b.loss.detach().numpy(),
        (weights * res_b.per_step_target_losses).sum(1).numpy(), rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _init_trees(backbone):
    jcfg = JaxConfig(**_kw(backbone))
    init, _ = jax_model(jcfg)
    params, bn = init(jax.random.PRNGKey(0))
    fast, _ = jinner.split_fast_slow(jcfg, params)
    return _np((params, jinner.lslr_init(jcfg, fast), bn))


@pytest.mark.parametrize("knob", [dict(per_step_bn_statistics=False),
                                  dict(norm_layer="layer_norm")],
                         ids=["shared_bn_row", "layer_norm"])
def test_on_runs_serial_where_batching_is_not_exact(knob):
    """Shared-row BN (blended serially by every forward) and layer norm
    (no per-step rows) keep the serial path under 'on', as in JAX:
    the same K target forwards, bitwise the 'auto' result."""
    results = {}
    for mode in ("on", "auto"):
        cfg = MAMLConfig(**_kw("vgg", msl_target_batching=mode, **knob))
        assert not inner.msl_batched(cfg, use_msl=True)
        init, apply = make_model(cfg)
        st = outer.init_train_state(cfg, init, seed=0, device="cpu")
        forwards = []

        def counted(*a, apply=apply, **k):
            forwards.append(a[2].shape[0])
            return apply(*a, **k)
        loss, _, _, bn, grads = outer.make_meta_gradients(cfg, counted)(
            st, inner.Episode(*(torch.from_numpy(np.asarray(f))
                                for f in _batch(cfg))), EPOCH,
            second_order=False, use_msl=True)
        # K support + K target forwards, each over the T tasks.
        assert forwards == [TASKS] * (2 * STEPS)
        results[mode] = {"loss": loss, "bn": bn, "grads": grads}
    for a, b in zip(tree_leaves(results["on"]), tree_leaves(results["auto"])):
        assert torch.equal(a, b)


def test_batched_forward_shapes_and_launches():
    """On the kernel path one first-order MSL step runs K support
    forwards over T tasks and ONE target forward over K·T instances: the
    BN kernel's entry sees P = K·T·C columns there (on the CPU its plain
    version stands in for the launch)."""
    cfg = MAMLConfig(**_kw("vgg", msl_target_batching="on",
                           bn_backend="pallas", compute_dtype="bfloat16",
                           bn_fast_math=True))
    init, apply = make_model(cfg)
    st = outer.init_train_state(cfg, init, seed=0, device="cpu")
    cols = []
    real = bn_act.bn_act_plain
    try:
        bn_act.bn_act_plain = lambda x, *a: cols.append(x.shape[1]) or real(
            x, *a)
        outer.make_train_step(cfg, apply)(
            st, inner.Episode(*(torch.from_numpy(np.asarray(f))
                                for f in _batch(cfg))), 0,
            second_order=False, use_msl=True)
    finally:
        bn_act.bn_act_plain = real
    c = cfg.cnn_num_filters
    want = ([TASKS * c] * cfg.num_stages * STEPS
            + [STEPS * TASKS * c] * cfg.num_stages)
    assert cols == want


def test_step_rows_gather_and_fold():
    """A per-instance row tensor picks each instance's own γ/β row, the
    gather carries outer gradients to exactly the rows used, and the
    running-stat blend lands in each instance's row; a row tensor that
    names one row for every instance gives bitwise the int path."""
    gen = torch.Generator().manual_seed(0)
    t, s, c = 4, 3, 5
    gamma = torch.rand(t, s, c, generator=gen).requires_grad_(True)
    params = {"gamma": gamma, "beta": torch.rand(t, s, c, generator=gen)}
    state = {"mean": torch.rand(t, s, c, generator=gen),
             "var": torch.rand(t, s, c, generator=gen) + 1}
    rows = torch.tensor([0, 2, 1, 7])      # 7 clips to the last row
    idx, g, b = layers._step_row(params, rows)
    assert idx.tolist() == [0, 2, 1, 2]
    want = torch.stack([gamma[i, r] for i, r in enumerate(idx.tolist())])
    assert torch.equal(g, want.reshape(-1))
    g.sum().backward()
    used = torch.zeros(t, s, c)
    for i, r in enumerate(idx.tolist()):
        used[i, r] = 1
    assert torch.equal(gamma.grad, used)
    mean, var = torch.rand(t * c, generator=gen), torch.rand(t * c,
                                                            generator=gen)
    new = layers._running_update(state, idx, mean, var, 10, 0.1)
    for i, r in enumerate(idx.tolist()):
        others = [j for j in range(s) if j != r]
        assert torch.equal(new["mean"][i, others], state["mean"][i, others])
        assert torch.equal(new["mean"][i, r], 0.9 * state["mean"][i, r]
                           + 0.1 * mean.reshape(t, c)[i])
    for step in (0, 1, 5):
        by_int = layers._running_update(
            state, layers._step_row(params, step)[0], mean, var, 10, 0.1)
        by_rows = layers._running_update(
            state, layers._step_row(params, torch.full((t,), step))[0],
            mean, var, 10, 0.1)
        assert all(torch.equal(by_int[k], by_rows[k]) for k in by_int)
        assert torch.equal(layers._step_row(params, step)[1],
                           layers._step_row(params,
                                            torch.full((t,), step))[1])
