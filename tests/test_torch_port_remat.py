"""The remat policies ``'conv_outs'`` and ``'dots'`` in the port, on the
CPU: gradient-identical to the other policies and to no remat, the same
meta-gradients as the JAX package under the same policy, what each
policy keeps, and the BN-kernel launches of a train step under every
policy and MSL batching against the count ``chip_smoke.py`` derives.

``'conv_outs'`` and ``'dots'`` run the segments of ``'nothing'`` (the
whole inner step under second order, each target forward under first
order) under a selective policy (meta/inner.py § SavePolicy). The JAX
policies are gradient-identical by construction
(tests/test_inner.py § test_remat_does_not_change_gradients); so are
the port's: a recompute repeats the forward's ops on the same inputs and
a kept output is the forward's own, so the gradients are held bitwise.

Tiny geometry: VGG 2 stages of 8 filters at 12x12x3, ResNet-12 at widths
4/10/20/40 on 16x16x3; 2-way 2-shot, 2 targets per class, 2 tasks, K=2.
Against JAX (f32 exact path): loss rtol 1e-4 / atol 2e-4, meta-gradients
1e-3 relative L2 per leaf, conv biases excluded (docs/PARITY.md, the
dead-bias degeneracy).
"""

import functools
import importlib.util
import os
from collections import defaultdict

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
from howtotrainyourmamlpytorch_tpu_torch.models import make_model
from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
from howtotrainyourmamlpytorch_tpu_torch.tree import tree_leaves, tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS, STEPS, EPOCH = 2, 2, 2
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
# (second_order, use_msl): the flagship's two phases and the pod's.
PHASES = [(False, True), (True, False), (True, True)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kw(backbone, **kw):
    return {**BASE, **BACKBONES[backbone], **kw}


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    h, w, c = cfg.image_shape
    n, k, q = (cfg.num_classes_per_set, cfg.num_samples_per_class,
               cfg.num_target_samples)
    return jinner.Episode(
        rng.integers(0, 256, (TASKS, n * k, h, w, c), dtype=np.uint8),
        np.tile(np.repeat(np.arange(n, dtype=np.int32), k), (TASKS, 1)),
        rng.integers(0, 256, (TASKS, n * q, h, w, c), dtype=np.uint8),
        np.tile(np.repeat(np.arange(n, dtype=np.int32), q), (TASKS, 1)))


def _torch_batch(batch):
    return inner.Episode(*(torch.from_numpy(np.asarray(f)) for f in batch))


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@functools.lru_cache(maxsize=None)
def _init_trees(backbone):
    jcfg = JaxConfig(**_kw(backbone))
    init, _ = jax_model(jcfg)
    params, bn = init(jax.random.PRNGKey(0))
    fast, _ = jinner.split_fast_slow(jcfg, params)
    return _np((params, jinner.lslr_init(jcfg, fast), bn))


def _meta_gradients(backbone, second_order, use_msl, **kw):
    cfg = MAMLConfig(**_kw(backbone, **kw))
    _, apply = make_model(cfg)
    st = state_from_jax(*_init_trees(backbone), device="cpu")
    return outer.make_meta_gradients(cfg, apply)(
        st, _torch_batch(_batch(cfg)), EPOCH, second_order=second_order,
        use_msl=use_msl)


def _remat(policy):
    return (dict(remat_inner_steps=False) if policy == "off"
            else dict(remat_policy=policy))


@pytest.mark.parametrize("second_order,use_msl", PHASES)
@pytest.mark.parametrize("backbone", ["vgg", "resnet12"])
def test_selective_policies_equal_every_other_remat(backbone, second_order,
                                                    use_msl):
    """``'conv_outs'`` and ``'dots'`` give bitwise the loss, BN state and
    meta-gradients of ``'block_outs'``, ``'nothing'`` and no remat."""
    outs = {p: _meta_gradients(backbone, second_order, use_msl,
                               **_remat(p))
            for p in ("off", "block_outs", "nothing", "conv_outs", "dots")}
    base = tree_leaves({"loss": outs["off"][0], "bn": outs["off"][3],
                        "grads": outs["off"][4]})
    for policy, out in outs.items():
        got = tree_leaves({"loss": out[0], "bn": out[3], "grads": out[4]})
        assert all(torch.equal(a, b) for a, b in zip(got, base)), policy


@functools.lru_cache(maxsize=None)
def _jax_grads(policy, second_order, use_msl):
    jcfg = JaxConfig(**_kw("vgg", remat_policy=policy))
    _, apply = jax_model(jcfg)
    params, lslr, bn = _init_trees("vgg")
    batch = jepisode.normalize_episode(
        jcfg, jinner.Episode(*map(jnp.asarray, _batch(jcfg))))
    w = jinner.per_step_loss_importance(jcfg, EPOCH) if use_msl else None

    @jax.jit
    def loss_fn(trainable):
        res = jax.vmap(lambda ep: jinner.task_forward(
            jcfg, apply, trainable["params"], trainable["lslr"], bn, ep,
            num_steps=STEPS, second_order=second_order, use_msl=use_msl,
            msl_weights=w))(batch)
        return jnp.mean(res.loss)
    loss, grads = jax.value_and_grad(loss_fn)({"params": params,
                                               "lslr": lslr})
    return float(loss), _np(grads)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("policy", ["conv_outs", "dots"])
def test_selective_policies_match_jax(policy):
    """One second-order meta-gradient (the flagship's steady phase)
    under each policy against the JAX package under the same policy."""
    loss, jgrads = _jax_grads(policy, True, False)
    got_loss, _, _, _, grads = _meta_gradients("vgg", True, False,
                                               remat_policy=policy)
    np.testing.assert_allclose(float(got_loss), loss, rtol=1e-4, atol=2e-4)
    want = {"params": params_from_jax(jgrads["params"]),
            "lslr": tree_map(torch.from_numpy, jgrads["lslr"])}
    scale = max(float(t.abs().max()) for t in tree_leaves(want))
    for top in ("params", "lslr"):
        for layer, sub in grads[top].items():
            for leaf, g in sub.items():
                w = want[top][layer][leaf]
                if "conv" in layer and leaf == "b":
                    assert float(g.abs().max()) <= 1e-3 * scale
                else:
                    assert _rel(g, w) <= 1e-3, (top, layer, leaf)


def _kept_ops(monkeypatch, backbone, policy, second_order, use_msl):
    kept = []

    class Recording(inner.SavePolicy):
        def __init__(self, name):
            super().__init__(name)
            kept.append(self)

    monkeypatch.setattr(inner, "SavePolicy", Recording)
    keep_calls = defaultdict(int)
    real = inner._Keep.__torch_dispatch__

    def spy(self, func, types, args=(), kwargs=None):
        if self.policy.keeps(func):
            keep_calls[str(func)] += 1
        return real(self, func, types, args, kwargs)
    monkeypatch.setattr(inner._Keep, "__torch_dispatch__", spy)
    _meta_gradients(backbone, second_order, use_msl,
                    remat_policy=policy)
    return sum(p.saved for p in kept), dict(keep_calls)


@pytest.mark.parametrize("backbone,convs", [("vgg", 2), ("resnet12", 16)])
def test_conv_outs_keeps_exactly_the_conv_outputs(monkeypatch, backbone,
                                                  convs):
    """``'conv_outs'`` keeps one output per conv of each forward in a
    segment (ResNet-12: 12 3x3 convs and 4 1x1 skip matmuls), nothing
    else: first order + MSL, K target-forward segments; second order,
    K inner-step segments, each keeping its support forward's convs (the
    forward-time recompute of the support forward is served from what
    was kept) and, with MSL, its target forward's."""
    for (so, msl), forwards in (((False, True), STEPS),
                                ((True, False), STEPS),
                                ((True, True), 2 * STEPS)):
        saved, ops = _kept_ops(monkeypatch, backbone, "conv_outs", so, msl)
        assert saved == forwards * convs, (so, msl, saved)
        want = ({"aten.convolution.default": forwards * 12,
                 "aten.bmm.default": forwards * 4}
                if backbone == "resnet12"
                else {"aten.convolution.default": forwards * convs})
        assert ops == want, (so, msl)


def test_dots_keeps_the_inner_gradients_products(monkeypatch):
    """``'dots'`` keeps every convolution and matrix product of a
    segment: under second order the inner gradient's
    ``convolution_backward`` and ``bmm`` too (dots_saveable saves
    ``conv_general_dilated`` and ``dot_general`` wherever they run)."""
    saved, ops = _kept_ops(monkeypatch, "vgg", "dots", True, False)
    s = BASE["num_stages"]
    assert ops == {"aten.convolution.default": STEPS * s,
                   "aten.baddbmm.default": STEPS,
                   "aten.convolution_backward.default": STEPS * s,
                   "aten.bmm.default": 2 * STEPS}
    assert saved == sum(ops.values())
    saved, ops = _kept_ops(monkeypatch, "vgg", "dots", False, True)
    assert ops == {"aten.convolution.default": STEPS * s,
                   "aten.baddbmm.default": STEPS}


def test_replay_refuses_a_recompute_that_differs():
    """A recompute whose kept op differs from the forward's (another
    shape) raises instead of serving the wrong tensor."""
    policy = inner.SavePolicy("dots")
    store = defaultdict(list)
    a, b = torch.randn(3, 4), torch.randn(4, 5)
    with inner._Keep(policy, store):
        want = torch.mm(a, b)
    with inner._Replay(policy, store):
        assert torch.equal(torch.mm(a, b), want)
    with inner._Replay(policy, store):
        with pytest.raises(RuntimeError, match="does not match"):
            torch.mm(a[:2], b)
    with inner._Replay(policy, store):
        torch.mm(a, b)
        with pytest.raises(RuntimeError, match="does not match"):
            torch.mm(a, b)
    assert policy.saved == 1


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_under_test", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("batching", ["auto", "on"])
@pytest.mark.parametrize("policy", ["off", "block_outs", "nothing",
                                    "conv_outs", "dots"])
def test_bn_kernel_calls_match_chip_smoke_derivation(policy, batching):
    """The calls that reach the BN kernel's entry in one train step on
    the kernel path (on the CPU its plain version stands in) equal the
    count chip_smoke.py asserts for the launches on the card, under
    every remat policy, both MSL forms and every (order, MSL) phase."""
    smoke = _chip_smoke()
    calls = []
    real = bn_act.bn_act_plain
    try:
        bn_act.bn_act_plain = lambda *a: calls.append(1) or real(*a)
        for so, msl in PHASES + [(False, False)]:
            cfg = MAMLConfig(**_kw(
                "vgg", msl_target_batching=batching, bn_backend="pallas",
                compute_dtype="bfloat16", bn_fast_math=True,
                task_microbatches=2, **_remat(policy)))
            init, apply = make_model(cfg)
            st = outer.init_train_state(cfg, init, seed=0, device="cpu")
            calls.clear()
            outer.make_train_step(cfg, apply)(
                st, _torch_batch(_batch(cfg)), 0, second_order=so,
                use_msl=msl)
            want = (cfg.effective_task_microbatches() * cfg.num_stages
                    * smoke._forwards_per_chunk(cfg, so, msl))
            assert len(calls) == want, (so, msl, len(calls), want)
    finally:
        bn_act.bn_act_plain = real
