"""The port's meta-training slice against the JAX package on the CPU: the
MSL schedule, the per-task forward, meta-gradients at first and second
order, remat, microbatch accumulation, Adam, a short ``train_step``
trajectory, the eval step, the algorithm gates and the carried-over
optimizer state. Both packages start from the same JAX-initialized
weights (``convert.state_from_jax``) and the same numpy episodes.

Tiny geometry: 2 stages of 8 filters, 12x12x3 images, 2-way 2-shot with
2 targets per class, 4 tasks, K=2 inner steps.

Tolerances:
* f32 exact path (``compute_dtype=float32``, ``bn_fast_math=false``,
  composite BN): rtol 1e-4 / atol 2e-4 on losses and logits, the
  reference's forward tolerance (tests/test_torch_parity.py); 1e-3
  relative L2 per leaf on meta-gradients. Conv biases are excluded from
  the relative checks: they sit before a batch-statistics BN, so their
  meta-gradient is analytically zero and both sides hold only rounding
  noise (docs/PARITY.md, the dead-bias degeneracy), and so does their
  LSLR vector's; they are checked to be that small instead.
* kernel path (``bn_backend='pallas'``, bf16, ``bn_fast_math``): the port
  runs ``BnActFunction`` over the kernel's plain version, the JAX package
  its Pallas kernel in interpret mode (eval) or that kernel's plain
  reference, the fast-math composite (meta-gradients). bf16 conv
  accumulation order differs between XLA:CPU and torch's CPU
  convolutions, so: batch losses rtol 2e-2, per-leaf meta-gradient
  cosine >= 0.99, eval logits cosine >= 0.999.
* Adam against ``optax.adam``: 1e-6 relative (both f32).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.meta import inner as jinner
from howtotrainyourmamlpytorch_tpu.meta import outer as jouter
from howtotrainyourmamlpytorch_tpu.models import make_model as jax_model
from howtotrainyourmamlpytorch_tpu.ops import episode as jepisode
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.convert import (params_from_jax,
                                                         state_from_jax)
from howtotrainyourmamlpytorch_tpu_torch.meta import inner, outer
from howtotrainyourmamlpytorch_tpu_torch.models import make_model
from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
from howtotrainyourmamlpytorch_tpu_torch.ops.episode import normalize_episode
from howtotrainyourmamlpytorch_tpu_torch.tree import (stack_tasks,
                                                      tree_leaves, tree_map)

TASKS, STEPS = 4, 2
SMALL = dict(dataset_name="synthetic", image_height=12, image_width=12,
             image_channels=3, num_classes_per_set=2,
             num_samples_per_class=2, num_target_samples=2,
             cnn_num_filters=8, num_stages=2, task_learning_rate=0.1,
             number_of_training_steps_per_iter=STEPS,
             number_of_evaluation_steps_per_iter=STEPS, batch_size=TASKS,
             multi_step_loss_num_epochs=10, total_iter_per_epoch=1,
             total_epochs=4)
EXACT = dict(compute_dtype="float32", bn_fast_math=False,
             bn_backend="composite")
KERNEL = dict(compute_dtype="bfloat16", bn_fast_math=True,
              bn_backend="pallas")
# The JAX side of the kernel path's meta-gradients: the fast-math
# composite, the Pallas kernel's plain reference in the JAX package
# (``_bn_relu_reference``, held against the kernel by its own tests); the
# eval test runs the Pallas kernel itself in interpret mode. (XLA:CPU may
# keep the composite's bf16 products in f32 inside a fusion; after 3
# adapt steps that alone moves the eval logits by cosine ~2e-3.)
KERNEL_REF = dict(KERNEL, bn_backend="composite")


def _configs(**kw):
    kw = {**SMALL, **kw}
    return JaxConfig(**kw), MAMLConfig(**kw)


def _jax_state(jcfg, seed=0):
    init, apply = jax_model(jcfg)
    params, bn = init(jax.random.PRNGKey(seed))
    fast, _ = jinner.split_fast_slow(jcfg, params)
    return apply, params, jinner.lslr_init(jcfg, fast), bn


def _batch(cfg, seed, tasks=TASKS):
    """A numpy meta-batch: uint8 images (the wire format), int32 labels."""
    rng = np.random.default_rng(seed)
    h, w, c = cfg.image_shape
    n, k, q = (cfg.num_classes_per_set, cfg.num_samples_per_class,
               cfg.num_target_samples)
    return jinner.Episode(
        rng.integers(0, 256, (tasks, n * k, h, w, c), dtype=np.uint8),
        np.tile(np.repeat(np.arange(n, dtype=np.int32), k), (tasks, 1)),
        rng.integers(0, 256, (tasks, n * q, h, w, c), dtype=np.uint8),
        np.tile(np.repeat(np.arange(n, dtype=np.int32), q), (tasks, 1)))


def _torch_batch(batch):
    return inner.Episode(*(torch.from_numpy(np.asarray(f)) for f in batch))


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _cos(a, b):
    a, b = np.ravel(np.asarray(a, np.float64)), np.ravel(np.asarray(
        b, np.float64))
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _leaf_items(grads):
    """``(name, array)`` over a ``{"params", "lslr"}`` tree in the port's
    layout, as numpy."""
    out = []
    for top in ("params", "lslr"):
        for layer, sub in grads[top].items():
            for leaf, t in sub.items():
                arr = t.detach().numpy() if torch.is_tensor(t) else t
                out.append((f"{top}/{layer}/{leaf}", np.asarray(arr)))
    return out


def _jax_grads_port_layout(g):
    """JAX ``{"params", "lslr"}`` gradients mapped to the port's layout."""
    g = _np(g)
    return {"params": params_from_jax(g["params"]),
            "lslr": tree_map(torch.from_numpy, g["lslr"])}


def _dead_bias(name):
    """Conv biases and their LSLR vectors (every conv of the VGG and of
    ResNet-12, whose layers are ``block{b}_conv{j}`` and
    ``block{b}_skip_conv``): both meta-gradients are analytically zero
    (the bias's inner gradient is)."""
    return "conv" in name.split("/")[1] and name.endswith("/b")


def _assert_grads(got, want, *, rel=None, cos=None):
    want_items = dict(_leaf_items(want))
    scale = max(np.abs(a).max() for a in want_items.values())
    for name, g in _leaf_items(got):
        w = want_items[name]
        if _dead_bias(name):
            assert np.abs(g).max() <= 1e-3 * scale, name
            continue
        if rel is not None:
            assert _rel(g, w) <= rel, (name, _rel(g, w))
        if cos is not None and np.abs(w).max() > 0:
            assert _cos(g, w) >= cos, (name, _cos(g, w))


# ---------------------------------------------------------------------------
# JAX references, computed once per module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs tiny tensors: one intra-op thread is as fast
    alone and does not oversubscribe the cores when test files run in
    parallel processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    """JAX references, each computed once per module on first use."""
    return {}


def _memo(ref, key, fn):
    if key not in ref:
        ref[key] = fn()
    return ref[key]


def _jax_task_grads(ref, path, second_order, use_msl, epoch=3):
    """JAX: ``(mean loss, vmapped TaskResult, grads)`` of one batch."""
    def compute():
        jcfg, _ = _configs(**path)
        apply, params, lslr, bn = _jax_state(jcfg)
        batch = jepisode.normalize_episode(
            jcfg, jinner.Episode(*map(jnp.asarray, _batch(jcfg, 1))))
        msl_w = (jinner.per_step_loss_importance(jcfg, epoch)
                 if use_msl else None)

        @jax.jit
        def loss_fn(trainable):
            res = jax.vmap(lambda ep: jinner.task_forward(
                jcfg, apply, trainable["params"], trainable["lslr"], bn, ep,
                num_steps=STEPS, second_order=second_order, use_msl=use_msl,
                msl_weights=msl_w))(batch)
            return jnp.mean(res.loss), res
        (loss, res), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            {"params": params, "lslr": lslr})
        return _np(loss), _np(res), grads, (params, lslr, bn)
    key = ("task", tuple(sorted(path.items())), second_order, use_msl)
    return _memo(ref, key, compute)


def _port_setup(path, jax_trees, **kw):
    _, cfg = _configs(**path, **kw)
    _, apply = make_model(cfg)
    state = state_from_jax(*_np(jax_trees), device="cpu")
    return cfg, apply, state


# The flagship's two phases, (second_order, use_msl), by use_msl.
FLAGSHIP_PHASE = {True: (False, True), False: (True, False)}


# ---------------------------------------------------------------------------
# 1. MSL schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("epoch", [0, 7, 20])
def test_per_step_loss_importance_matches_jax(epoch):
    jcfg, cfg = _configs(number_of_training_steps_per_iter=5,
                         multi_step_loss_num_epochs=15)
    want = np.asarray(jinner.per_step_loss_importance(jcfg, epoch))
    got = inner.per_step_loss_importance(cfg, epoch).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got.dtype == np.float32 and got.shape == (5,)


# ---------------------------------------------------------------------------
# 2-3. task_forward values and meta-gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_msl", [False, True])
@pytest.mark.parametrize("second_order", [False, True])
def test_task_forward_matches_jax(ref, second_order, use_msl):
    """Loss, final logits, per-step losses and the post-task BN state of
    every task. The forward values do not depend on the derivative
    order, so both orders of the port meet the values of the JAX
    reference the meta-gradient test computes for that MSL setting."""
    _, res, _, trees = _jax_task_grads(ref, EXACT, *FLAGSHIP_PHASE[use_msl])
    cfg, apply, st = _port_setup(EXACT, trees)
    batch = normalize_episode(cfg, _torch_batch(_batch(cfg, 1)))
    msl_w = inner.per_step_loss_importance(cfg, 3) if use_msl else None
    params = tree_map(lambda t: t.requires_grad_(True), st.params)
    out = inner.task_forward(cfg, apply, params, st.lslr, st.bn_state,
                             batch, num_steps=STEPS,
                             second_order=second_order, use_msl=use_msl,
                             msl_weights=msl_w)
    tol = dict(rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(out.loss.detach().numpy(), res.loss, **tol)
    np.testing.assert_allclose(out.target_logits.detach().numpy(),
                               res.target_logits, **tol)
    np.testing.assert_allclose(out.target_accuracy.numpy(),
                               res.target_accuracy, **tol)
    np.testing.assert_allclose(out.per_step_support_losses.numpy(),
                               res.per_step_support_losses, **tol)
    np.testing.assert_allclose(out.per_step_target_losses.numpy(),
                               res.per_step_target_losses, **tol)
    np.testing.assert_allclose(out.support_loss.numpy(), res.support_loss,
                               **tol)
    for layer, sub in res.bn_state.items():
        for key, arr in sub.items():
            np.testing.assert_allclose(out.bn_state[layer][key].numpy(), arr,
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("second_order,use_msl", [(False, True),
                                                  (True, False)])
def test_meta_gradients_match_jax(ref, second_order, use_msl):
    """The gradient of the batch's mean meta-loss with respect to θ and
    the LSLR vectors, f32 exact path: 1e-3 relative per leaf."""
    loss, _, jgrads, trees = _jax_task_grads(ref, EXACT, second_order,
                                             use_msl)
    cfg, apply, st = _port_setup(EXACT, trees)
    meta_gradients = outer.make_meta_gradients(cfg, apply)
    got_loss, _, _, _, grads = meta_gradients(
        st, _torch_batch(_batch(cfg, 1)), 3, second_order=second_order,
        use_msl=use_msl)
    np.testing.assert_allclose(got_loss.numpy(), loss, rtol=1e-4, atol=2e-4)
    _assert_grads(grads, _jax_grads_port_layout(jgrads), rel=1e-3)


def test_meta_gradients_kernel_path_match_jax(ref):
    """The flagship's second-order phase on the kernel path: bf16 +
    fast-math BN through ``BnActFunction`` and its double backward,
    against the JAX package's fast-math composite. (The first-order
    backward of ``BnActFunction`` is the serving path's, held against JAX
    by tests/test_torch_port_serve.py and test_torch_port_bn_act.py.)"""
    second_order, use_msl = FLAGSHIP_PHASE[False]
    loss, _, jgrads, trees = _jax_task_grads(ref, KERNEL_REF, second_order,
                                             use_msl)
    cfg, apply, st = _port_setup(KERNEL, trees)
    got_loss, _, _, _, grads = outer.make_meta_gradients(cfg, apply)(
        st, _torch_batch(_batch(cfg, 1)), 3, second_order=second_order,
        use_msl=use_msl)
    np.testing.assert_allclose(got_loss.numpy(), loss, rtol=2e-2)
    _assert_grads(grads, _jax_grads_port_layout(jgrads), cos=0.99)


def test_first_order_support_step_keeps_outer_graph():
    """First order takes the inner gradient as a constant (``stop_gradient``
    in JAX) but keeps the fast weights in the outer graph: the outer
    gradient reaches θ through ``w − lr·g`` and each LSLR vector through
    ``−g``. One support step, then a target loss, differentiated with
    respect to θ and LSLR, equals the JAX package's."""
    jcfg, cfg = _configs(**EXACT)
    japply, params, lslr, bn = _jax_state(jcfg)
    nb = _batch(cfg, 2)
    jb = jepisode.normalize_episode(jcfg, jinner.Episode(*map(jnp.asarray,
                                                              nb)))

    def jloss(trainable):
        fast, slow = jinner.split_fast_slow(jcfg, trainable["params"])

        def one(ep):
            f, b, _ = jinner.support_adapt_step(
                jcfg, japply, slow, trainable["lslr"], ep.support_x,
                ep.support_y, fast, bn, jnp.int32(0), second_order=False)
            logits, _ = japply(jinner.merge_fast_slow(f, slow), b,
                               ep.target_x, jnp.int32(0), True)
            return jinner.task_loss_fns(jcfg)[0](logits, ep.target_y)
        return jnp.mean(jax.vmap(one)(jb))
    jgrads = jax.jit(jax.grad(jloss))({"params": params, "lslr": lslr})

    _, apply = make_model(cfg)
    st = state_from_jax(*_np((params, lslr, bn)), device="cpu")
    trainable = tree_map(lambda t: t.requires_grad_(True),
                         {"params": st.params, "lslr": st.lslr})
    b = normalize_episode(cfg, _torch_batch(nb))
    fast0, slow0 = inner.split_fast_slow(cfg, trainable["params"])
    fast, slow = stack_tasks(fast0, TASKS), stack_tasks(slow0, TASKS)
    f, bn2, _ = inner.support_adapt_step(
        cfg, apply, slow, trainable["lslr"], b.support_x, b.support_y, fast,
        stack_tasks(st.bn_state, TASKS), 0, second_order=False)
    logits, _ = apply(inner.merge_fast_slow(f, slow), bn2, b.target_x, 0,
                      True)
    loss = inner.task_loss_fns(cfg)[0](logits, b.target_y).mean()
    leaves = tree_leaves(trainable)
    flat = torch.autograd.grad(loss, leaves)
    it = iter(flat)
    grads = tree_map(lambda _: next(it), trainable)
    _assert_grads(grads, _jax_grads_port_layout(jgrads), rel=1e-3)
    assert any(float(g.abs().max()) > 0 for g in tree_leaves(
        grads["lslr"]))


# ---------------------------------------------------------------------------
# 4-5. remat and microbatch accumulation (port against itself)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _init_trees(seed=0):
    """JAX-initialized ``(params, lslr, bn_state)`` as numpy (the same
    shapes under every config of this module)."""
    jcfg, _ = _configs(**EXACT)
    return _np(_jax_state(jcfg, seed)[1:])


def _port_only(seed=0, **kw):
    trees = _init_trees(seed)
    _, cfg = _configs(**EXACT, **kw)
    _, apply = make_model(cfg)
    return cfg, apply, state_from_jax(*trees, device="cpu")


@pytest.mark.parametrize("policy", ["block_outs", "nothing"])
@pytest.mark.parametrize("second_order,use_msl", [(False, True),
                                                  (True, False),
                                                  (True, True)])
def test_remat_equals_no_remat(policy, second_order, use_msl):
    """Checkpointed and plain runs give the same loss and meta-gradients:
    the recompute repeats the forward's ops on the same inputs."""
    outs = []
    for remat in (False, True):
        cfg, apply, st = _port_only(remat_inner_steps=remat,
                                    remat_policy=policy)
        outs.append(outer.make_meta_gradients(cfg, apply)(
            st, _torch_batch(_batch(cfg, 3)), 2, second_order=second_order,
            use_msl=use_msl))
    (l0, *_, g0), (l1, *_, g1) = outs
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=1e-7)
    for (name, a), (_, b) in zip(_leaf_items(g1), _leaf_items(g0)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7,
                                   err_msg=name)


def bn_calls_per_step(cfg, use_msl):
    """BN kernel launches of one ``train_step`` on the kernel path: every
    forward runs ``num_stages`` of them; 'block_outs' remat recomputes
    each target forward once in the outer backward. chip_smoke.py asserts
    the same count on the card."""
    s, k = cfg.num_stages, cfg.number_of_training_steps_per_iter
    targets = k if use_msl else 1
    remat = 2 if (cfg.remat_inner_steps
                  and cfg.remat_policy == "block_outs") else 1
    per_chunk = s * (k + targets * remat)
    return cfg.effective_task_microbatches() * per_chunk


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("second_order,use_msl", [(False, True),
                                                  (True, False)])
def test_bn_kernel_calls_per_train_step(monkeypatch, remat, second_order,
                                        use_msl):
    """Counts the calls that reach the BN kernel's entry on the kernel
    path (on the CPU its plain version stands in): the count
    chip_smoke.py asserts for the launches on the card."""
    trees = _init_trees()
    _, cfg = _configs(**KERNEL, remat_inner_steps=remat, task_microbatches=2)
    _, apply = make_model(cfg)
    st = state_from_jax(*trees, device="cpu")
    calls = []
    real = bn_act.bn_act_plain
    monkeypatch.setattr(bn_act, "bn_act_plain",
                        lambda *a: calls.append(1) or real(*a))
    step = outer.make_train_step(cfg, apply)
    step(st, _torch_batch(_batch(cfg, 4)), 0, second_order=second_order,
         use_msl=use_msl)
    assert len(calls) == bn_calls_per_step(cfg, use_msl)
    calls.clear()
    outer.make_eval_step(cfg, apply)(st, _torch_batch(_batch(cfg, 5)))
    assert len(calls) == cfg.num_stages * (
        cfg.number_of_evaluation_steps_per_iter + 1)


@pytest.mark.parametrize("second_order,use_msl", [(False, True),
                                                  (True, False)])
def test_microbatch_accumulation_equals_single_shot(second_order, use_msl):
    outs = []
    for micro in (1, 2, 4):
        cfg, apply, st = _port_only(task_microbatches=micro)
        outs.append(outer.make_meta_gradients(cfg, apply)(
            st, _torch_batch(_batch(cfg, 6)), 1, second_order=second_order,
            use_msl=use_msl))
    base = outs[0]
    for out in outs[1:]:
        for a, b in zip(out[:3], base[:3]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        for x, y in zip(tree_leaves(out[3]), tree_leaves(base[3])):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
        for (name, a), (_, b) in zip(_leaf_items(out[4]),
                                     _leaf_items(base[4])):
            if not _dead_bias(name):
                np.testing.assert_allclose(a, b, rtol=1e-4,
                                           atol=1e-6 * np.abs(b).max(),
                                           err_msg=name)


# ---------------------------------------------------------------------------
# 6. Adam + schedule against optax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_adam_and_schedule_match_optax(seed):
    jcfg, cfg = _configs(total_iter_per_epoch=2, total_epochs=3,
                         meta_learning_rate=0.003)
    rng = np.random.default_rng(seed)
    shapes = {"params": {"a": {"w": (3, 4)}, "b": {"b": (5,)}},
              "lslr": {"a": {"w": (3,)}}}
    p0 = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                      shapes, is_leaf=lambda s: isinstance(s, tuple))
    opt = jouter.make_optimizer(jcfg)
    jstate, jp = opt.init(p0), p0
    tp = tree_map(torch.from_numpy, p0)
    tstate = outer.adam_init(tp)
    sched = outer.meta_lr_schedule(cfg)
    for i in range(5):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                    * 10.0 ** rng.integers(-4, 2)
                                    ).astype(np.float32), p0)
        upd, jstate = opt.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tp, tstate = outer.adam_update(cfg, tree_map(torch.from_numpy, g),
                                       tstate, tp)
        np.testing.assert_allclose(
            sched(i), np.asarray(jouter.meta_lr_schedule(jcfg)(i)),
            rtol=1e-6)
        for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
        for got, want in zip(tree_leaves(tstate.nu),
                             jax.tree.leaves(jstate[0].nu)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=0)
    assert tstate.count == int(jstate[0].count) == int(jstate[1].count)


# ---------------------------------------------------------------------------
# 7. train_step trajectory, 8. eval step, convert's optimizer state
# ---------------------------------------------------------------------------

# (epoch, second_order, use_msl) of each trajectory step: the flagship's
# first phase, the meta-LR falling each step (one iteration per epoch).
# Second-order train steps are held against JAX by the ANIL gate test.
PHASES = ((0, False, True), (1, False, True), (2, False, True))
# FOMAML: its gate only forces first order, which the phases are anyway,
# so the trajectory doubles as the FOMAML gate test.
TRAJ = dict(EXACT, task_microbatches=2, clamp_meta_grad_value=0.05,
            meta_algorithm="fomaml")


def _jax_trajectory(ref):
    def compute():
        jcfg, _ = _configs(**TRAJ)
        init, apply = jax_model(jcfg)
        state0 = jouter.init_train_state(jcfg, init, jax.random.PRNGKey(0))
        step = jax.jit(jouter.make_train_step(jcfg, apply),
                       static_argnames=("second_order", "use_msl"))
        states, losses = [state0], []
        for i, (epoch, so, msl) in enumerate(PHASES):
            batch = jinner.Episode(*map(jnp.asarray, _batch(jcfg, 10 + i)))
            new, m = step(states[-1], batch, epoch, second_order=so,
                          use_msl=msl)
            states.append(new)
            losses.append(float(m.loss))
        return [_np(s) for s in states], losses, apply
    return _memo(ref, "trajectory", compute)


def _port_from_jax_state(js):
    return state_from_jax(js.params, js.lslr, js.bn_state, int(js.step),
                          device="cpu", opt_state=js.opt_state)


def test_train_step_trajectory_matches_jax(ref):
    """Three FOMAML outer steps (2 microbatches, a clamp that bites, first
    order + MSL) from the same state: loss per step, Adam's first
    moment (linear in the clamped gradients) per leaf, and the cumulative
    update as vectors (cosine > 0.90, rel-L2 < 0.6 per weight leaf, the
    floors of docs/PARITY.md)."""
    jstates, jlosses, _ = _jax_trajectory(ref)
    jcfg, cfg = _configs(**TRAJ)
    assert not cfg.use_second_order(50) and not jcfg.use_second_order(50)
    _, apply = make_model(cfg)
    step = outer.make_train_step(cfg, apply)
    st = _port_from_jax_state(jstates[0])
    st0 = st
    for i, (epoch, so, msl) in enumerate(PHASES):
        st, m = step(st, _torch_batch(_batch(cfg, 10 + i)), epoch,
                     second_order=so, use_msl=msl)
        np.testing.assert_allclose(float(m.loss), jlosses[i], rtol=1e-4,
                                   atol=2e-4)
        assert m.learning_rate == pytest.approx(
            float(jouter.meta_lr_schedule(jcfg)(i)),
            rel=1e-6)
        assert st.step == i + 1 and st.opt_state.count == i + 1
    jfinal = jstates[-1]
    want_mu = {"params": params_from_jax(jfinal.opt_state[0].mu["params"]),
               "lslr": tree_map(torch.from_numpy,
                                jfinal.opt_state[0].mu["lslr"])}
    _assert_grads(st.opt_state.mu, want_mu, rel=1e-3)
    want = params_from_jax(jfinal.params)
    for layer, sub in st.params.items():
        for leaf, t in sub.items():
            if layer.startswith("conv") and leaf == "b":
                continue
            du = (t - st0.params[layer][leaf]).numpy()
            dw = (want[layer][leaf] - st0.params[layer][leaf]).numpy()
            assert _cos(du, dw) > 0.90, (layer, leaf, _cos(du, dw))
            assert _rel(du, dw) < 0.6, (layer, leaf, _rel(du, dw))
    for layer, sub in jfinal.bn_state.items():
        for key, arr in sub.items():
            np.testing.assert_allclose(st.bn_state[layer][key].numpy(), arr,
                                       rtol=2e-2, atol=1e-3)


def test_state_from_jax_carries_optax_state(ref):
    """A JAX state after one step crosses over with its Adam moments and
    counts in the port's layout; one further step from it in each package
    then agrees (loss, first moment)."""
    jstates, jlosses, _ = _jax_trajectory(ref)
    js = jstates[1]
    st = _port_from_jax_state(js)
    assert st.opt_state.count == 1 and st.step == 1
    for name in ("mu", "nu"):
        jm = getattr(js.opt_state[0], name)
        got = getattr(st.opt_state, name)
        np.testing.assert_array_equal(
            got["params"]["conv0"]["w"].numpy(),
            np.asarray(jm["params"]["conv0"]["w"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(got["params"]["linear"]["w"].numpy(),
                                      np.asarray(jm["params"]["linear"]
                                                 ["w"]).T)
        np.testing.assert_array_equal(got["lslr"]["conv1"]["w"].numpy(),
                                      np.asarray(jm["lslr"]["conv1"]["w"]))
    _, cfg = _configs(**TRAJ)
    _, apply = make_model(cfg)
    epoch, so, msl = PHASES[1]
    new, m = outer.make_train_step(cfg, apply)(
        st, _torch_batch(_batch(cfg, 11)), epoch, second_order=so,
        use_msl=msl)
    np.testing.assert_allclose(float(m.loss), jlosses[1], rtol=1e-4,
                               atol=2e-4)
    want_mu = {"params": params_from_jax(jstates[2].opt_state[0].mu[
        "params"]), "lslr": tree_map(torch.from_numpy,
                                     jstates[2].opt_state[0].mu["lslr"])}
    _assert_grads(new.opt_state.mu, want_mu, rel=1e-3)
    assert new.opt_state.count == 2


@pytest.mark.parametrize("path", ["exact", "kernel"])
def test_eval_step_matches_jax(path):
    """Eval adapts with the evaluation step count, first order, final
    target only; the state is left as it was."""
    kw = EXACT if path == "exact" else KERNEL
    jcfg, cfg = _configs(**kw, number_of_evaluation_steps_per_iter=3)
    init, japply = jax_model(jcfg)
    js = jouter.init_train_state(jcfg, init, jax.random.PRNGKey(1))
    nb = _batch(cfg, 7, tasks=6)
    want = jax.jit(jouter.make_eval_step(jcfg, japply))(
        js, jinner.Episode(*map(jnp.asarray, nb)))
    js = _np(js)
    st = state_from_jax(js.params, js.lslr, js.bn_state, device="cpu")
    _, apply = make_model(cfg)
    before = [t.clone() for t in tree_leaves(st.bn_state)]
    got = outer.make_eval_step(cfg, apply)(st, _torch_batch(nb))
    if path == "exact":
        tol = dict(rtol=1e-4, atol=2e-4)
        np.testing.assert_allclose(got.loss.numpy(), want.loss, **tol)
        np.testing.assert_allclose(got.target_logits.numpy(),
                                   want.target_logits, **tol)
        np.testing.assert_allclose(got.accuracy.numpy(), want.accuracy)
    else:
        # bf16 rounding differences compound over 3 adapt steps and move
        # single tasks' losses by several percent (the JAX package's own
        # kernel and its reference differ so): the batch's mean loss
        # within 2 %, the logits as a vector within cosine 0.999.
        np.testing.assert_allclose(got.loss.numpy().mean(),
                                   np.mean(want.loss), rtol=2e-2)
        assert _cos(got.target_logits.numpy(), want.target_logits) > 0.999
    assert got.target_logits.shape == (6, 4, 2)
    assert not got.loss.requires_grad
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(
        st.bn_state)))


# ---------------------------------------------------------------------------
# 9. algorithm gates, 10. deferred knobs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["anil", "reptile"])
def test_algorithm_gates_match_jax(algo):
    """One train step under each gated algorithm: Adam's first moment
    after one step is 0.1 x the processed meta-gradient, so it shows the
    gates (head-only fast set under second order, interpolation deltas,
    frozen LSLR) leaf by leaf. FOMAML: the trajectory test."""
    kw = dict(EXACT, meta_algorithm=algo)
    jcfg, cfg = _configs(**kw)
    init, japply = jax_model(jcfg)
    js = jouter.init_train_state(jcfg, init, jax.random.PRNGKey(2))
    so, msl = jcfg.use_second_order(50), jcfg.use_msl(0)
    nb = _batch(cfg, 8)
    jnew, jm = jax.jit(jouter.make_train_step(jcfg, japply),
                       static_argnames=("second_order", "use_msl"))(
        js, jinner.Episode(*map(jnp.asarray, nb)), 0, second_order=so,
        use_msl=msl)
    jnew, js = _np(jnew), _np(js)
    st = state_from_jax(js.params, js.lslr, js.bn_state, device="cpu",
                        opt_state=js.opt_state)
    _, apply = make_model(cfg)
    assert (cfg.use_second_order(50), cfg.use_msl(0)) == (so, msl)
    new, m = outer.make_train_step(cfg, apply)(
        st, _torch_batch(nb), 0, second_order=so, use_msl=msl)
    np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=1e-4,
                               atol=2e-4)
    want_mu = {"params": params_from_jax(jnew.opt_state[0].mu["params"]),
               "lslr": tree_map(torch.from_numpy,
                                jnew.opt_state[0].mu["lslr"])}
    _assert_grads(new.opt_state.mu, want_mu, rel=1e-3)
    if algo == "reptile":
        assert all(float(t.abs().max()) == 0
                   for t in tree_leaves(new.opt_state.mu["lslr"]))


@pytest.mark.parametrize("knob", [dict(elastic_pad_tasks=2), "reduce_axes"])
def test_deferred_knobs_raise(knob):
    cfg, apply, st = _port_only(**(knob if isinstance(knob, dict) else {}))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        step = outer.make_train_step(
            cfg, apply, **({"reduce_axes": ("tasks",)}
                           if knob == "reduce_axes" else {}))
        step(st, _torch_batch(_batch(cfg, 9)), 0, second_order=True,
             use_msl=True)


@pytest.mark.parametrize("knob", [
    dict(health_metrics_every_n_steps=1),
    dict(msl_target_batching="on"), dict(remat_policy="conv_outs"),
    dict(remat_policy="dots")])
def test_ported_knobs_build_and_run_one_step(knob):
    """Knobs whose slice has landed build a train step and run it, every
    metric finite: with the training-health metrics on, a step asked for
    them returns them; batched MSL targets and the selective remat
    policies (tests/test_torch_port_msl_batched.py and
    test_torch_port_remat.py hold their values) advance the step."""
    cfg, apply, st = _port_only(**knob)
    health = bool(cfg.health_metrics_every_n_steps)
    new, m = outer.make_train_step(cfg, apply)(
        st, _torch_batch(_batch(cfg, 9)), 0, second_order=True,
        use_msl=True, health=health)
    assert new.step == st.step + 1
    assert all(bool(torch.isfinite(v).all())
               for v in (m.loss, m.accuracy, m.support_loss))
    if health:
        assert m.health and all(bool(torch.isfinite(v).all())
                                for v in m.health.values())
