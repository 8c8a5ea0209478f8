"""The port's device mesh (``parallel/``) in one process, against the JAX
package's ``parallel/`` on the virtual CPU devices of tests/conftest.py.

* Pure functions, equal to JAX: ``degraded_mesh_shape`` and
  ``derive_degraded_config`` on the JAX tests' cases; the microbatch
  clamp and its warning text; the ``make_mesh`` / ``make_sharded_steps``
  validation errors; ``local_batch_positions`` covering the batch
  disjointly, rank by rank as JAX places shards device by device; the
  agreement helpers as no-ops with one process.
* A world of 1 over gloo (a ``FileStore`` group made here and torn down
  after): the step and the eval step through ``make_sharded_steps`` are
  bitwise the port's unsharded steps, the all-reduce and all-gather
  included.
* Pad-and-mask: a batch of real tasks plus a zero tail gives the unpadded
  batch's loss, meta-gradient and update (the JAX elastic test's
  tolerances: loss rtol 2e-5, weights rtol 2e-4 / atol 2e-6) and agrees
  with the JAX package's padded step on its degraded 4-device mesh
  (rtol 1e-4 / atol 2e-4 on the loss, the port's forward-f32 tolerance;
  weights at the same elastic tolerances).

Parity runs the f32 exact path (``compute_dtype=float32``,
``bn_fast_math=false``, composite BN); both packages start from the JAX
package's initial weights (``convert.state_from_jax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.meta import inner as jinner
from howtotrainyourmamlpytorch_tpu.meta import outer as jouter
from howtotrainyourmamlpytorch_tpu.models import make_model as jax_model
from howtotrainyourmamlpytorch_tpu.parallel import mesh as jmesh
from howtotrainyourmamlpytorch_tpu.parallel import multihost as jmultihost
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.convert import (params_from_jax,
                                                         state_from_jax)
from howtotrainyourmamlpytorch_tpu_torch.meta import inner, outer
from howtotrainyourmamlpytorch_tpu_torch.models import make_model
from howtotrainyourmamlpytorch_tpu_torch.parallel import mesh, multihost
from howtotrainyourmamlpytorch_tpu_torch.tree import tree_leaves

EXACT = dict(compute_dtype="float32", bn_fast_math=False,
             bn_backend="composite")
TINY = dict(dataset_name="syn", image_height=8, image_width=8,
            image_channels=1, num_classes_per_set=3,
            num_samples_per_class=2, num_target_samples=2,
            cnn_num_filters=4, num_stages=2,
            number_of_training_steps_per_iter=2,
            number_of_evaluation_steps_per_iter=2, batch_size=8, **EXACT)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_init(jcfg, seed=0):
    init, _ = jax_model(jcfg)
    s = jouter.init_train_state(jcfg, init, jax.random.PRNGKey(seed))
    return s, _np((s.params, s.lslr, s.bn_state))


def _episodes(cfg, n, seed):
    """``n`` uint8 episodes (the wire format) and int32 labels."""
    rng = np.random.default_rng(seed)
    h, w, c = cfg.image_shape
    k, q = cfg.num_support_per_task, cfg.num_target_per_task
    labels = np.repeat(np.arange(cfg.num_classes_per_set, dtype=np.int32),
                       cfg.num_samples_per_class)
    tlabels = np.repeat(np.arange(cfg.num_classes_per_set, dtype=np.int32),
                        cfg.num_target_samples)
    return jinner.Episode(
        rng.integers(0, 256, (n, k, h, w, c), dtype=np.uint8),
        np.tile(labels, (n, 1)),
        rng.integers(0, 256, (n, q, h, w, c), dtype=np.uint8),
        np.tile(tlabels, (n, 1)))


def _torch(ep):
    return inner.Episode(*(torch.from_numpy(np.asarray(f)) for f in ep))


def _mesh_of(shape, rank):
    """A rank's view of a mesh of ``prod(shape)`` ranks (no process
    group: the geometry only)."""
    return mesh.Mesh(shape=shape, axis_names=("dcn", "tasks"), rank=rank,
                     world=int(np.prod(shape)))


# ---------------------------------------------------------------------------
# pure functions against JAX
# ---------------------------------------------------------------------------

DEGRADED = [  # (cfg kwargs, survivors, original processes)
    (dict(batch_size=8, mesh_shape=(2, 4), task_microbatches=2), 1, 2),
    (dict(batch_size=16, mesh_shape=(4, 3), task_microbatches=4), 3, 4),
    (dict(batch_size=8, mesh_shape=(2, 4), task_microbatches=2), 2, 2),
    (dict(batch_size=6, mesh_shape=(2, 4)), 1, 2),
]


@pytest.mark.parametrize("kw,survivors,orig", DEGRADED)
def test_derive_degraded_config_equals_jax(kw, survivors, orig):
    kw = dict(kw, num_classes_per_set=3)
    got = mesh.derive_degraded_config(MAMLConfig(**kw), survivors, orig)
    want = jmesh.derive_degraded_config(JaxConfig(**kw), survivors, orig)
    assert got.to_dict() == MAMLConfig.from_dict(want.to_dict()).to_dict()
    assert got.padded_batch_size == want.padded_batch_size
    assert got.padded_batch_size % int(np.prod(got.mesh_shape)) == 0


@pytest.mark.parametrize("args", [((2, 4), 1, 3), ((2, 4), 0, 2),
                                  ((2, 4), 3, 2), ((4, 3), 3, 4)])
def test_degraded_mesh_shape_equals_jax(args):
    try:
        want = jmesh.degraded_mesh_shape(*args)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh.degraded_mesh_shape(*args)
        assert str(got.value) == str(e)
        return
    assert mesh.degraded_mesh_shape(*args) == want


def test_mesh_validation_errors_equal_jax():
    """make_mesh refuses a shape the world does not realize, and
    make_sharded_steps a batch the mesh does not divide, in the JAX
    package's words."""
    jcfg, cfg = JaxConfig(**TINY), MAMLConfig(**TINY)
    bad = dict(mesh_shape=(1, 3))
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(jcfg.replace(**bad), jax.devices()[:1])
    with pytest.raises(ValueError) as got:
        mesh.make_mesh(cfg.replace(**bad))
    assert str(got.value) == str(want.value)
    assert "needs 3 devices" in str(got.value)
    for kw in (dict(mesh_shape=(1, 8), batch_size=6),
               dict(mesh_shape=(1, 8), batch_size=8, eval_batch_size=12)):
        j, p = jcfg.replace(**kw), cfg.replace(**kw)
        with pytest.raises(ValueError) as want:
            jmesh.make_sharded_steps(j, jax_model(j)[1],
                                     jmesh.make_mesh(j, jax.devices()))
        with pytest.raises(ValueError) as got:
            mesh.make_sharded_steps(p, make_model(p)[1],
                                    _mesh_of((1, 8), 0))
        assert str(got.value) == str(want.value)
        assert "divisible" in str(got.value)


def test_microbatch_clamp_and_warning_equal_jax(caplog):
    """A task_microbatches the per-device shard does not divide clamps to
    the gcd with the JAX package's warning (also logged); one that shares
    no factor with a multi-task shard raises, in its words."""
    kw = dict(TINY, mesh_shape=(1, 8), batch_size=16, task_microbatches=16)
    jcfg, cfg = JaxConfig(**kw), MAMLConfig(**kw)
    with pytest.warns(UserWarning, match="clamping to gcd 2") as want:
        jmesh.make_sharded_steps(jcfg, jax_model(jcfg)[1],
                                 jmesh.make_mesh(jcfg, jax.devices()))
    with pytest.warns(UserWarning, match="clamping to gcd 2") as got:
        mesh.make_sharded_steps(cfg, make_model(cfg)[1],
                                _mesh_of((1, 8), 0))
    assert [str(w.message) for w in got] == [str(w.message) for w in want]
    assert str(got[0].message) in caplog.text
    kw = dict(TINY, mesh_shape=(1, 2), batch_size=8, task_microbatches=3)
    jcfg, cfg = JaxConfig(**kw), MAMLConfig(**kw)
    with pytest.raises(ValueError) as want:
        jmesh.make_sharded_steps(jcfg, jax_model(jcfg)[1],
                                 jmesh.make_mesh(jcfg, jax.devices()[:2]))
    with pytest.raises(ValueError) as got:
        mesh.make_sharded_steps(cfg, make_model(cfg)[1],
                                _mesh_of((1, 2), 0))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shape", [(1, 8), (2, 4), (4, 2)])
def test_local_batch_positions_cover_the_batch_like_jax(shape):
    """Rank r owns [r·L, (r+1)·L): disjoint, covering, dcn-major, the
    slices JAX gives the devices of the same mesh in device order."""
    cfg = JaxConfig(**dict(TINY, mesh_shape=shape, batch_size=16))
    jm = jmesh.make_mesh(cfg, jax.devices())
    want = jmultihost.local_batch_positions(jmesh.batch_sharding(jm), 16)
    by_device = {d: (s, e) for d, s, e in want}
    order = list(np.asarray(jm.devices).reshape(-1))
    got = [multihost.local_batch_positions(_mesh_of(shape, r), 16)
           for r in range(int(np.prod(shape)))]
    assert got == [by_device[d] for d in order]
    covered = sorted(i for s, e in got for i in range(s, e))
    assert covered == list(range(16))
    assert got == [mesh.batch_positions(_mesh_of(shape, r), 16)
                   for r in range(len(got))]


def test_agreement_helpers_single_process_noop():
    assert not multihost.is_initialized()
    assert multihost.agree_int_from_main(7) == 7
    assert multihost.agree_int_from_main(-1) == -1
    assert multihost.agree_int_from_main(2**40 + 3) == 2**40 + 3
    assert multihost.any_process_true(True) is True
    assert multihost.any_process_true(False) is False
    assert multihost.any_process_true_each([True, False]) == [True, False]
    assert multihost.gather_host_floats(1.5) == [1.5]
    assert multihost.gather_host_ints(-9) == [-9]
    multihost.barrier("noop")
    multihost.abort_all_if_any(None, "unused")
    with pytest.raises(KeyError):
        multihost.abort_all_if_any(KeyError("mine"), "unused")
    assert multihost.initialize_distributed(device="cpu") is False
    assert jmultihost.agree_int_from_main(7) == 7
    # The int64 wire encoding round-trips the full range, as JAX's.
    vals = [0, -1, 2**31, -(2**63), 2**63 - 1]
    assert list(multihost._decode_i64(multihost._encode_i64(vals))) == vals
    assert np.array_equal(multihost._encode_i64(vals),
                          jmultihost._encode_i64(vals))


def test_initialize_distributed_refuses_a_partial_environment(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        multihost.initialize_distributed(device="cpu")
    assert not multihost.is_initialized()


# ---------------------------------------------------------------------------
# a world of 1 over gloo
# ---------------------------------------------------------------------------

@pytest.fixture
def gloo_world_of_one(tmp_path):
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("phase", [(True, True), (False, True)])
def test_world_of_one_over_gloo_is_bitwise_the_unsharded_step(
        gloo_world_of_one, phase):
    """Through make_sharded_steps on a one-rank gloo group, the fused
    all-reduce and the eval all-gather run and leave every bit as the
    unsharded steps compute it: loss, metrics, new state, eval results."""
    cfg = MAMLConfig(**dict(TINY, task_microbatches=2))
    _, apply = make_model(cfg)
    _, trees = _jax_init(JaxConfig(**TINY))
    state = state_from_jax(*trees, device="cpu")
    m = mesh.make_mesh(cfg)
    assert m.communicates and (m.rank, m.world) == (0, 1)
    assert "backend=gloo, world=1, shape=(1, 1)" in m.describe(
        torch.device("cpu"))
    plan = mesh.make_sharded_steps(cfg, apply, m)
    batch = _torch(_episodes(cfg, 8, 1))
    got, gm = plan.train_steps[phase](state, batch, 0)
    want, wm = outer.make_train_step(cfg, apply)(
        state, batch, 0, second_order=phase[0], use_msl=phase[1])
    for a, b in ((gm.loss, wm.loss), (gm.accuracy, wm.accuracy),
                 (gm.support_loss, wm.support_loss)):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves({"p": got.params, "l": got.lslr, "b": got.bn_state,
                     "m": got.opt_state.mu, "v": got.opt_state.nu}),
        tree_leaves({"p": want.params, "l": want.lslr, "b": want.bn_state,
                     "m": want.opt_state.mu, "v": want.opt_state.nu})))
    ev = _torch(_episodes(cfg, 16, 2))
    res, ref = plan.eval_step(got, ev), outer.make_eval_step(cfg, apply)(
        got, ev)
    assert all(torch.equal(a, b) for a, b in zip(res, ref))
    assert plan.train_steps[phase].__name__ == (
        f"train_so{int(phase[0])}_msl{int(phase[1])}")


# ---------------------------------------------------------------------------
# pad-and-mask exactness
# ---------------------------------------------------------------------------

PAD_BASE = dict(dataset_name="syn", image_height=6, image_width=6,
                image_channels=1, num_classes_per_set=2,
                num_samples_per_class=1, num_target_samples=1,
                cnn_num_filters=2, num_stages=2,
                number_of_training_steps_per_iter=1,
                number_of_evaluation_steps_per_iter=1, second_order=False,
                use_multi_step_loss_optimization=False, batch_size=6,
                **EXACT)


def _pad(ep, n):
    return jinner.Episode(*(np.concatenate(
        [f, np.zeros((n,) + f.shape[1:], f.dtype)]) for f in ep))


def test_pad_and_mask_equals_the_unpadded_step_and_jax():
    """6 real tasks + 2 zero pads on the port (a world of 1, and the 4
    ranks of the JAX degraded mesh each scaling its own shard) give the
    unpadded step's loss, meta-gradient and weights; the port's padded
    step agrees with the JAX package's padded step on 4 devices."""
    jcfgd = jmesh.derive_degraded_config(
        JaxConfig(**PAD_BASE, mesh_shape=(2, 4)), 1, 2)
    assert jcfgd.elastic_pad_tasks == 2 and jcfgd.mesh_shape == (1, 4)
    cfg1 = MAMLConfig(**PAD_BASE)
    cfgp = cfg1.replace(elastic_pad_tasks=2)
    _, apply = make_model(cfg1)
    js, trees = _jax_init(JaxConfig(**PAD_BASE))
    state = state_from_jax(*trees, device="cpu")
    real = _episodes(cfg1, 6, 5)
    padded = _pad(real, 2)
    key = dict(second_order=False, use_msl=False)

    s1, m1 = outer.make_train_step(cfg1, apply)(state, _torch(real), 0,
                                                **key)
    sp, mp = outer.make_train_step(cfgp, apply)(state, _torch(padded), 0,
                                                **key)
    np.testing.assert_allclose(float(mp.loss), float(m1.loss), rtol=2e-5)
    np.testing.assert_allclose(float(mp.accuracy), float(m1.accuracy),
                               rtol=2e-5)
    for a, b in zip(tree_leaves(sp.params), tree_leaves(s1.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-6)
    g1 = outer.make_meta_gradients(cfg1, apply)(state, _torch(real), 0,
                                                **key)[4]
    gp = outer.make_meta_gradients(cfgp, apply)(state, _torch(padded), 0,
                                                **key)[4]
    for a, b in zip(tree_leaves(gp), tree_leaves(g1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-6)
    # Each of 4 ranks on its shard of the padded batch: the local
    # accumulations, meaned as the all-reduce does, are the same step.
    cfg4 = MAMLConfig.from_dict(jcfgd.to_dict()).replace(**EXACT)
    sums = []
    for r in range(4):
        s, e = multihost.local_batch_positions(_mesh_of((1, 4), r), 8)
        shard = jinner.Episode(*(f[s:e] for f in padded))
        out = outer._make_accumulation(cfg4, apply, rank=r)(
            state, _torch(shard), 0, **key)
        sums.append(out["loss"])
    np.testing.assert_allclose(float(torch.stack(sums).mean()),
                               float(m1.loss), rtol=2e-5)

    # The JAX package's padded step on its degraded (1, 4) mesh.
    _, japply = jax_model(jcfgd)
    jm = jmesh.make_mesh(jcfgd, jax.devices()[:4])
    plan = jmesh.make_sharded_steps(jcfgd, japply, jm)
    jsd, jmd = plan.train_steps[(False, False)](
        jmesh.replicate_state(js, jm),
        jmesh.shard_batch(jinner.Episode(*map(jnp.asarray, padded)), jm),
        jnp.float32(0.0))
    np.testing.assert_allclose(float(mp.loss), float(jmd.loss), rtol=1e-4,
                               atol=2e-4)
    # Conv biases sit before a batch-statistics BN: their meta-gradient
    # is analytically zero and both sides hold rounding noise, which
    # Adam scales to a full step (docs/PARITY.md, the dead-bias
    # degeneracy); every other weight is held.
    want = params_from_jax(_np(jsd.params))
    held = 0
    for layer, sub in sp.params.items():
        for leaf, t in sub.items():
            if layer.startswith("conv") and leaf == "b":
                continue
            held += 1
            np.testing.assert_allclose(t.numpy(), want[layer][leaf].numpy(),
                                       rtol=2e-4, atol=2e-6,
                                       err_msg=f"{layer}/{leaf}")
    assert held >= 5
