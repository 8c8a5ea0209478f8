"""The port's training-health diagnostics against the JAX package's, on
the CPU: a tiny VGG (f32, composite BN, two stages of 8 filters, K=2),
weights initialized by the JAX package and carried over with
``convert``, batches from a numpy seed. One first-order + MSL step and
one second-order step in both packages give the same health dict, key
for key:

* gradient norms and update ratios within rtol 1e-4 / atol 1e-5 (the
  meta-gradient parity tolerance of ``tests/test_torch_port_train.py``);
* LSLR statistics within rtol 1e-6;
* per-step losses (and the MSL weights) within rtol 1e-4 / atol 2e-4.

Health on against health off over three steps keeps the port's weights
and Adam state bitwise, and ``publish_health`` writes the JAX package's
gauge names and row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.meta import inner as jinner
from howtotrainyourmamlpytorch_tpu.meta import outer as jouter
from howtotrainyourmamlpytorch_tpu.models import make_model as jax_model
from howtotrainyourmamlpytorch_tpu.telemetry import health as jhealth
from howtotrainyourmamlpytorch_tpu.telemetry import registry as jreg
from howtotrainyourmamlpytorch_tpu.utils import tracing as jtracing
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.convert import state_from_jax
from howtotrainyourmamlpytorch_tpu_torch.meta import inner, outer
from howtotrainyourmamlpytorch_tpu_torch.models import make_model
from howtotrainyourmamlpytorch_tpu_torch.telemetry import health
from howtotrainyourmamlpytorch_tpu_torch.telemetry import registry as reg
from howtotrainyourmamlpytorch_tpu_torch.tree import tree_leaves
from howtotrainyourmamlpytorch_tpu_torch.utils import tracing

CFG = dict(dataset_name="synthetic", image_height=12, image_width=12,
           image_channels=3, num_classes_per_set=2, num_samples_per_class=2,
           num_target_samples=2, cnn_num_filters=8, num_stages=2,
           task_learning_rate=0.1, number_of_training_steps_per_iter=2,
           number_of_evaluation_steps_per_iter=2, batch_size=4,
           task_microbatches=2, multi_step_loss_num_epochs=10,
           total_iter_per_epoch=1, total_epochs=4, compute_dtype="float32",
           bn_fast_math=False, bn_backend="composite",
           clamp_meta_grad_value=10.0, health_metrics_every_n_steps=1)
# (epoch, second_order, use_msl): the flagship's two phases.
PHASES = ((0, False, True), (1, True, False))
NORM_TOL = dict(rtol=1e-4, atol=1e-5)
LSLR_TOL = dict(rtol=1e-6, atol=0.0)
LOSS_TOL = dict(rtol=1e-4, atol=2e-4)


def _batch(cfg, seed):
    """A numpy meta-batch: uint8 images (the wire format), int32 labels."""
    rng = np.random.default_rng(seed)
    h, w, c = cfg.image_shape
    n, k, q = (cfg.num_classes_per_set, cfg.num_samples_per_class,
               cfg.num_target_samples)
    return jinner.Episode(
        rng.integers(0, 256, (cfg.batch_size, n * k, h, w, c),
                     dtype=np.uint8),
        np.tile(np.repeat(np.arange(n, dtype=np.int32), k),
                (cfg.batch_size, 1)),
        rng.integers(0, 256, (cfg.batch_size, n * q, h, w, c),
                     dtype=np.uint8),
        np.tile(np.repeat(np.arange(n, dtype=np.int32), q),
                (cfg.batch_size, 1)))


def _torch_batch(batch):
    return inner.Episode(*(torch.from_numpy(np.asarray(f)) for f in batch))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package: the two phases' steps from one state, each with
    its health dict fetched; and the start state as numpy."""
    jcfg = JaxConfig(**CFG)
    init, apply = jax_model(jcfg)
    state = jouter.init_train_state(jcfg, init, jax.random.PRNGKey(0))
    step = jax.jit(jouter.make_train_step(jcfg, apply),
                   static_argnames=("second_order", "use_msl"))
    out = {}
    for i, (epoch, so, msl) in enumerate(PHASES):
        batch = jinner.Episode(*map(jnp.asarray, _batch(jcfg, 20 + i)))
        _, m = step(state, batch, epoch, second_order=so, use_msl=msl)
        out[(so, msl)] = {k: np.asarray(v)
                          for k, v in jax.device_get(m.health).items()}
    return jax.tree.map(np.asarray, jax.device_get(state)), out


def _port_state(js):
    return state_from_jax(js.params, js.lslr, js.bn_state, int(js.step),
                          device="cpu", opt_state=js.opt_state)


@pytest.mark.parametrize("phase", range(len(PHASES)))
def test_health_dict_matches_jax(jax_run, phase):
    js, want_all = jax_run
    epoch, so, msl = PHASES[phase]
    want = want_all[(so, msl)]
    cfg = MAMLConfig(**CFG)
    _, apply = make_model(cfg)
    step = outer.make_train_step(cfg, apply)
    _, m = step(_port_state(js), _torch_batch(_batch(cfg, 20 + phase)),
                epoch, second_order=so, use_msl=msl, health=True)
    got = {k: v.numpy() for k, v in m.health.items()}
    assert sorted(got) == sorted(want)
    for key, value in got.items():
        if key.startswith(("grad_norm", "update_ratio")):
            tol = NORM_TOL
        elif key.startswith("lslr_"):
            tol = LSLR_TOL
        else:  # per-step losses, the MSL weights
            tol = LOSS_TOL
        np.testing.assert_allclose(value, want[key], err_msg=key, **tol)


def _leaves(state):
    return tree_leaves({"p": state.params, "l": state.lslr,
                        "b": state.bn_state, "m": state.opt_state.mu,
                        "v": state.opt_state.nu})


def test_health_on_keeps_the_weights_bitwise(jax_run):
    """Three steps (first order + MSL, then second order) with health on
    and with it off: the same weights, LSLR, BN state and Adam state,
    bitwise."""
    js, _ = jax_run
    cfg = MAMLConfig(**CFG)
    _, apply = make_model(cfg)
    step = outer.make_train_step(cfg, apply)
    runs = []
    for with_health in (False, True):
        state = _port_state(js)
        for i, (epoch, so, msl) in enumerate(PHASES + PHASES[1:]):
            state, m = step(state, _torch_batch(_batch(cfg, 30 + i)), epoch,
                            second_order=so, use_msl=msl,
                            health=with_health)
            assert (m.health is not None) == with_health
        runs.append(state)
    off, on = runs
    assert on.step == off.step == 3 and on.opt_state.count == 3
    for a, b in zip(_leaves(off), _leaves(on)):
        assert torch.equal(a, b)


def test_publish_health_matches_jax(jax_run, tmp_path, monkeypatch):
    """The same fetched dict publishes the JAX package's gauges and one
    identical ``health`` row."""
    monkeypatch.setattr(reg.time, "time", lambda: 1_790_000_000.5)
    _, want_all = jax_run
    want = want_all[(False, True)]
    fetched = health.fetch_health({k: torch.from_numpy(np.array(v))
                                   for k, v in want.items()})
    ours, ref = reg.MetricsRegistry(), jreg.MetricsRegistry()
    row = health.publish_health(
        ours, tracing.JsonlLogger(str(tmp_path / "ours.jsonl")), fetched,
        iteration=7, epoch=1)
    jrow = jhealth.publish_health(
        ref, jtracing.JsonlLogger(str(tmp_path / "ref.jsonl")),
        dict(want), iteration=7, epoch=1)
    assert row == jrow
    assert ours.snapshot() == ref.snapshot()
    assert (tmp_path / "ours.jsonl").read_bytes() == (
        tmp_path / "ref.jsonl").read_bytes()
    assert {health.HEALTH_EVENT, health.GRAD_NORM_WARN_EVENT,
            health.GRAD_NORM_WARN_COUNTER} == {
        jhealth.HEALTH_EVENT, jhealth.GRAD_NORM_WARN_EVENT,
        jhealth.GRAD_NORM_WARN_COUNTER}
