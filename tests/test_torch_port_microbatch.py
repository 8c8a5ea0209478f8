"""A task's computation does not depend on how many tasks share its
chunk: ``task_microbatches`` 1 and 2 give the same conv-bias
meta-gradients in the port, as the one-step conv biases of the JAX
package's train step agree at one chunk and two.

A conv bias feeds batch-statistics BN, so its meta-gradient is zero in
exact arithmetic and rounding noise in practice (ROADMAP.md § Known
reference conditions); Adam's first step then moves the bias by a part
of the meta-LR whatever the noise's size. So the noise has to be the
same at any chunk size, or a ``task_microbatches`` pair reads ``fail``
in the tuner's parity gate. The port makes it so with per-task BN
reductions (``models/layers.py § _TasksFirst``) and, on the CPU,
group-by-group convolutions (``§ per_task_convs``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.meta import inner as jinner
from howtotrainyourmamlpytorch_tpu.meta import outer as jouter
from howtotrainyourmamlpytorch_tpu.models import make_model as jax_model
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.meta import inner, outer
from howtotrainyourmamlpytorch_tpu_torch.models import layers, make_model

# ``tests/test_torch_port_tune_parity.py § BASE``: batch 2, batch norm.
BASE = dict(experiment_name="parity", dataset_name="synthetic",
            image_height=8, image_width=8, image_channels=3,
            num_classes_per_set=2, num_samples_per_class=1,
            num_target_samples=1, cnn_num_filters=4, num_stages=2,
            number_of_training_steps_per_iter=1,
            number_of_evaluation_steps_per_iter=1, batch_size=2,
            task_microbatches=1, second_order=False,
            use_multi_step_loss_optimization=False, total_epochs=1,
            compute_dtype="float32", bn_fast_math=False)
CONV_BIASES = ("conv0", "conv1")


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    n, k, q, b = (cfg.num_classes_per_set, cfg.num_samples_per_class,
                  cfg.num_target_samples, cfg.batch_size)
    h, w, c = cfg.image_shape
    sy = np.tile(np.repeat(np.arange(n), k)[None], (b, 1)).astype(np.int32)
    ty = np.tile(np.repeat(np.arange(n), q)[None], (b, 1)).astype(np.int32)
    return (rng.randint(0, 256, (b, n * k, h, w, c)).astype(np.uint8), sy,
            rng.randint(0, 256, (b, n * q, h, w, c)).astype(np.uint8), ty)


def _port_conv_bias_grads(micro, second_order, **kw):
    cfg = MAMLConfig(**{**BASE, **kw, "task_microbatches": micro})
    init, apply = make_model(cfg)
    state = outer.init_train_state(cfg, init, seed=0, device="cpu")
    batch = inner.Episode(*(torch.from_numpy(a) for a in _batch(cfg)))
    grads = outer.make_meta_gradients(cfg, apply)(
        state, batch, 0, second_order=second_order, use_msl=False)[4]
    return [grads["params"][c]["b"] for c in CONV_BIASES]


@pytest.mark.parametrize("second_order", [False, True],
                         ids=["first_order", "second_order"])
def test_port_conv_bias_meta_gradients_ignore_the_chunk_count(second_order):
    one = _port_conv_bias_grads(1, second_order)
    two = _port_conv_bias_grads(2, second_order)
    for name, a, b in zip(CONV_BIASES, one, two):
        assert torch.equal(a, b), (name, a, b)


def test_jax_conv_biases_after_one_step_ignore_the_chunk_count():
    """The reference condition the port is held to: the JAX train step's
    conv biases after one step are the same at one chunk and two."""
    out = []
    for micro in (1, 2):
        jcfg = JaxConfig(**{**BASE, "task_microbatches": micro})
        init, apply = jax_model(jcfg)
        state = jouter.init_train_state(jcfg, init, jax.random.PRNGKey(0))
        step = jax.jit(jouter.make_train_step(jcfg, apply),
                       static_argnames=("second_order", "use_msl"))
        new, _ = step(state, jinner.Episode(*map(jnp.asarray,
                                                 _batch(jcfg))),
                      0, second_order=False, use_msl=False)
        out.append([np.asarray(new.params[c]["b"]) for c in CONV_BIASES])
    for name, a, b in zip(CONV_BIASES, *out):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_port_conv_biases_after_one_step_ignore_the_chunk_count():
    out = []
    for micro in (1, 2):
        cfg = MAMLConfig(**{**BASE, "task_microbatches": micro})
        init, apply = make_model(cfg)
        state = outer.init_train_state(cfg, init, seed=0, device="cpu")
        batch = inner.Episode(*(torch.from_numpy(a) for a in _batch(cfg)))
        new, _ = outer.make_train_step(cfg, apply)(
            state, batch, 0, second_order=False, use_msl=False)
        out.append([new.params[c]["b"] for c in CONV_BIASES])
    for name, a, b in zip(CONV_BIASES, *out):
        assert torch.equal(a, b), (name, a, b)


@pytest.mark.parametrize("fast_math", [False, True],
                         ids=["exact", "fast_math"])
def test_batch_norm_of_one_task_ignores_its_neighbours(fast_math):
    """``batch_norm_apply`` over three tasks against each task alone:
    output, input gradient and γ/β gradients bitwise, and the second
    derivative (a second-order step differentiates the backward)."""
    t, n, c, hw = 3, 2, 4, 5
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(n, t * c, hw, hw, generator=gen).contiguous(
        memory_format=torch.channels_last)
    params = {"gamma": torch.randn(t, 1, c, generator=gen),
              "beta": torch.randn(t, 1, c, generator=gen)}
    gy = torch.randn(n, t * c, hw, hw, generator=gen)

    def run(x, params, gy):
        x = x.detach().clone().requires_grad_(True)
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        tasks = p["gamma"].shape[0]
        state = {"mean": torch.zeros(tasks, 1, c),
                 "var": torch.ones(tasks, 1, c)}
        y, _ = layers.batch_norm_apply(p, state, x, 0, training=True,
                                       fast_math=fast_math)
        gx, gg, gb = torch.autograd.grad(y, (x, p["gamma"], p["beta"]),
                                         gy, create_graph=True)
        (hx,) = torch.autograd.grad(gx.square().sum(), (x,))
        return y, gx, gg, gb, hx

    whole = run(x, params, gy)
    for k in range(t):
        cols = slice(k * c, (k + 1) * c)
        one = run(x[:, cols].contiguous(memory_format=torch.channels_last),
                  {name: v[k:k + 1] for name, v in params.items()},
                  gy[:, cols])
        got = (whole[0][:, cols], whole[1][:, cols], whole[2][k:k + 1],
               whole[3][k:k + 1], whole[4][:, cols])
        for name, a, b in zip(("y", "gx", "ggamma", "gbeta", "hx"), got,
                              one):
            assert torch.equal(a, b), (k, name)


def test_per_task_convs_restores_the_flag_and_leaves_the_card_alone():
    before = torch.backends.mkldnn.enabled
    with layers.per_task_convs("cpu"):
        assert torch.backends.mkldnn.enabled is False
    assert torch.backends.mkldnn.enabled == before
    with layers.per_task_convs("cuda"):
        assert torch.backends.mkldnn.enabled == before
