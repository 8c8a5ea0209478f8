"""The port on the card: the hand-written kernels against their plain
versions, and the serving and training paths end to end at a small size.

Every test here needs an NVIDIA GPU and the CUDA toolkit; each skips
elsewhere (decided in a fixture, when the test runs). This file imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -m cuda
"""

import json

import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.data import MetaLearningDataLoader
from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
    init_train_state, make_meta_gradients, make_train_step)
from howtotrainyourmamlpytorch_tpu_torch.models import make_model
from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
from howtotrainyourmamlpytorch_tpu_torch.serve import (FewShotRequest,
                                                       ServingEngine)

pytestmark = pytest.mark.cuda

# The flagship's serving shapes (25 images x H x W, 8 tasks x 48 channels),
# and rows fewer than and not a multiple of the SM count.
STAGES = [(25 * hw * hw, 384) for hw in (84, 42, 21, 10)]
SMALL = [(100, 384), (1000, 384)]
# Training (one task per microbatch: 48 columns) and the eval step's 24
# tasks at once (1152 columns).
TRAIN_STAGES = [(25 * hw * hw, 48) for hw in (84, 42, 21, 10)]
EVAL_STAGES = [(25 * hw * hw, 24 * 48) for hw in (84, 42, 21, 10)]
# ResNet-12's training shapes (one task per microbatch): its four blocks'
# widths 64/160/320/640 at 84/42/21/10.
RESNET12_TRAIN = [(25 * hw * hw, width)
                  for hw, width in ((84, 64), (42, 160), (21, 320),
                                    (10, 640))]


@pytest.fixture
def cuda_device():
    """The card, decided when a test runs (never at import): skipped
    where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1001, 7), (4096, 384)] + STAGES + SMALL
                         + TRAIN_STAGES + EVAL_STAGES)
def test_cuda_tensor_launches_kernel(cuda_device, shape, dtype):
    """On a CUDA tensor the wrapper launches the kernel (counted once) and
    agrees with the plain version on the card: bf16 bitwise up to the
    statistics' sum order (2 ulp), f32 to sum order (1e-4)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(shape) * 2 + 0.3).astype(
        np.float32)).to(cuda_device, dtype)
    gamma = torch.from_numpy((rng.random(shape[1]) + 0.5).astype(
        np.float32)).to(cuda_device)
    beta = torch.zeros(shape[1], device=cuda_device)
    before = bn_act.launches
    y, m, v = bn_act.bn_act(x, gamma, beta, 1e-5, 0.1)
    torch.cuda.synchronize()
    assert bn_act.launches == before + 1
    y_p, m_p, v_p = bn_act.bn_act(x, gamma, beta, 1e-5, 0.1, plain=True)
    assert bn_act.launches == before + 1
    rtol, atol = ((1.6e-2, 1e-2) if dtype == torch.bfloat16 else
                  (1e-4, 1e-5))
    torch.testing.assert_close(y.float(), y_p.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(m, m_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(v, v_p, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("slope", [0.1, 1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", RESNET12_TRAIN)
def test_resnet12_shapes_and_slopes_match_plain(cuda_device, shape, dtype,
                                                 slope):
    """ResNet-12's training shapes at its slopes (0.1 leaky, 1.0 none):
    the kernel's forward, statistics and gradients (its autograd.Function
    against autograd of the plain version) on the card. Tolerances as
    chip_smoke.py's: forward 2 ulp bf16 / sum order f32; gradients 2 ulp
    (bf16) or 1e-3 (f32) of the largest entry."""
    x, gamma, beta = _stage_inputs(shape, dtype, cuda_device, seed=4)
    rng = np.random.default_rng(5)
    gy = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        cuda_device, dtype)
    with torch.no_grad():
        y_k = bn_act.bn_act(x, gamma, beta, 1e-5, slope)[0]
        y_p = bn_act.bn_act(x, gamma, beta, 1e-5, slope, plain=True)[0]
    # Opposite sides of the kink have other derivatives by design.
    gy = gy.masked_fill((y_k > 0) != (y_p > 0), 0)
    outs = []
    for plain in (False, True):
        xs, gs, bs = (t.clone().requires_grad_(True) for t in (x, gamma,
                                                                beta))
        y, m, v = bn_act.bn_act(xs, gs, bs, 1e-5, slope, plain=plain)
        grads = torch.autograd.grad((y.float() * gy.float()).sum()
                                    + m.sum() + v.sum(), (xs, gs, bs))
        outs.append((y.detach(), m.detach(), v.detach(), *grads))
    torch.cuda.synchronize()
    k, p = outs
    bf16 = dtype == torch.bfloat16
    rtol, atol = (1.6e-2, 1e-2) if bf16 else (1e-4, 1e-5)
    torch.testing.assert_close(k[0].float(), p[0].float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(k[1], p[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(k[2], p[2], rtol=1e-4, atol=1e-5)
    grtol = 1.6e-2 if bf16 else 1e-3
    for a, b in zip(k[3:], p[3:]):
        scale = float(b.abs().max()) or 1.0
        torch.testing.assert_close(a.float(), b.float(), rtol=grtol,
                                   atol=grtol * scale)


@pytest.fixture
def no_tf32():
    """Full f32 convolutions and matrix products for the test (cuDNN runs
    f32 convolutions in TF32 by default, which rounds their inputs to 10
    bits: kernel-vs-plain last-bit differences then grow to bf16's
    size)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def test_resnet12_train_step_on_the_card_kernel_matches_plain(cuda_device,
                                                              no_tf32):
    """A small ResNet-12 on the card: one second-order MSL train step
    through the kernel, launching it 16 x (K + K x 2) times per microbatch
    ('block_outs' remat), then an f32 second-order meta-gradient with the
    kernel against its plain version, TF32 off (loss 2e-3, cosine 0.998:
    chip_smoke.py's R12_F32_FLOORS)."""
    cfg = MAMLConfig(dataset_name="synthetic", backbone="resnet12",
                     image_height=20, image_width=20, image_channels=3,
                     num_classes_per_set=3, num_samples_per_class=2,
                     num_target_samples=2, cnn_num_filters=8,
                     number_of_training_steps_per_iter=2, batch_size=2,
                     task_microbatches=2, bn_backend="pallas",
                     bn_fast_math=True, clamp_meta_grad_value=10.0)
    init, apply = make_model(cfg)
    state = init_train_state(cfg, init, seed=0, device=cuda_device)
    batches = MetaLearningDataLoader(cfg, device=cuda_device)\
        .get_train_batches(0, 2)
    bn_act.reset_launches()
    new, m = make_train_step(cfg, apply)(state, next(batches), 0,
                                         second_order=True, use_msl=True)
    torch.cuda.synchronize()
    assert bn_act.launches == 2 * 16 * (2 + 2 * 2)
    assert new.step == 1 and torch.isfinite(m.loss)
    cfg32 = cfg.replace(compute_dtype="float32")
    _, apply32 = make_model(cfg32)
    batch = next(batches)
    (lk, *_, gk), (lp, *_, gp) = [make_meta_gradients(cfg32, apply32)(
        new, batch, 1, second_order=True, use_msl=False, plain=plain)
        for plain in (False, True)]
    assert abs(float(lk) - float(lp)) <= 2e-3 * abs(float(lp))
    flat = lambda g: torch.cat([t.flatten() for sub in g.values()
                                for leaf in sub.values()
                                for t in leaf.values()])
    a, b = flat(gk).double(), flat(gp).double()
    assert float(a @ b / (a.norm() * b.norm())) >= 0.998


def test_engine_on_the_card_launches_the_kernel(cuda_device):
    """A small engine on the card launches the BN kernel stages x steps
    times per adapt batch and stages times per predict batch (2 x 2 + 2
    here), and a repeated support set is a cache hit with the same
    logits."""
    cfg = MAMLConfig(dataset_name="synthetic", image_height=12,
                     image_width=12, image_channels=3,
                     num_classes_per_set=3, num_samples_per_class=2,
                     num_target_samples=2, cnn_num_filters=8, num_stages=2,
                     number_of_evaluation_steps_per_iter=2,
                     bn_backend="pallas", bn_fast_math=True,
                     serve_batch_tasks=2, serve_default_deadline_ms=0.0)
    init, _ = make_model(cfg)
    engine = ServingEngine(cfg, init_train_state(cfg, init, seed=0),
                           device=cuda_device)
    rng = np.random.default_rng(1)
    req = FewShotRequest(
        support_x=rng.integers(0, 256, (6, 12, 12, 3), dtype=np.uint8),
        support_y=np.arange(6, dtype=np.int32) % 3,
        query_x=rng.integers(0, 256, (6, 12, 12, 3), dtype=np.uint8))
    bn_act.reset_launches()
    engine.submit(req)
    (resp,) = engine.drain()
    assert resp.status == "ok" and np.isfinite(resp.logits).all()
    assert bn_act.launches == 2 * 2 + 2
    engine.submit(FewShotRequest(support_x=req.support_x,
                                 support_y=req.support_y,
                                 query_x=req.query_x))
    (hit,) = engine.drain()
    assert hit.cache_hit and engine.adapt_invocations == 1
    np.testing.assert_array_equal(hit.logits, resp.logits)


def _stage_inputs(shape, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(shape) * 2 + 0.3).astype(
        np.float32)).to(device, dtype)
    gamma = torch.from_numpy((rng.random(shape[1]) + 0.5).astype(
        np.float32)).to(device)
    beta = torch.from_numpy((rng.standard_normal(shape[1]) * 0.1).astype(
        np.float32)).to(device)
    return x, gamma, beta


@pytest.mark.parametrize("shape", [STAGES[0], STAGES[3], (100, 384)])
def test_kernel_is_bitwise_deterministic(cuda_device, shape):
    """No float atomics: two launches on the same x agree bitwise in y,
    mean and var (the serving cache relies on it)."""
    x, gamma, beta = _stage_inputs(shape, torch.bfloat16, cuda_device)
    first = bn_act.bn_act(x, gamma, beta, 1e-5, 0.0)
    second = bn_act.bn_act(x, gamma, beta, 1e-5, 0.0)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unaligned_view_takes_scalar_path(cuda_device, dtype):
    """A contiguous view one element into its storage is not 16-byte
    aligned: the same kernel runs with scalar loads and still agrees with
    the plain version."""
    shape = (3001, 384)
    x0, gamma, beta = _stage_inputs(shape, dtype, cuda_device, seed=2)
    x = torch.empty(x0.numel() + 1, dtype=dtype,
                    device=cuda_device)[1:].view(shape)
    x.copy_(x0)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert bn_act.plan(*shape, x.element_size(), False,
                       bn_act._sm_count(x.device.index)).vec == 1
    y, m, v = bn_act.bn_act(x, gamma, beta, 1e-5, 0.0)
    y_p, m_p, v_p = bn_act.bn_act(x0, gamma, beta, 1e-5, 0.0, plain=True)
    rtol, atol = ((1.6e-2, 1e-2) if dtype == torch.bfloat16 else
                  (1e-4, 1e-5))
    torch.testing.assert_close(y.float(), y_p.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(m, m_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(v, v_p, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_single_row_matches_plain(cuda_device, dtype):
    """One row: var is 0, scale = gamma/sqrt(eps) ~ 316 gamma, and y = x *
    scale + shift cancels two terms of size |x * scale|. A last-bit
    difference of 1/sqrt(eps) (the plain version's rsqrt, the kernel's
    rounded 1/sqrt) shows at that size, so y's atol is the dtype's rtol of
    max |x * scale|; mean and var are exact in both."""
    x, gamma, beta = _stage_inputs((1, 384), dtype, cuda_device, seed=3)
    y, m, v = bn_act.bn_act(x, gamma, beta, 1e-5, 0.1)
    y_p, m_p, v_p = bn_act.bn_act(x, gamma, beta, 1e-5, 0.1, plain=True)
    rtol = 1.6e-2 if dtype == torch.bfloat16 else 1e-4
    atol = rtol * float((x.float().abs().max() * gamma.max()
                         / 1e-5 ** 0.5).item())
    torch.testing.assert_close(y.float(), y_p.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(m, m_p, rtol=0, atol=0)
    torch.testing.assert_close(v, v_p, rtol=0, atol=0)


def test_train_step_on_the_card_kernel_matches_plain(cuda_device):
    """A tiny flagship-shaped training run on the card: loader batches,
    one first-order MSL step and one second-order step through the kernel
    (launches as derived: stages x (K + targets x 2) per microbatch with
    'block_outs' remat), then a second-order meta-gradient with the
    kernel against its plain version (loss 1 %, cosine 0.99)."""
    cfg = MAMLConfig(dataset_name="synthetic", image_height=12,
                     image_width=12, image_channels=3,
                     num_classes_per_set=3, num_samples_per_class=2,
                     num_target_samples=2, cnn_num_filters=8, num_stages=2,
                     number_of_training_steps_per_iter=2,
                     number_of_evaluation_steps_per_iter=2, batch_size=4,
                     task_microbatches=2, bn_backend="pallas",
                     bn_fast_math=True, clamp_meta_grad_value=10.0)
    init, apply = make_model(cfg)
    state = init_train_state(cfg, init, seed=0, device=cuda_device)
    batches = MetaLearningDataLoader(cfg, device=cuda_device)\
        .get_train_batches(0, 3)
    step = make_train_step(cfg, apply)
    for (so, msl), per_micro in (((False, True), 2 * (2 + 2 * 2)),
                                 ((True, False), 2 * (2 + 1 * 2))):
        bn_act.reset_launches()
        new, m = step(state, next(batches), 0, second_order=so,
                      use_msl=msl)
        torch.cuda.synchronize()
        assert bn_act.launches == 2 * per_micro
        assert new.step == state.step + 1 and torch.isfinite(m.loss)
        state = new
    batch = next(batches)
    outs = [make_meta_gradients(cfg, apply)(
        state, batch, 41, second_order=True, use_msl=False, plain=plain)
        for plain in (False, True)]
    (lk, *_, gk), (lp, *_, gp) = outs
    assert abs(float(lk) - float(lp)) <= 1e-2 * abs(float(lp))
    flat = lambda g: torch.cat([t.flatten() for sub in g.values()
                                for leaf in sub.values()
                                for t in leaf.values()])
    a, b = flat(gk).double(), flat(gp).double()
    assert float(a @ b / (a.norm() * b.norm())) >= 0.99


@pytest.mark.parametrize("policy", ["block_outs", "nothing", "conv_outs",
                                    "dots"])
def test_remat_on_the_card_matches_no_remat(cuda_device, policy):
    """Checkpoint recomputes launch the kernel again on the same inputs
    (it is bitwise deterministic), so remat changes no meta-gradient
    (second order, MSL: the whole-step segment runs the inner
    ``autograd.grad`` inside the checkpoint). cuDNN's weight gradients may
    sum in another order from run to run, so leaves are compared by
    cosine (>= 0.999), conv biases excepted: their meta-gradient is
    analytically zero and holds rounding noise only."""
    base = MAMLConfig(dataset_name="synthetic", image_height=12,
                      image_width=12, image_channels=3,
                      num_classes_per_set=3, num_samples_per_class=2,
                      num_target_samples=2, cnn_num_filters=8, num_stages=2,
                      number_of_training_steps_per_iter=2, batch_size=2,
                      bn_backend="pallas", bn_fast_math=True)
    init, apply = make_model(base)
    state = init_train_state(base, init, seed=1, device=cuda_device)
    batch = next(MetaLearningDataLoader(base, device=cuda_device)
                 .get_train_batches(0, 1))
    outs = [make_meta_gradients(base.replace(**kw), apply)(
        state, batch, 0, second_order=True, use_msl=True)
        for kw in (dict(remat_inner_steps=False),
                   dict(remat_inner_steps=True, remat_policy=policy))]
    (l0, *_, g0), (l1, *_, g1) = outs
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    for top in ("params", "lslr"):
        for layer, sub in g0[top].items():
            for leaf, t in sub.items():
                if layer.startswith("conv") and leaf == "b":
                    continue
                a = g1[top][layer][leaf].double().flatten()
                b = t.double().flatten()
                if float(b.norm()) > 0:
                    assert float(a @ b / (a.norm() * b.norm())) >= 0.999, (
                        top, layer, leaf)


def test_batched_msl_on_the_card_matches_serial(cuda_device):
    """``msl_target_batching='on'`` on the card: a first-order MSL step
    launches the kernel K + 1 times per BN layer and microbatch (K
    support forwards, ONE target forward over K·T instances) against
    3K under 'auto' with 'block_outs'; the meta-gradient equals the
    serial one (loss 1e-5, leaf cosine 0.999, conv biases excepted)."""
    base = MAMLConfig(dataset_name="synthetic", image_height=12,
                      image_width=12, image_channels=3,
                      num_classes_per_set=3, num_samples_per_class=2,
                      num_target_samples=2, cnn_num_filters=8, num_stages=2,
                      number_of_training_steps_per_iter=3, batch_size=4,
                      task_microbatches=2, bn_backend="pallas",
                      bn_fast_math=True, compute_dtype="float32")
    init, apply = make_model(base)
    state = init_train_state(base, init, seed=2, device=cuda_device)
    batch = next(MetaLearningDataLoader(base, device=cuda_device)
                 .get_train_batches(0, 1))
    grads = {}
    for mode, per_micro in (("on", 3 + 1), ("auto", 3 + 3 * 2)):
        cfg = base.replace(msl_target_batching=mode)
        bn_act.reset_launches()
        loss, *_, g = make_meta_gradients(cfg, apply)(
            state, batch, 0, second_order=False, use_msl=True)
        torch.cuda.synchronize()
        assert bn_act.launches == 2 * 2 * per_micro, mode
        grads[mode] = (loss, g)
    (lb, gb), (ls, gs) = grads["on"], grads["auto"]
    torch.testing.assert_close(lb, ls, rtol=1e-5, atol=0)
    for top in ("params", "lslr"):
        for layer, sub in gs[top].items():
            for leaf, t in sub.items():
                if layer.startswith("conv") and leaf == "b":
                    continue
                a, b = gb[top][layer][leaf].double().flatten(), t.double(
                    ).flatten()
                if float(b.norm()) > 0:
                    assert float(a @ b / (a.norm() * b.norm())) >= 0.999


def test_pack_cli_run_on_the_card(cuda_device, tmp_path):
    """A tiny CLI run on the card trained from MAMLPACK1 shards under
    'on' + 'conv_outs': it reads the packed source, exits 0 and launches
    the kernel as derived (per train step: microbatches x stages x
    (K + 1) in the first-order MSL epoch, x (3K + 1) in the second-order
    one)."""
    from howtotrainyourmamlpytorch_tpu_torch import train_maml_system
    from howtotrainyourmamlpytorch_tpu_torch.data import source_kind
    from howtotrainyourmamlpytorch_tpu_torch.datastore import write_shard
    rng = np.random.default_rng(0)
    packs = tmp_path / "packs"
    for split, n in (("train", 8), ("val", 4), ("test", 4)):
        write_shard(str(packs / f"{split}.mamlpack"),
                    [(f"c{i}", rng.integers(0, 256, (6, 12, 12, 3),
                                            dtype=np.uint8))
                     for i in range(n)])
    cfg = dict(experiment_name="pack", dataset_name="packed",
               image_height=12, image_width=12, image_channels=3,
               num_classes_per_set=3, num_samples_per_class=2,
               num_target_samples=2, cnn_num_filters=8, num_stages=2,
               number_of_training_steps_per_iter=2,
               number_of_evaluation_steps_per_iter=2, batch_size=4,
               task_microbatches=2, bn_backend="pallas", bn_fast_math=True,
               total_epochs=2, total_iter_per_epoch=2,
               first_order_to_second_order_epoch=0,
               multi_step_loss_num_epochs=1, num_evaluation_tasks=4,
               max_models_to_save=1, msl_target_batching="on",
               remat_policy="conv_outs", dataset_pack_path=str(packs))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    builders = []
    bn_act.reset_launches()
    assert train_maml_system.main(
        ["--name_of_args_json_file", str(path), "--experiment_root",
         str(tmp_path / "runs")], builders=builders) == 0
    torch.cuda.synchronize()
    b = builders[0]
    assert source_kind(b.data.sampler("train").source) == "packed"
    s, k, micro = 2, 2, 2
    train = 2 * micro * s * (k + 1) + 2 * micro * s * (3 * k + 1)
    per_eval = -(-4 // b.cfg.effective_eval_batch_size) * s * (k + 1)
    assert bn_act.launches == train + (2 + 1) * per_eval


def _paths(tree, prefix=()):
    """``(key path, leaf)`` over a nested dict."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _paths(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def test_builder_run_on_the_card(cuda_device, tmp_path):
    """A tiny ExperimentBuilder run on the card through the kernel: two
    epochs (first order + MSL, then second order), two validation sweeps
    and a two-model ensemble test. The kernel's launches equal the count
    derived for the path, and the latest checkpoint reloads bitwise into
    the state the builder holds."""
    from howtotrainyourmamlpytorch_tpu_torch.experiment import (
        ExperimentBuilder)
    from howtotrainyourmamlpytorch_tpu_torch.utils.checkpoint import (
        CheckpointManager)
    cfg = MAMLConfig(experiment_name="card", experiment_root=str(tmp_path),
                     dataset_name="synthetic", image_height=12,
                     image_width=12, image_channels=3,
                     num_classes_per_set=3, num_samples_per_class=2,
                     num_target_samples=2, cnn_num_filters=8, num_stages=2,
                     number_of_training_steps_per_iter=2,
                     number_of_evaluation_steps_per_iter=2, batch_size=4,
                     task_microbatches=2, bn_backend="pallas",
                     bn_fast_math=True, total_epochs=2,
                     total_iter_per_epoch=2,
                     first_order_to_second_order_epoch=0,
                     multi_step_loss_num_epochs=1, num_evaluation_tasks=8,
                     max_models_to_save=2)
    builder = ExperimentBuilder(cfg)
    assert builder.device.type == "cuda"
    bn_act.reset_launches()
    result = builder.run_experiment()
    torch.cuda.synchronize()
    s, k = cfg.num_stages, cfg.number_of_training_steps_per_iter
    micro = cfg.effective_task_microbatches()
    train = 2 * micro * s * (k + k * 2) + 2 * micro * s * (k + 1 * 2)
    eval_batches = -(-cfg.num_evaluation_tasks
                     // cfg.effective_eval_batch_size)
    per_eval = eval_batches * s * (cfg.number_of_evaluation_steps_per_iter
                                   + 1)
    assert bn_act.launches == train + 2 * per_eval + 2 * per_eval
    assert result["num_models"] == 2 and result["num_episodes"] == 8
    reloaded, _ = CheckpointManager(builder.paths["saved_models"]).load(
        builder.state, "latest")

    def named(state):
        trees = {"params": state.params, "lslr": state.lslr,
                 "bn_state": state.bn_state, "mu": state.opt_state.mu,
                 "nu": state.opt_state.nu}
        return {(top, *path): t for top, tree in trees.items()
                for path, t in _paths(tree)}
    held, got = named(builder.state), named(reloaded)
    assert held.keys() == got.keys()
    for name, t in held.items():
        assert got[name].device == t.device and torch.equal(got[name], t), (
            name)
    assert reloaded.step == builder.state.step == 4


def test_cli_f32_config_convolves_without_tf32(cuda_device, tmp_path,
                                               monkeypatch):
    """Through the CLI on the card, an f32 config's train steps run under
    the entry point's numerics policy: inside each step cuDNN is
    deterministic and TF32 is off, which a convolution against its f64
    value shows (max error / max |value| under 1e-5; TF32 rounds inputs
    to 10 mantissa bits, ~1e-3). Torch's flags come back after the run."""
    import json
    import torch.nn.functional as F
    from howtotrainyourmamlpytorch_tpu_torch import (experiment,
                                                     train_maml_system)
    seen = []
    make = experiment.make_train_step

    def spy(cfg, apply_fn, **kw):
        step = make(cfg, apply_fn, **kw)

        def wrapped(*args, **kwargs):
            gen = torch.Generator(device="cuda").manual_seed(0)
            x = torch.randn(8, 64, 32, 32, device="cuda", generator=gen)
            w = torch.randn(64, 64, 3, 3, device="cuda", generator=gen)
            ref = F.conv2d(x.double(), w.double(), padding=1)
            err = (F.conv2d(x, w, padding=1).double() - ref).abs().max()
            seen.append((torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.deterministic,
                         float(err / ref.abs().max())))
            return step(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(experiment, "make_train_step", spy)
    path = tmp_path / "f32.json"
    path.write_text(json.dumps(dict(
        experiment_name="f32", dataset_name="synthetic", image_height=12,
        image_width=12, image_channels=3, num_classes_per_set=3,
        num_samples_per_class=2, num_target_samples=2, cnn_num_filters=8,
        num_stages=2, number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=2, batch_size=4,
        task_microbatches=2, compute_dtype="float32", bn_fast_math=False,
        bn_backend="pallas", total_epochs=1, total_iter_per_epoch=2,
        num_evaluation_tasks=4, max_models_to_save=1)))
    cudnn = torch.backends.cudnn
    saved = (cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             cudnn.deterministic, cudnn.benchmark)
    try:
        cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        cudnn.deterministic, cudnn.benchmark = False, True
        rc = train_maml_system.main(["--name_of_args_json_file", str(path),
                                     "--experiment_root", str(tmp_path)])
        after = (cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                 cudnn.deterministic, cudnn.benchmark)
    finally:
        (cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         cudnn.deterministic, cudnn.benchmark) = saved
    assert rc == 0 and len(seen) == 2
    for tf32, mm_tf32, deterministic, err in seen:
        assert not tf32 and not mm_tf32 and deterministic
        assert err < 1e-5, err
    assert after == (True, True, False, True)


CARD_RUN = dict(
    experiment_name="card", dataset_name="synthetic", image_height=12,
    image_width=12, image_channels=3, num_classes_per_set=3,
    num_samples_per_class=2, num_target_samples=2, cnn_num_filters=8,
    num_stages=2, number_of_training_steps_per_iter=2,
    number_of_evaluation_steps_per_iter=2, batch_size=4,
    task_microbatches=2, bn_backend="pallas", bn_fast_math=True,
    total_epochs=2, total_iter_per_epoch=2,
    first_order_to_second_order_epoch=0, multi_step_loss_num_epochs=1,
    num_evaluation_tasks=8, max_models_to_save=2, dispatch_sync_every=1)
# A child that launches a spin kernel after its second train step: the
# step's loss fetch then waits behind it on the card.
SPIN_CHILD = """
import sys
import torch
sys.path.insert(0, sys.argv[1])
from howtotrainyourmamlpytorch_tpu_torch import experiment, train_maml_system
real = experiment.make_train_step
def make(cfg, apply):
    step, calls = real(cfg, apply), []
    def spun(*args, **kwargs):
        out = step(*args, **kwargs)
        calls.append(1)
        if len(calls) == 2:
            torch.cuda._sleep(2 * 10**10)
        return out
    return spun
experiment.make_train_step = make
sys.exit(train_maml_system.main(["--name_of_args_json_file", sys.argv[2]]))
"""


def test_device_hang_trips_the_watchdog(cuda_device, tmp_path):
    """A kernel that spins on the card past a 3 s step deadline: the
    watchdog, whose trip path calls nothing on the card, exits 74 with a
    bundle while the main thread waits in the loss fetch."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = tmp_path / "hang.json"
    path.write_text(json.dumps(dict(
        CARD_RUN, experiment_root=str(tmp_path),
        watchdog_step_timeout_s=3.0, watchdog_poll_interval_s=0.25)))
    proc = subprocess.run([sys.executable, "-c", SPIN_CHILD, root,
                           str(path)], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 74, proc.stderr[-2000:]
    bundle = tmp_path / "card" / "logs" / "crash_bundle"
    crash = json.loads((bundle / "crash.json").read_text())
    assert crash["reason"] == "hung_step"
    assert 3.0 < crash["age_seconds"] < 3.0 + 2 * 0.25 + 1.0
    assert {"stacks.txt", "flight.jsonl", "trace.json"} <= set(
        os.listdir(bundle))
    assert "in _train_epoch" in (bundle / "stacks.txt").read_text()


def test_async_and_sync_saves_write_the_same_bytes(cuda_device, tmp_path):
    """On the card, a run with ``ckpt_async=1`` leaves the checkpoint
    files, manifest and bookkeeping of the ``ckpt_async=0`` run, byte for
    byte."""
    import os
    from howtotrainyourmamlpytorch_tpu_torch.experiment import (
        ExperimentBuilder)
    files = {}
    for mode in (0, 1):
        builder = ExperimentBuilder(MAMLConfig(**dict(
            CARD_RUN, experiment_root=str(tmp_path / str(mode)),
            ckpt_async=mode)))
        assert builder.run_experiment()["num_models"] == 2
        models = builder.paths["saved_models"]
        files[mode] = {n: open(os.path.join(models, n), "rb").read()
                       for n in sorted(os.listdir(models))
                       if n.endswith(".ckpt")
                       or n in ("MANIFEST.json", "state.json")}
    assert len(files[0]) == 5 and files[0] == files[1]


def _serve_cfg(tmp_path, **kw):
    base = dict(dataset_name="synthetic", experiment_root=str(tmp_path),
                image_height=12, image_width=12, image_channels=3,
                num_classes_per_set=3, num_samples_per_class=2,
                num_target_samples=2, cnn_num_filters=8, num_stages=2,
                number_of_evaluation_steps_per_iter=2, bn_backend="pallas",
                bn_fast_math=False, compute_dtype="float32",
                serve_batch_tasks=2, serve_default_deadline_ms=0.0)
    base.update(kw)
    return MAMLConfig(**base)


def _published_checkpoint(cfg, directory):
    """Epoch 0 of a seeded state, saved and published as the trainer
    does; returns the manager."""
    from howtotrainyourmamlpytorch_tpu_torch.ckpt.registry import (
        ModelRegistry)
    from howtotrainyourmamlpytorch_tpu_torch.utils.checkpoint import (
        CheckpointManager)
    init, _ = make_model(cfg)
    mgr = CheckpointManager(directory)
    mgr.save(init_train_state(cfg, init, seed=0, device="cpu"), epoch=0,
             current_iter=1, val_acc=0.5)
    ModelRegistry(directory).publish(tag="0", epoch=0, iteration=1,
                                     val_acc=0.5,
                                     fingerprint=mgr.fingerprint(0))
    return mgr


def _serve_request(seed, support_seed=None):
    rng = np.random.default_rng(seed)
    sx = np.random.default_rng(
        seed if support_seed is None else support_seed).integers(
            0, 256, (6, 12, 12, 3), dtype=np.uint8)
    return FewShotRequest(
        support_x=sx, support_y=np.arange(6, dtype=np.int32) % 3,
        query_x=rng.integers(0, 256, (6, 12, 12, 3), dtype=np.uint8))


def test_from_checkpoint_on_the_card(cuda_device, tmp_path):
    """``from_checkpoint`` on the card serves the CPU engine's logits
    (f32, TF32 off) and launches the kernel as the path needs."""
    cfg = _serve_cfg(tmp_path)
    directory = str(tmp_path / "saved_models")
    _published_checkpoint(cfg, directory)
    card = ServingEngine.from_checkpoint(cfg, directory, device=cuda_device)
    cpu = ServingEngine.from_checkpoint(cfg, directory, device="cpu")
    bn_act.reset_launches()
    out = []
    for engine in (card, cpu):
        engine.submit(_serve_request(1))
        engine.submit(_serve_request(2))
        out.append(sorted(engine.drain(), key=lambda r: r.request_id))
    for a, b in zip(*out):
        np.testing.assert_allclose(a.logits, b.logits, rtol=1e-4, atol=2e-4)
    assert bn_act.launches == 2 * 2 * card.adapt_runs + 2 * card.predict_runs
    assert card.maybe_hot_swap(force=True) is None
    assert card._model_version == 1
    card.close()
    cpu.close()


def test_l2_publish_from_the_writer_thread_on_the_card(cuda_device,
                                                       tmp_path):
    """Adapted tensors on the card reach the L2 tier from the writer
    thread; a second engine on the card serves the repeat from it with
    no adapt, with the first engine's L1-hit logits."""
    cfg = _serve_cfg(tmp_path, serve_l2_dir=str(tmp_path / "l2"))
    directory = str(tmp_path / "saved_models")
    _published_checkpoint(cfg, directory)
    a = ServingEngine.from_checkpoint(cfg, directory, device=cuda_device)
    b = ServingEngine.from_checkpoint(cfg, directory, device=cuda_device)
    a.submit(_serve_request(1))
    a.drain()
    assert a.l2_flush(30.0) and a.l2.publishes == 1 and a.l2.errors == 0
    a.submit(_serve_request(3, support_seed=1))
    (l1,) = a.drain()
    b.submit(_serve_request(3, support_seed=1))
    (l2,) = b.drain()
    assert (l1.cache_tier, l2.cache_tier) == ("l1", "l2")
    assert b.adapt_invocations == 0
    np.testing.assert_allclose(l2.logits, l1.logits, rtol=1e-5, atol=1e-5)
    a.close()
    b.close()


def test_canary_on_the_card_is_warmed_before_it_is_timed(cuda_device,
                                                         tmp_path):
    """A nudged version passes the canary at the default latency gate
    (3x live): each version's probe batch runs once untimed, then timed
    (2 adapts + 1 predict per version), and the swap is adopted."""
    import dataclasses
    from howtotrainyourmamlpytorch_tpu_torch.ckpt.registry import (
        ModelRegistry)
    from howtotrainyourmamlpytorch_tpu_torch.tree import tree_map
    cfg = _serve_cfg(tmp_path)
    assert cfg.serve_canary_latency_factor == 3.0
    directory = str(tmp_path / "saved_models")
    mgr = _published_checkpoint(cfg, directory)
    engine = ServingEngine.from_checkpoint(cfg, directory,
                                           device=cuda_device)
    engine.warmup()
    with torch.no_grad():
        nudged = dataclasses.replace(engine.state, params=tree_map(
            lambda x: x * 1.001, engine.state.params))
    mgr.save(nudged, epoch=1, current_iter=2, val_acc=0.6)
    ModelRegistry(directory).publish(tag="1", epoch=1, iteration=2,
                                     val_acc=0.6,
                                     fingerprint=mgr.fingerprint(1))
    runs = (engine.adapt_runs, engine.predict_runs)
    out = engine.maybe_hot_swap(force=True)
    assert out["swapped"] is True, out
    assert (engine.adapt_runs - runs[0], engine.predict_runs - runs[1]) == (
        4, 2)
    assert engine._model_version == 2
    engine.close()


def test_replica_child_on_the_card(cuda_device, tmp_path):
    """``scripts/torch_fleet_bench.py --quick --device cuda``: 2 replica
    processes on the card, none dropped, the migration from L2, and each
    replica's BN-kernel launches equal to its batches' count."""
    import json
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "scripts",
                                      "torch_fleet_bench.py"),
         "--quick", "--device", "cuda", "--out", str(tmp_path / "fb")],
        cwd=repo, capture_output=True, text=True, timeout=600)
    art = json.loads(proc.stdout.strip().splitlines()[-1])
    assert proc.returncode == 0 and art["status"] == "ok", art
    assert art["zero_dropped"] and art["migration"]["second_tier"] == "l2"
    kernels = art["bn_act_launches"]["fleet"]
    assert kernels["ok"] and kernels["total"] > 0
