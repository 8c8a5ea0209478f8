"""The port on the card: the hand-written kernels against their plain
versions, and the serving path end to end at a small size.

Every test here needs an NVIDIA GPU and the CUDA toolkit; each skips
elsewhere (decided in a fixture, when the test runs). This file imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.meta.outer import init_train_state
from howtotrainyourmamlpytorch_tpu_torch.models import make_model
from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
from howtotrainyourmamlpytorch_tpu_torch.serve import (FewShotRequest,
                                                       ServingEngine)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The card, decided when a test runs (never at import): skipped
    where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1001, 7), (4096, 384)])
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
