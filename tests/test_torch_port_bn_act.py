"""The port's BN + activation (ops/bn_act.py) against the JAX package's
Pallas kernel (ops/pallas_fused.py, run in interpret mode on the CPU).

On the CPU the port's wrapper runs the kernel's plain PyTorch version
(the CUDA kernel itself is held against it on the card by
``chip_smoke.py`` and tests/test_torch_port_cuda.py). Inputs come
from a numpy seed and go through both packages.

Tolerances:
* f32: rtol 1e-4 / atol 2e-4 — the repo's forward tolerance
  (tests/test_torch_parity.py); only reduction order differs.
* bf16: rtol 1.6e-2 (about 2 bf16 ulp) and atol 1.6e-2 (2 ulp at the
  normalized values' unit scale, for outputs near zero): both packages
  round scale/shift, the product and the sum to bf16 at the same places.
* mean/var are f32 in both: rtol 1e-5 / atol 1e-5 (var: 1e-4 relative,
  E[x²]−E[x]² cancels).
* gradients (f32 math in both VJPs): rtol 1e-4 / atol 1e-4 against JAX,
  1e-4 against torch autograd of the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.ops import pallas_fused
from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act, build

EPS = 1e-5
SLOPES = (0.0, 0.1, 1.0)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": (1e-4, 2e-4), "bfloat16": (1.6e-2, 1.6e-2)}


def _inputs(rows, c, seed=0, tasks=None):
    rng = np.random.default_rng(seed)
    shape = (rows, c) if tasks is None else (tasks, rows, c)
    x = (rng.standard_normal(shape) * 2.0 + 0.3).astype(np.float32)
    gamma = (rng.random(shape[-1:] if tasks is None else (tasks, c))
             + 0.5).astype(np.float32)
    beta = (rng.standard_normal(gamma.shape) * 0.1).astype(np.float32)
    return x, gamma, beta


def _port(x, gamma, beta, dtype, slope):
    """The port's entry on a CPU tensor (plain version by device)."""
    y, m, v = bn_act.bn_act(torch.from_numpy(x).to(dtype),
                            torch.from_numpy(gamma), torch.from_numpy(beta),
                            EPS, slope)
    return y.float().numpy(), m.numpy(), v.numpy()


def _assert_stats(m, v, m_ref, v_ref):
    np.testing.assert_allclose(m, np.asarray(m_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v, np.asarray(v_ref), rtol=1e-4, atol=1e-5)


# Shapes where pallas_fused.supported() holds, so the JAX side provably
# runs the Pallas kernel (interpret mode): C=8 with rows % 16 == 0, C=48
# with rows % 8 == 0.
@pytest.mark.parametrize("rows,c", [(64, 8), (96, 48)])
@pytest.mark.parametrize("slope", SLOPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_matches_pallas_kernel(rows, c, slope, dtype):
    assert pallas_fused.supported(rows, c)
    jdt, tdt = DTYPES[dtype]
    x, gamma, beta = _inputs(rows, c)
    y_ref, m_ref, v_ref = pallas_fused.fused_bn_relu(
        jnp.asarray(x, jdt), jnp.asarray(gamma), jnp.asarray(beta), EPS,
        True, slope)
    y, m, v = _port(x, gamma, beta, tdt, slope)
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(y, np.asarray(y_ref, np.float32), rtol=rtol,
                               atol=atol)
    _assert_stats(m, v, m_ref, v_ref)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_unsupported_shape_matches_reference(dtype):
    """Where the Pallas wrapper falls back (supported() false) the port
    still matches its jnp reference: the port has no shape gate."""
    rows, c = 5, 48
    assert not pallas_fused.supported(rows, c)
    jdt, tdt = DTYPES[dtype]
    x, gamma, beta = _inputs(rows, c, seed=1)
    y_ref, m_ref, v_ref = pallas_fused._bn_relu_reference(
        jnp.asarray(x, jdt), jnp.asarray(gamma), jnp.asarray(beta), EPS, 0.1)
    y, m, v = _port(x, gamma, beta, tdt, 0.1)
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(y, np.asarray(y_ref, np.float32), rtol=rtol,
                               atol=atol)
    _assert_stats(m, v, m_ref, v_ref)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_task_axis_matches_vmapped_kernel(dtype):
    """Tasks folded into the columns (P = T·C) equal the JAX package's
    per-task vmap of the kernel: statistics per (task, channel)."""
    tasks, rows, c = 3, 32, 8
    assert pallas_fused.supported(rows, c)
    jdt, tdt = DTYPES[dtype]
    x, gamma, beta = _inputs(rows, c, seed=2, tasks=tasks)
    y_ref, m_ref, v_ref = jax.vmap(
        lambda a, g, b: pallas_fused.fused_bn_relu(a, g, b, EPS, True, 0.0))(
        jnp.asarray(x, jdt), jnp.asarray(gamma), jnp.asarray(beta))
    packed = np.ascontiguousarray(x.transpose(1, 0, 2).reshape(rows,
                                                               tasks * c))
    y, m, v = _port(packed, gamma.reshape(-1), beta.reshape(-1), tdt, 0.0)
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(
        y.reshape(rows, tasks, c).transpose(1, 0, 2),
        np.asarray(y_ref, np.float32), rtol=rtol, atol=atol)
    _assert_stats(m, v, np.asarray(m_ref).reshape(-1),
                  np.asarray(v_ref).reshape(-1))


def _port_grads(x, gamma, beta, gy, gm, gv, slope, plain):
    xs = torch.from_numpy(x).requires_grad_(True)
    gs = torch.from_numpy(gamma).requires_grad_(True)
    bs = torch.from_numpy(beta).requires_grad_(True)
    y, m, v = bn_act.bn_act(xs, gs, bs, EPS, slope, plain=plain)
    loss = ((y * torch.from_numpy(gy)).sum() + (m * torch.from_numpy(gm)).sum()
            + (v * torch.from_numpy(gv)).sum())
    return [g.numpy() for g in torch.autograd.grad(loss, (xs, gs, bs))]


def _jax_grads(x, gamma, beta, gy, gm, gv, slope):
    def loss(a, g, b):
        y, m, v = pallas_fused.fused_bn_relu(a, g, b, EPS, True, slope)
        return jnp.sum(y * gy) + jnp.sum(m * gm) + jnp.sum(v * gv)
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))]


@pytest.mark.parametrize("constant_channel", [False, True])
@pytest.mark.parametrize("slope", SLOPES)
def test_backward_matches_autograd_and_jax(slope, constant_channel):
    """The autograd.Function's hand-written VJP (driven here through its
    plain CPU forward) against torch autograd of the plain version and
    against jax.grad of the Pallas kernel's custom_jvp. The constant
    channel is the clamp-gate case: var rounds to 0 and the tangent rule
    must propagate zero there, not blow up through rsqrt(eps)³."""
    rows, c = 64, 8
    assert pallas_fused.supported(rows, c)
    x, gamma, beta = _inputs(rows, c, seed=3)
    if constant_channel:
        x[:, 2] = 3.0
    rng = np.random.default_rng(4)
    gy = rng.standard_normal((rows, c)).astype(np.float32)
    gm = rng.standard_normal(c).astype(np.float32)
    gv = rng.standard_normal(c).astype(np.float32)
    fn = _port_grads(x, gamma, beta, gy, gm, gv, slope, plain=False)
    auto = _port_grads(x, gamma, beta, gy, gm, gv, slope, plain=True)
    ref = _jax_grads(x, gamma, beta, gy, gm, gv, slope)
    for name, g_fn, g_auto, g_ref in zip(("dx", "dgamma", "dbeta"), fn, auto,
                                         ref):
        assert np.isfinite(g_fn).all()
        # On the constant channel dgamma is sum(g·x) − mean·sum(g), two
        # equal f32 sums that cancel, times rsqrt(eps) ≈ 316: its value
        # is rounding noise of ~1e-3 in every implementation.
        atol = 1e-3 if constant_channel and name == "dgamma" else 1e-4
        np.testing.assert_allclose(g_fn, g_ref, rtol=1e-4, atol=atol)
        np.testing.assert_allclose(g_fn, g_auto, rtol=1e-4, atol=atol)


def test_backward_composes_to_second_order():
    """create_graph=True through the Function: the double-backward of the
    hand-written VJP equals the double-backward of the plain version."""
    x, gamma, beta = _inputs(32, 8, seed=5)
    out = []
    for plain in (False, True):
        xs = torch.from_numpy(x).requires_grad_(True)
        y = bn_act.bn_act(xs, torch.from_numpy(gamma),
                          torch.from_numpy(beta), EPS, 0.1, plain=plain)[0]
        (gx,) = torch.autograd.grad((y ** 2).sum(), xs, create_graph=True)
        (ggx,) = torch.autograd.grad((gx ** 2).sum(), xs)
        out.append(ggx.numpy())
    np.testing.assert_allclose(out[0], out[1], rtol=1e-3, atol=1e-4)


def test_cpu_tensor_uses_plain_version_without_launching():
    x, gamma, beta = _inputs(16, 4, seed=6)
    before = bn_act.launches
    got = _port(x, gamma, beta, torch.float32, 0.0)
    want = bn_act.bn_act(torch.from_numpy(x), torch.from_numpy(gamma),
                         torch.from_numpy(beta), EPS, 0.0, plain=True)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    assert bn_act.launches == before


def test_kernel_path_raises_without_toolkit(monkeypatch, tmp_path):
    """The launch path builds the kernel or raises: with no nvcc and no
    library on disk there is no quiet fallback."""
    monkeypatch.setattr(build, "_built", {})
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load("bn_act")


def test_wrapper_rejects_bad_inputs():
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        bn_act._check(x.t(), torch.ones(4), torch.zeros(4))   # not contiguous
    with pytest.raises(TypeError):
        bn_act._check(x.half(), torch.ones(3), torch.zeros(3))
    with pytest.raises(ValueError):
        bn_act._check(x, torch.ones(4), torch.zeros(3))
    with pytest.raises(ValueError):
        bn_act._check(torch.zeros(0, 3), torch.ones(3), torch.zeros(3))


@pytest.mark.parametrize("rows", [1, 2, 131, 132, 133, 2500, 176400])
def test_plan_slabs_cover_rows_once(rows):
    """The normalize pass's slabs tile [0, R) exactly once, balanced to one
    row; the chunks of the sum order (256 rows) cover R; the scratch is
    sized as the C interface reads it (mean | var | scale | shift |
    per-chunk partial sums | partial squares) and the shared memory as it
    checks it (16 B of mbarriers, the 12 warps' lane folds, and for the
    16-byte path a ring of 2 x 128 rows x 49 slots), within the 227 KB a
    Hopper block may use."""
    blocks = 132
    bounds = [bn_act.slab(rows, blocks, b) for b in range(blocks)]
    assert bounds[0][0] == 0 and bounds[-1][1] == rows
    for (_, end), (start, _) in zip(bounds, bounds[1:]):
        assert end == start
    sizes = [r1 - r0 for r0, r1 in bounds]
    assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1
    chunk_rows, n_chunks = bn_act.chunking(rows)
    assert chunk_rows == 256 and (n_chunks - 1) * 256 < rows <= n_chunks * 256
    for cols in (1, 7, 97, 384, 1000):
        for itemsize in (2, 4):
            for aligned in (False, True):
                pl = bn_act.plan(rows, cols, itemsize, aligned, blocks)
                assert (pl.chunk_rows, pl.n_chunks) == (chunk_rows, n_chunks)
                assert pl.scratch_floats == 4 * cols + 2 * n_chunks * cols
                wide = 16 // itemsize
                assert pl.vec == (wide if aligned and cols % wide == 0
                                  else 1)
                assert pl.smem_bytes == (16 + 12 * 32 * 2 * pl.vec * 4
                                         + (2 * 128 * 49 * 16 if pl.vec > 1
                                            else 0))
                assert pl.smem_bytes <= 232448


def test_chunking_caps_the_chunk_count():
    """Past 65535 chunks of 256 rows the chunks grow, as in the sum order
    the kernel keeps (that of the three-pass kernel it replaced)."""
    rows = 65535 * 256 + 1
    chunk_rows, n_chunks = bn_act.chunking(rows)
    assert chunk_rows == 257 and n_chunks <= 65535
    assert (n_chunks - 1) * chunk_rows < rows <= n_chunks * chunk_rows
