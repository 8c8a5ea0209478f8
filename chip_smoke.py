#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit. Imports nothing of JAX. Phases, each of which raises on
failure:

1. Build every hand-written kernel (``csrc/*.cu``, nvcc for sm_90a) and
   turn TF32 off for convolutions and matrix products.
2. Hold each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it (the flagship's four VGG stages at 8
   tasks x 25 images x 48 channels) and at ragged shapes: forward outputs,
   statistics, and gradients of the autograd.Function against autograd
   of the plain version; forward outputs at one row, fewer rows than SMs,
   rows not a multiple of the SM count and an unaligned view; two
   launches on the same x bitwise equal. Time kernel, plain version and
   the library yardstick (``F.batch_norm(training=True)`` + ``relu_``,
   timed only, never called by the port) after warm-up: wall (CUDA
   events around one call, median) and device (the profiler's kernel
   time per call, which must be one kernel for the BN kernel).
3. Serve at the flagship's full width through ``ServingEngine``
   (experiment_config/mini-imagenet_maml++_5-way_5-shot_DA_b12.json with
   bn_backend='pallas', seeded random weights): 16 uint8 requests plus a
   repeat of one support set, which must be a cache hit. Every kernel's
   launch count over that run must match the path (20 per adapt batch, 4
   per predict batch). One batch is then run again with the plain
   version selected explicitly and the logits compared.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Exits non-zero without a result
when no CUDA device is available or the port's package is missing.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(REPO, "experiment_config",
                        "mini-imagenet_maml++_5-way_5-shot_DA_b12.json")

# HBM bandwidth by card (NVIDIA data sheets), for each kernel's bound.
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12,
                   "H100": 3.35e12, "H200": 4.8e12}
# Peak f32 rate outside the tensor cores (H100 SXM data sheet); the
# kernel's arithmetic is f32.
F32_FLOP_PER_S = 67e12

# Serving-path shapes of the BN kernel at the flagship's full width:
# (R, P) = (25 images x H x W, 8 tasks x 48 channels), one per VGG stage.
TASKS, SHOTS, FILTERS = 8, 25, 48
STAGE_HW = (84, 42, 21, 10)
SHAPES = [(SHOTS * hw * hw, TASKS * FILTERS) for hw in STAGE_HW]
RAGGED = ((1001, 7), (3001, 97))
# ((R, P), element offset of x in its buffer): one row, fewer rows than
# SMs, rows not a multiple of the SM count, and an unaligned view.
SMALL = (((1, 384), 0), ((100, 384), 0), ((1000, 384), 0), ((3001, 384), 1))


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _bandwidth(name: str) -> float:
    for key, bw in HBM_BYTES_PER_S.items():   # most specific key first
        if key in name:
            return bw
    raise RuntimeError(f"no HBM bandwidth on record for {name!r}")


def _median_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Wall time of one call: CUDA events around each call, median. It
    includes the host's launch cost whenever the device waits on it."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, iters: int = 20):
    """Device time of one call: the profiler's kernel durations summed over
    ``iters`` calls, per call, and the device kernels per call; (None, None)
    when the profiler records no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None, None
    us = sum(e.time_range.elapsed_us() for e in kernels)
    return us / 1e3 / iters, len(kernels) / iters


def _close(name: str, got, want, rtol: float, atol: float) -> float:
    """Assert |got − want| <= atol + rtol·|want| elementwise; returns the
    max absolute error."""
    got, want = got.float(), want.float()
    if want.numel() == 0:
        return 0.0
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {err.numel()} elements off "
            f"(max abs err {err.max().item():.3e}, rtol {rtol}, atol {atol})")
    return float(err.max().item())


def _small_shapes_and_determinism(gen) -> None:
    """Forward-only checks of the BN kernel against its plain version where
    the launch plan is at its edges: one row, fewer rows than SMs, rows not
    a multiple of the SM count, and an unaligned view (the scalar path);
    then bitwise equality of two launches on the same x."""
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act

    for (r, p), offset in SMALL:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.empty(r * p + offset, dtype=dtype,
                            device="cuda")[offset:].view(r, p)
            x.copy_(torch.randn(r, p, device="cuda", generator=gen) * 2.0
                    + 0.3)
            gamma = torch.rand(p, device="cuda", generator=gen) + 0.5
            beta = torch.randn(p, device="cuda", generator=gen) * 0.1
            rtol, atol = ((1.6e-2, 1e-2) if dtype == torch.bfloat16
                          else (1e-4, 1e-5))
            if r == 1:
                # One row: var is 0, scale = gamma/sqrt(eps) ~ 316 gamma,
                # and y = x*scale + shift cancels two terms of size
                # |x*scale|; a last-bit difference of 1/sqrt(eps) (the
                # plain version's rsqrt, the kernel's rounded 1/sqrt)
                # shows at that size, so atol is rtol of it.
                atol = rtol * float((x.float().abs().max()
                                     * gamma.max() / 1e-5 ** 0.5).item())
            for slope in (0.0, 0.1, 1.0):
                tag = (f"bn_act {(r, p)} {dtype} slope={slope}"
                       f"{' unaligned' if offset else ''}")
                with torch.no_grad():
                    k = bn_act.bn_act(x, gamma, beta, 1e-5, slope)
                    ref = bn_act.bn_act(x, gamma, beta, 1e-5, slope,
                                        plain=True)
                _close(tag + " y", k[0], ref[0], rtol, atol)
                _close(tag + " mean", k[1], ref[1], 1e-5, 1e-5)
                _close(tag + " var", k[2], ref[2], 1e-4, 1e-5)
    for r, p in SHAPES + [(100, 384)]:
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(r, p, device="cuda", generator=gen) * 2.0
                 + 0.3).to(dtype)
            gamma = torch.rand(p, device="cuda", generator=gen) + 0.5
            beta = torch.randn(p, device="cuda", generator=gen) * 0.1
            with torch.no_grad():
                first = bn_act.bn_act(x, gamma, beta, 1e-5, 0.0)
                second = bn_act.bn_act(x, gamma, beta, 1e-5, 0.0)
            for name, u, v in zip(("y", "mean", "var"), first, second):
                if not torch.equal(u, v):
                    raise AssertionError(f"bn_act {(r, p)} {dtype}: two "
                                         f"launches differ in {name}")
    torch.cuda.synchronize()
    print(f"bn_act small/unaligned checks passed: {len(SMALL)} shapes x 2 "
          f"dtypes x 3 slopes; bitwise equal reruns at "
          f"{len(SHAPES) + 1} shapes x 2 dtypes", flush=True)


def check_bn_act(device_name: str, card: str) -> dict:
    """Phase 2 for the BN+activation kernel; returns its kernels entry
    (``launches`` filled in by phase 3)."""
    import torch
    import torch.nn.functional as F
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act

    gen = torch.Generator(device="cuda").manual_seed(0)
    bw = _bandwidth(device_name)
    max_err = {torch.bfloat16: 0.0, torch.float32: 0.0}
    stages = []
    for r, p in SHAPES + list(RAGGED):
        for dtype in (torch.bfloat16, torch.float32):
            for slope in (0.0, 0.1, 1.0):
                x = (torch.randn(r, p, device="cuda", generator=gen) * 2.0
                     + 0.3).to(dtype)
                gamma = torch.rand(p, device="cuda", generator=gen) + 0.5
                beta = torch.randn(p, device="cuda", generator=gen) * 0.1
                gy = torch.randn(r, p, device="cuda", generator=gen).to(dtype)
                gm = torch.randn(p, device="cuda", generator=gen)
                gv = torch.randn(p, device="cuda", generator=gen)
                tag = f"bn_act {(r, p)} {dtype} slope={slope}"
                # bf16: 2 ulp (rtol 1.6e-2) — the kernel repeats the plain
                # version's roundings; only the f32 sum order differs.
                # f32: sum order only.
                rtol, atol = ((1.6e-2, 1e-2) if dtype == torch.bfloat16
                              else (1e-4, 1e-5))
                with torch.no_grad():
                    y_k = bn_act.bn_act(x, gamma, beta, 1e-5, slope)[0]
                    y_p = bn_act.bn_act(x, gamma, beta, 1e-5, slope,
                                        plain=True)[0]
                if slope != 1.0:
                    # Where the two forwards sit on opposite sides of the
                    # activation's kink (|y| within the forward
                    # tolerance of 0) the derivatives differ by design:
                    # zero the cotangent there so both sides agree.
                    kink = (y_k > 0) != (y_p > 0)
                    _close(tag + " y at the kink", y_k[kink], y_p[kink],
                           0.0, atol)
                    gy = gy.masked_fill(kink, 0)
                outs = {}
                for plain in (False, True):
                    xs = x.clone().requires_grad_(True)
                    gs = gamma.clone().requires_grad_(True)
                    bs = beta.clone().requires_grad_(True)
                    y, mean, var = bn_act.bn_act(xs, gs, bs, 1e-5, slope,
                                                 plain=plain)
                    loss = ((y.float() * gy.float()).sum()
                            + (mean * gm).sum() + (var * gv).sum())
                    grads = torch.autograd.grad(loss, (xs, gs, bs))
                    torch.cuda.synchronize()
                    outs[plain] = (y.detach(), mean.detach(), var.detach(),
                                   *grads)
                k, ref = outs[False], outs[True]
                max_err[dtype] = max(max_err[dtype], _close(
                    tag + " y", k[0], ref[0], rtol, atol))
                _close(tag + " mean", k[1], ref[1], 1e-5, 1e-5)
                _close(tag + " var", k[2], ref[2], 1e-4, 1e-5)
                # Gradients: hand-written VJP (f32 math) vs autograd of the
                # plain version. In bf16 autograd rounds the per-column
                # sums behind dscale/dshift to bf16 before dgamma =
                # inv·dscale − mean·inv·dshift cancels them, so its error
                # is ~1 bf16 ulp of the largest entry: 2 ulp (1.6e-2) of
                # max|ref|. In f32 only the order differs: 1e-3.
                grtol = 1.6e-2 if dtype == torch.bfloat16 else 1e-3
                for name, a, b in zip(("dx", "dgamma", "dbeta"), k[3:],
                                      ref[3:]):
                    scale = float(b.abs().max().item()) or 1.0
                    _close(f"{tag} {name}", a, b, grtol, grtol * scale)
    print(f"bn_act checks passed: {len(SHAPES) + len(RAGGED)} shapes x "
          f"2 dtypes x 3 slopes, forward max abs err bf16 "
          f"{max_err[torch.bfloat16]:.3e}, f32 {max_err[torch.float32]:.3e}",
          flush=True)
    _small_shapes_and_determinism(gen)

    # Timing at the serving dtype (bf16) and activation (relu). Wall: one
    # call between CUDA events (host launch cost included where the device
    # waits on it). Device: the profiler's kernel time per call.
    for r, p in SHAPES:
        x = (torch.randn(r, p, device="cuda", generator=gen) * 2.0
             + 0.3).to(torch.bfloat16)
        gamma = torch.rand(p, device="cuda", generator=gen) + 0.5
        beta = torch.randn(p, device="cuda", generator=gen) * 0.1
        hw = int(round((r // SHOTS) ** 0.5))
        x4 = x.view(SHOTS, hw, hw, p).permute(0, 3, 1, 2)  # channels_last

        def kernel():
            return bn_act.bn_act(x, gamma, beta, 1e-5, 0.0)

        def library():
            return F.batch_norm(x4, None, None, gamma, beta, training=True,
                                eps=1e-5).relu_()

        with torch.no_grad():
            ms = _median_ms(kernel)
            plain_ms = _median_ms(lambda: bn_act.bn_act(
                x, gamma, beta, 1e-5, 0.0, plain=True))
            lib_ms = _median_ms(library)
            dev_ms, per_call = _device_ms(kernel)
            lib_dev_ms, lib_per_call = _device_ms(library)
        if per_call is not None and per_call != 1:
            raise AssertionError(f"bn_act {r}x{p}: {per_call} device "
                                 f"kernels per call, want 1")
        nbytes = 2 * r * p * x.element_size() + 4 * p * 4
        flops = 8 * r * p   # stats 3/elem, normalize+act 5/elem
        bound_s = max(nbytes / bw, flops / F32_FLOP_PER_S)
        stages.append({"shape": [r, p], "ms": ms, "device_ms": dev_ms,
                       "kernels_per_call": per_call,
                       "plain_ms": plain_ms, "library_ms": lib_ms,
                       "library_device_ms": lib_dev_ms,
                       "library_kernels_per_call": lib_per_call,
                       "bound_ms": bound_s * 1e3,
                       "bound_by": ("bytes" if nbytes / bw
                                    >= flops / F32_FLOP_PER_S
                                    else "operations")})
        print(f"bn_act {r}x{p} bf16 relu: kernel wall {ms:.4f} ms, device "
              f"{dev_ms} ms ({per_call} kernels/call); plain {plain_ms:.4f} "
              f"ms; F.batch_norm+relu_ wall {lib_ms:.4f} ms, device "
              f"{lib_dev_ms} ms ({lib_per_call} kernels/call); bound "
              f"{bound_s * 1e3:.4f} ms ({card})", flush=True)
    top = stages[0]
    return {"name": "bn_act", "route": "cuda",
            "source": "howtotrainyourmamlpytorch_tpu_torch/csrc/bn_act.cu",
            "replaces": "howtotrainyourmamlpytorch_tpu/ops/pallas_fused.py:67",
            "launches": None, "max_abs_err": max(max_err.values()),
            "ms": top["ms"], "device_ms": top["device_ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "library_device_ms": top["library_device_ms"],
            "shape": top["shape"], "dtype": "bfloat16", "stages": stages}


def _cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float((a @ b) / (a.norm() * b.norm()))


def serve_flagship(entry: dict, card: str) -> None:
    """Phase 3: flagship-width serving through the ServingEngine; fills
    the BN kernel's ``launches`` in its kernels ``entry``."""
    import numpy as np
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
        init_train_state)
    from howtotrainyourmamlpytorch_tpu_torch.models import make_model
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.serve import (
        FewShotRequest, ServingEngine, pad_group)
    from howtotrainyourmamlpytorch_tpu_torch.serve.adapt import (
        adapt_task, predict_tasks)

    cfg = MAMLConfig.from_json_file(FLAGSHIP).replace(
        bn_backend="pallas", serve_default_deadline_ms=0.0)
    model_init, _ = make_model(cfg)
    state = init_train_state(cfg, model_init, seed=cfg.seed, device="cuda")
    engine = ServingEngine(cfg, state, device="cuda")
    t0 = time.perf_counter()
    engine.warmup()
    print(f"serve: warmup {time.perf_counter() - t0:.2f} s "
          f"(buckets {engine.batcher.buckets}, {cfg.serve_batch_tasks} "
          f"tasks/batch, {engine.num_adapt_steps} adapt steps, "
          f"{cfg.compute_dtype})", flush=True)

    h, w, c = cfg.image_shape
    n, k = cfg.num_classes_per_set, cfg.num_samples_per_class
    q = cfg.num_target_per_task
    rng = np.random.default_rng(cfg.seed)

    def request(support=None):
        sx = (support if support is not None
              else rng.integers(0, 256, (n * k, h, w, c), dtype=np.uint8))
        return FewShotRequest(
            support_x=sx, support_y=np.repeat(np.arange(n, dtype=np.int32), k),
            query_x=rng.integers(0, 256, (q, h, w, c), dtype=np.uint8))

    requests = [request() for _ in range(2 * cfg.serve_batch_tasks)]
    torch.cuda.reset_peak_memory_stats()
    bn_act.reset_launches()
    t0 = time.perf_counter()
    for req in requests:
        engine.submit(req)
    responses = engine.drain()
    serve_s = time.perf_counter() - t0
    adapts_before = engine.adapt_invocations
    repeat = request(support=requests[0].support_x)
    engine.submit(repeat)
    (hit,) = engine.drain()
    launches = bn_act.launches

    if len(responses) != len(requests):
        raise AssertionError(f"{len(responses)} responses to "
                             f"{len(requests)} requests")
    for resp in responses + [hit]:
        if resp.status != "ok" or resp.logits is None:
            raise AssertionError(f"request {resp.request_id}: {resp.status}"
                                 f" {resp.error}")
        if resp.logits.shape != (q, n) or not np.isfinite(resp.logits).all():
            raise AssertionError(f"request {resp.request_id}: logits "
                                 f"{resp.logits.shape}, finite="
                                 f"{np.isfinite(resp.logits).all()}")
    if not hit.cache_hit or engine.adapt_invocations != adapts_before:
        raise AssertionError("repeated support set was not a cache hit")
    want = (20 * engine.adapt_invocations + 4 * engine.predict_invocations)
    if launches != want:
        raise AssertionError(
            f"bn_act launched {launches} times, the path needs "
            f"{want} (20 x {engine.adapt_invocations} adapts + 4 x "
            f"{engine.predict_invocations} predicts)")
    entry["launches"] = launches
    peak = torch.cuda.max_memory_allocated()
    adapt_ms = statistics.median(engine.adapt_seconds) * 1e3
    predict_ms = statistics.median(engine.predict_seconds) * 1e3
    print(f"serve: {len(requests)} requests in {serve_s:.3f} s = "
          f"{len(requests) / serve_s:.2f} req/s; adapt {adapt_ms:.2f} "
          f"ms/batch, predict {predict_ms:.2f} ms/batch (medians of "
          f"{len(engine.adapt_seconds)}/{len(engine.predict_seconds)}); "
          f"cache hit ok; bn_act launches {launches} = 20 x "
          f"{engine.adapt_invocations} + 4 x {engine.predict_invocations}; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB ({card})",
          flush=True)

    # The first batch again, with the kernel and with the plain version
    # selected explicitly; timed per variant (device-synchronized).
    group = requests[:cfg.serve_batch_tasks]
    batch = pad_group(group, engine.batcher.buckets[0],
                      cfg.serve_batch_tasks, cfg.image_shape)
    dev = torch.device("cuda")
    sx = torch.from_numpy(batch["support_x"]).to(dev)
    sy = torch.from_numpy(batch["support_y"]).to(dev, torch.long)
    sw = torch.from_numpy(batch["support_w"]).to(dev)
    qx = torch.from_numpy(batch["query_x"]).to(dev)
    st = engine.state
    composite = cfg.replace(bn_backend="composite")
    _, composite_apply = make_model(composite)
    variants = {"kernel": (cfg, engine.model_apply, False),
                "plain": (cfg, engine.model_apply, True),
                "composite": (composite, composite_apply, False)}
    logits = {}
    for name in ("kernel", "plain", "composite", "composite", "plain",
                 "kernel"):
        vcfg, apply_fn, plain = variants[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ad = adapt_task(vcfg, apply_fn, st.params, st.lslr, st.bn_state,
                        sx, sy, sw, num_steps=engine.num_adapt_steps,
                        plain=plain)
        lg = predict_tasks(vcfg, apply_fn, st.params, ad.fast, ad.bn_state,
                           qx, num_steps=engine.num_adapt_steps,
                           plain=plain)
        torch.cuda.synchronize()
        print(f"serve: one batch adapt+predict, {name} BN "
              f"(bn_backend={vcfg.bn_backend}, plain={plain}): "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms ({card})",
              flush=True)
        logits[name] = lg
    k, p = logits["kernel"], logits["plain"]
    cos = _cosine(k, p)
    # Near-ties: query rows whose top-2 margin in the plain run is within
    # 2 bf16 ulps (1.6e-2) of the logit scale, bf16's resolution of the
    # output; last-bit differences of the batch statistics, carried
    # through 5 adapt steps, may flip their argmax. Every other row must
    # keep its argmax.
    top2 = p.topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) <= 1.6e-2 * p.abs().max()
    flips = k.argmax(-1) != p.argmax(-1)
    served = torch.from_numpy(np.stack([r.logits for r in responses[
        :cfg.serve_batch_tasks]]))
    print(f"serve: kernel vs plain logits cosine {cos:.6f}, max abs diff "
          f"{(k - p).abs().max().item():.3e} (max |logit| "
          f"{p.abs().max().item():.3e}); argmax flips {int(flips.sum())} "
          f"of {flips.numel()} rows, {int((flips & ~tie).sum())} outside "
          f"the {int(tie.sum())} near-tie rows; kernel vs composite cosine "
          f"{_cosine(k, logits['composite']):.6f}; engine vs rerun max abs "
          f"diff {(served - k[:len(group)].cpu()).abs().max().item():.3e}",
          flush=True)
    if cos < 0.999 or bool((flips & ~tie).any()):
        raise AssertionError("kernel and plain-version logits disagree")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from howtotrainyourmamlpytorch_tpu_torch.ops import build
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e}); run from "
              f"the root of a checkout", file=sys.stderr)
        return 2
    card = _card_line()
    device_name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}",
          flush=True)

    t0 = time.perf_counter()
    built = {"bn_act": build.load("bn_act")}
    print(f"build: {sorted(built)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, b in built.items():
        print(f"build {name}: nvcc {b.seconds:.2f} s\n{b.log.strip()}",
              flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("tf32: cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False",
          flush=True)

    entry = check_bn_act(device_name, card)
    serve_flagship(entry, card)

    print(card, flush=True)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
