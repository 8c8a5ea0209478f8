"""The plain reference against the program on the CPU, at the trial leg's
quick sizes (``tune/trial.py § quick_shrink``: 16x16 images, 8
filters, 2 VGG stages, 2 tasks) in float32, and the yardstick's counts.

The program runs its CPU chunk loop with oneDNN off
(``models/layers.py § per_task_convs``); torch's own convolutions then
round about ten times coarser than oneDNN's, and ResNet-12's twelve BN
layers under a second-order step amplify that past any tight bound. The
ResNet-12 step test keeps oneDNN on in the program (one task per chunk,
where oneDNN's grouping does not arise), so both sides round alike.
"""

import contextlib
import json
import os

import pytest
import torch

from portbench.drivers import train_step as drv
from portbench.lib import costs, episodes, port, weights
from portbench.lib.spec import PKG_DIR
from portbench.reference import maml, model
from portbench.reference.model import Numerics, hyper

QUICK = {"image_height": 16, "image_width": 16, "num_stages": 2,
         "cnn_num_filters": 8, "batch_size": 2, "task_microbatches": 2,
         "compute_dtype": "float32", "bn_fast_math": False,
         "bn_backend": "composite"}


def maml_config(name, **extra):
    with open(os.path.join(PKG_DIR, "configs", f"{name}.json")) as f:
        cfg = json.load(f)["maml_config"]
    return {**cfg, **QUICK, **extra}


def program_steps(cfg, params, lslr, bn, pool, epoch):
    """The program's losses, first gradient (from Adam's first moment),
    final tables and row-0 running variances after the first step."""
    state = port.train_state(params, lslr, bn)
    step, phase = port.train_step(cfg, state, pool[0], epoch, "cpu")
    losses = []
    for i, batch in enumerate(pool):
        state, m = step(state, batch)
        losses.append(float(m.loss))
        if i == 0:
            first = {k: {n: {l: t / 0.1 for l, t in s.items()}
                         for n, s in state.opt_state.mu[k].items()}
                     for k in ("params", "lslr")}
            bn0 = drv.row0(state.bn_state)
    return (losses, first, {"params": state.params, "lslr": state.lslr},
            bn0), phase


def compared(hp, cfg, params, lslr, bn, pool, epoch):
    prog, phase = program_steps(cfg, params, lslr, bn, pool, epoch)
    ref = drv.reference_steps(hp, params, lslr, bn, pool, phase, epoch,
                              Numerics())
    return drv.numbers_against(ref, {"params": params, "lslr": lslr,
                                     "bn_state": bn}, *prog)


def numbers(name, monkeypatch=None, steps=3, **extra):
    mc = maml_config(name, **extra)
    if monkeypatch is not None:
        import howtotrainyourmamlpytorch_tpu_torch.meta.outer as outer
        monkeypatch.setattr(outer, "per_task_convs",
                            lambda device: contextlib.nullcontext())
    hp = hyper(mc)
    cfg = port.config(mc, {})
    params, lslr, bn = weights.make(hp, 7, "cpu")
    pool = episodes.train_pool(hp.image_shape, hp.num_classes, hp.shots,
                               hp.targets, 2, steps, 9, "cpu")
    return compared(hp, cfg, params, lslr, bn, pool, 99)


@pytest.mark.parametrize("phase_epoch,loss_tol,grad_tol", [
    (99, 1e-5, 1e-4), (20, 1e-5, 1e-4), (0, 1e-4, 1e-2)])
def test_vgg_train_steps_match_the_program(phase_epoch, loss_tol, grad_tol):
    """Second order without MSL (the cell), first order without MSL and
    first order with MSL: three steps agree to float32 rounding. Under
    the multi-step loss the first LSLR vector's gradient is a sum of
    inner products of gradients that nearly cancel, and its rounding
    shows at 6e-3; Adam carries it into the later steps' losses (5e-5;
    the first step's loss agrees to 1e-7)."""
    mc = maml_config("vgg_flagship")
    hp = hyper(mc)
    cfg = port.config(mc, {})
    params, lslr, bn = weights.make(hp, 3, "cpu")
    pool = episodes.train_pool(hp.image_shape, 5, 5, 5, 2, 3, 4, "cpu")
    got = compared(hp, cfg, params, lslr, bn, pool, phase_epoch)
    assert got["loss_gap"] < loss_tol and got["grad_gap"] < grad_tol, got
    assert got["change_gap"] < 1e-2 and got["bn_var_gap"] < 1e-4, got


def test_resnet12_step_matches_the_program(monkeypatch):
    """One outer step: the statistics of the first forward to 1e-5, the
    meta-loss to 1e-3 and the median leaf's gradient to 1e-2 (the five
    inner steps amplify the two sides' different rounding, module
    docstring)."""
    got = numbers("resnet12_pod", monkeypatch, steps=1,
                  image_height=32, image_width=32)
    assert got["bn_var_gap"] < 1e-5, got
    assert got["loss_gap"] < 1e-3 and got["grad_median_gap"] < 1e-2, got


def test_resnet12_forward_and_inner_step_match_the_program():
    from howtotrainyourmamlpytorch_tpu_torch.meta.inner import (
        split_fast_slow, support_adapt_step)
    from howtotrainyourmamlpytorch_tpu_torch.models import make_model
    from howtotrainyourmamlpytorch_tpu_torch.ops.episode import (
        normalize_images)
    from howtotrainyourmamlpytorch_tpu_torch.tree import stack_tasks
    mc = maml_config("resnet12_pod")
    hp = hyper(mc)
    cfg = port.config(mc, {})
    params, lslr, bn = weights.make(hp, 5, "cpu")
    x = episodes.train_pool(hp.image_shape, 5, 5, 5, 1, 1, 6,
                            "cpu")[0].support_x
    y = torch.arange(5).repeat_interleave(5)[None]
    _, apply = make_model(cfg)
    logits, _ = apply(stack_tasks(params, 1), stack_tasks(bn, 1),
                      normalize_images(cfg, x), 2, True)
    ref = model.resnet12(params, model.normalize_images(hp, x[0]), 2, hp,
                         Numerics())
    assert torch.allclose(logits[0], ref, rtol=1e-5, atol=1e-4)
    fast0, slow0 = split_fast_slow(cfg, params)
    new, _, _ = support_adapt_step(
        cfg, apply, stack_tasks(slow0, 1), lslr, normalize_images(cfg, x),
        y, stack_tasks(fast0, 1), stack_tasks(bn, 1), 1, second_order=False)
    rf = {k: {l: t.clone().requires_grad_(True) for l, t in v.items()}
          for k, v in params.items() if model.is_fast(k)}
    ref_new, _ = maml._inner(hp, params, lslr, model.normalize_images(
        hp, x[0]), y[0], rf, 1, Numerics(), False)
    for name, sub in ref_new.items():
        for leaf, t in sub.items():
            assert torch.allclose(new[name][leaf][0], t.detach(),
                                  rtol=1e-5, atol=1e-6), (name, leaf)


@pytest.mark.parametrize("name,steps,tol", [("vgg_flagship", 5, 1e-4),
                                            ("resnet12_pod", 1, 1e-2)])
def test_serve_adapt_and_predict_match_the_engine(name, steps, tol):
    """VGG with the cell's five adapt steps to 1e-4; ResNet-12 with one
    (its five steps amplify rounding past any tight bound at these
    sizes, module docstring) to 1e-2."""
    size = 32 if name == "resnet12_pod" else 16
    mc = maml_config(name, image_height=size, image_width=size,
                     serve_adapt_steps=steps)
    hp = hyper(mc)
    cfg = port.config(mc, {"serve_batch_tasks": 2,
                           "watchdog_serve_timeout_s": 0})
    params, lslr, bn = weights.make(hp, 11, "cpu")
    pool = episodes.image_pool(hp.image_shape, 64, 12, "cpu")
    plan = episodes.request_plan(64, 50, 2, 13)
    sy = (torch.arange(25) % 5).to(torch.int32).numpy()
    engine = port.serving_engine(cfg, params, lslr, bn, "cpu")
    try:
        for i in range(2):
            engine.submit(port.request(pool[plan[i, :25]], sy,
                                       pool[plan[i, 25:]], 0.0))
        got = sorted(engine.drain(), key=lambda r: r.request_id)
    finally:
        engine.close()
    for i, resp in enumerate(got):
        ref = maml.adapt_predict(
            hp, params, lslr, torch.from_numpy(pool[plan[i, :25]]),
            torch.from_numpy(sy), torch.from_numpy(pool[plan[i, 25:]]),
            Numerics())
        assert resp.status == "ok"
        assert torch.allclose(torch.from_numpy(resp.logits), ref,
                              rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["vgg_flagship", "resnet12_pod"])
def test_tables_have_the_programs_structure(name):
    with open(os.path.join(PKG_DIR, "configs", f"{name}.json")) as f:
        mc = json.load(f)["maml_config"]
    hp = hyper(mc)
    mine = weights.make(hp, 1, "cpu")
    theirs = port.template(port.config(mc, {}))
    shapes = lambda t: {p: tuple(x.shape) for p, x in maml.leaves(t)}
    for a, b in zip(mine, theirs):
        assert shapes(a) == shapes(b)


def test_flop_count_ignores_recomputation_and_chunking():
    base = maml_config("vgg_flagship", image_height=84, image_width=84,
                       num_stages=4, cnn_num_filters=48, batch_size=12,
                       task_microbatches=12, compute_dtype="bfloat16")
    counts = set()
    for remat in ("block_outs", "nothing", "dots"):
        for chunks in (1, 12):
            hp = hyper({**base, "remat_policy": remat,
                        "task_microbatches": chunks})
            counts.add(costs.train_task(hp, second_order=True,
                                        use_msl=False, epoch=99)[0])
    assert len(counts) == 1
    flops = counts.pop()
    # ~5.6 GFLOP per 84x84 forward of 25 images; a second-order step
    # takes some 20 forward-equivalents.
    assert 100e9 < flops < 160e9


def test_bn_bytes_count_each_application_once():
    hp = hyper(maml_config("vgg_flagship", image_height=84, image_width=84,
                           num_stages=4, cnn_num_filters=48,
                           compute_dtype="bfloat16"))
    per = costs.per_unit(hp, "task", second_order=True, use_msl=False,
                         epoch=99)
    rows = [25 * s * s for s in (84, 42, 21, 10)]
    forward = sum(2 * r * 48 * 2 + 16 * 48 for r in rows)
    assert per["bn_bytes"] == 6 * forward   # 5 support + 1 target forward
    served = costs.per_unit(hp, "request")
    assert served["bn_bytes"] == 6 * forward  # 5 adapt steps + predict
