"""Traffic driver ``train_step``: the program's meta-training step at one
epoch's phase key, as the trainer runs it (``lib/port.py § train_step``:
the phase key's CUDA graph on the card), fed a pool of meta-batches made
from the seed on the device.

Set-up makes the tables and the pool, captures the step and drives the
state through the traffic's ``check_steps`` first steps on distinct
batches, through the same call the window makes. The window then steps
on for ``seconds``, one step queued ahead of the host, and its rate is
all the tasks over all the time. After the window (and the traced
sub-window, if asked for), the program's state is freed and the plain
reference (``reference/maml.py``, float32, TF32 off) repeats the first
steps from the same tables and batches; ``lib/compare.py`` gives the
numbers ``correct`` is judged by.

Traffic keys: ``epoch`` (a number, or ``"last"``: the schedule's last
epoch), ``pool_batches``, ``check_steps``, ``trace_steps``.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from portbench.lib import compare, costs, episodes, port, trace, weights
from portbench.lib.spec import Context, Outcome
from portbench.reference import maml
from portbench.reference.model import Numerics, hyper


def epoch_of(traffic, hp) -> int:
    return hp.total_epochs - 1 if traffic["epoch"] == "last" else int(
        traffic["epoch"])


def row0(bn_state):
    """Each norm's row-0 running variance."""
    return {k: v["var"][0] for k, v in bn_state.items()}


def reference_steps(hp, params, lslr, bn_state, batches, phase, epoch,
                    numerics, tasks=None):
    """The reference's losses, first meta-gradient, final tables and
    row-0 running variances after the first step, over ``batches``, from
    ``params``, ``lslr`` and ``bn_state``."""
    state = maml.init_state(params, lslr)
    losses, first = [], None
    with maml.TF32Off():
        bn = maml.first_running_var(hp, params, lslr, batches[0],
                                    row0(bn_state), use_msl=phase[1],
                                    n=numerics, tasks=tasks)
        for batch in batches:
            state, loss, grads = maml.train_step(
                hp, state, batch, second_order=phase[0], use_msl=phase[1],
                epoch=epoch, n=numerics, tasks=tasks)
            losses.append(loss)
            first = grads if first is None else first
    return losses, first, {"params": state.params, "lslr": state.lslr}, bn


def numbers_against(ref, start, losses, first, final, bn):
    """The compared numbers of a side (the program, the control or a
    fault) against the reference's ``ref`` (:func:`reference_steps`),
    from the tables ``start``."""
    ref_losses, ref_first, ref_final, ref_bn = ref
    return compare.train_numbers(
        losses, ref_losses, first, ref_first,
        compare.difference(final, {k: start[k] for k in final}),
        compare.difference(ref_final, {k: start[k] for k in ref_final}),
        bn, ref_bn, row0(start["bn_state"]))


def run(ctx: Context) -> Outcome:
    device = ctx.device
    maml_config = ctx.config["maml_config"]
    hp = hyper(maml_config)
    cfg = port.config(maml_config, ctx.program_overrides)
    epoch = epoch_of(ctx.traffic, hp)
    checks = int(ctx.traffic["check_steps"])
    tasks = cfg.batch_size

    params, lslr, bn_state = weights.make(hp, weights.sub_seed(ctx.seed, 1),
                                        device)
    pool = episodes.train_pool(
        hp.image_shape, hp.num_classes, hp.shots, hp.targets, tasks,
        int(ctx.traffic["pool_batches"]), weights.sub_seed(ctx.seed, 2),
        device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = port.train_state(params, lslr, bn_state)
    step, phase = port.train_step(cfg, state, pool[0], epoch, device)
    losses = []
    for i in range(checks):
        state, m = step(state, pool[i])
        losses.append(m.loss)
        if i == 0:
            first_mu = state.opt_state.mu
            first_bn = row0(state.bn_state)
    checked = {"params": state.params, "lslr": state.lslr}
    losses = [float(x) for x in losses]
    setup_s = time.perf_counter() - ctx.t0

    done = 0
    prev = None
    t0 = time.perf_counter()
    while True:
        state, m = step(state, pool[(checks + done) % len(pool)])
        done += 1
        if torch.device(device).type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            if prev is not None:
                prev.synchronize()
            prev = ev
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    last_loss = float(m.loss)
    elapsed = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)

    summary = None
    if ctx.trace:
        n_trace = int(ctx.traffic["trace_steps"])

        def traced_steps():
            nonlocal state
            for i in range(n_trace):
                with trace.host_range("portbench.train_step"):
                    state, _ = step(state, pool[i % len(pool)])
            return {"tasks": n_trace * tasks}
        summary = trace.traced(traced_steps, device)

    del state, step, m
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    batches = pool[:checks]
    del pool
    ref = reference_steps(hp, params, lslr, bn_state, batches, phase, epoch,
                          Numerics())
    prog_first = {k: {n: {l: t / (1 - hp.beta1) for l, t in sub.items()}
                      for n, sub in first_mu[k].items()}
                  for k in ("params", "lslr")}
    start = {"params": params, "lslr": lslr, "bn_state": bn_state}
    numbers = numbers_against(ref, start, losses, prog_first, checked,
                              first_bn)
    limits = ctx.cell["limits"]
    readings = {"tasks_per_s": done * tasks / elapsed, "numbers": numbers}
    if ctx.trace:
        readings["per_task"] = costs.per_unit(
            hp, "task", second_order=phase[0], use_msl=phase[1], epoch=epoch)
        readings["peak_flops"] = costs.PEAK_FLOPS[hp.compute_dtype]
    return Outcome(
        end_to_end={"setup_s": setup_s,
                    "train_tasks_per_s": done * tasks / elapsed,
                    "peak_gib": peak / 2 ** 30},
        checks={k: (numbers[k], float(limits[k])) for k in limits},
        attempted=done, failed=0 if math.isfinite(last_loss) else 1,
        memory_peak_bytes=peak, trace=summary, readings=readings)
