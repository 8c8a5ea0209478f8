"""The plain reference of MAML++'s outer step and of serving's
adapt-and-predict, one task at a time (``reference/model.py`` for the
forwards).

Outer step (Antoniou et al., arXiv:1810.09502, the repository's
``few_shot_learning_system.py``): for each task, K support steps of
``w <- w - lr[name][s] * grad`` on the fast (non-norm) tables, with BN
row ``s``; second order keeps the graph of each inner gradient. The
task's loss is the target loss after the last step at row K-1, or with
the multi-step loss the importance-weighted sum of the target losses
after every step. The meta-loss is the mean over tasks; its gradient
reaches every table and every LSLR vector. Non-learnable gamma, beta or
LSLR gradients are zeroed, the network's gradients clamped if the
configuration says so, then Adam with the epoch-granular cosine
meta-learning rate.

Serving: K first-order support steps per request from the
meta-parameters, then the query logits at row K-1 with the query's own
batch statistics.

Every task is computed on its own and its gradient added, so the
reference fits the card at the cells' sizes.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.model import (FORWARDS, Hyper, Numerics,
                                       is_fast, normalize_images)

Tree = Dict[str, Dict[str, torch.Tensor]]


class TF32Off:
    """float32 products in float32 (cuDNN and cuBLAS would otherwise
    round their inputs to TF32): the reference's setting."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


class TrainState(NamedTuple):
    """Parameters, LSLR vectors, Adam's moments and its step count."""
    params: Tree
    lslr: Tree
    mu: Dict[str, Tree]
    nu: Dict[str, Tree]
    count: int


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def leaves(tree) -> List[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every leaf, paths joined with ``/``."""
    out = []

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        else:
            out.append((prefix, t))
    walk(tree, "")
    return out


def init_state(params: Tree, lslr: Tree) -> TrainState:
    zeros = lambda t: torch.zeros_like(t)
    trainable = {"params": params, "lslr": lslr}
    return TrainState(params, lslr, tree_map(zeros, trainable),
                      tree_map(zeros, trainable), 0)


def msl_weights(hp: Hyper, epoch: int) -> List[float]:
    """The multi-step loss importance vector of ``epoch``."""
    k = hp.train_steps
    decay = 1.0 / k / hp.msl_epochs
    floor = 0.03 / k
    nonfinal = max(1.0 / k - epoch * decay, floor)
    final = min(1.0 / k + epoch * (k - 1) * decay, 1.0 - (k - 1) * floor)
    return [nonfinal] * (k - 1) + [final]


def meta_lr(hp: Hyper, count: int) -> float:
    """Cosine over epochs, stepped once per epoch."""
    frac = min((count // hp.iters_per_epoch) / hp.total_epochs, 1.0)
    return hp.min_lr + (hp.meta_lr - hp.min_lr) * 0.5 * (
        1.0 + math.cos(math.pi * frac))


def _inner(hp: Hyper, params: Tree, lslr: Tree, x: torch.Tensor,
           y: torch.Tensor, fast: Tree, step: int, n: Numerics,
           create_graph: bool) -> Tuple[Tree, torch.Tensor]:
    """One support step: the fast tables after ``w - lr[s] * grad``."""
    logits = FORWARDS[hp.backbone]({**params, **fast}, x, step, hp, n)
    loss = F.cross_entropy(logits, y)
    flat = leaves(fast)
    grads = torch.autograd.grad(loss, [t for _, t in flat],
                                create_graph=create_graph)
    g = dict(zip((p for p, _ in flat), grads))
    new = {name: {leaf: w - lslr[name][leaf][step] * g[f"{name}/{leaf}"]
                  for leaf, w in sub.items()}
           for name, sub in fast.items()}
    return new, loss


def task_loss(hp: Hyper, params: Tree, lslr: Tree, sx: torch.Tensor,
              sy: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor, *,
              second_order: bool, use_msl: bool, epoch: int,
              n: Numerics) -> torch.Tensor:
    """One task's meta-loss (images already normalized, NCHW)."""
    fast = {k: v for k, v in params.items() if is_fast(k)}
    forward = FORWARDS[hp.backbone]
    weights = msl_weights(hp, epoch) if use_msl else None
    total = None
    for s in range(hp.train_steps):
        fast, _ = _inner(hp, params, lslr, sx, sy, fast, s, n,
                         second_order)
        if use_msl:
            t_loss = F.cross_entropy(forward({**params, **fast}, tx, s, hp,
                                             n), ty)
            total = weights[s] * t_loss if total is None else (
                total + weights[s] * t_loss)
    if use_msl:
        return total
    return F.cross_entropy(forward({**params, **fast}, tx,
                                   hp.train_steps - 1, hp, n), ty)


def meta_gradients(hp: Hyper, state: TrainState, batch, *,
                   second_order: bool, use_msl: bool, epoch: int,
                   n: Numerics, tasks: Optional[List[int]] = None
                   ) -> Tuple[torch.Tensor, Dict[str, Tree]]:
    """The meta-loss (a 0-dim tensor) and its gradient over ``{"params", "lslr"}``, one
    task at a time. ``batch``: uint8 NHWC support/target images and
    int labels with a leading task axis. ``tasks``: the tasks that make
    the mean (all by default)."""
    sx_all, sy_all, tx_all, ty_all = batch
    tasks = list(range(sx_all.shape[0])) if tasks is None else tasks
    trainable = tree_map(lambda t: t.detach().requires_grad_(True),
                         {"params": state.params, "lslr": state.lslr})
    flat = leaves(trainable)
    sums = [torch.zeros_like(t) for _, t in flat]
    loss_sum = torch.zeros((), device=sx_all.device)
    for i in tasks:
        loss = task_loss(
            hp, trainable["params"], trainable["lslr"],
            normalize_images(hp, sx_all[i]), sy_all[i].long(),
            normalize_images(hp, tx_all[i]), ty_all[i].long(),
            second_order=second_order, use_msl=use_msl, epoch=epoch, n=n)
        grads = torch.autograd.grad(loss, [t for _, t in flat],
                                    allow_unused=True)
        for acc, g in zip(sums, grads):
            if g is not None:
                acc.add_(g.detach())
        loss_sum = loss_sum + loss.detach()
        del loss, grads
    it = iter(s / len(tasks) for s in sums)
    return loss_sum / len(tasks), tree_map(lambda _: next(it), trainable)


def train_step(hp: Hyper, state: TrainState, batch, *, second_order: bool,
               use_msl: bool, epoch: int, n: Numerics,
               tasks: Optional[List[int]] = None
               ) -> Tuple[TrainState, float, Dict[str, Tree]]:
    """One outer step: ``(new state, meta-loss, meta-gradient as the
    optimizer takes it)``."""
    loss, grads = meta_gradients(hp, state, batch, second_order=second_order,
                                 use_msl=use_msl, epoch=epoch, n=n,
                                 tasks=tasks)
    loss = float(loss)
    with torch.no_grad():
        if not hp.learnable_lslr:
            grads["lslr"] = tree_map(torch.zeros_like, grads["lslr"])
        for name, sub in grads["params"].items():
            if "norm" in name:
                if not hp.learnable_gamma:
                    sub["gamma"] = torch.zeros_like(sub["gamma"])
                if not hp.learnable_beta:
                    sub["beta"] = torch.zeros_like(sub["beta"])
        if hp.clamp is not None:
            grads["params"] = tree_map(lambda g: g.clamp(-hp.clamp, hp.clamp),
                                       grads["params"])
        b1, b2 = hp.beta1, hp.beta2
        count = state.count + 1
        lr = meta_lr(hp, state.count)
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * g * g + b2 * v, grads, state.nu)
        bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
        new = tree_map(
            lambda p, m, v: p - lr * (m / bc1) / (torch.sqrt(v / bc2)
                                                  + hp.adam_eps),
            {"params": state.params, "lslr": state.lslr}, mu, nu)
    return (TrainState(new["params"], new["lslr"], mu, nu, count), loss,
            grads)


def first_running_var(hp: Hyper, params: Tree, lslr: Tree, batch,
                      bn_var: Dict[str, torch.Tensor], *, use_msl: bool,
                      n: Numerics, tasks: Optional[List[int]] = None
                      ) -> Dict[str, torch.Tensor]:
    """Each norm's running variance at row 0 after one outer step from
    ``bn_var`` (its row 0 before): the task mean of torch's momentum
    update with the unbiased batch variance of the first support
    forward (and, with the multi-step loss, of the target forward after
    the first support step)."""
    sx_all, sy_all, tx_all, _ = batch
    tasks = list(range(sx_all.shape[0])) if tasks is None else tasks
    names = [k for k in params if not is_fast(k)]
    m = hp.momentum
    total = {k: torch.zeros_like(bn_var[k]) for k in names}
    forward = FORWARDS[hp.backbone]
    for i in tasks:
        sx = normalize_images(hp, sx_all[i])
        seen: List[torch.Tensor] = []
        rec = Numerics(n.fp8, bn_vars=seen)
        run = {k: {l: t.detach().requires_grad_(True) for l, t in v.items()}
               for k, v in params.items()}
        with torch.enable_grad():
            fast = {k: v for k, v in run.items() if is_fast(k)}
            fast, _ = _inner(hp, run, lslr, sx, sy_all[i].long(), fast, 0,
                             rec, False)
        rows = {k: (1 - m) * bn_var[k] + m * v for k, v in zip(names, seen)}
        if use_msl:
            seen.clear()
            with torch.no_grad():
                forward({**run, **fast}, normalize_images(hp, tx_all[i]), 0,
                        hp, rec)
            rows = {k: (1 - m) * rows[k] + m * v
                    for k, v in zip(names, seen)}
        for k in names:
            total[k] += rows[k]
    return {k: v / len(tasks) for k, v in total.items()}


def adapt_predict(hp: Hyper, params: Tree, lslr: Tree,
                  support_x: torch.Tensor, support_y: torch.Tensor,
                  query_x: torch.Tensor, n: Numerics) -> torch.Tensor:
    """One served request: K first-order support steps from the
    meta-parameters, then the query logits ``(Q, N)`` at row K-1."""
    sx = normalize_images(hp, support_x)
    qx = normalize_images(hp, query_x)
    y = support_y.long()
    base = tree_map(lambda t: t.detach(), params)
    fast = {k: tree_map(lambda t: t.detach().requires_grad_(True), v)
            for k, v in base.items() if is_fast(k)}
    with torch.enable_grad():
        for s in range(hp.serve_steps):
            fast, _ = _inner(hp, base, lslr, sx, y, fast, s, n, False)
            fast = tree_map(lambda t: t.detach().requires_grad_(True), fast)
    with torch.no_grad():
        return FORWARDS[hp.backbone]({**base, **fast}, qx,
                                     hp.serve_steps - 1, hp, n)
