"""The numbers ``correct`` compares, each against the limit its cell's
file states (set from readings of the program and of the control,
PERF.md § 2).

A cell's file names the numbers it compares, each with its limit.

Training (the first steps of the timed path against the reference from
the same tables and batches):

* ``loss_gap``: the largest relative gap of a step's meta-loss
  (``loss1_gap``: the first step's).
* ``grad_gap``: the first meta-gradient as the optimizer took it (the
  program's Adam first moment after one step over ``1 - beta1``), by the
  worst leaf: the gap between the program's norm of the leaf and the
  reference's, over the reference's norm of that leaf or of the median
  leaf, whichever is larger.
* ``change_gap``: the change of every table and LSLR vector over the
  steps, by the worst leaf alike, leaving out the leaves whose first
  reference gradient is under a thousandth of the median leaf's (a conv
  bias under batch-statistics BN moves under Adam by round-off alone).
* ``grad_median_gap``, ``change_median_gap``: the median leaf's gaps.
* ``bn_var_gap``: each norm's row-0 running variance after the first
  step (the task mean of the first support forward's batch variances,
  by torch's momentum rule), the program's against the reference's, by
  the worst layer, relative to the reference's change of it. It reads
  the forward and the BN kernel's statistics before any adaptation.

Serving (a sample of the requests served in the window, drawn from the
seed, against the reference's adapt and predict on the same request):

* ``logit_gap``: the largest absolute gap of a served query logit
  (``logit_median_gap``: the median request's largest).
* ``top1_regret``: the widest gap by which the reference's logit of the
  served class lies below the reference's best.
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from portbench.reference.maml import leaves

DEAD_LEAF = 1e-3


def norms(tree) -> Dict[str, float]:
    return {p: float(t.detach().double().norm()) for p, t in leaves(tree)}


def live_leaves(first_grad: Dict[str, float]) -> List[str]:
    median = statistics.median(first_grad.values())
    return [k for k, v in first_grad.items() if v >= DEAD_LEAF * median]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Every leaf's gap: ``|p - r| / max(r, median r)`` of its norms."""
    keys = list(ref) if keep is None else list(keep)
    median = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
            for k in keys}


def bn_var_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               start: Dict[str, torch.Tensor]) -> float:
    """The worst norm layer's gap of its row-0 running variance after
    the first step, relative to the reference's change of it."""
    return max(float((prog[k].double() - ref[k].double()).norm()
                     / (ref[k].double() - start[k].double()).norm()
                     .clamp(min=1e-30)) for k in ref)


def train_numbers(prog_losses: List[float], ref_losses: List[float],
                  prog_first_grad, ref_first_grad, prog_change,
                  ref_change, prog_bn=None, ref_bn=None,
                  start_bn=None) -> Dict[str, Any]:
    """The training numbers (the gradient and change arguments are
    ``{"params", "lslr"}`` trees): ``loss_gap`` over every step and
    ``loss1_gap`` of the first, the worst leaf's ``grad_gap`` and
    ``change_gap``, the median leaf's ``grad_median_gap`` and
    ``change_median_gap``, and with the row-0 running variances
    (``{norm: (C,)}``: the program's and the reference's after the
    first step, and before it) ``bn_var_gap``; ``worst`` names the
    worst leaves."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses)]
    g_ref = norms(ref_first_grad)
    grad = leaf_gaps(norms(prog_first_grad), g_ref)
    change = leaf_gaps(norms(prog_change), norms(ref_change),
                       live_leaves(g_ref))
    top = lambda d: max(d, key=d.get)
    out = {"loss_gap": max(losses), "loss1_gap": losses[0],
           "grad_gap": max(grad.values()),
           "grad_median_gap": statistics.median(grad.values()),
           "change_gap": max(change.values()),
           "change_median_gap": statistics.median(change.values()),
           "worst": {"grad": top(grad), "change": top(change)}}
    if ref_bn is not None:
        out["bn_var_gap"] = bn_var_gap(prog_bn, ref_bn, start_bn)
    return out


def difference(a, b):
    if isinstance(a, dict):
        return {k: difference(a[k], b[k]) for k in b}
    return a.detach().double() - b.detach().double()


def serve_numbers(pairs: List[Tuple[torch.Tensor, torch.Tensor]]
                  ) -> Dict[str, float]:
    """``pairs``: (served logits, reference logits) of each sampled
    request, ``(Q, N)`` each. ``logit_gap`` is the widest gap over all
    of them, ``logit_median_gap`` the median request's widest gap,
    ``ref_logit_max`` the largest reference logit."""
    gaps, regrets, scale = [], [], 0.0
    for served, ref in pairs:
        served, ref = served.double(), ref.double().to(served.device)
        gaps.append(float((served - ref).abs().max()))
        chosen = ref.gather(1, served.argmax(1, keepdim=True)).squeeze(1)
        regrets.append(float((ref.max(1).values - chosen).max()))
        scale = max(scale, float(ref.abs().max()))
    return {"logit_gap": max(gaps),
            "logit_median_gap": statistics.median(gaps),
            "top1_regret": max(regrets), "ref_logit_max": scale}
