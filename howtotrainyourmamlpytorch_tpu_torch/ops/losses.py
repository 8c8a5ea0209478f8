"""Loss and metric primitives (counterpart of the JAX ``ops/losses.py``).

Every function reduces over the example axis, the last axis of the
labels, so a leading task axis is carried through: ``(rows, C)`` logits
give a scalar, ``(T, rows, C)`` logits give one value per task.
"""

from __future__ import annotations

import torch


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float64 else x.float()


def _ce_per_example(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(_at_least_f32(logits), dim=-1)
    return -logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels (torch
    ``F.cross_entropy`` semantics: mean reduction, at least f32)."""
    return _ce_per_example(logits, labels).mean(-1)


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """Weighted-mean cross-entropy ``sum(w·l) / sum(w)``: the serving
    batcher's zero-weight pad rows add nothing to the loss."""
    per_example = _ce_per_example(logits, labels)
    weights = weights.to(per_example.dtype)
    return (weights * per_example).sum(-1) / weights.sum(-1)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean(-1)


def _se_per_row(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-row squared error summed over the output dim; targets are
    ``(..., rows)`` or ``(..., rows, D)``."""
    preds = _at_least_f32(preds)
    targets = targets.to(preds.dtype)
    if targets.dim() == preds.dim() - 1:
        targets = targets.unsqueeze(-1)
    return (preds - targets).square().sum(-1)


def mse(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean squared error (``F.mse_loss`` mean-reduction semantics)."""
    return _se_per_row(preds, targets).mean(-1)


def weighted_mse(preds: torch.Tensor, targets: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """Weighted-mean squared error ``sum(w·l) / sum(w)``."""
    per_example = _se_per_row(preds, targets)
    weights = weights.to(per_example.dtype)
    return (weights * per_example).sum(-1) / weights.sum(-1)


def regression_score(preds: torch.Tensor,
                     targets: torch.Tensor) -> torch.Tensor:
    """Negative MSE, the higher-is-better regression stand-in for
    :func:`accuracy`."""
    return -mse(preds, targets)


def task_loss_fns(cfg):
    """(loss, weighted_loss, metric) for the config's task type."""
    if cfg.task_type == "regression":
        return mse, weighted_mse, regression_score
    return cross_entropy, weighted_cross_entropy, accuracy
