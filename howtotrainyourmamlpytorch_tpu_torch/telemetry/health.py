"""Optimization-health introspection: training diagnostics of the outer
step (the port's counterpart of the JAX package's ``telemetry/health.py``,
on torch tensors).

MAML++'s outer optimization is unstable by nature; MSL annealing,
per-layer per-step LSLR and derivative-order annealing all exist to tame
the meta-gradient. When a run diverges these say which layer's gradients
exploded, whether the learned LSLR rates collapsed, and how the MSL
schedule stood at the time:

* :func:`grad_health` / :func:`update_health` — computed by the train step
  (``meta/outer.py § make_train_step``, ``health=True``) from the
  meta-gradient before zeroing and clamp, and from the post-update
  trainables and Adam moments: the outer-gradient global norm,
  per-top-level-layer gradient norms and update-to-param ratios, LSLR
  min/mean/max over the trained rows with a count of nonpositive entries,
  the MSL importance vector and the per-inner-step support/target losses.
  Every norm is accumulated in f32. They read tensors the step already
  holds and write none of them, so the weights are bitwise those of a step
  without health. Eager PyTorch lets the step skip them on the steps the
  trainer does not publish.
* :func:`publish_health` — routes one fetched snapshot: scalars to
  ``health/*`` registry gauges, everything to one ``health`` event row.
  A copy of the JAX function.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from howtotrainyourmamlpytorch_tpu_torch.tree import tree_leaves, tree_map

# events.jsonl row carrying one fetched health snapshot.
HEALTH_EVENT = "health"
# events.jsonl row + registry counter for the guard's grad-norm warning.
GRAD_NORM_WARN_EVENT = "health_grad_norm_warn"
GRAD_NORM_WARN_COUNTER = "health/grad_norm_warn"

# Keys of the health dict that are vectors (logged to the health row,
# never to scalar gauges).
_VECTOR_KEYS = ("msl_importance", "per_step_support_loss",
                "per_step_target_loss")

_EPS = 1e-12  # update-ratio denominator guard (a zero-norm layer reads
              # ratio 0/eps, not NaN)


def _subtree_norm(tree: Any) -> torch.Tensor:
    """Global L2 norm over every leaf of ``tree``, accumulated in f32."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    total = sum(torch.sum(torch.square(leaf.detach().float()))
                for leaf in leaves)
    return torch.sqrt(total)


def grad_health(grads: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Gradient-side diagnostics of the meta-gradient before the LSLR/γ/β
    zeroing and the clamp. Keys: ``grad_norm`` (global, params ∪ lslr)
    and ``grad_norm/<layer>`` per top-level parameter layer."""
    health = {"grad_norm": _subtree_norm(grads)}
    for name in sorted(grads["params"]):
        health[f"grad_norm/{name}"] = _subtree_norm(grads["params"][name])
    return health


def update_health(cfg: Any, new_trainable: Dict[str, Any], new_opt: Any,
                  learning_rate: float,
                  per_step_support_loss: torch.Tensor,
                  per_step_target_loss: torch.Tensor,
                  msl_weights: Optional[torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Post-update diagnostics: per-layer update-to-param ratios, LSLR row
    statistics over the trained rows, and the per-inner-step loss
    trajectories. ``new_opt`` is the post-update Adam state
    (``meta/outer.py § AdamState``); the update is rebuilt from its
    moments and count, ``lr·m̂/(√v̂ + eps)``, as the JAX function does.
    ``msl_weights`` is None outside the MSL window."""
    health: Dict[str, torch.Tensor] = {}
    f32 = np.float32
    bc1 = float(f32(1.0) - f32(cfg.meta_adam_beta1) ** f32(new_opt.count))
    bc2 = float(f32(1.0) - f32(cfg.meta_adam_beta2) ** f32(new_opt.count))
    eps = cfg.meta_adam_eps

    def update_leaf(m, v):
        return learning_rate * (m.float() / bc1) / (
            torch.sqrt(v.float() / bc2) + eps)

    ratios = []
    for name in sorted(new_trainable["params"]):
        p = _subtree_norm(new_trainable["params"][name])
        u = _subtree_norm(tree_map(update_leaf, new_opt.mu["params"][name],
                                   new_opt.nu["params"][name]))
        ratio = u / (p + _EPS)
        health[f"update_ratio/{name}"] = ratio
        ratios.append(ratio)
    health["update_ratio_max"] = torch.max(torch.stack(ratios))

    # LSLR rows 0..K-1 are the rows gradients reach (meta/inner.py §
    # lslr_init: the final +1 row keeps its init).
    k = cfg.number_of_training_steps_per_iter
    new_lslr = new_trainable["lslr"]
    all_rows = []
    for name in sorted(new_lslr):
        rows = torch.cat([leaf.detach()[:k].float().reshape(-1)
                          for leaf in tree_leaves(new_lslr[name])])
        health[f"lslr_min/{name}"] = rows.min()
        health[f"lslr_mean/{name}"] = rows.mean()
        health[f"lslr_max/{name}"] = rows.max()
        all_rows.append(rows)
    flat = torch.cat(all_rows)
    health["lslr_min"] = flat.min()
    health["lslr_mean"] = flat.mean()
    health["lslr_max"] = flat.max()
    # A learned per-step LR at or below zero means that (layer, step)
    # update is off or ascending: the LSLR collapse mode.
    health["lslr_nonpositive"] = (flat <= 0.0).sum().float()

    health["per_step_support_loss"] = per_step_support_loss
    health["per_step_target_loss"] = per_step_target_loss
    if msl_weights is not None:
        health["msl_importance"] = msl_weights[:k]
    return health


def fetch_health(health: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The health dict on the host, in its order: scalars as floats (one
    stacked transfer), vectors as float lists."""
    scalars = [k for k in health if k not in _VECTOR_KEYS]
    values = (torch.stack([health[k].detach().float().reshape(())
                           for k in scalars]).cpu().tolist()
              if scalars else [])
    fetched = dict(zip(scalars, values))
    return {key: (health[key].detach().float().cpu().tolist()
                  if key in _VECTOR_KEYS else fetched[key])
            for key in health}


def _gauge_name(key: str) -> str:
    """Map a health key to its registry gauge name."""
    for prefix, fmt in (("grad_norm/", "health/layer/{}/grad_norm"),
                        ("update_ratio/", "health/layer/{}/update_ratio"),
                        ("lslr_min/", "health/lslr/{}/min"),
                        ("lslr_mean/", "health/lslr/{}/mean"),
                        ("lslr_max/", "health/lslr/{}/max")):
        if key.startswith(prefix):
            return fmt.format(key[len(prefix):])
    return f"health/{key}"


def publish_health(registry: Any, jsonl: Any, fetched: Dict[str, Any], *,
                   iteration: int, epoch: Optional[int] = None
                   ) -> Dict[str, Any]:
    """Route one fetched health snapshot: scalars → ``health/*`` gauges,
    vectors + scalars → ONE ``health`` event row (the report's source)."""
    row: Dict[str, Any] = {"iter": iteration}
    if epoch is not None:
        row["epoch"] = epoch
    for key, value in fetched.items():
        if key in _VECTOR_KEYS:
            row[key] = [float(v) for v in value]
            continue
        value = float(value)
        row[key] = value
        registry.gauge(_gauge_name(key)).set(value)
    return jsonl.log(HEALTH_EVENT, **row)
