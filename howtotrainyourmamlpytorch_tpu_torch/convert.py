"""Carry training state between the JAX package and the port.

:func:`state_from_jax` takes the JAX package's ``params``, ``lslr`` and
``bn_state`` trees as numpy arrays (``jax.device_get`` of them, or a
checkpoint's arrays), and optionally its optax Adam state, and returns the
port's :class:`MetaTrainState`: HWIO conv kernels become OIHW, ``(in,
out)`` linear weights become ``(out, in)``, in the parameters and in
Adam's ``mu``/``nu`` alike. Leaf names are kept, so the LSLR vectors map
one to one. Both packages flatten features in NHWC order, so the linear's
input dimension needs no permutation. The same two rules cover every
backbone: ResNet-12's 1x1 skip kernels are 4-d ``w`` (HWIO -> OIHW), the
MLP's ``dense{i}`` weights are 2-d ``w``. Layer-norm γ/β (``(1, H, W,
C)``, named ``gamma``/``beta``) keep the JAX package's NHWC order in the
port (models/layers.py § layer_norm_apply applies them so) and cross
unchanged; an empty norm state (the MLP's ``{}``, layer norm's
``{"norm0": {}, ...}``) crosses as the same empty dicts.

:func:`state_to_jax` is its inverse: the port's state as numpy trees in
the JAX layout, Adam's state as the flax state dict of optax's
``(ScaleByAdamState, ScaleByScheduleState)``. :func:`to_state_dict` and
:func:`from_state_dict` wrap both around the flax state dict of the JAX
package's ``MetaTrainState`` — the checkpoint payload
(``utils/checkpoint.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from howtotrainyourmamlpytorch_tpu_torch.device import (DeviceLike,
                                                        resolve_device)
from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (AdamState,
                                                            MetaTrainState,
                                                            adam_init)
from howtotrainyourmamlpytorch_tpu_torch.tree import tree_map


def _param_leaf(leaf: str, arr) -> torch.Tensor:
    a = np.asarray(arr, dtype=np.float32)
    if leaf == "w" and a.ndim == 4:          # conv HWIO -> OIHW
        a = a.transpose(3, 2, 0, 1)
    elif leaf == "w" and a.ndim == 2:        # linear (in, out) -> (out, in)
        a = a.T
    return _tensor(a)


def _param_leaf_to_jax(leaf: str, t: torch.Tensor) -> np.ndarray:
    a = _array(t)
    if leaf == "w" and a.ndim == 4:          # conv OIHW -> HWIO
        a = a.transpose(2, 3, 1, 0)
    elif leaf == "w" and a.ndim == 2:        # linear (out, in) -> (in, out)
        a = a.T
    return np.ascontiguousarray(a)


def _array(t: torch.Tensor) -> np.ndarray:
    """A C-contiguous numpy copy of a tensor, on the host."""
    return np.ascontiguousarray(t.detach().cpu().numpy())


def _tensor(arr) -> torch.Tensor:
    """A C-contiguous f32 copy (the source may be a read-only view)."""
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX parameter tree (HWIO convs, (in, out) linears) in the port's
    layout."""
    return {layer: {leaf: _param_leaf(leaf, arr)
                    for leaf, arr in sub.items()}
            for layer, sub in tree.items()}


def params_to_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameter tree in the JAX layout, as numpy."""
    return {layer: {leaf: _param_leaf_to_jax(leaf, t)
                    for leaf, t in sub.items()}
            for layer, sub in tree.items()}


def _trainables(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A ``{"params", "lslr"}`` tree (Adam's moments) in the port's layout."""
    return {"params": params_from_jax(tree["params"]),
            "lslr": tree_map(_tensor, tree["lslr"])}


def _field(obj, name: str):
    """``obj.name`` for optax's namedtuples, ``obj[name]`` for their flax
    state dicts."""
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def adam_state_from_optax(opt_state) -> AdamState:
    """The port's :class:`AdamState` from ``optax.adam``'s state, the tuple
    ``(ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count))``
    as numpy (read by attribute: the port does not import optax), or from
    its flax state dict ``{"0": {"count", "mu", "nu"}, "1": {"count"}}``."""
    if isinstance(opt_state, dict):
        adam, sched = opt_state["0"], opt_state["1"]
    else:
        adam, sched = opt_state[0], opt_state[1]
    count = int(np.asarray(_field(adam, "count")))
    sched_count = int(np.asarray(_field(sched, "count")))
    if count != sched_count:
        raise ValueError(f"optax state counts differ: adam {count}, "
                         f"schedule {sched_count}")
    return AdamState(count=count, mu=_trainables(_field(adam, "mu")),
                     nu=_trainables(_field(adam, "nu")))


def adam_state_to_optax(opt: AdamState) -> Dict[str, Any]:
    """The flax state dict of optax's Adam state for the port's
    :class:`AdamState`: both counts int32, moments in the JAX layout."""
    def moments(tree):
        return {"params": params_to_jax(tree["params"]),
                "lslr": tree_map(_array, tree["lslr"])}
    count = np.array(opt.count, dtype=np.int32)
    return {"0": {"count": count, "mu": moments(opt.mu),
                  "nu": moments(opt.nu)},
            "1": {"count": count.copy()}}


def state_from_jax(params: Dict[str, Any], lslr: Dict[str, Any],
                   bn_state: Dict[str, Any], step: int = 0,
                   device: DeviceLike = None,
                   opt_state: Optional[Any] = None) -> MetaTrainState:
    """The port's state from the JAX package's numpy trees, on ``device``
    (the card by default). ``opt_state`` is optax's Adam state; without
    it Adam starts from zero moments and count 0."""
    device = resolve_device(device)
    tparams, tlslr = params_from_jax(params), tree_map(_tensor, lslr)
    opt = (adam_init({"params": tparams, "lslr": tlslr})
           if opt_state is None else adam_state_from_optax(opt_state))
    state = MetaTrainState(params=tparams, lslr=tlslr,
                           bn_state=tree_map(_tensor, bn_state),
                           opt_state=opt, step=int(step))
    return state.to(device)


def state_to_jax(state: MetaTrainState) -> Tuple[Dict[str, Any], ...]:
    """The inverse of :func:`state_from_jax`: ``(params, lslr, bn_state,
    opt_state, step)`` as numpy in the JAX layout (HWIO convs, ``(in,
    out)`` linears, the same transposes in Adam's moments); ``opt_state``
    is the flax state dict of optax's Adam state, ``step`` a 0-d int32."""
    return (params_to_jax(state.params), tree_map(_array, state.lslr),
            tree_map(_array, state.bn_state),
            adam_state_to_optax(state.opt_state),
            np.array(state.step, dtype=np.int32))


STATE_FIELDS = ("params", "lslr", "bn_state", "opt_state", "step")


def _sorted(tree):
    """``tree`` with every dict's keys in sorted order."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def to_state_dict(state: MetaTrainState) -> Dict[str, Any]:
    """The flax state dict of the JAX package's ``MetaTrainState`` holding
    the port's ``state``, in the order the JAX package writes it (fields in
    declaration order, every dict below them by sorted key — the order
    ``jax.device_get`` leaves): the checkpoint payload's tree."""
    return {name: _sorted(value)
            for name, value in zip(STATE_FIELDS, state_to_jax(state))}


def from_state_dict(sd: Dict[str, Any],
                    device: DeviceLike = None) -> MetaTrainState:
    """The port's state from the flax state dict of a JAX
    ``MetaTrainState`` (as :func:`to_state_dict` writes it)."""
    return state_from_jax(sd["params"], sd["lslr"], sd["bn_state"],
                          int(np.asarray(sd["step"])), device=device,
                          opt_state=sd["opt_state"])
