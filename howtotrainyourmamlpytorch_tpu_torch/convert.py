"""Carry the JAX package's training state over to the port.

:func:`state_from_jax` takes the JAX package's ``params``, ``lslr`` and
``bn_state`` trees as numpy arrays (``jax.device_get`` of them, or a
checkpoint's arrays), and optionally its optax Adam state, and returns the
port's :class:`MetaTrainState`: HWIO conv kernels become OIHW, ``(in,
out)`` linear weights become ``(out, in)``, in the parameters and in
Adam's ``mu``/``nu`` alike. Leaf names are kept, so the LSLR vectors map
one to one. Both packages flatten features in NHWC order, so the linear's
input dimension needs no permutation.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

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


def _tensor(arr) -> torch.Tensor:
    """A C-contiguous f32 copy (the source may be a read-only view)."""
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX parameter tree (HWIO convs, (in, out) linears) in the port's
    layout."""
    return {layer: {leaf: _param_leaf(leaf, arr)
                    for leaf, arr in sub.items()}
            for layer, sub in tree.items()}


def _trainables(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A ``{"params", "lslr"}`` tree (Adam's moments) in the port's layout."""
    return {"params": params_from_jax(tree["params"]),
            "lslr": tree_map(_tensor, tree["lslr"])}


def adam_state_from_optax(opt_state) -> AdamState:
    """The port's :class:`AdamState` from ``optax.adam``'s state, the tuple
    ``(ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count))``
    as numpy (read by attribute: the port does not import optax)."""
    adam, sched = opt_state[0], opt_state[1]
    count, sched_count = int(np.asarray(adam.count)), int(np.asarray(
        sched.count))
    if count != sched_count:
        raise ValueError(f"optax state counts differ: adam {count}, "
                         f"schedule {sched_count}")
    return AdamState(count=count, mu=_trainables(adam.mu),
                     nu=_trainables(adam.nu))


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
