"""Carry the JAX package's parameters over to the port.

:func:`state_from_jax` takes the JAX package's ``params``, ``lslr`` and
``bn_state`` trees as numpy arrays (``jax.device_get`` of them, or a
checkpoint's arrays) and returns the port's :class:`MetaTrainState`:
HWIO conv kernels become OIHW, ``(in, out)`` linear weights become
``(out, in)``. Leaf names are kept, so the LSLR vectors map one to one.
Both packages flatten features in NHWC order, so the linear's input
dimension needs no permutation.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from howtotrainyourmamlpytorch_tpu_torch.device import (DeviceLike,
                                                        resolve_device)
from howtotrainyourmamlpytorch_tpu_torch.meta.outer import MetaTrainState
from howtotrainyourmamlpytorch_tpu_torch.tree import tree_map


def _param_leaf(layer: str, leaf: str, arr) -> torch.Tensor:
    a = np.asarray(arr, dtype=np.float32)
    if leaf == "w" and a.ndim == 4:          # conv HWIO -> OIHW
        a = a.transpose(3, 2, 0, 1)
    elif leaf == "w" and a.ndim == 2:        # linear (in, out) -> (out, in)
        a = a.T
    return _tensor(a)


def _tensor(arr) -> torch.Tensor:
    """A C-contiguous f32 copy (the source may be a read-only view)."""
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))


def state_from_jax(params: Dict[str, Any], lslr: Dict[str, Any],
                   bn_state: Dict[str, Any], step: int = 0,
                   device: DeviceLike = None) -> MetaTrainState:
    """The port's state from the JAX package's numpy trees, on ``device``
    (the card by default)."""
    device = resolve_device(device)
    tparams = {layer: {leaf: _param_leaf(layer, leaf, arr)
                       for leaf, arr in sub.items()}
               for layer, sub in params.items()}
    state = MetaTrainState(params=tparams, lslr=tree_map(_tensor, lslr),
                           bn_state=tree_map(_tensor, bn_state),
                           step=int(step))
    return state.to(device)
