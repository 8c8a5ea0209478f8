"""Small MLP backbone for regression workloads (counterpart of the JAX
``models/mlp.py``): the Finn et al. 2017 sinusoid network (§5.1),
``num_stages`` hidden layers ``dense{i}`` of ``cnn_num_filters`` ReLU
units and a ``linear`` head::

    init(generator)                                  -> (params, {})
    apply(params, state, x, step, training, plain=False, remat=False)
                                                     -> (out, {})

``x`` is the episode's NHWC "image" tensor with the task axis, ``(T, N,
H, W, C)`` (``(T, N, 1, 1, 1)`` x points for the sinusoid), flattened to
``(T, N, H·W·C)``; outputs are ``(T, N, out)`` f32. There are no norm
layers: the state is the empty dict and every parameter is fast under
the default algorithm. ``step``, ``training``, ``plain`` and ``remat``
are accepted for the shared backbone contract and unused (no BN kernel,
no blocks to checkpoint).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.models import layers

Params = Dict[str, Any]
State = Dict[str, Any]


def make_mlp(cfg: MAMLConfig):
    """Build (init, apply) for the MLP backbone described by ``cfg``."""
    h, w, c = cfg.image_shape
    in_features = h * w * c
    hidden = cfg.cnn_num_filters
    num_hidden = cfg.num_stages
    compute_dtype = getattr(torch, cfg.compute_dtype)

    def init(gen: torch.Generator) -> Tuple[Params, State]:
        params: Params = {}
        fan_in = in_features
        for i in range(num_hidden):
            params[f"dense{i}"] = layers.linear_init(gen, fan_in, hidden)
            fan_in = hidden
        params["linear"] = layers.linear_init(gen, fan_in,
                                              cfg.num_output_units)
        return params, {}

    def apply(params: Params, state: State, x: torch.Tensor, step: int,
              training: bool, plain: bool = False, remat: bool = False
              ) -> Tuple[torch.Tensor, State]:
        x = x.reshape(x.shape[0], x.shape[1], -1)
        for i in range(num_hidden):
            x = F.relu(layers.linear_apply(params[f"dense{i}"], x,
                                           compute_dtype=compute_dtype))
        out = layers.linear_apply(params["linear"], x,
                                  compute_dtype=compute_dtype)
        return out.float(), {}

    return init, apply
