"""Meta-training state (counterpart of the JAX ``meta/outer.py``).

Only what serving needs is ported so far: the state and its
initialization. The optimizer state (``opt_state``) and the outer step
come with the training slice (ROADMAP.md, port queue).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.device import (DeviceLike,
                                                        resolve_device)
from howtotrainyourmamlpytorch_tpu_torch.meta.inner import (lslr_init,
                                                            split_fast_slow)
from howtotrainyourmamlpytorch_tpu_torch.tree import tree_map

Params = Dict[str, Any]


@dataclass
class MetaTrainState:
    """Network params (slow + fast canonical), per-leaf per-step inner LRs,
    per-step BN running stats, and the outer iteration counter."""
    params: Params
    lslr: Params
    bn_state: Params
    step: int = 0

    def to(self, device: torch.device) -> "MetaTrainState":
        move = lambda t: t.to(device)
        return MetaTrainState(params=tree_map(move, self.params),
                              lslr=tree_map(move, self.lslr),
                              bn_state=tree_map(move, self.bn_state),
                              step=self.step)


def init_train_state(cfg: MAMLConfig, model_init, seed: int,
                     device: DeviceLike = None) -> MetaTrainState:
    """Fresh state from the model's initializer, seeded through a
    ``torch.Generator``; placed on ``device`` (the card by default)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    params, bn_state = model_init(gen)
    fast0, _ = split_fast_slow(cfg, params)
    state = MetaTrainState(params=params, lslr=lslr_init(cfg, fast0),
                           bn_state=bn_state)
    return state.to(device)
