"""The weights both sides start from, made from the seed on the device.

One ``torch.Generator`` on the run's device draws one uniform buffer for
all tables (a few large calls, no host copy), sliced into the backbone's
tables (``reference/model.py § param_shapes``): convolution and linear
weights Xavier-uniform, biases zero (as the models initialize them),
per-step BN gamma in [0.9, 1.1] and beta in [-0.1, 0.1], and each LSLR
vector's rows in [0.5, 1.5] x ``task_learning_rate``, so that a wrong
BN row or LSLR row shows in the outputs. The BN running statistics are
zero mean and unit variance.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from portbench.reference.model import Hyper, is_fast, param_shapes

Tree = Dict[str, Dict[str, torch.Tensor]]


def sub_seed(seed: int, tag: int) -> int:
    """Independent streams of one seed (weights, data, arrivals, ...)."""
    return (int(seed) * 1_000_003 + tag) % 2 ** 63


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number
    below 2**64)."""
    return torch.Generator(device=device).manual_seed(int(seed) % 2 ** 64)


def _fans(shape: Tuple[int, ...]) -> Tuple[int, int]:
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


def make(hp: Hyper, seed: int, device) -> Tuple[Tree, Tree, Tree]:
    """``(params, lslr, bn_state)`` in float32 on ``device``."""
    shapes = param_shapes(hp)
    sizes = []
    for name, sub in shapes.items():
        for leaf, shape in sub.items():
            sizes.append(math.prod(shape))
    lslr_rows = hp.lslr_rows
    n_lslr = sum(len(sub) for name, sub in shapes.items() if is_fast(name))
    u = torch.rand(sum(sizes) + n_lslr * lslr_rows, generator=generator(
        seed, device), device=device, dtype=torch.float32)
    params: Tree = {}
    at = 0
    for name, sub in shapes.items():
        params[name] = {}
        for leaf, shape in sub.items():
            n = math.prod(shape)
            chunk = u[at:at + n].view(shape)
            at += n
            if leaf == "w":
                fan_in, fan_out = _fans(shape)
                limit = math.sqrt(6.0 / (fan_in + fan_out))
                params[name][leaf] = (chunk * 2.0 - 1.0) * limit
            elif leaf == "b":
                params[name][leaf] = torch.zeros(shape, device=device)
            elif leaf == "gamma":
                params[name][leaf] = 0.9 + 0.2 * chunk
            else:
                params[name][leaf] = 0.2 * chunk - 0.1
    lslr: Tree = {}
    for name, sub in shapes.items():
        if not is_fast(name):
            continue
        lslr[name] = {}
        for leaf in sub:
            lslr[name][leaf] = hp.task_lr * (0.5 + u[at:at + lslr_rows])
            at += lslr_rows
    bn_state: Tree = {
        name: {"mean": torch.zeros(sub["gamma"], device=device),
               "var": torch.ones(sub["gamma"], device=device)}
        for name, sub in shapes.items() if not is_fast(name)}
    return params, lslr, bn_state


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return tree.detach().clone()
