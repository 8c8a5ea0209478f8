"""The work the benchmark counts, from the plain reference at the cell's
shapes: never from the program's counters, so a change to the program's
recomputation, chunking or kernels cannot move the yardstick.

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the
  reference's work for ONE task (a training task's outer step: support
  steps, target loss and the outer gradient; a served request: the
  first-order adapt steps and the query forward), run on the ``meta``
  device, so nothing is computed. Adam and the elementwise work are not
  counted (FlopCounterMode counts convolutions and matrix products).
* BN bytes: for every batch norm + activation the reference applies in
  that work's forwards (the backward runs no BN kernel), its input
  read once and its output written once in the configuration's compute
  dtype, and gamma, beta, mean and variance (float32) once each.

Published peaks of one H100 SXM (NVIDIA's data sheet, dense): 989e12
bf16 FLOP/s and 3.35e12 HBM bytes/s, at the full 700 W power limit.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.reference import maml
from portbench.reference.model import Hyper, Numerics, param_shapes

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def _meta_state(hp: Hyper):
    dev = torch.device("meta")
    params = {n: {l: torch.empty(s, device=dev) for l, s in sub.items()}
              for n, sub in param_shapes(hp).items()}
    lslr = {n: {l: torch.empty(hp.lslr_rows, device=dev) for l in sub}
            for n, sub in params.items() if "norm" not in n}
    return params, lslr


def _images(hp: Hyper, count: int) -> torch.Tensor:
    return torch.empty((count, *hp.image_shape), dtype=torch.uint8,
                       device="meta")


def _labels(hp: Hyper, count: int) -> torch.Tensor:
    return torch.zeros(count, dtype=torch.long, device="meta")


def train_task(hp: Hyper, *, second_order: bool, use_msl: bool,
               epoch: int) -> Tuple[float, List[Tuple[int, int]]]:
    """``(FLOPs, BN applications)`` of one task's share of an outer
    step."""
    from torch.utils.flop_counter import FlopCounterMode
    params, lslr = _meta_state(hp)
    s = hp.num_classes * hp.shots
    t = hp.num_classes * hp.targets
    batch = (_images(hp, s)[None], _labels(hp, s)[None],
             _images(hp, t)[None], _labels(hp, t)[None])
    log: List[Tuple[int, int]] = []
    state = maml.init_state(params, lslr)
    with FlopCounterMode(display=False) as mode:
        maml.meta_gradients(hp, state, batch, second_order=second_order,
                            use_msl=use_msl, epoch=epoch,
                            n=Numerics(bn_log=log))
    return float(mode.get_total_flops()), log


def serve_request(hp: Hyper) -> Tuple[float, List[Tuple[int, int]]]:
    """``(FLOPs, BN applications)`` of one served request."""
    from torch.utils.flop_counter import FlopCounterMode
    params, lslr = _meta_state(hp)
    s = hp.num_classes * hp.shots
    q = hp.num_classes * hp.targets
    log: List[Tuple[int, int]] = []
    with FlopCounterMode(display=False) as mode:
        maml.adapt_predict(hp, params, lslr, _images(hp, s), _labels(hp, s),
                           _images(hp, q), Numerics(bn_log=log))
    return float(mode.get_total_flops()), log


def bn_bytes(hp: Hyper, applications: List[Tuple[int, int]]) -> float:
    """Bytes the BN + activation applications must move, each once."""
    item = _ITEMSIZE[hp.compute_dtype]
    return float(sum(2 * r * c * item + 4 * c * 4
                     for r, c in applications))


def per_unit(hp: Hyper, unit: str, **phase) -> Dict[str, float]:
    """``{"flops", "bn_bytes"}`` of one training task (``unit='task'``,
    with the phase's ``second_order``, ``use_msl`` and ``epoch``) or one
    served request (``unit='request'``)."""
    if unit == "task":
        flops, log = train_task(hp, **phase)
    else:
        flops, log = serve_request(hp)
    return {"flops": flops, "bn_bytes": bn_bytes(hp, log)}
