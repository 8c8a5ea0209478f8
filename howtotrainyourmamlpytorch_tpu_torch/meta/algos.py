"""Meta-algorithm registry: declarative specs for one shared trainer.

The zoo (docs/ALGORITHMS.md) exists because the paper family is a
*family*: Finn et al. 2017 (arXiv:1703.03400) defines MAML, its
first-order approximation and the sinusoid-regression protocol;
Antoniou et al. 2019 (arXiv:1810.09502) is the MAML++ stabilization
point this repo's flagship reproduces; Raghu et al. 2020
(arXiv:1909.02729) shows the head-only inner loop (ANIL) matches full
MAML on classification; Nichol et al. 2018 (arXiv:1803.02999) replaces
the outer gradient with the interpolation delta (Reptile).

Each algorithm is a frozen ``AlgoSpec`` consumed by the ONE trainer /
server machinery — there are no per-algorithm train loops. The spec's
fields are *capability gates* resolved by ``MAMLConfig`` properties
(config.py § algorithm resolution), never consulted ad hoc:

- ``first_order``:   force the stop-gradient inner loop (the
                     ``use_second_order`` schedule resolves to False).
- ``msl``:           False forces the multi-step-loss schedule off.
- ``lslr_learnable``: False freezes the per-layer per-step inner LRs
                     (``lslr`` grads are zeroed; the init value —
                     ``task_learning_rate`` — is used as-is).
- ``trainable``:     ``"head"`` restricts the inner-loop fast set to
                     the classifier head (meta/inner.py §
                     split_fast_slow); the body still meta-trains in
                     the outer loop.
- ``outer``:         ``"interpolate"`` replaces the outer gradient
                     with the per-task interpolation delta θ − φ
                     (meta/outer.py § make_train_step); ``"backprop"``
                     differentiates through the inner loop.

The default spec (``maml++``) gates NOTHING: every property resolves
to exactly the pre-registry expression, so the flagship trajectory is
bitwise-pinned (tests/test_algos.py § default-path pin).

The port's own copy of the JAX package's ``meta/algos/__init__.py``
(stdlib only): ``config.py`` validates ``meta_algorithm`` against it.
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AlgoSpec:
    """Declarative description of one meta-learning algorithm."""
    name: str
    description: str
    # Outer-loop coupling: "backprop" differentiates through the inner
    # loop (first- or second-order per ``first_order`` + config DA
    # schedule); "interpolate" uses the θ − φ delta as the gradient.
    outer: str = "backprop"
    # Force the stop-gradient inner loop regardless of the config's
    # second_order / DA-schedule fields.
    first_order: bool = False
    # Capability gates over config toggles: False wins over the config.
    msl: bool = True
    lslr_learnable: bool = True
    # Inner-loop trainable mask over the TOP-LEVEL param-tree keys:
    # None = the default fast set (everything but frozen norm groups);
    # "head" = only ``HEAD_PARAM_KEYS``.
    trainable: Optional[str] = None


# The classifier/regressor head's top-level param-tree key, shared by
# every backbone (models/vgg.py, models/resnet12.py, models/mlp.py all
# name their output projection "linear").
HEAD_PARAM_KEYS: Tuple[str, ...] = ("linear",)

_REGISTRY: Dict[str, AlgoSpec] = {}


def register(spec: AlgoSpec) -> AlgoSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"meta-algorithm {spec.name!r} already registered")
    if spec.outer not in ("backprop", "interpolate"):
        raise ValueError(f"AlgoSpec.outer must be 'backprop' or "
                         f"'interpolate', got {spec.outer!r}")
    if spec.trainable not in (None, "head"):
        raise ValueError(f"AlgoSpec.trainable must be None or 'head', "
                         f"got {spec.trainable!r}")
    _REGISTRY[spec.name] = spec
    return spec


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get(name: str) -> AlgoSpec:
    """Resolve a registered algorithm; unknown names raise ValueError
    with a did-you-mean suggestion (the config.from_dict convention,
    applied to VALUES of the ``meta_algorithm`` key)."""
    spec = _REGISTRY.get(name)
    if spec is None:
        close = difflib.get_close_matches(name, _REGISTRY, n=1,
                                          cutoff=0.5)
        hint = f" — did you mean {close[0]!r}?" if close else ""
        raise ValueError(
            f"unknown meta_algorithm {name!r}{hint} "
            f"(registered: {', '.join(names())})")
    return spec


register(AlgoSpec(
    name="maml++",
    description="second-order MAML with MSL/LSLR/per-step-BN/DA "
                "(Antoniou et al. 2019) — the flagship default; gates "
                "nothing, every schedule comes from the config",
))

register(AlgoSpec(
    name="fomaml",
    description="first-order MAML (Finn et al. 2017 §5.2): "
                "stop-gradient inner loop, no second-order graph",
    first_order=True,
))

register(AlgoSpec(
    name="anil",
    description="ANIL (Raghu et al. 2020): inner loop adapts ONLY the "
                "head; body features reused frozen — shrinks the adapt "
                "executable and serve cache entries",
    trainable="head",
))

register(AlgoSpec(
    name="reptile",
    description="Reptile (Nichol et al. 2018): first-order inner SGD; "
                "the outer 'gradient' is the interpolation delta "
                "theta - phi fed to the meta-optimizer",
    outer="interpolate",
    first_order=True,
    msl=False,
    lslr_learnable=False,
))
