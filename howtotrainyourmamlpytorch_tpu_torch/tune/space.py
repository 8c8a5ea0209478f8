"""Autotune search space of the port: the knobs worth searching, declared
once (the port's copy of the JAX package's ``tune/space.py``).

A sweep point is an *assignment* — one value per axis — split into the
two channels a trial exercises:

* ``kind="xla"`` axes become backend options, ``KEY=VAL`` pairs carried
  by the config key ``xla_compiler_options`` and applied by
  ``device.numerics_policy`` (the port's counterpart of the JAX
  package's PJRT compiler options; the kind keeps the JAX spelling so
  one spec file drives both tuners), and
* ``kind="config"`` axes become :class:`MAMLConfig` field overrides
  (``remat_policy``, ``task_microbatches``, ``bn_fast_math``, ...).

Per-axis validity predicates prune assignments that cannot run before a
subprocess is spawned for them; pruned points are recorded. Every
enumeration leads with the identity assignment, the ``baseline`` trial:
the objective a winner must beat, and the untuned program the parity
gate compares against. Trial ids are the JAX package's for the same
assignment.

Stdlib only: the torch-free driver (``scripts/torch_autotune.py``)
imports it. Option syntax is checked here
(:func:`parse_compiler_options`); option names and values are checked
by the trial child, whose failure the harness counts.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

TUNE_SCHEMA = "maml_tpu_tune_v1"

# The trial id of the identity assignment (always enumerated first).
BASELINE_TRIAL_ID = "baseline"

PLATFORMS = ("cpu", "cuda")


def parse_compiler_options(pairs) -> dict:
    """Validate ``KEY=VAL`` option pairs into a dict; raises ValueError
    on malformed or repeated keys (the JAX package's rules and text)."""
    opts: dict = {}
    for kv in pairs:
        key, sep, val = str(kv).partition("=")
        if not sep or not key or not val:
            raise ValueError(
                f"--compiler-option needs KEY=VAL, got {kv!r}")
        if key in opts:
            raise ValueError(
                f"--compiler-option {key!r} given twice; repeated keys "
                f"would silently overwrite")
        opts[key] = val
    return opts


@dataclasses.dataclass(frozen=True)
class Axis:
    """One searchable knob.

    ``valid`` (optional) is a predicate ``(value, assignment) -> bool
    or str``: False/str rejects the full assignment (a str is the
    recorded reason). It sees the whole assignment, so cross-axis
    constraints live on the axis that owns them.
    """
    name: str
    values: Tuple[Any, ...]
    kind: str = "config"  # "xla" (backend options) | "config"

    valid: Optional[Callable[[Any, Dict[str, Any]], Any]] = None

    def __post_init__(self):
        if self.kind not in ("xla", "config"):
            raise ValueError(
                f"axis {self.name!r}: kind must be 'xla' or 'config', "
                f"got {self.kind!r}")
        if not self.values:
            raise ValueError(f"axis {self.name!r} has no values")
        if len(set(map(repr, self.values))) != len(self.values):
            raise ValueError(f"axis {self.name!r} repeats a value")


@dataclasses.dataclass(frozen=True)
class Trial:
    """One enumerated sweep point, id'd by its canonical assignment."""
    trial_id: str
    assignment: Dict[str, Any]            # axis name -> value
    compiler_options: Dict[str, str]      # the backend-option channel
    config_overrides: Dict[str, Any]      # the config channel


def trial_id(assignment: Dict[str, Any]) -> str:
    """Stable content id of an assignment: the ledger key, so a resumed
    sweep recognizes completed points in any enumeration order."""
    if not assignment:
        return BASELINE_TRIAL_ID
    blob = json.dumps(assignment, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


class SearchSpace:
    """Cartesian product of axes, validity-pruned, baseline-first."""

    def __init__(self, axes: Sequence[Axis]):
        names = [a.name for a in axes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate axis name in {names}")
        self.axes = tuple(axes)

    def enumerate(self) -> Tuple[List[Trial], List[Dict[str, Any]]]:
        """(trials, pruned): trials leads with the baseline; pruned
        records every validity-rejected assignment with the refusing
        axis and reason."""
        trials = [Trial(BASELINE_TRIAL_ID, {}, {}, {})]
        pruned: List[Dict[str, Any]] = []
        for combo in itertools.product(*(a.values for a in self.axes)):
            assignment = {a.name: v for a, v in zip(self.axes, combo)}
            reason = self._rejection(assignment)
            if reason is not None:
                pruned.append({"assignment": assignment, **reason})
                continue
            xla, cfg = self.split(assignment)
            trials.append(Trial(trial_id(assignment), assignment,
                                xla, cfg))
        return trials, pruned

    def _rejection(self, assignment: Dict[str, Any]
                   ) -> Optional[Dict[str, str]]:
        for a in self.axes:
            if a.valid is None:
                continue
            verdict = a.valid(assignment[a.name], assignment)
            if verdict is True or verdict is None:
                continue
            return {"axis": a.name,
                    "reason": (verdict if isinstance(verdict, str)
                               else "axis validity predicate")}
        return None

    def split(self, assignment: Dict[str, Any]
              ) -> Tuple[Dict[str, str], Dict[str, Any]]:
        """(backend options, config overrides) for one assignment; the
        option channel is held to the ``KEY=VAL`` rules, so a malformed
        axis name fails at enumeration."""
        xla: Dict[str, str] = {}
        cfg: Dict[str, Any] = {}
        for a in self.axes:
            v = assignment[a.name]
            if a.kind == "xla":
                xla[a.name] = str(v)
            else:
                cfg[a.name] = v
        parse_compiler_options([f"{k}={v}" for k, v in xla.items()])
        return xla, cfg


def _microbatch_valid(per_device_tasks: int):
    def check(value, assignment):
        if int(per_device_tasks) % int(value) == 0:
            return True
        return (f"task_microbatches {value} does not divide the "
                f"per-device task count {per_device_tasks}")
    return check


def default_space(platform: str = "cuda",
                  per_device_tasks: int = 12) -> SearchSpace:
    """The port's in-tree knobs: the four remat policies, the
    accumulation chunk count, the fast-math BN fold and, on the card,
    the ``cudnn_deterministic`` backend option. The CPU carries no
    backend axis: the cuDNN switches change nothing there."""
    if platform not in PLATFORMS:
        raise ValueError(f"platform must be one of {PLATFORMS}, got "
                         f"{platform!r}")
    axes = [
        Axis("remat_policy",
             ("nothing", "dots", "conv_outs", "block_outs")),
        Axis("task_microbatches", (1, 2, 3, 4),
             valid=_microbatch_valid(per_device_tasks)),
        Axis("bn_fast_math", (False, True)),
    ]
    if platform == "cuda":
        axes.append(Axis("cudnn_deterministic", ("true", "false"),
                         kind="xla"))
    return SearchSpace(axes)


def space_from_spec(spec: Dict[str, Any]) -> SearchSpace:
    """Build a space from a JSON spec, the ``--space`` file format:

        {"axes": [{"name": ..., "kind": "xla"|"config",
                   "values": [...]}, ...]}

    Spec axes carry no predicates; an invalid point in a spec file is a
    deliberate sweep member (how a crash-isolation proof injects a
    known-bad option)."""
    axes_spec = spec.get("axes")
    if not isinstance(axes_spec, list) or not axes_spec:
        raise ValueError("space spec needs a non-empty 'axes' list")
    axes = []
    for a in axes_spec:
        try:
            axes.append(Axis(name=str(a["name"]),
                             values=tuple(a["values"]),
                             kind=str(a.get("kind", "config"))))
        except KeyError as e:
            raise ValueError(f"space spec axis missing {e}") from None
    return SearchSpace(axes)
