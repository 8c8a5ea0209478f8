"""Autotune subsystem of the port (the JAX package's ``tune/``).

Searches the joint space of backend options (the cuDNN switches of
``device.BACKEND_OPTIONS``, carried by the ``xla_compiler_options``
config key) and structural config knobs (remat policy, task
microbatching, fast-math BN) for a faster train step, with every trial
crash-isolated in a process group and the winner adopted only through
parity and accuracy gates:

* :mod:`~.space` — axes, validity pruning, ``parse_compiler_options``;
* :mod:`~.harness` — the trial, parity and accuracy legs as children,
  outcome classification;
* :mod:`~.record` — the resumable ``TUNE.json`` ledger and the
  ``TUNED.json`` adoption record;
* :mod:`~.trial` — the trial leg itself (imports torch; run as
  ``python -m howtotrainyourmamlpytorch_tpu_torch.tune.trial``);
* :mod:`~.points` — the perf sweeps' measurement core (a grid's points,
  each timed eager and through its CUDA graph, on :mod:`~.trial`).

This package's ``__init__`` and the first three modules are stdlib only:
the driver (``scripts/torch_autotune.py``) runs torch-free.
"""

from howtotrainyourmamlpytorch_tpu_torch.tune.space import (
    Axis, SearchSpace, Trial, default_space, parse_compiler_options,
    space_from_spec, trial_id)
from howtotrainyourmamlpytorch_tpu_torch.tune.record import (
    TrialLedger, decide_adoption, read_tuned, write_tuned)

__all__ = [
    "Axis", "SearchSpace", "Trial", "TrialLedger", "decide_adoption",
    "default_space", "parse_compiler_options", "read_tuned",
    "space_from_spec", "trial_id", "write_tuned",
]
