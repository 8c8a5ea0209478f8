"""Resilience pieces the trainer uses: retry/backoff for storage IO and the
divergence guard (the port's own copies of the JAX package's
``resilience/retry.py`` and ``resilience/guard.py``).

Not ported yet (ROADMAP.md, Queue 1: resilience/ckpt slice): fault
injection, the watchdog and flight recorder, the pod fault domain and the
registry counters these modules count into.
"""

from __future__ import annotations

from howtotrainyourmamlpytorch_tpu_torch.resilience.guard import (
    DivergenceGuard)
from howtotrainyourmamlpytorch_tpu_torch.resilience.retry import (
    backoff_delay, retry_io)

# Exit code for "preempted, checkpointed, restart me" — EX_TEMPFAIL, so
# schedulers/wrappers can distinguish a clean preemption (resubmit with
# continue_from_epoch='latest') from success (0) and real failure (1).
EXIT_PREEMPTED = 75

__all__ = ["EXIT_PREEMPTED", "DivergenceGuard", "backoff_delay", "retry_io"]
