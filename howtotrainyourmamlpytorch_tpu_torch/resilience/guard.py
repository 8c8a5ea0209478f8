"""Divergence guard: host-side NaN/Inf + loss-spike detection (the port's
copy of the JAX package's ``resilience/guard.py``).

The guard watches the outer-loss scalar the experiment loop already
fetches at its dispatch-sync points (``dispatch_sync_every``), so
detection adds no device work: ``patience`` consecutive bad observations
(non-finite loss, or — when ``spike_factor`` > 1 — loss above
``spike_factor`` times the running median of recent good losses) make
:meth:`observe` return True, and ``ExperimentBuilder._perform_rewind``
rewinds to the last-good epoch checkpoint.

The grad-norm early warning (``observe_grad_norm``) goes with the
training-health metrics (ROADMAP.md, Queue 1: telemetry slice).
"""

from __future__ import annotations

import math
from collections import deque
from typing import Deque

# Spike detection needs a few good observations before the median means
# anything; until then only non-finite losses count as bad.
_MIN_HISTORY = 5
# Recent good losses the spike median is taken over.
_WINDOW = 32


class DivergenceGuard:
    """Decides when the outer loss has diverged. Not thread-safe by
    design — exactly one train loop feeds it."""

    def __init__(self, patience: int = 2, spike_factor: float = 0.0):
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        if spike_factor != 0.0 and spike_factor <= 1.0:
            raise ValueError(
                f"spike_factor must be 0 (off) or > 1, got {spike_factor}")
        self.patience = int(patience)
        self.spike_factor = float(spike_factor)
        self._history: Deque[float] = deque(maxlen=_WINDOW)
        self._bad_streak = 0

    def _is_spike(self, loss: float) -> bool:
        if not self.spike_factor or len(self._history) < _MIN_HISTORY:
            return False
        ordered = sorted(self._history)
        median = ordered[len(ordered) // 2]
        return median > 0 and loss > self.spike_factor * median

    def observe(self, loss: float, step: int) -> bool:
        """Feed one outer-loss scalar; True ⇒ rewind now (and the guard
        has reset itself for the post-rewind stream)."""
        loss = float(loss)
        bad = not math.isfinite(loss) or self._is_spike(loss)
        if not bad:
            self._history.append(loss)
            self._bad_streak = 0
            return False
        self._bad_streak += 1
        if self._bad_streak >= self.patience:
            self.reset()
            return True
        return False

    def reset(self) -> None:
        """Forget streaks and history (after a rewind the loss scale may
        legitimately differ — stale medians must not re-trigger)."""
        self._bad_streak = 0
        self._history.clear()
