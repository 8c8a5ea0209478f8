"""Divergence guard: host-side NaN/Inf + loss-spike detection (the port's
copy of the JAX package's ``resilience/guard.py``).

The guard watches the outer-loss scalar the experiment loop already
fetches at its dispatch-sync points (``dispatch_sync_every``), so
detection adds no device work: ``patience`` consecutive bad observations
(non-finite loss, or — when ``spike_factor`` > 1 — loss above
``spike_factor`` times the running median of recent good losses) make
:meth:`observe` return True, and ``ExperimentBuilder._perform_rewind``
rewinds to the last-good epoch checkpoint.

With the training-health metrics on (``telemetry/health.py``,
``health_metrics_every_n_steps``) the guard also observes the outer-grad
global norm through :meth:`observe_grad_norm`: an early warning (one log
row and a counter, before any NaN-triggered rewind) that never changes
recovery.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Deque

from howtotrainyourmamlpytorch_tpu_torch import resilience

# Spike detection needs a few good observations before the median means
# anything; until then only non-finite losses count as bad.
_MIN_HISTORY = 5
# Recent good losses the spike median is taken over.
_WINDOW = 32


class DivergenceGuard:
    """Decides when the outer loss has diverged. Not thread-safe by
    design — exactly one train loop feeds it."""

    def __init__(self, patience: int = 2, spike_factor: float = 0.0,
                 grad_norm_factor: float = 10.0):
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        if spike_factor != 0.0 and spike_factor <= 1.0:
            raise ValueError(
                f"spike_factor must be 0 (off) or > 1, got {spike_factor}")
        if grad_norm_factor != 0.0 and grad_norm_factor <= 1.0:
            raise ValueError(
                f"grad_norm_factor must be 0 (non-finite-only) or > 1, "
                f"got {grad_norm_factor}")
        self.patience = int(patience)
        self.spike_factor = float(spike_factor)
        self.grad_norm_factor = float(grad_norm_factor)
        self._history: Deque[float] = deque(maxlen=_WINDOW)
        self._norm_history: Deque[float] = deque(maxlen=_WINDOW)
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
        if not math.isfinite(loss):
            resilience.counter_inc("resilience/nan_steps")
            bad = True
        elif self._is_spike(loss):
            resilience.counter_inc("resilience/loss_spikes")
            bad = True
        else:
            bad = False
        if not bad:
            self._history.append(loss)
            self._bad_streak = 0
            return False
        self._bad_streak += 1
        if self._bad_streak >= self.patience:
            self.reset()
            return True
        return False

    def observe_grad_norm(self, norm: float) -> bool:
        """Feed one outer-grad global norm (the health diagnostic); True ⇒
        warn now. Warns on a non-finite norm, or — when
        ``grad_norm_factor`` > 1 — on a norm above factor x the running
        median of recent healthy norms (bad observations stay out of the
        history). Counts ``health/grad_norm_warn``; never rewinds."""
        norm = float(norm)
        bad = not math.isfinite(norm)
        if not bad and self.grad_norm_factor \
                and len(self._norm_history) >= _MIN_HISTORY:
            ordered = sorted(self._norm_history)
            median = ordered[len(ordered) // 2]
            bad = median > 0 and norm > self.grad_norm_factor * median
        if bad:
            resilience.counter_inc("health/grad_norm_warn")
            return True
        self._norm_history.append(norm)
        return False

    def reset(self) -> None:
        """Forget streaks and history (after a rewind the loss scale may
        legitimately differ — stale medians must not re-trigger)."""
        self._bad_streak = 0
        self._history.clear()
        self._norm_history.clear()
