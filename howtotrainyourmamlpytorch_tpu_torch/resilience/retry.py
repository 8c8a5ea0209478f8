"""Jittered exponential backoff for storage IO (the port's copy of the JAX
package's ``resilience/retry.py``).

Shared-filesystem IO (NFS, FUSE mounts) fails transiently; a training run
must not die because one ``state.json`` write hit a short mount hiccup.
``utils/storage.py`` and ``utils/checkpoint.py`` decorate their read/write
primitives with :func:`retry_io`:

* bounded retries (``MAML_IO_RETRIES``, default 3 — 4 attempts total);
* exponential backoff with multiplicative jitter so processes retrying the
  same flaky mount do not re-stampede it in lockstep;
* ``FileNotFoundError`` gives up immediately — a missing file
  is control flow (fallback/fresh-run detection), not a transient fault;
* invalid env knob values (non-numeric, negative) warn once and fall back
  to the defaults.

Retries are NOT applied to append-style writes (``save_statistics``): a
retry after a partial append would duplicate the row. Every retry counts
``resilience/io_retries`` and every exhaustion ``resilience/io_giveups``
in the installed telemetry registry (``resilience.set_registry``).
"""

from __future__ import annotations

import functools
import math
import os
import random
import time
import warnings
import zlib

from howtotrainyourmamlpytorch_tpu_torch import resilience

_warned_env = set()


def _env_number(name: str, default, cast, minimum=0):
    """Parse a numeric env knob, falling back to ``default`` (with ONE
    warning per knob per process) on invalid values — non-numeric or
    below ``minimum``."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        value = cast(raw)
        if not math.isfinite(value) or value < minimum:
            raise ValueError("non-finite or below minimum")
    except (TypeError, ValueError):
        if name not in _warned_env:
            _warned_env.add(name)
            warnings.warn(
                f"invalid {name}={raw!r} (need a {cast.__name__} "
                f">= {minimum}); using the default {default}",
                stacklevel=2)
        return default
    return value


DEFAULT_RETRIES = _env_number("MAML_IO_RETRIES", 3, int)
# Zero delays are invalid too (backoff_delay rejects base/cap <= 0).
DEFAULT_BASE_S = _env_number("MAML_IO_RETRY_BASE_S", 0.02, float,
                             minimum=1e-6)
DEFAULT_CAP_S = _env_number("MAML_IO_RETRY_CAP_S", 2.0, float,
                            minimum=1e-6)
DEFAULT_FACTOR = 2.0
DEFAULT_JITTER_FRAC = 0.5


def backoff_delay(attempt: int, base: float = DEFAULT_BASE_S,
                  factor: float = DEFAULT_FACTOR,
                  cap: float = DEFAULT_CAP_S,
                  jitter_frac: float = DEFAULT_JITTER_FRAC,
                  rng: random.Random = None) -> float:
    """Sleep before retry ``attempt`` (0-based): ``base * factor**attempt``
    capped at ``cap``, then scaled by a jitter factor drawn uniformly
    from ``[1, 1 + jitter_frac]``. Jitter multiplies AFTER the cap so the
    worst case stays bounded by ``cap * (1 + jitter_frac)``."""
    if attempt < 0:
        raise ValueError(f"attempt must be >= 0, got {attempt}")
    if base <= 0 or factor < 1 or cap <= 0 or jitter_frac < 0:
        raise ValueError(
            f"invalid backoff spec (base={base}, factor={factor}, "
            f"cap={cap}, jitter_frac={jitter_frac})")
    delay = min(base * factor ** attempt, cap)
    if jitter_frac and rng is not None:
        delay *= 1.0 + rng.random() * jitter_frac
    return delay


def retry_io(description: str):
    """Decorator: retry a transiently-failing idempotent IO callable on
    ``OSError``, up to ``DEFAULT_RETRIES`` times with :func:`backoff_delay`
    between attempts. ``FileNotFoundError`` re-raises at once (it IS an
    ``OSError``, but retrying a missing file only delays the caller's
    fallback logic)."""
    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            # Jitter seed = site ⊕ pid: deterministic within a process,
            # different across processes.
            rng = random.Random(zlib.crc32(description.encode())
                                ^ (os.getpid() << 16))
            for attempt in range(DEFAULT_RETRIES + 1):
                try:
                    return fn(*args, **kwargs)
                except FileNotFoundError:
                    raise
                except OSError as e:
                    if attempt >= DEFAULT_RETRIES:
                        resilience.counter_inc("resilience/io_giveups")
                        raise
                    resilience.counter_inc("resilience/io_retries")
                    warnings.warn(
                        f"{description}: {type(e).__name__}: {e} — "
                        f"retry {attempt + 1}/{DEFAULT_RETRIES}",
                        stacklevel=2)
                    time.sleep(backoff_delay(attempt, rng=rng))
            raise AssertionError("unreachable")  # loop always returns/raises
        return wrapper
    return decorate
