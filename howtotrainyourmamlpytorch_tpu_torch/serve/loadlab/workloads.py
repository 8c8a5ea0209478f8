"""Synthetic workloads: request arrays + shaped traffic synthesizers.

The port's own copy of the JAX package's ``serve/loadlab/workloads.py``
(the same generators, so both packages' benches synthesize identical
traffic from a seed). It imports nothing of that package.

Two layers, both deterministic:

* **Request content** — ``synthetic_arrays`` / ``tenant_pool``, the
  ONE definition of the synthetic few-shot request generators (moved
  here from scripts/serve_bench.py; serve_bench, fleet_bench and the
  replayer all import THIS copy, so a change to the workload changes
  every bench identically).
* **Traffic shape** — generators that emit trace records
  (``trace.py`` schema): a diurnal raised-cosine rate ramp sampled by
  Poisson thinning, tenant churn via a sliding active window over the
  tenant space, and burst overlays merged into an existing trace.
  Same seed, same records — the replay proofs depend on reruns
  splitting identically.

Stdlib + numpy only, no package imports — loadable by file path (the
``l2cache.py`` discipline) so the torch-free fleet frontends share these
generators without initializing an accelerator runtime.
"""

from __future__ import annotations

import math
import os
import random
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

# -- sibling trace module, resolved lazily (the router.py reqtrace
# idiom): prefer the package copy already in sys.modules, else load by
# file path under a private alias — this module must work both as a
# package member and as a bare file-path load.
_TRACE_PKG = "howtotrainyourmamlpytorch_tpu_torch.serve.loadlab.trace"
_trace_cached: Optional[Any] = None


def trace_mod() -> Any:
    global _trace_cached
    if _trace_cached is None:
        import sys
        mod = sys.modules.get(_TRACE_PKG)
        if mod is None:
            import importlib.util
            path = os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "trace.py")
            spec = importlib.util.spec_from_file_location(
                "_maml_torch_loadlab_trace", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        _trace_cached = mod
    return _trace_cached


# ---------------------------------------------------------------------------
# request content (migrated from scripts/serve_bench.py — one definition)
# ---------------------------------------------------------------------------

def synthetic_arrays(image_shape, num_classes, uint8_wire, rng, fill):
    """Raw (support_x, support_y, query_x) arrays for one synthetic
    task at ``fill`` occupancy — plain args and numpy only, so the
    torch-free fleet frontend processes can share THIS generator instead
    of forking it."""
    s, q = fill
    h, w, c = image_shape
    if uint8_wire:
        sx = rng.randint(0, 256, (s, h, w, c)).astype(np.uint8)
        qx = rng.randint(0, 256, (q, h, w, c)).astype(np.uint8)
    else:
        sx = rng.randn(s, h, w, c).astype(np.float32)
        qx = rng.randn(q, h, w, c).astype(np.float32)
    sy = (np.arange(s) % num_classes).astype(np.int32)
    return sx, sy, qx


def tenant_pool(image_shape, num_classes, uint8_wire, rng, buckets,
                num_tenants):
    """Fixed support sets, one per tenant — the "adapt once, predict
    many" population both serving benches draw repeats from. Each
    tenant keeps its support set forever; only queries are fresh."""
    pool = []
    for t in range(num_tenants):
        bucket = buckets[t % len(buckets)]
        fill = (max(1, bucket[0] - (t % 2)), max(1, bucket[1] - (t % 3)))
        sx, sy, _ = synthetic_arrays(image_shape, num_classes,
                                     uint8_wire, rng, fill)
        pool.append((sx, sy, fill[1]))
    return pool


def tenant_bucket(tenant: int, buckets: Sequence[Sequence[int]]):
    """The bucket a tenant's requests pad into — the SAME assignment
    ``tenant_pool`` uses, exposed so trace generators and replayers
    agree on it by construction."""
    return buckets[int(tenant) % len(buckets)]


# ---------------------------------------------------------------------------
# traffic shape
# ---------------------------------------------------------------------------

def diurnal_rate(t: float, period_s: float, base_rate: float,
                 peak_rate: float) -> float:
    """Offered load at trace time ``t``: a raised cosine from
    ``base_rate`` (t=0) up to ``peak_rate`` (t=period/2) and back —
    one full diurnal swing per period, smooth so the autoscaler sees a
    ramp, not a step."""
    frac = (1.0 - math.cos(2.0 * math.pi * t / period_s)) / 2.0
    return base_rate + (peak_rate - base_rate) * frac


def active_window(t: float, num_tenants: int, active_tenants: int,
                  churn_every_s: float) -> range:
    """The tenant ids active at trace time ``t``: a window of
    ``active_tenants`` ids sliding one id every ``churn_every_s``
    seconds (0 = no churn) over the ``num_tenants`` space, wrapping.
    Sliding by ONE id per step keeps the population mostly stable —
    churn means tenants arriving and leaving, not the whole audience
    being replaced."""
    if churn_every_s <= 0 or active_tenants >= num_tenants:
        return range(0, min(active_tenants, num_tenants))
    offset = int(t / churn_every_s) % num_tenants
    return range(offset, offset + active_tenants)


def gen_diurnal_trace(*, duration_s: float, base_rate: float,
                      peak_rate: float, num_tenants: int,
                      buckets: Sequence[Sequence[int]],
                      period_s: Optional[float] = None,
                      active_tenants: Optional[int] = None,
                      churn_every_s: float = 0.0,
                      deadline_ms: Optional[float] = None,
                      seed: int = 0) -> List[Dict[str, Any]]:
    """A diurnal-ramp trace with tenant churn, by Poisson thinning.

    Candidate arrivals are drawn at ``peak_rate`` (exponential gaps)
    and each is kept with probability ``rate(t)/peak_rate`` — the
    standard non-homogeneous Poisson construction, fully determined by
    ``seed``. Tenants are drawn uniformly from the sliding active
    window, so the request mix churns while individual tenants keep
    their support sets (the cache-affinity workload shape).
    """
    if peak_rate <= 0 or base_rate < 0 or base_rate > peak_rate:
        raise ValueError(
            f"need 0 <= base_rate <= peak_rate > 0, got "
            f"base={base_rate} peak={peak_rate}")
    period = float(period_s if period_s is not None else duration_s)
    act = int(active_tenants if active_tenants is not None
              else num_tenants)
    tm = trace_mod()
    rng = random.Random(seed)
    records: List[Dict[str, Any]] = []
    t = 0.0
    i = 0
    while True:
        t += rng.expovariate(peak_rate)
        if t >= duration_s:
            break
        if rng.random() >= diurnal_rate(t, period, base_rate,
                                        peak_rate) / peak_rate:
            continue
        win = active_window(t, num_tenants, act, churn_every_s)
        tenant = win[rng.randrange(len(win))] % num_tenants
        records.append(tm.trace_record(
            t, tenant, tenant_bucket(tenant, buckets),
            deadline_ms=deadline_ms,
            seed=(seed * 1_000_003 + i) & 0x7FFFFFFF))
        i += 1
    return records


def overlay_burst(records: Sequence[Dict[str, Any]], *, at_s: float,
                  duration_s: float, rate: float, num_tenants: int,
                  buckets: Sequence[Sequence[int]],
                  deadline_ms: Optional[float] = None,
                  seed: int = 0) -> List[Dict[str, Any]]:
    """A flat Poisson burst merged into an existing trace (sorted by
    arrival, stable against reruns). Bursts model the traffic the
    diurnal curve cannot: a sudden hot tenant cohort landing ON TOP of
    whatever the base shape is doing at that instant."""
    if rate <= 0 or duration_s <= 0:
        raise ValueError(
            f"burst needs rate > 0 and duration_s > 0, got "
            f"rate={rate} duration_s={duration_s}")
    tm = trace_mod()
    rng = random.Random(seed ^ 0x5EEDB0B0)
    burst: List[Dict[str, Any]] = []
    t = float(at_s)
    i = 0
    while True:
        t += rng.expovariate(rate)
        if t >= at_s + duration_s:
            break
        tenant = rng.randrange(num_tenants)
        burst.append(tm.trace_record(
            t, tenant, tenant_bucket(tenant, buckets),
            deadline_ms=deadline_ms,
            seed=(seed * 2_000_003 + i) & 0x7FFFFFFF))
        i += 1
    merged = sorted(list(records) + burst, key=lambda r: r["t"])
    return merged
