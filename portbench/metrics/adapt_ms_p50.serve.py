"""``adapt_ms_p50.serve``: the median of the engine's own adapt timings in
the window (``serve/engine.py § _run_adapt``: one padded batch of
misses, closed by a synchronize; the values its ``serve/adapt_seconds``
histogram observes)."""

import statistics


def read(outcome):
    s = outcome.readings.get("adapt_seconds")
    return 1e3 * statistics.median(s) if s else None
