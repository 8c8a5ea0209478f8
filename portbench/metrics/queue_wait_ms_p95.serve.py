"""``queue_wait_ms_p95.serve``: the 95th percentile of the engine's
``serve/queue_wait_seconds`` histogram over the window's requests (from
admission to dequeue), as the histogram gives it: the upper bound of
the bucket holding the nearest-rank sample."""

import math


def read(outcome):
    bounds, counts = outcome.readings.get("queue_wait", ([], []))
    n = sum(counts)
    if not n:
        return None
    rank, seen = max(math.ceil(0.95 * n), 1), 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= rank:
            return 1e3 * bounds[min(i, len(bounds) - 1)]
    return None
