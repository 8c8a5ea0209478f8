"""``gen_late_ms_p99.serve``: the 99th percentile of how late the
benchmark's generator submitted requests against their schedule (a
guard of the open loop's validity, not a property of the program)."""

import math

from portbench.lib.episodes import percentile


def read(outcome):
    late = [x for x in outcome.readings.get("late_seconds", ())
            if math.isfinite(x)]
    return 1e3 * percentile(late, 0.99) if late else None
