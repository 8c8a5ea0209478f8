"""``idle_frac.serve``: the share of the traced sub-window in which no kernel ran
on the device, 1 - (union of kernel intervals / window)."""


def read(outcome):
    t = outcome.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
