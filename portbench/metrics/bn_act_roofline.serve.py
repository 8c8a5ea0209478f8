"""``bn_act_roofline.serve``: the BN + activation kernel's share of its
roofline while serving, in %: the least time the bytes of the requests
answered in the traced sub-window take at 3.35e12 B/s (the reference's
adapt and predict forwards, ``lib/costs.py``), over the device time of
the ``bn_act`` kernel family."""

from portbench.lib.costs import PEAK_BYTES_PER_S


def read(outcome):
    t, r = outcome.trace, outcome.readings
    if not t or not t.get("requests") or "per_request" not in r:
        return None
    kernel_s = t["family_s"].get("bn_act", 0.0)
    if kernel_s <= 0:
        return None
    bound_s = r["per_request"]["bn_bytes"] * t["requests"] / PEAK_BYTES_PER_S
    return 100.0 * bound_s / kernel_s
