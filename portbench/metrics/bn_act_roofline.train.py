"""``bn_act_roofline.train``: the BN + activation kernel's share of its
roofline in the traced sub-window, in %: the least time the bytes the
reference's step needs take at 3.35e12 B/s (``lib/costs.py``: each input
read once, each output written once, no recomputation) for the tasks
traced, over the device time of the ``bn_act`` kernel family."""

from portbench.lib.costs import PEAK_BYTES_PER_S


def read(outcome):
    t, r = outcome.trace, outcome.readings
    if not t or not t.get("tasks") or "per_task" not in r:
        return None
    kernel_s = t["family_s"].get("bn_act", 0.0)
    if kernel_s <= 0:
        return None
    bound_s = r["per_task"]["bn_bytes"] * t["tasks"] / PEAK_BYTES_PER_S
    return 100.0 * bound_s / kernel_s
