"""``elementwise_ms_per_task.train``: device milliseconds of the
``elementwise/other`` and ``reduce`` kernel families (the BN VJP's
pointwise ops and column sums, and every other pointwise torch op) per
task in the traced sub-window."""

FAMILIES = ("elementwise/other", "reduce")


def read(outcome):
    t = outcome.trace
    if not t or not t.get("tasks"):
        return None
    s = sum(t["family_s"].get(f, 0.0) for f in FAMILIES)
    return 1e3 * s / t["tasks"] if s > 0 else None
