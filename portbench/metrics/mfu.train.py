"""``mfu.train``: the whole train step's share of the card's peak, in %:
the plain reference's FLOPs per task at the cell's shapes
(``lib/costs.py``, FlopCounterMode, no recomputation) times the run's
window rate in tasks/s, over the published bf16 peak (989e12 FLOP/s)."""


def read(outcome):
    r = outcome.readings
    if "per_task" not in r:
        return None
    return 100.0 * r["per_task"]["flops"] * r["tasks_per_s"] / r["peak_flops"]
