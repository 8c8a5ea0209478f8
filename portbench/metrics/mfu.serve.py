"""``mfu.serve``: the served requests' share of the card's peak, in %: the
plain reference's FLOPs per request (adapt and predict, ``lib/costs.py``)
times the requests answered per second in the window, over the
published bf16 peak."""


def read(outcome):
    r = outcome.readings
    if "per_request" not in r:
        return None
    return (100.0 * r["per_request"]["flops"] * r["requests_per_s"]
            / r["peak_flops"])
