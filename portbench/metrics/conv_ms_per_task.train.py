"""``conv_ms_per_task.train``: device milliseconds of the ``conv`` kernel
family (cuDNN's convolutions) per task in the traced sub-window."""


def read(outcome):
    t = outcome.trace
    if not t or not t.get("tasks") or not t["family_s"].get("conv"):
        return None
    return 1e3 * t["family_s"]["conv"] / t["tasks"]
