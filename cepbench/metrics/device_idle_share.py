"""``device_idle_share``: the share of the traced sub-window in which no
operation ran on the card (100% less the union of device activity),
from ``torch.profiler``."""


def read(ctx):
    p = ctx.get("profile")
    if not p:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
