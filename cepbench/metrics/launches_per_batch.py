"""``launches_per_batch``: device operations (kernels, copies and fills)
a batch in the traced sub-window, from ``torch.profiler``."""


def read(ctx):
    p = ctx.get("profile")
    if not p or not p["batches"]:
        return None
    return p["n_events"] / p["batches"]
