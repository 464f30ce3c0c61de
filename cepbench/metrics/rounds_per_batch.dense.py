"""``rounds_per_batch.dense``: collision rounds a batch on the dense pattern runtime: the count of the port's step.round spans over the count of its step spans in the window (both recorded on every batch of a ``--trace 1`` run)."""


def read(ctx):
    spans = ctx.get("spans")
    if (not spans or "step.round" not in spans
            or "dense" not in ctx.get("span_engines", ())):
        return None
    rounds, steps = spans["step.round"][0], spans["step"][0]
    return rounds / steps if steps else None
