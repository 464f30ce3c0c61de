"""``ingest_ms``: the mean of the port's ingest span: from a batch's arrival at the engine runtime (after the partition receiver) to its put and step dispatched (core/ingest_stage.py), over the window, in ms."""

from cepbench.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "ingest", None)
