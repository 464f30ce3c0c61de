"""``emit_ms``: the mean of the port's emit span: from a drain's coalesced fetch to the batch materialized and handed to the selector and callbacks (core/emit_queue.py), over the window, in ms."""

from cepbench.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "emit", None)
