"""``emit_deliver_ms``: the mean of the port's emit.deliver span: one batch's materialize, selector and callbacks after its fetch (core/emit_queue.py), inside ``emit_ms``, over the window, in ms."""

from cepbench.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "emit.deliver", None)
