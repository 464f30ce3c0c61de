"""``emit_fetch_ms``: the mean of the port's emit.fetch span: one drain round's coalesced fetch of the pending batches' outputs, the wait for their steps and the device-to-host copy (core/emit_queue.py), inside ``emit_ms``, over the window, in ms."""

from cepbench.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "emit.fetch", None)
