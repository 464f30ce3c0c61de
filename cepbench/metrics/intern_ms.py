"""``intern_ms``: the mean of the port's intern span: the dense pattern runtime's interning of a batch's partition keys to its state rows (core/dense_pattern.py ``intern_keys``, inside ``send_ms`` and before ``ingest_ms``), over the window, in ms."""

from cepbench.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "intern", "dense")
