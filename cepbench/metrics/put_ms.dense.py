"""``put_ms.dense``: the mean of the port's ingest.put span on the dense pattern runtime: the host time of the engine's ``staged_put`` of a batch's inputs (ops/dense_nfa.py), inside ``ingest_ms``, over the window, in ms."""

from cepbench.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "ingest.put", "dense")
