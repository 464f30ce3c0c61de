"""``round_dispatch_ms.dense``: the mean of the port's step.round span on the dense pattern runtime: the host dispatch of one collision round's general step (ops/dense_nfa.py ``_process_general``), inside ``ingest_ms``, over the window, in ms."""

from cepbench.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "step.round", "dense")
