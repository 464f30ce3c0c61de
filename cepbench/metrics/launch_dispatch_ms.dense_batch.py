"""``launch_dispatch_ms.dense_batch``: the mean of the port's step.launch span on the dense pattern runtime: the host dispatch of the batch step's filter matrix, its one ``batch_step`` launch and its output columns (ops/dense_nfa.py ``batch_chunk``), inside ``ingest_ms``, over the window, in ms."""

from cepbench.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "step.launch", "dense")
