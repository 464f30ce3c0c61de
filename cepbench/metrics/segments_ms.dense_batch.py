"""``segments_ms.dense_batch``: the mean of the port's ingest.segments span on the dense pattern runtime: the host sort of a batch by partition (``partition_segments``) in the batch step's ``batch_chunk`` (ops/dense_nfa.py), inside ``ingest_ms``, over the window, in ms."""

from cepbench.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "ingest.segments", "dense")
