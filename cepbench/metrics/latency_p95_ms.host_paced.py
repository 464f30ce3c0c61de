"""``latency_p95_ms.host_paced``: the 95th percentile, over the traced
run's window batches that complete an output row, of the time from a
batch's hand-off to the delivery of the last row it completes (host
clock).  A row names its batch by its event time (each batch owns its
span of timestamps).  A per-layer reading: the host paces the tail, and
its runs spread too widely for an end-to-end bound."""

import numpy as np


def delivered(ctx) -> dict:
    """Batch index -> host time of the last callback holding its rows."""
    tr = ctx["traffic"]
    last = {}
    for t, ts, _cols in ctx["received"]:
        if len(ts) == 0:
            continue
        lo, hi = tr.batch_of_ts(np.array([np.min(ts), np.max(ts)]))
        for b in (range(lo, hi + 1) if hi - lo < 2
                  else np.unique(tr.batch_of_ts(ts))):
            last[int(b)] = t
    return last


def read(ctx):
    last = delivered(ctx)
    lat = [last[i] - t for i, t, _r in ctx["hand"] if i in last]
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95) * 1e3)
