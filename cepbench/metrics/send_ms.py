"""``send_ms``: the mean host time of one ``send_batch`` call in the
window (the harness's own span around each hand-off): the input handler,
the partition receiver's key interning, the ingest stage and whatever
step waits and emits the call drains."""


def read(ctx):
    hand = ctx["hand"]
    return 1e3 * sum(r - t for _i, t, r in hand) / len(hand)
