"""``events_per_s``: every event handed to ``send_batch`` in the window,
over the time from the first hand-off to the end of the drain that
delivered the window's last output (host clock)."""


def read(ctx):
    hand = ctx["hand"]
    return len(hand) * ctx["traffic"].B / (ctx["t_end"] - hand[0][1])
