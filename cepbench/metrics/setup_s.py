"""``setup_s``: process start to the window's first hand-off (host
clock): imports, the card, the app's planning and its state, the
warm-up batches."""


def read(ctx):
    return ctx["setup_s"]
