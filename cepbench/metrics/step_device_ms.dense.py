"""``step_device_ms.dense``: the mean of the port's step.device span on the dense pattern runtime: the time the card's stream took from just before a batch's put to just after its last collision round (two timing events, on the host clock through the tracer's device anchor), launch gaps included, over the window, in ms."""

from cepbench.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "step.device", "dense")
