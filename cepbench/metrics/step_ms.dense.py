"""``step_ms.dense``: the mean of the port's step span on the dense pattern runtime: from the step's dispatch to its count gate resolved (ops/dense_nfa.py), over the window, in ms."""

from cepbench.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "step", 'dense')
