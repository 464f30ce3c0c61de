"""``kernel_ms.dense_batch``: the device time of ``dense_batch_kernel``
(the port's kernel 1, one launch a batch) a batch of the traced
sub-window, from ``torch.profiler``, in ms."""

from cepbench.rooflines.dense_batch import kernel_s


def read(ctx):
    s = kernel_s(ctx)
    return None if s is None else 1e3 * s / ctx["profile"]["batches"]
