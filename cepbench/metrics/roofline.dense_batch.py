"""``roofline.dense_batch``: ``dense_batch_kernel``'s share of its
roofline over the traced sub-window: the bytes its batches must move at
the least (``rooflines/dense_batch.py``, regenerated from the seed) at
the H100 SXM's 3.35 TB/s, over the kernel's device time, in %."""

from cepbench.rooflines.dense_batch import PEAK_BYTES_S, kernel_s, window_bytes


def read(ctx):
    s = kernel_s(ctx)
    return None if not s else 100.0 * window_bytes(ctx) / PEAK_BYTES_S / s
