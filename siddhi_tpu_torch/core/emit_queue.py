"""Device-to-host fetch of match outputs.

Port of ``fetch_coalesced`` of the JAX package's ``core/emit_queue.py``:
the port's single device-to-host path.  ``np.asarray`` raises on a CUDA
tensor, so every materializer of the port goes through here.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def fetch_coalesced(arrays: Sequence) -> List[np.ndarray]:
    """One device-to-host copy per group of tensors.

    Tensors are grouped by (device, dtype, trailing shape); each group is
    concatenated on the device (0-d tensors are stacked), copied with
    one ``.cpu()``, and split back in input order.  Host values pass
    through ``np.asarray``.
    """
    out: List[np.ndarray] = [None] * len(arrays)
    groups: Dict[Tuple, List[int]] = {}
    for i, a in enumerate(arrays):
        if not isinstance(a, torch.Tensor):
            out[i] = np.asarray(a)
            continue
        groups.setdefault((a.device, a.dtype, tuple(a.shape[1:]), a.dim() == 0),
                          []).append(i)
    for (_dev, _dtype, _trail, scalar), idxs in groups.items():
        members = [arrays[i] for i in idxs]
        joined = torch.stack(members) if scalar else torch.cat(members)
        host = joined.cpu().numpy()
        if scalar:
            for k, i in enumerate(idxs):
                out[i] = host[k]
            continue
        start = 0
        for i in idxs:
            n = arrays[i].shape[0]
            out[i] = host[start:start + n]
            start += n
    return out
