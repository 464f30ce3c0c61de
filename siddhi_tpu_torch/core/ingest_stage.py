"""Host-to-device staging of one collision round.

Port of ``staged_put`` of the JAX package's ``core/ingest_stage.py``:
the one ingest-path transfer.  It puts a pytree of numpy arrays (tuples,
lists and dicts of them) onto the engine's device as torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def staged_put(x, device):
    """Numpy leaves of ``x`` → tensors on ``device`` (structure kept)."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    if isinstance(x, dict):
        return {k: staged_put(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(staged_put(v, device) for v in x)
    raise TypeError(f"staged_put: unsupported leaf {type(x).__name__}")
