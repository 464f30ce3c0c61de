"""Build-and-launch check for the port's CUDA kernels.

Port of the JAX package's ``kernels/probe.py`` (its Pallas ``x + 1``
probe).  ``kernels_available(device)`` builds the kernel libraries from
``csrc/`` and launches ``csrc/probe.cu`` on an ``[8, 128]`` int32 tensor
on the card, checking the result against ``x + 1``.  It answers
``(ok, reason)``; nothing falls back on it: the dense engine refuses to
build on a card where it is not ok.
"""

from __future__ import annotations

from typing import Tuple

import torch

from siddhi_tpu_torch.kernels import build


def add_one_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1


def add_one(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` for an int32 tensor: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("add_one takes a contiguous int32 tensor")
    if x.device.type == "cpu":
        return add_one_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"add_one: unsupported device {x.device}")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device.index).cuda_stream
    err = build.entry("probe", "probe_add_one")(x.data_ptr(), y.data_ptr(),
                                                x.numel(), stream)
    if err != 0:
        raise RuntimeError(f"probe kernel launch failed: CUDA error {err}")
    add_one.launches += 1
    return y


add_one.launches = 0


def kernels_available(device) -> Tuple[bool, str]:
    """(ok, reason): do the port's kernels build and launch on ``device``?"""
    device = torch.device(device)
    if device.type != "cuda":
        return False, f"no kernels for device {device}"
    if not torch.cuda.is_available():
        return False, "torch.cuda.is_available() is false"
    try:
        build.build_all()
        x = torch.zeros((8, 128), dtype=torch.int32, device=device)
        y = add_one(x)
        torch.cuda.synchronize(device)
    except (OSError, RuntimeError) as e:
        return False, f"kernel build or launch failed: {e}"
    if not torch.equal(y, x + 1):
        return False, "probe kernel returned a wrong result"
    return True, ""
