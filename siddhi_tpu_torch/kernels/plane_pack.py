"""Bit-plane layout for the packed dense-NFA step.

One int32 word carries the boolean node activity of 32 batch rows:
row ``w*32 + b`` lives at bit ``b`` of word ``w``.  Only the batch /
partition axis packs; the ``[S, I]`` plane shape of the engine state is
untouched, so a packed snapshot of the JAX package loads here unchanged.

Two flavours live side by side:

- ``pack_active_host``/``unpack_active_host`` and ``pack_state``/
  ``unpack_state``: numpy, axis 0 packs; copied from the JAX package.
- ``pack_bits``/``unpack_bits``: torch, last axis packs; used on both
  sides of the ``dense_step`` kernel boundary.

Both use the same bit order, so a word is a word regardless of which
axis it was packed along.
"""

from __future__ import annotations

import numpy as np
import torch

PLANE_BITS = 32


def packed_words(n_rows: int) -> int:
    """Words needed to hold ``n_rows`` packed rows."""
    return (n_rows + PLANE_BITS - 1) // PLANE_BITS


def pack_active_host(active: np.ndarray) -> np.ndarray:
    """``[P, S, I] bool`` → ``[ceil(P/32), S, I] int32`` bit planes."""
    P, S, I = active.shape
    W = packed_words(P)
    padded = np.zeros((W * PLANE_BITS, S, I), dtype=np.uint32)
    padded[:P] = active.astype(np.uint32)
    planes = np.zeros((W, S, I), dtype=np.uint32)
    for b in range(PLANE_BITS):
        planes |= padded[b::PLANE_BITS] << np.uint32(b)
    return planes.view(np.int32)


def unpack_active_host(planes: np.ndarray, n_rows: int) -> np.ndarray:
    """``[W, S, I] int32`` bit planes → ``[n_rows, S, I] bool``."""
    planes = np.ascontiguousarray(planes, dtype=np.int32)
    W, S, I = planes.shape
    u = planes.view(np.uint32)
    out = np.zeros((W * PLANE_BITS, S, I), dtype=bool)
    for b in range(PLANE_BITS):
        out[b::PLANE_BITS] = ((u >> np.uint32(b)) & np.uint32(1)).astype(bool)
    return out[:n_rows]


def pack_state(state: dict) -> dict:
    """Engine state dict (host numpy) → packed snapshot dict.

    ``active`` is replaced by its bit planes plus the original row
    count; every other array passes through untouched.
    """
    out = {k: v for k, v in state.items() if k != "active"}
    out["active_planes"] = pack_active_host(state["active"])
    out["active_rows"] = int(state["active"].shape[0])
    return out


def unpack_state(packed: dict) -> dict:
    """Inverse of ``pack_state`` — restores the engine dict layout."""
    out = {
        k: v
        for k, v in packed.items()
        if k not in ("active_planes", "active_rows")
    }
    out["active"] = unpack_active_host(
        packed["active_planes"], packed["active_rows"]
    )
    return out


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """``[..., 32*W] bool`` → ``[..., W] int32`` (last axis).

    Torch has no uint32 shift, so the words are summed in int64 and
    folded into the int32 range explicitly (bit 31 is a real row)."""
    shape = bits.shape
    if shape[-1] % PLANE_BITS:
        raise ValueError(f"pack_bits: last axis {shape[-1]} is not a "
                         f"multiple of {PLANE_BITS}")
    W = shape[-1] // PLANE_BITS
    b = bits.reshape(*shape[:-1], W, PLANE_BITS).to(torch.int64)
    shifts = torch.arange(PLANE_BITS, dtype=torch.int64, device=bits.device)
    words = (b << shifts).sum(dim=-1)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """``[..., W] int32`` → ``[..., 32*W] bool`` (last axis).

    int32 ``>>`` sign-extends, so each shifted word is masked with 1."""
    shifts = torch.arange(PLANE_BITS, dtype=torch.int32, device=words.device)
    bits = (words.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*words.shape[:-1],
                        words.shape[-1] * PLANE_BITS).to(torch.bool)
