"""Bit-plane packing of the PyTorch port against the JAX package.

The port's torch ``pack_bits``/``unpack_bits`` and its numpy host
converters must give the JAX package's words bit for bit (exact: the
layout is pure int32), including bit 31 of a word (a real batch row,
the sign bit of the int32) and row counts that are not a multiple of 32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siddhi_tpu.kernels import plane_pack as jpack
from siddhi_tpu_torch.kernels import plane_pack as tpack


@pytest.mark.parametrize("shape", [(32,), (3, 64), (2, 5, 96)])
def test_pack_bits_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    bits = rng.random(shape) < 0.5
    bits[..., 31::32] = True  # bit 31 of every word: the int32 sign bit
    want = np.asarray(jpack.pack_bits(jax, jnp, jnp.asarray(bits)))
    got = tpack.pack_bits(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert (want < 0).all()
    back = tpack.unpack_bits(torch.from_numpy(want.copy()))
    assert np.array_equal(back.numpy(), bits)
    jback = np.asarray(jpack.unpack_bits(jax, jnp, jnp.asarray(got.numpy())))
    assert np.array_equal(jback, bits)


def test_pack_bits_rejects_ragged_axis():
    with pytest.raises(ValueError):
        tpack.pack_bits(torch.zeros(40, dtype=torch.bool))


@pytest.mark.parametrize("P", [53, 64, 1])
def test_host_planes_match_jax(P):
    rng = np.random.default_rng(P)
    active = rng.random((P, 3, 4)) < 0.4
    active[31 % P] = True
    planes = tpack.pack_active_host(active)
    assert np.array_equal(planes, jpack.pack_active_host(active))
    assert np.array_equal(tpack.unpack_active_host(planes, P), active)
    # the torch flavour packs the same words along the last axis
    W = tpack.packed_words(P)
    padded = np.zeros((W * 32, 3, 4), dtype=bool)
    padded[:P] = active
    words = tpack.pack_bits(torch.from_numpy(
        np.ascontiguousarray(padded.transpose(1, 2, 0))))
    assert np.array_equal(words.numpy().transpose(2, 0, 1), planes)


def test_jax_packed_snapshot_unpacks():
    rng = np.random.default_rng(5)
    state = {
        "active": rng.random((40, 3, 2)) < 0.5,
        "first_ts": rng.integers(0, 1 << 30, (40, 3, 2)).astype(np.int32),
        "overflow": rng.integers(0, 9, 40).astype(np.int32),
    }
    snap = jpack.pack_state(state)
    back = tpack.unpack_state(snap)
    assert set(back) == set(state)
    for k in state:
        assert np.array_equal(back[k], state[k]), k
    mine = tpack.pack_state(state)
    assert np.array_equal(mine["active_planes"], snap["active_planes"])
    assert mine["active_rows"] == snap["active_rows"]
