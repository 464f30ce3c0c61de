"""The port's packed step (plain torch version) against the Pallas kernel.

The JAX package's packed step (``kernels/dense_step.build_packed_nfa``)
runs its Pallas kernel in interpret mode on the CPU, as
``tests/test_kernels.py`` runs it.  The port's step for a CPU tensor runs
the kernel's plain torch version.  Both get the same engine state and
the same round, built from one numpy seed, and every output must agree
bit for bit (exact: the step is int32/bool and its outputs are selects
of its inputs).

Batch sizes cover one word (W = 1), one full 1024-row block (W = WB) and
more than one block (B = 1056 pads to two blocks).  The two larger
sizes need that many distinct partitions in one round, so those cases
hold up to 2048 partitions; at S = 4 the state is still small.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siddhi_tpu.kernels.dense_step import build_packed_nfa as jax_build
from siddhi_tpu.ops.dense_nfa import compile_pattern as jax_compile
from siddhi_tpu_torch import compile_pattern, state_from_numpy
from siddhi_tpu_torch.kernels import dense_step

DEFINE = "define stream S (k long, u double, v double); "


def chain_app(n_states, within):
    states = ["every e1=S[v > 1.0]"]
    for i in range(2, n_states + 1):
        states.append(f"e{i}=S[v > {float(i)}]")
    tail = f" within {within} ms" if within else ""
    return (DEFINE + "@info(name='q') from " + " -> ".join(states) + tail
            + f" select e{n_states}.v as v, e{n_states}.k as k "
            "insert into Alerts;")


def random_state(layout, rng, now, within):
    """Mid-chain state: anchors only where active, some past ``within``."""
    P1, S, I = layout["active"][0]
    active = rng.random((P1, S, I)) < 0.6
    horizon = within or 600_000
    age = rng.integers(0, horizon + horizon // 4, (P1, S, I))
    first = np.where(active, np.maximum(now - age, 1), 0).astype(np.int32)
    return {
        "active": active,
        "first_ts": first,
        "counts": np.zeros((P1, S, I), np.int32),
        "regs": np.zeros((P1, S, I, 1), np.float32),
        "overflow": rng.integers(0, 5, P1).astype(np.int32),
    }


@pytest.mark.parametrize("B,P,n_inst,within", [
    (20, 64, 4, 3000),        # W = 1
    (1024, 1100, 4, None),    # W = WB: one full block
    (1056, 2048, 2, 3000),    # two blocks; two lanes make overflow common
])
def test_plain_step_matches_pallas_kernel(B, P, n_inst, within):
    app = chain_app(4, within)
    je = jax_compile(app, "q", n_partitions=P, n_instances=n_inst)
    je.use_kernel = True
    te = compile_pattern(app, "q", n_partitions=P, n_instances=n_inst,
                         device="cpu")
    rng = np.random.default_rng(B)
    now = 5_000_000
    host = random_state(te.state_layout(), rng, now, within)
    jstate = {k: jnp.asarray(v) for k, v in host.items()}
    tstate = state_from_numpy(te, host, base_ts=0)

    Bp = max(1 << (B - 1).bit_length(), 16)
    part = np.full(Bp, P, dtype=np.int32)  # padding rows: scratch row
    part[:B] = rng.choice(P, B, replace=False)
    valid = np.zeros(Bp, dtype=bool)
    valid[:B] = True
    ts = np.zeros(Bp, dtype=np.int32)
    ts[:B] = now + rng.integers(0, 1000, B)
    v = rng.uniform(0.0, 6.0, Bp).astype(np.float32)
    k = rng.integers(-2**40, 2**40, Bp)
    cols = te.prepare_cols("S", {"k": k, "u": v, "v": v})

    jout = jax_build(je, "S")(
        jstate, jnp.asarray(part), {c: jnp.asarray(x) for c, x in cols.items()},
        jnp.asarray(ts), jnp.asarray(valid))
    before = dense_step.packed_step.launches
    tout = te.make_step("S")(
        tstate, torch.from_numpy(part).long(),
        {c: torch.from_numpy(x) for c, x in cols.items()},
        torch.from_numpy(ts), torch.from_numpy(valid))
    assert dense_step.packed_step.launches == before  # CPU: no kernel

    jnew, jemit, jcols, janch, jn = jout
    tnew, temit, tcols, tanch, tn = tout
    assert np.array_equal(np.asarray(jemit), temit.numpy())
    assert np.array_equal(np.asarray(janch), tanch.numpy())
    assert np.array_equal(np.asarray(jcols["f"]), tcols["f"].numpy())
    assert np.array_equal(np.asarray(jcols["i"]), tcols["i"].numpy())
    assert int(jn) == int(tn) > 0
    for key in ("active", "first_ts", "overflow"):
        assert np.array_equal(np.asarray(jnew[key]), tnew[key].numpy()), key
    # the case exercised what it claims: expiry and overflow fired
    grew = tnew["overflow"].numpy() - host["overflow"]
    assert (grew > 0).any()
    if within is not None:
        expired = (host["first_ts"] > 0) & (now - host["first_ts"] > within)
        assert expired[part[:B]].any()


def test_packed_step_checks_its_inputs():
    ok = torch.zeros((2, 1), dtype=torch.int32)
    a = torch.zeros((4, 1), dtype=torch.int32)
    first = torch.zeros((4, 32), dtype=torch.int32)
    ts = torch.zeros((1, 32), dtype=torch.int32)
    out = dense_step.packed_step(ok, a, first, ts, n_inst=2, within=None)
    assert [tuple(o.shape) for o in out] == [(4, 1), (4, 32), (2, 1),
                                             (2, 32), (1, 32)]
    with pytest.raises(ValueError, match="int32"):
        dense_step.packed_step(ok, a, first.float(), ts, n_inst=2, within=None)
    with pytest.raises(ValueError, match="shape"):
        dense_step.packed_step(ok, a, first[:, :16], ts, n_inst=2, within=None)
    with pytest.raises(ValueError, match="out of range"):
        dense_step.packed_step(ok, torch.zeros((34, 1), dtype=torch.int32),
                               torch.zeros((34, 32), dtype=torch.int32), ts,
                               n_inst=17, within=None)
