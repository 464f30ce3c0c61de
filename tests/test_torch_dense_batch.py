"""The port's batch step (``kernels/dense_batch.py``) against the JAX
package.

End to end, the same seeded numpy batches go through the JAX engine's
``process`` (its Pallas packed step in interpret mode, ``use_kernel =
True``, over collision rounds) and through the port's engine on
``device="cpu"`` (one ``batch_step`` a batch, its plain version walking
the occurrence ranks).  Every batch's match indices and outputs, in
order, and the final ``active``, ``first_ts`` and ``overflow`` must be
bit-exact: the class is int32/bool and the outputs are selects of the
inputs.

At the function level, ``batch_step_plain`` must equal the round loop of
``packed_step_plain`` (the packed kernel's plain twin, itself pinned to
the Pallas kernel by ``tests/test_torch_dense_step.py``) on the same
inputs, and ``batch_step`` must refuse what the kernel does not take.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from siddhi_tpu.ops.dense_nfa import compile_pattern as jax_compile
from siddhi_tpu_torch import compile_pattern, state_to_numpy
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.kernels import build, dense_batch, dense_step
from siddhi_tpu_torch.kernels.plane_pack import pack_bits, unpack_bits
from siddhi_tpu_torch.ops import dense_nfa
from siddhi_tpu_torch.ops.dense_nfa import _collision_rounds, partition_segments

DEFINE = "define stream S (k long, u double, v double); "
PAIR = ("@info(name='q') from every a=S[v > 8.0] -> b=S[v > 12.0] "
        "{within}select b.v as bv insert into Alerts;")


def chain_app(n_states, within="within 10 min "):
    states = ["every e1=S[v > 1.0]"]
    for i in range(2, n_states + 1):
        states.append(f"e{i}=S[v > {float(i)}]")
    return (DEFINE + "@info(name='q') from " + " -> ".join(states) + " "
            + within + f"select e{n_states}.v as v, e{n_states}.k as k "
            "insert into Alerts;")


def batches(seed, n_batches, B, P, span=900, hot=None, jump_at=None,
            v_high=20.0, stream="S"):
    """Seeded batches of ``stream``: ``hot = (row, share)`` puts that share
    of every batch on one partition (one long segment); ``jump_at``
    moves time past the int32 relative range before that batch."""
    rng = np.random.default_rng(seed)
    out, t = [], 1000
    for i in range(n_batches):
        if i == jump_at:
            t += 2**31
        part = rng.integers(0, P, B)
        if hot is not None:
            part[rng.random(B) < hot[1]] = hot[0]
        cols = {"k": rng.integers(-2**40, 2**40, B),
                "u": rng.uniform(0.0, 20.0, B),
                "v": rng.uniform(0.0, v_high, B)}
        ts = t + np.sort(rng.integers(0, span, B))
        t = int(ts[-1])
        out.append((stream, part.astype(np.int32), cols, ts))
    return out


def run_both(app, P, n_instances, sends):
    """Every send through the JAX engine (Pallas, interpret mode) and the
    port's CPU engine; asserts matches batch by batch and the final
    state; returns the port engine, its state and the match count."""
    je = jax_compile(app, "q", n_partitions=P, n_instances=n_instances)
    je.use_kernel = True
    je._step_cache.clear()
    te = compile_pattern(app, "q", n_partitions=P, n_instances=n_instances,
                         device="cpu")
    jstate, tstate = je.init_state(), te.init_state()
    n = 0
    for stream, part, cols, ts in sends:
        jstate, jev, jout = je.process(jstate, stream, part, cols, ts)
        tstate, tev, tout = te.process(tstate, stream, part, cols, ts)
        assert np.array_equal(jev, tev)
        assert jout.dtype == tout.dtype and jout.shape == tout.shape
        assert np.array_equal(jout, tout)
        n += len(tev)
    host, base_ts = state_to_numpy(te, tstate)
    assert base_ts == je.base_ts
    for k in ("active", "first_ts", "overflow"):
        assert np.array_equal(np.asarray(jstate[k]), host[k]), k
    return te, host, n


def longest_segment(sends):
    return max(int(np.unique(p, return_counts=True)[1].max())
               for _s, p, _c, _t in sends)


TWO_STREAMS = ("define stream S (k long, u double, v double); "
               "define stream T (k long, u double, v double); "
               "@info(name='q') from every a=S[v > 8.0] -> b=T[v > 12.0] "
               "-> c=S[u > 5.0] within 10 sec select c.u as cu "
               "insert into Alerts;")


def two_stream_sends():
    s = batches(31, 6, 120, P=12, hot=(5, 0.5))
    t = batches(32, 6, 120, P=12, hot=(5, 0.5), stream="T")
    out = []
    for i in range(6):  # alternate, with time moving forward
        for stream, part, cols, ts in (s[i], t[i]):
            out.append((stream, part, cols, ts + 2000 * i))
    return out


CASES = {
    # one partition holds 200+ events of a batch (a 200-rank segment)
    "long_segment": (DEFINE + PAIR.format(within="within 3 sec "), 16, 4,
                     batches(1, 3, 320, P=16, hot=(3, 0.75))),
    # every event on its own partition (one-event segments)
    "distinct_partitions": (
        DEFINE + PAIR.format(within="within 3 sec "), 256, 4,
        [("S", np.random.default_rng(2).permutation(256)[:200].astype(
            np.int32), *b[2:]) for b in batches(2, 4, 200, P=256)]),
    # anchors older than `within` expire in the middle of a segment
    "within_expiry": (chain_app(3, "within 100 ms "), 8, 4,
                      batches(3, 3, 240, P=8, span=3000, hot=(1, 0.6))),
    # two lanes: fired instances beyond the free lanes overflow
    "overflow_two_lanes": (chain_app(4), 8, 2,
                           batches(4, 3, 200, P=8, hot=(2, 0.5))),
    # the widest lane count at 16 nodes
    "sixteen_by_sixteen": (chain_app(16), 16, 16,
                           batches(5, 3, 256, P=16, hot=(7, 0.4))),
    # 32 lanes: node 1 gathers more than 16 pending instances on the hot
    # partitions (e2 fires on 2.5% of events) and overflows past 32
    "thirty_two_lanes": (
        DEFINE + "@info(name='q') from every e1=S[v > 1.0] -> "
        "e2=S[v > 19.5] -> e3=S[u > 10.0] within 10 min "
        "select e3.v as v, e3.k as k insert into Alerts;", 8, 32,
        batches(8, 3, 200, P=8, hot=(6, 0.6))),
    # nodes of one stream are off-stream for the other's batches
    "two_streams": (TWO_STREAMS, 12, 4, two_stream_sends()),
    # a LONG compare on the hi/lo lanes, values far outside int32
    "long_compare": (
        DEFINE + "@info(name='q') from every a=S[v > 8.0] -> "
        "b=S[k > 5 and v > 4.0] within 3 sec select b.v as bv, b.k as bk "
        "insert into Alerts;", 16, 4, batches(6, 3, 200, P=16, hot=(0, 0.3))),
    # time jumps past the int32 relative range: re-anchor between batches
    "re_anchor": (DEFINE + PAIR.format(within="within 3 sec "), 16, 4,
                  batches(7, 5, 160, P=16, hot=(4, 0.3), jump_at=3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_jax(case):
    app, P, I, sends = CASES[case]
    te, host, n = run_both(app, P, I, sends)
    assert n > 0
    if case == "long_segment":
        assert longest_segment(sends) >= 200
    if case == "distinct_partitions":
        assert longest_segment(sends) == 1
    if case == "overflow_two_lanes":
        assert host["overflow"].sum() > 0
    if case == "re_anchor":
        assert te.base_ts > 2**31
    if case == "thirty_two_lanes":
        assert te.I == 32
        assert host["active"][:, 1].sum(axis=1).max() > 16
        assert host["overflow"].sum() > 0


def test_within_expiry_changes_the_matches():
    """The expiry case's data reach the horizon: without ``within`` the
    same sends match otherwise (port alone, on the CPU)."""
    _app, P, I, sends = CASES["within_expiry"]
    got = []
    for within in ("within 100 ms ", ""):
        te = compile_pattern(chain_app(3, within), "q", n_partitions=P,
                             n_instances=I, device="cpu")
        st, n = te.init_state(), 0
        for stream, part, cols, ts in sends:
            st, ev, _out = te.process(st, stream, part, cols, ts)
            n += len(ev)
        got.append(n)
    assert got[0] != got[1]


def test_one_batch_step_per_batch_and_no_packed_step(monkeypatch):
    """``process`` makes one ``batch_step`` call per batch and stream and
    never reaches the packed step."""
    calls = []
    real = dense_nfa.batch_step

    def counted(*args, **kw):
        calls.append(args[5].shape)
        return real(*args, **kw)

    monkeypatch.setattr(dense_nfa, "batch_step", counted)
    monkeypatch.setattr(dense_step, "packed_step", None)
    _app, P, I, sends = CASES["two_streams"]
    te = compile_pattern(TWO_STREAMS, "q", n_partitions=P, n_instances=I,
                         device="cpu")
    st = te.init_state()
    for stream, part, cols, ts in sends:
        st, _ev, _out = te.process(st, stream, part, cols, ts)
    assert len(calls) == len(sends)
    assert calls == [(len(part),) for _s, part, _c, _t in sends]


def test_partition_segments():
    part = np.array([3, 1, 3, 0, 1, 3], dtype=np.int32)
    order, seg_start, seg_part = partition_segments(part)
    assert order.tolist() == [3, 1, 4, 0, 2, 5]
    assert seg_start.tolist() == [0, 1, 3, 6]
    assert seg_part.tolist() == [0, 1, 3]
    assert {a.dtype for a in (order, seg_start, seg_part)} == {np.dtype(np.int32)}
    empty = partition_segments(np.zeros(0, dtype=np.int64))
    assert [a.tolist() for a in empty] == [[], [0], []]


# -- function level ---------------------------------------------------------

def batch_inputs(S, I, N, P, within, seed):
    """Seeded valid inputs: a mid-chain state (anchors only where active,
    some past ``within``), Zipf-skewed partitions (long segments), ok
    flags and ts ascending within the batch."""
    rng = np.random.default_rng(seed)
    w = within or 600_000
    now = 5_000_000
    active = rng.random((P + 1, S, I)) < 0.5
    age = rng.integers(0, w + w // 4, (P + 1, S, I))
    first = np.where(active, now - age, 0).astype(np.int32)
    state = {"active": torch.from_numpy(active),
             "first_ts": torch.from_numpy(first),
             "overflow": torch.from_numpy(
                 rng.integers(0, 5, P + 1).astype(np.int32))}
    part = ((rng.zipf(1.3, N) - 1) % P).astype(np.int32)
    ok = torch.from_numpy(rng.random((N, S)) < 0.5)
    ts = torch.from_numpy(
        (now + np.sort(rng.integers(0, w // 2, N))).astype(np.int32))
    return state, part, ok, ts


def rounds_of_packed_step(state, part, ok, ts, I, within):
    """The engine's former path: collision rounds, each gathered, packed,
    stepped by ``packed_step_plain``, unpacked and written back."""
    N, S = ok.shape
    emit = torch.zeros((N, 2 * I), dtype=torch.bool)
    anchor = torch.zeros((N, 2 * I), dtype=torch.int32)
    for ridx in _collision_rounds(part):
        b = len(ridx)
        Bp = ((b + 31) // 32) * 32
        p = torch.from_numpy(part[ridx]).long()
        r = torch.from_numpy(ridx).long()
        a = torch.zeros((Bp, S, I), dtype=torch.bool)
        a[:b] = state["active"][p]
        f = torch.zeros((Bp, S, I), dtype=torch.int32)
        f[:b] = state["first_ts"][p]
        okp = torch.zeros((S, Bp), dtype=torch.bool)
        okp[:, :b] = ok[r].t()
        tp = torch.zeros((1, Bp), dtype=torch.int32)
        tp[0, :b] = ts[r]
        a_o, f_o, e_o, an_o, ov_o = dense_step.packed_step_plain(
            pack_bits(okp), pack_bits(a.permute(1, 2, 0).reshape(S * I, Bp)),
            f.permute(1, 2, 0).reshape(S * I, Bp).contiguous(), tp, I, within)
        state["active"][p] = unpack_bits(a_o).reshape(S, I, Bp).permute(
            2, 0, 1)[:b]
        state["first_ts"][p] = f_o.reshape(S, I, Bp).permute(2, 0, 1)[:b]
        state["overflow"][p] += ov_o[0, :b]
        emit[r, :I] = unpack_bits(e_o).t()[:b]
        anchor[r, :I] = an_o.t()[:b]
    return emit, anchor, emit.sum(dtype=torch.int32)


@pytest.mark.parametrize("S,I,N,P,within", [
    (2, 8, 300, 40, None),       # the skew-routed shape, cut
    (16, 4, 256, 64, 600_000),   # the 1 M cell's chain, cut
    (3, 7, 200, 16, 50),         # ragged lanes, short horizon
    (32, 16, 64, 8, 3000),       # 16 lanes at 32 nodes
    (4, 32, 200, 16, 3000),      # 32 lanes: one uint32 mask a node
    (1, 1, 40, 4, None),         # one node, one lane
])
def test_plain_equals_rounds_of_packed_step(S, I, N, P, within):
    state, part, ok, ts = batch_inputs(S, I, N, P, within, seed=S * I + N)
    ref = {k: v.clone() for k, v in state.items()}
    order, seg_start, seg_part = (torch.from_numpy(a) for a in
                                  partition_segments(part))
    got = dense_batch.batch_step(state, order, seg_start, seg_part, ok, ts,
                                 n_inst=I, within=within)
    want = rounds_of_packed_step(ref, part, ok, ts, I, within)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    for k in state:
        assert torch.equal(state[k], ref[k]), k
    assert int(got[2]) > 0


def small_inputs(S=2, I=4, N=6, P=3):
    state, part, ok, ts = batch_inputs(S, I, N, P, None, seed=1)
    order, seg_start, seg_part = (torch.from_numpy(a) for a in
                                  partition_segments(part))
    return state, order, seg_start, seg_part, ok, ts


def test_batch_step_checks_its_inputs():
    state, order, seg_start, seg_part, ok, ts = small_inputs()
    before = dense_batch.batch_step.launches
    emit, anchor, n = dense_batch.batch_step(
        state, order, seg_start, seg_part, ok, ts, n_inst=4, within=None)
    assert dense_batch.batch_step.launches == before  # CPU: no kernel
    assert emit.shape == (6, 8) and anchor.shape == (6, 8) and n.dim() == 0
    call = lambda **kw: dense_batch.batch_step(
        kw.get("state", state), kw.get("order", order),
        kw.get("seg_start", seg_start), kw.get("seg_part", seg_part),
        kw.get("ok", ok), kw.get("ts", ts), n_inst=kw.get("n_inst", 4),
        within=kw.get("within"))
    with pytest.raises(ValueError, match="ts must be torch.int32"):
        call(ts=ts.long())
    with pytest.raises(ValueError, match="ok must be torch.bool"):
        call(ok=ok.to(torch.int32))
    with pytest.raises(ValueError, match="active must be torch.bool"):
        call(state={**state, "active": state["active"].to(torch.uint8)})
    with pytest.raises(ValueError, match="ok has shape"):
        call(ok=ok[:, :1].contiguous())
    with pytest.raises(ValueError, match="seg_start has shape"):
        call(seg_start=seg_start[:-1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        call(ok=torch.zeros((2, 6), dtype=torch.bool).t())
    with pytest.raises(ValueError, match="overflow is missing"):
        call(state={k: v for k, v in state.items() if k != "overflow"})
    with pytest.raises(ValueError, match="out of range"):
        call(n_inst=3)
    with pytest.raises(ValueError, match="within"):
        call(within=2**31)
    s33 = small_inputs(S=33, I=1)
    with pytest.raises(ValueError, match="out of range"):
        dense_batch.batch_step(*s33, n_inst=1, within=None)
    i33 = small_inputs(S=2, I=33)
    with pytest.raises(ValueError, match="out of range"):
        dense_batch.batch_step(*i33, n_inst=33, within=None)


def test_more_than_32_instances_refused():
    """The batch step holds at most 32 lanes a node and refuses more, so
    an engine with ``instances='40'`` is routed, at compile time, to the
    general step, which carries the lanes as an array axis.  It must
    match the JAX engine's XLA step (reset on emit off, as the product
    runtime sets it for `every` chains), with more than 32 instances
    pending on a node and overflow past 40."""
    app = CASES["thirty_two_lanes"][0]
    assert compile_pattern(app, "q", n_partitions=4, n_instances=32,
                           device="cpu").step_kind == "batch"
    with pytest.raises(ValueError, match="out of range"):
        dense_batch.batch_step(*small_inputs(S=2, I=33), n_inst=33,
                               within=None)
    je = jax_compile(app, "q", n_partitions=8, n_instances=40)
    je.reset_on_emit = False
    te = compile_pattern(app, "q", n_partitions=8, n_instances=40,
                         device="cpu")
    assert te.step_kind == "general" and te.I == 40
    jstate, tstate, n = je.init_state(), te.init_state(), 0
    for stream, part, cols, ts in batches(8, 3, 200, P=8, hot=(6, 0.8)):
        jstate, jev, jout = je.process(jstate, stream, part, cols, ts)
        tstate, tev, tout = te.process(tstate, stream, part, cols, ts)
        assert np.array_equal(jev, tev)
        assert jout.dtype == tout.dtype and np.array_equal(jout, tout)
        n += len(tev)
    host, _ = state_to_numpy(te, tstate)
    for k in host:
        assert np.array_equal(np.asarray(jstate[k]), host[k]), k
    assert n > 0 and host["active"][:, 1].sum(axis=1).max() > 32
    assert host["overflow"].sum() > 0


def test_packed_step_refuses_more_than_16_instances():
    """The packed step (off the main path) keeps its 16 lanes: an engine
    with more gets a clear error from ``make_step``, and ``process``
    never reaches it."""
    te = compile_pattern(chain_app(3), "q", n_partitions=4, n_instances=17,
                         device="cpu")
    with pytest.raises(ValueError, match="packed step holds at most 16"):
        te.make_step("S")
    assert compile_pattern(chain_app(3), "q", n_partitions=4, n_instances=16,
                           device="cpu").make_step("S") is not None


def test_plan_matches_the_c_struct():
    """``dense_batch._Plan`` is ``struct Plan`` of ``csrc/dense_batch.cu``
    field for field (the kernel reads it at the address the wrapper
    passes)."""
    text = (build.CSRC / "dense_batch.cu").read_text()
    body = re.search(r"struct Plan \{([^}]*)\};", text).group(1)
    want = [(d.split()[-1], ctypes.c_int)
            for d in filter(None, (x.strip() for x in body.split(";")))]
    assert all(d.split()[0] == "int" for d in body.split(";") if d.strip())
    assert dense_batch._Plan._fields_ == want
