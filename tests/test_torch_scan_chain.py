"""The port's fused hot-key scan and scan engine against the JAX package.

The JAX package's fused scan (``kernels/scan_chain.fused_scan``) runs its
Pallas kernel in interpret mode on the CPU, as ``tests/test_kernels.py``
runs it; the port's ``fused_scan`` on a CPU tensor runs the kernel's
plain torch twin.  Both get the same inputs made from one numpy seed:
random 0/1 filter rows with all-zero padding rows, a mix of live starts
and ``NEG`` in ``v``, integer-valued counts in ``c``.  The twin must
agree bit for bit on every lane, dead lanes included (the same float32
operations in the same order).

Against the reference's other step, the two-pass associative scan
(``use_kernel = False``), the contract is the reference's own: emissions
and live lanes exact, dead lanes at or below ``NEG/2`` in both.

A numpy model of the CUDA kernel's algorithm (``csrc/scan_chain.cu``:
lanes in order, each lane's per-thread elements combined by the
segmented (max, sum) operator in the kernel's two-level shuffle-scan
order, tiles carrying each lane's value) must equal ``fused_scan_plain``
bit for bit on hypothesis-drawn inputs of the engine's domain, with
small tiles and warps so several tiles and warps take part.  That proves
the kernel's algebra here; the card tests hold the kernel itself.

The host-side pieces (dense-row handoff converters, the space-saving
sketch, the scan engine's eligibility reasons) are held exact against
the reference's.

The reference kernel's body calls ``pl.load``/``pl.store``, which the
installed JAX (0.9) keeps in ``jax._src.pallas.primitives`` but no
longer exports from ``jax.experimental.pallas``.  The ``pallas_io``
fixture re-exports those same two functions for the duration of a test,
so the reference kernel runs unchanged; the reference package itself is
not touched.
"""

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, assume, given, settings
from hypothesis import strategies as st
from jax._src.pallas import primitives as pallas_primitives

from siddhi_tpu.compiler import SiddhiCompiler as JaxCompiler
from siddhi_tpu.core.exceptions import SiddhiAppCreationError as JaxCreationError
from siddhi_tpu.core.hotkey_router import SpaceSavingSketch as JaxSketch
from siddhi_tpu.kernels.scan_chain import fused_scan as jax_fused_scan
from siddhi_tpu.ops.hotkey_scan import HotKeyScanEngine as JaxScanEngine
from siddhi_tpu.ops.nfa_scan import NEG as JAX_NEG
from siddhi_tpu_torch.compiler import SiddhiCompiler
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError
from siddhi_tpu_torch.core.hotkey_router import SpaceSavingSketch
from siddhi_tpu_torch.kernels import scan_chain
from siddhi_tpu_torch.ops.hotkey_scan import (
    HotKeyScanEngine,
    scan_state_from_numpy,
    scan_state_to_numpy,
)
from siddhi_tpu_torch.ops.nfa_scan import NEG

DEFINE = "define stream S (k long, u double, v double, n int); "
NEG32 = np.float32(NEG)


@pytest.fixture
def pallas_io(monkeypatch):
    """``pl.load``/``pl.store`` as the reference kernel calls them."""
    monkeypatch.setattr(pl, "load", pallas_primitives.load, raising=False)
    monkeypatch.setattr(pl, "store", pallas_primitives.store, raising=False)


def scan_inputs(H, n, S, seed, n_real=None):
    """Seeded fused-scan inputs: 0/1 filter rows (rows past each slot's
    ``n_real`` all zero, as the router pads), ``v`` a mix of live
    starts and ``NEG`` (lane 0 the constant 0), integer counts."""
    rng = np.random.default_rng(seed)
    F = (rng.random((H, n, S + 1)) < 0.55).astype(np.float32)
    if n_real is not None:
        for h in range(H):
            F[h, n_real[h]:] = 0.0
    ts = np.sort(rng.integers(1, 5000, (H, n)), axis=1).astype(np.float32)
    live = rng.random((H, S)) < 0.6
    v = np.where(live, rng.integers(-200, 1000, (H, S)), NEG32
                 ).astype(np.float32)
    c = np.where(live, rng.integers(1, 9, (H, S)), 0).astype(np.float32)
    v[:, 0] = 0.0
    c[:, 0] = 1.0
    return F, ts, v, c


def run_jax(F, ts, v, c):
    out = jax_fused_scan(jax, jnp, jnp.asarray(F), jnp.asarray(ts),
                         jnp.asarray(v), jnp.asarray(c), JAX_NEG)
    return [np.asarray(a) for a in out]


def run_port(F, ts, v, c):
    t = lambda a: torch.from_numpy(np.array(a))
    return [a.numpy() for a in scan_chain.fused_scan(t(F), t(ts), t(v), t(c))]


def assert_bits(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        assert np.array_equal(g.view(np.int32), w.view(np.int32))


@pytest.mark.parametrize("H,n,S,seed", [
    (1, 16, 2, 1),    # the smallest legal shape
    (3, 16, 5, 2),    # ragged slots, S = 5
    (4, 32, 3, 3),
    (2, 64, 4, 4),
])
def test_twin_bit_exact_against_pallas(H, n, S, seed, pallas_io):
    rng = np.random.default_rng(100 + seed)
    n_real = rng.integers(1, n + 1, H)
    F, ts, v, c = scan_inputs(H, n, S, seed, n_real)
    want = run_jax(F, ts, v, c)
    got = run_port(F, ts, v, c)
    assert_bits(got, want)
    assert want[2].any(), "inputs emitted nothing"
    assert (want[0] <= NEG32 / 2).any(), "no dead lane at the end"


def test_twin_all_padding_is_identity(pallas_io):
    """An all-zero filter block leaves both chains as they were."""
    F, ts, v, c = scan_inputs(2, 16, 3, 7)
    F[:] = 0.0
    got = run_port(F, ts, v, c)
    assert_bits(got, run_jax(F, ts, v, c))
    assert np.array_equal(got[0], v) and np.array_equal(got[1], c)
    assert not got[2].any()


@pytest.mark.parametrize("bad", ["dtype", "shape", "S", "n", "device"])
def test_fused_scan_rejects_bad_inputs(bad):
    F, ts, v, c = (torch.from_numpy(a) for a in scan_inputs(2, 16, 3, 1))
    if bad == "dtype":
        F = F.double()
    elif bad == "shape":
        v = v[:, :2].contiguous()
    elif bad == "S":
        F, v, c = F[:, :, :2].contiguous(), v[:, :1].contiguous(), c[:, :1].contiguous()
    elif bad == "n":
        F, ts = F[:, :12].contiguous(), ts[:, :12].contiguous()
    else:
        F = F.to("meta")
    with pytest.raises(ValueError):
        scan_chain.fused_scan(F, ts, v, c)


# -- the kernel's algorithm, modelled in numpy -------------------------------


def seg_combine(x, y):
    """Element ``x`` then element ``y``; an element ``(k, a, c)`` is the
    step ``v -> max(a, k ? v : NEG)``, ``c -> c_e + (k ? c : 0)``."""
    (xk, xa, xc), (yk, ya, yc) = x, y
    return (xk & yk, np.where(yk, np.maximum(xa, ya), ya),
            np.where(yk, xc + yc, yc))


def seg_identity(shape):
    return (np.ones(shape, dtype=bool), np.full(shape, NEG32),
            np.zeros(shape, dtype=np.float32))


def warp_inclusive(s, W):
    """Hillis-Steele inclusive scan along the last axis (one warp of
    ``W`` lanes), as the kernel's ``__shfl_up_sync`` loop."""
    lane = np.arange(W)
    d = 1
    while d < W:
        o = tuple(np.concatenate([x[..., :d], x[..., :-d]], axis=-1)
                  for x in s)
        c = seg_combine(o, s)
        s = tuple(np.where(lane >= d, cx, x) for cx, x in zip(c, s))
        d *= 2
    return s


def block_exclusive(agg, W):
    """Exclusive scan over the block's threads (last axis, a multiple of
    ``W``): within each warp, then each warp's prefix from the scan of
    the warp totals, as the kernel does it."""
    H, T = agg[0].shape
    nw = T // W
    inc = warp_inclusive(tuple(x.reshape(H, nw, W) for x in agg), W)
    ident = seg_identity((H, nw, 1))
    pre = tuple(np.concatenate([i, x[..., :-1]], axis=-1)
                for i, x in zip(ident, inc))
    tot = seg_identity((H, W))
    for t, x in zip(tot, inc):
        t[:, :nw] = x[..., -1]
    tot = warp_inclusive(tot, W)
    wpre = tuple(np.concatenate([i, t[:, :nw - 1]], axis=1)[..., None]
                 for i, t in zip(seg_identity((H, 1)), tot))
    pre = seg_combine(wpre, pre)
    return tuple(x.reshape(H, T) for x in pre)


def kernel_model(F, ts, v, c, E=16, threads=128, W=32):
    """The algorithm of ``csrc/scan_chain.cu`` in numpy float32: tiles of
    ``E * T`` events (``T`` threads, ``W`` a warp), lanes in order, each
    lane one block-wide segmented scan, each lane's value carried from
    tile to tile; ``v`` floored at NEG on load."""
    H, n, Sp1 = F.shape
    S = Sp1 - 1
    f32, neg = np.float32, NEG32
    T = min(max(n // E, W), threads)
    tile = min(n, E * T)
    active = tile // E
    fb = F > 0.5
    car_v = np.maximum(v, neg).astype(f32)
    car_c = c.copy()
    emit = np.zeros((H, n), dtype=f32)
    for e0 in range(0, n, tile):
        f = fb[:, e0:e0 + tile].reshape(H, active, E, Sp1)
        pv = ts[:, e0:e0 + tile].reshape(H, active, E).copy()
        pc = np.ones((H, active, E), dtype=f32)
        if e0 == 0:
            pc[:, 0, 0] = c[:, 0]
        for i in range(1, S):
            keep = ~f[..., i + 1]
            a = np.where(f[..., i], pv, neg)
            al = np.where(f[..., i], pc, f32(0.0))
            agg = seg_identity((H, T))
            part = seg_identity((H, active))
            for k in range(E):
                part = seg_combine(part, (keep[..., k], a[..., k], al[..., k]))
            for x, p in zip(agg, part):
                x[:, :active] = p
            pk, pa, pcs = (x[:, :active] for x in block_exclusive(agg, W))
            x = np.maximum(pa, np.where(pk, car_v[:, i:i + 1], neg))
            y = pcs + np.where(pk, car_c[:, i:i + 1], f32(0.0))
            for k in range(E):
                pv[..., k], pc[..., k] = x, y
                x = np.maximum(a[..., k], np.where(keep[..., k], x, neg))
                y = al[..., k] + np.where(keep[..., k], y, f32(0.0))
            car_v[:, i], car_c[:, i] = x[:, -1], y[:, -1]
        emit[:, e0:e0 + tile] = np.where(
            f[..., S] & (pv > NEG32 / 2), pc, f32(0.0)).reshape(H, tile)
    car_v[:, 0], car_c[:, 0] = 0.0, 1.0
    return [car_v, car_c, emit]


def run_plain(F, ts, v, c):
    t = lambda a: torch.from_numpy(np.array(a))
    return [a.numpy() for a in scan_chain.fused_scan_plain(t(F), t(ts), t(v),
                                                           t(c))]


def max_count(F, c):
    """The largest count the sequential walk reaches (float64)."""
    S = F.shape[2] - 1
    cc = c.astype(np.float64)
    top = cc.max()
    for e in range(F.shape[1]):
        f = F[:, e] > 0.5
        cs = np.concatenate([np.ones((len(cc), 1)), cc[:, :S - 1]], axis=1)
        cc = np.where(f[:, :S], cs, 0.0) + np.where(f[:, 1:], 0.0, cc)
        cc[:, 0] = 1.0
        top = max(top, cc.max())
    return top


DEAD = np.array([NEG, NEG / 2, 1.5 * NEG, -3.0e38], dtype=np.float32)


def domain_inputs(H, n, S, seed, density, v_mode):
    """Seeded inputs of the engine's domain: 0/1 filter rows at
    ``density`` with all-zero padding past each slot's real events, ts
    and live starts below 2^24, dead starts at or below NEG/2 (NEG, NEG/2,
    1.5 NEG, -3e38), integer counts."""
    rng = np.random.default_rng(seed)
    F = (rng.random((H, n, S + 1)) < density).astype(np.float32)
    for h, k in enumerate(rng.integers(0, n + 1, H)):
        F[h, k:] = 0.0
    ts = rng.integers(-1000, 2**24, (H, n)).astype(np.float32)
    live_v = rng.integers(-(2**24) + 1, 2**24, (H, S)).astype(np.float32)
    dead_v = rng.choice(DEAD, (H, S))
    live = {"mix": rng.random((H, S)) < 0.5, "all_dead": np.zeros((H, S), bool),
            "all_live": np.ones((H, S), bool),
            "zero": np.ones((H, S), bool)}[v_mode]
    if v_mode == "zero":
        live_v[:] = 0.0  # live starts at +0.0
    v = np.where(live, live_v, dead_v).astype(np.float32)
    c = rng.integers(0, 40, (H, S)).astype(np.float32)
    return F, ts, v, c


@settings(max_examples=60, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(S=st.integers(2, 32), n=st.sampled_from([16, 32, 64, 128]),
       H=st.integers(1, 3), seed=st.integers(0, 2**32 - 1),
       density=st.sampled_from([0.15, 0.55, 0.9]),
       v_mode=st.sampled_from(["mix", "all_dead", "all_live", "zero"]),
       E=st.sampled_from([1, 2, 4, 8, 16]), W=st.sampled_from([2, 4, 8]),
       warps=st.sampled_from([1, 2, 4]))
def test_kernel_model_bit_exact_against_plain(S, n, H, seed, density, v_mode,
                                              E, W, warps):
    """The kernel's algorithm, with tiles of ``E * W * warps`` events at
    most (several tiles where that is below ``n``), bit for bit against
    the plain version on every lane, dead lanes included."""
    assume(warps <= W)  # the warp totals fit one warp, as in the kernel
    F, ts, v, c = domain_inputs(H, n, S, seed, density, v_mode)
    assume(max_count(F, c) < 2**24)
    got = kernel_model(F, ts, v, c, E=E, threads=W * warps, W=W)
    assert_bits(got, run_plain(F, ts, v, c))


@pytest.mark.parametrize("H,n,S,seed", [
    (3, 4096, 3, 1),   # two tiles at the kernel's own sizes
    (8, 2048, 2, 2),   # the routed path's shape: one tile
    (2, 16, 32, 3),    # the widest chain on the smallest n
])
def test_kernel_model_at_kernel_sizes(H, n, S, seed):
    """The model at the kernel's constants (16 events a thread, 128
    threads, 32-lane warps) against the plain version, on the inputs
    the card tests use."""
    F, ts, v, c = scan_inputs(H, n, S, seed)
    want = run_plain(F, ts, v, c)
    assert_bits(kernel_model(F, ts, v, c), want)
    assert want[2].any()


def test_kernel_model_floors_dead_starts_on_load():
    """Every filter set: each lane takes the one below it, one lane an
    event, so lane ``i``'s start after 16 events is lane ``i-16``'s
    start before them.  Dead starts below NEG (-3e38) must come out at
    NEG, as the plain version's every step floors them: the walk floors
    them on load."""
    H, n, S = 2, 16, 32
    F = np.ones((H, n, S + 1), dtype=np.float32)
    ts = np.arange(1, H * n + 1, dtype=np.float32).reshape(H, n)
    v = np.full((H, S), -3.0e38, dtype=np.float32)
    c = np.arange(H * S, dtype=np.float32).reshape(H, S)
    want = run_plain(F, ts, v, c)
    assert_bits(kernel_model(F, ts, v, c), want)
    assert (want[0][:, 18:] == NEG32).all()


# -- the scan engine's step against both reference steps ---------------------


def chain_query(tail=""):
    return (DEFINE + "partition with (k of S) begin @info(name='q') from "
            "every a=S[v > 8.0] -> b=S[u > 6.0] -> c=S[v > 10.0 and n > 3] "
            f"{tail}select c.v as cv insert into Alerts; end;")


def parse_both(app):
    jq = JaxCompiler.parse(app).execution_elements[0].queries[0]
    tq = SiddhiCompiler.parse(app).execution_elements[0].queries[0]
    jdef = JaxCompiler.parse(app).stream_definitions["S"]
    tdef = SiddhiCompiler.parse(app).stream_definitions["S"]
    return (jq.input_stream, jdef), (tq.input_stream, tdef)


def engines(H):
    (jst, jdef), (tst, tdef) = parse_both(chain_query())
    return (JaxScanEngine(jst, jdef, n_slots=H),
            HotKeyScanEngine(tst, tdef, n_slots=H, device="cpu"))


def step_inputs(H, n, seed):
    rng = np.random.default_rng(seed)
    cols = {"u": rng.uniform(0, 20, (H, n)).astype(np.float32),
            "v": rng.uniform(0, 20, (H, n)).astype(np.float32),
            "n": rng.integers(0, 8, (H, n)).astype(np.int32)}
    valid = np.zeros((H, n), dtype=bool)
    for h, k in enumerate(rng.integers(1, n + 1, H)):
        valid[h, :k] = True
    ts = np.sort(rng.integers(500, 4000, (H, n)), axis=1).astype(np.float32)
    return cols, ts, valid


def run_steps(je, te, H, n, seed, n_cycles=3):
    """Cycles of both engines' steps from the same start, a non-zero
    rebase ``delta`` on every cycle after the first."""
    jstate, tstate = je.init_state(), te.init_state()
    outs = []
    for cyc in range(n_cycles):
        cols, ts, valid = step_inputs(H, n, seed + cyc)
        delta = np.float32(0.0 if cyc == 0 else 37.0 * cyc)
        jstate, jemit, jn = je.make_step()(
            jstate, {k: jnp.asarray(a) for k, a in cols.items()},
            jnp.asarray(ts), jnp.asarray(valid), jnp.asarray(delta))
        tstate, temit, tn = te.step(
            tstate, {k: torch.from_numpy(a) for k, a in cols.items()},
            torch.from_numpy(ts), torch.from_numpy(valid),
            torch.tensor(delta))
        outs.append(((np.asarray(jstate["v"]), np.asarray(jstate["c"]),
                      np.asarray(jemit), int(jn)),
                     (tstate["v"].numpy(), tstate["c"].numpy(),
                      temit.numpy(), int(tn))))
    return outs


@pytest.mark.parametrize("H,n,seed", [(2, 16, 11), (4, 32, 12)])
def test_step_bit_exact_against_reference_kernel_step(H, n, seed,
                                                     pallas_io):
    je, te = engines(H)
    je.use_kernel = True
    total = 0
    for (jv, jc, je_, jn), (tv, tc, te_, tn) in run_steps(je, te, H, n, seed):
        assert_bits([tv, tc, te_], [jv, jc, je_])
        assert tn == jn
        total += tn
    assert total > 0


@pytest.mark.parametrize("H,n,seed", [(2, 16, 21), (3, 64, 22)])
def test_step_against_reference_two_pass_scan(H, n, seed):
    """The reference's XLA step: emissions and live lanes exact, dead
    lanes at or below NEG/2 in both (its contract with its kernel)."""
    je, te = engines(H)
    assert je.use_kernel is False
    total = 0
    for (jv, jc, je_, jn), (tv, tc, te_, tn) in run_steps(je, te, H, n, seed):
        assert np.array_equal(te_, je_) and tn == jn
        live = jv > NEG32 / 2
        assert np.array_equal(live, tv > NEG32 / 2)
        assert np.array_equal(tv[live], jv[live])
        assert np.array_equal(tc[live], jc[live])
        total += tn
    assert total > 0


@pytest.mark.parametrize("H,n,seed", [(2, 16, 31), (4, 64, 32),
                                      (8, 128, 33)])
def test_two_pass_scan_against_fused_scan_plain(H, n, seed):
    """The hot-key associative-scan route: the reference's two-pass XLA
    scan (``make_step`` with ``use_kernel = False``) against the port's
    ``fused_scan_plain`` on the same seeded ``[H, n, S]`` filter rows,
    timestamps and carried state (live starts, NEG lanes, counts):
    emissions and live lanes bit-equal, dead lanes at or below NEG/2.
    The port sends ``@app:hotkeys`` with or without
    ``@app:kernels('scan')`` through kernel 4, whose plain twin this is."""
    je, te = engines(H)
    assert je.use_kernel is False
    S = te.n_nodes
    _F, _ts, v, c = scan_inputs(H, n, S, seed)
    total = 0
    for cyc in range(3):
        cols, ts, valid = step_inputs(H, n, seed + cyc)
        delta = np.float32(0.0 if cyc == 0 else 41.0 * cyc)
        (jstate, jemit, jn) = je.make_step()(
            {"v": jnp.asarray(v), "c": jnp.asarray(c)},
            {k: jnp.asarray(a) for k, a in cols.items()},
            jnp.asarray(ts), jnp.asarray(valid), jnp.asarray(delta))
        # the same filter rows and rebased starts, into the plain twin
        env = {k: torch.from_numpy(a) for k, a in cols.items()}
        env["__n"] = n
        F = (te._filter_matrix(env, H, n)
             & torch.from_numpy(valid)[:, :, None]).to(torch.float32)
        vt = torch.from_numpy(v.copy())
        live = vt > NEG / 2
        live[:, 0] = False
        vt = torch.where(live, vt - float(delta), vt)
        nv, nc, emit = scan_chain.fused_scan_plain(
            F, torch.from_numpy(ts), vt, torch.from_numpy(c.copy()))
        jv, jc = np.asarray(jstate["v"]), np.asarray(jstate["c"])
        assert emit.numpy().tobytes() == np.asarray(jemit).tobytes()
        assert int(emit.sum()) == int(jn)
        jlive = jv > NEG32 / 2
        assert np.array_equal(jlive, nv.numpy() > NEG32 / 2)
        assert nv.numpy()[jlive].tobytes() == jv[jlive].tobytes()
        assert nc.numpy()[jlive].tobytes() == jc[jlive].tobytes()
        assert (nv.numpy()[~jlive] <= NEG32 / 2).all()
        total += int(jn)
        v, c = jv.copy(), jc.copy()
    assert total > 0


def test_pack_cycle_and_rebase_match_reference():
    je, te = engines(4)
    rng = np.random.default_rng(5)
    for cyc in range(3):
        B = 40
        ts = np.sort(rng.integers(1000 + 500 * cyc, 1400 + 500 * cyc, B))
        cols = {"k": rng.integers(0, 5, B), "u": rng.uniform(0, 20, B),
                "v": rng.uniform(0, 20, B),
                "n": rng.integers(0, 8, B).astype(np.int32)}
        slot_pos = {0: np.flatnonzero(cols["k"] == 1),
                    2: np.flatnonzero(cols["k"] == 3)}
        jput, jmeta = je.pack_cycle(slot_pos, cols, ts)
        tput, tmeta = te.pack_cycle(slot_pos, cols, ts)
        assert jmeta["n_pad"] == tmeta["n_pad"] and je.base_ts == te.base_ts
        assert sorted(jput) == sorted(tput)
        for k in jput:
            assert jput[k].dtype == tput[k].dtype
            assert np.array_equal(jput[k], tput[k]), k


# -- dense handoff converters ------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_dense_row_handoff_matches_reference(seed):
    je, te = engines(2)
    rng = np.random.default_rng(seed)
    S, I = je.n_nodes, 4
    for _ in range(20):
        active = rng.random((S, I)) < 0.5
        first = np.where(active, rng.integers(1, 10_000, (S, I)), 0
                         ).astype(np.int32)
        dense_base, scan_base = [int(x) for x in rng.integers(0, 5000, 2)]
        jv, jc = je.dense_row_to_slot(active, first, dense_base, scan_base)
        tv, tc = te.dense_row_to_slot(active, first, dense_base, scan_base)
        assert_bits([tv, tc], [jv, jc])
        cnt = rng.integers(0, 7, S).astype(np.float32)
        v = np.where(rng.random(S) < 0.7, rng.integers(-50, 3000, S),
                     NEG32).astype(np.float32)
        want = je.slot_to_dense_row(v, cnt, scan_base, dense_base, I)
        got = te.slot_to_dense_row(v, cnt, scan_base, dense_base, I)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1]) and got[1].dtype == want[1].dtype
        assert got[2] == want[2]


def test_scan_state_round_trip_from_reference():
    je, te = engines(3)
    host = {k: np.array(v) for k, v in je.init_state().items()}
    host["v"][1, 1] = np.float32(123.0)
    host["c"][1, 1] = np.float32(4.0)
    state = scan_state_from_numpy(te, host, 777)
    assert te.base_ts == 777
    back, base = scan_state_to_numpy(te, state)
    assert base == 777
    assert_bits([back["v"], back["c"]], [host["v"], host["c"]])
    with pytest.raises(ValueError):
        scan_state_from_numpy(te, {"v": host["v"][:2], "c": host["c"]}, 0)


# -- the space-saving sketch -------------------------------------------------


@pytest.mark.parametrize("cap,decay,seed", [(8, 0.9, 1), (16, 0.5, 2),
                                            (4, 1.0, 3)])
def test_sketch_decisions_match_reference(cap, decay, seed):
    js, ts = JaxSketch(cap, decay), SpaceSavingSketch(cap, decay)
    rng = np.random.default_rng(seed)
    for _ in range(40):
        ks = np.where(rng.random(64) < 0.4, 7, rng.integers(0, 40, 64))
        u, c = np.unique(ks, return_counts=True)
        js.update(u, c)
        ts.update(u, c)
        assert ts.counts == js.counts and ts.total == js.total
        for thr in (0.05, 0.2, 0.5):
            assert ts.heavy(thr) == js.heavy(thr)
        assert ts.share(7) == js.share(7)


def test_sketch_tie_break_matches_reference():
    js, ts = JaxSketch(16), SpaceSavingSketch(16)
    for sk in (js, ts):
        sk.update(np.asarray([3, 1, 2, 12]), np.asarray([10, 10, 10, 10]))
    assert ts.heavy(0.1) == js.heavy(0.1) == [1, 12, 2, 3]


# -- eligibility reasons -----------------------------------------------------


INELIGIBLE_CHAINS = {
    "non_every_head": "from a=S[v > 1.0] -> b=S[v > 2.0] ",
    "inner_every": "from a=S[v > 1.0] -> every b=S[v > 2.0] ",
    "one_node": "from every a=S[v > 1.0] ",
    "long_filter": "from every a=S[k > 1] -> b=S[v > 2.0] ",
    "within": "from every a=S[v > 1.0] -> b=S[v > 2.0] within 3 sec ",
    "sequence": "from every a=S[v > 1.0], b=S[v > 2.0] ",
}


@pytest.mark.parametrize("shape", sorted(INELIGIBLE_CHAINS))
def test_ineligible_chain_reasons_match_reference(shape):
    app = (DEFINE + "partition with (k of S) begin @info(name='q') "
           + INELIGIBLE_CHAINS[shape]
           + "select a.v as av insert into Alerts; end;")
    (jst, jdef), (tst, tdef) = parse_both(app)
    with pytest.raises(JaxCreationError) as want:
        JaxScanEngine(jst, jdef, n_slots=2)
    with pytest.raises(SiddhiAppCreationError) as got:
        HotKeyScanEngine(tst, tdef, n_slots=2, device="cpu")
    assert str(got.value) == str(want.value)
