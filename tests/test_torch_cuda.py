"""Card-only checks of the port's CUDA kernels (marker ``cuda``).

These skip where ``torch.cuda.is_available()`` is false, as on the CPU
test machines.  They import neither JAX nor the JAX package, so on a
machine with a card and no JAX they run without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held bit for bit against its plain torch version on the
same inputs (the packed and batch steps are pure int32 arithmetic, the
batch step's in-place state included, up to 32 instance lanes; the
fused scan's tree-order evaluation is exact on the engine's domain, and
a test pins what it does with NaN, which lies outside it).  The bank's
segmented reduce and its in-place accumulate are bit-exact on int32,
min/max and integer-valued lanes; float32 sums are held per row to
``n * 2^-24 * sum|v|`` (plus one rounding of the accumulate's final add
on each side).
"""

import numpy as np
import pytest
import torch

from siddhi_tpu_torch.kernels import (
    bank_scatter,
    dense_batch,
    dense_step,
    probe,
    scan_chain,
)
from siddhi_tpu_torch.kernels.plane_pack import pack_bits

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def packed_inputs(S, I, B, within, seed, device):
    """Seeded valid packed-step inputs: anchors only where active, some
    older than ``within``, busy lanes so placement overflows."""
    rng = np.random.default_rng(seed)
    Bp, _W, _ = dense_step._batch_blocks(B)
    w = within or 600_000
    ts = np.zeros(Bp, dtype=np.int64)
    ts[:B] = rng.integers(2 * w, 2**30, B)
    active = rng.random((S * I, Bp)) < 0.6
    active[:, B:] = False
    age = rng.integers(0, w + w // 4, (S * I, Bp))
    first = np.where(active, np.maximum(ts[None, :] - age, 1), 0)
    ok = rng.random((S, Bp)) < 0.5
    ok[:, B:] = False
    as_t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    return (pack_bits(as_t(ok)).to(device),
            pack_bits(as_t(active)).to(device),
            as_t(first.astype(np.int32)).to(device),
            as_t(ts.astype(np.int32)[None, :]).to(device))


def test_probe_kernel_adds_one(cuda_device):
    ok, reason = probe.kernels_available(cuda_device)
    assert ok, reason
    x = torch.arange(8 * 128, dtype=torch.int32,
                     device=cuda_device).reshape(8, 128)
    before = probe.add_one.launches
    y = probe.add_one(x)
    torch.cuda.synchronize()
    assert probe.add_one.launches == before + 1
    assert torch.equal(y, x + 1)


@pytest.mark.parametrize("S,I,B,within", [
    (1, 1, 32, None), (4, 4, 40, 3000), (16, 4, 1000, 600_000),
    (16, 4, 1056, 600_000), (5, 16, 2100, None), (3, 7, 100, 50),
])
def test_packed_step_kernel_matches_plain(cuda_device, S, I, B, within):
    ins = packed_inputs(S, I, B, within, seed=S * 100 + B, device=cuda_device)
    before = dense_step.packed_step.launches
    got = dense_step.packed_step(*ins, n_inst=I, within=within)
    torch.cuda.synchronize()
    assert dense_step.packed_step.launches == before + 1
    want = dense_step.packed_step_plain(*ins, I, within)
    names = ("active", "first", "emit", "anchor", "overflow")
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name


def test_engine_on_card_matches_cpu(cuda_device):
    from siddhi_tpu_torch import compile_pattern

    app = ("define stream S (k long, v double); @info(name='q') "
           "from every a=S[v > 2.0] -> b=S[v > 4.0] -> c=S[v > 6.0 and k > 3] "
           "within 2 sec select c.v as cv, c.k as ck insert into Alerts;")
    eng = {d: compile_pattern(app, "q", n_partitions=256, device=d)
           for d in ("cuda", "cpu")}
    state = {d: e.init_state() for d, e in eng.items()}
    rng = np.random.default_rng(4)
    t = 1000
    n_matches = 0
    for _ in range(8):
        part = rng.integers(0, 256, 400)
        cols = {"k": rng.integers(0, 9, 400), "v": rng.uniform(0, 8, 400)}
        ts = t + np.sort(rng.integers(0, 900, 400))
        t = int(ts[-1])
        res = {}
        for d, e in eng.items():
            state[d], ev, out = e.process(state[d], "S", part, cols, ts)
            res[d] = (ev, out)
        assert np.array_equal(res["cuda"][0], res["cpu"][0])
        assert np.array_equal(res["cuda"][1], res["cpu"][1])
        n_matches += len(res["cpu"][0])
    assert n_matches > 0
    for k in ("active", "first_ts", "overflow"):
        assert torch.equal(state["cuda"][k].cpu(), state["cpu"][k]), k


GENERAL_APPS = {
    # bench.py's headline chain cut to 4 states
    "headline_s4": (
        "define stream S (k long, v double); @info(name='q') from "
        "every e1=S[v > 0.0] -> e2=S[v > 1.0 and v > e1.v] -> "
        "e3=S[v > 2.0 and v > e1.v] -> e4=S[v > 3.0 and v > e1.v] "
        "within 10 min select e1.v as v1, e4.v as v4 insert into Alerts;",
        4),
    # an integer id-join with integer selects: the iregs bank
    "int_id_join": (
        "define stream S (k long, v double); @info(name='q') from "
        "every a=S[v > 5.0] -> b=S[k == a.k and v > a.v] within 2 sec "
        "select a.k as ak, a.v as av, b.v as bv insert into Alerts;", 4),
    # capture-free, past the batch step's 32 lanes
    "forty_lanes": (
        "define stream S (k long, v double); @info(name='q') from "
        "every a=S[v > 1.0] -> b=S[v > 7.5] -> c=S[v > 2.0] within 2 sec "
        "select c.v as cv insert into Alerts;", 40),
    # part b: an open count on the last node (BASELINE config 2's shape)
    "count_last": (
        "define stream S (k long, v double); @info(name='q') from "
        "every a=S[v > 5.0] -> b=S[v > a.v]<3:5> within 2 sec "
        "select a.v as av, b[0].v as b0, b[last].v as bl "
        "insert into Alerts;", 4),
    # a Kleene head cloning through the last node (emit bank 1), with an
    # integer capture
    "kleene_via": (
        "define stream S (k long, v double); @info(name='q') from "
        "every f=S[v < 4.0]<2:> -> s=S[v > 6.0] within 2 sec "
        "select f[0].v as f0, f[last].k as fk, s.v as sv "
        "insert into Alerts;", 4),
    # an open count mid-chain: the via-path places into node 2
    "open_mid": (
        "define stream S (k long, v double); @info(name='q') from "
        "every a=S[v > 6.0] -> b=S[v > 2.0]<1:3> -> c=S[v > b[last].v] "
        "within 2 sec select a.v as av, b[last].v as bl, c.v as cv "
        "insert into Alerts;", 4),
    # logical nodes: one event fills both sides of `and`; `or` takes the
    # first side
    "and_same_stream": (
        "define stream S (k long, v double); @info(name='q') from "
        "every a=S[v > 4.0] -> (b=S[v > a.v] and c=S[k == 1]) within 2 sec "
        "select a.v as av, b.v as bv, c.k as ck insert into Alerts;", 4),
    "or_head": (
        "define stream S (k long, v double); @info(name='q') from "
        "every (a=S[v > 7.0] or b=S[k == 2]) -> c=S[v < 1.0] within 2 sec "
        "select a.v as av, b.k as bk, c.v as cv insert into Alerts;", 4),
    # a strict-contiguity sequence, a non-every head, a group-every
    "sequence": (
        "define stream S (k long, v double); @info(name='q') from "
        "every a=S[v > 2.0], b=S[v > a.v], c=S[v > b.v] within 2 sec "
        "select a.v as av, c.v as cv insert into Alerts;", 4),
    "non_every": (
        "define stream S (k long, v double); @info(name='q') from "
        "a=S[v > 6.0]<2:3> -> b=S[v < 1.0] within 2 sec "
        "select a[0].v as a0, b.v as bv insert into Alerts;", 4),
    "group_every": (
        "define stream S (k long, v double); @info(name='q') from "
        "every (a=S[v > 6.0] -> b=S[v > a.v]) within 2 sec "
        "select a.v as av, b.v as bv insert into Alerts;", 4),
}


@pytest.mark.parametrize("case", sorted(GENERAL_APPS))
def test_general_step_on_card_matches_cpu(cuda_device, case):
    """The general step (torch ops) on the card against the same engine
    on the CPU: matches, output bits and the whole state, registers
    included, over batches with colliding partitions (several rounds)
    and values that hit the register move's edge cases."""
    from siddhi_tpu_torch import compile_pattern, state_to_numpy

    app, n_inst = GENERAL_APPS[case]
    eng = {d: compile_pattern(app, "q", n_partitions=64, device=d,
                              n_instances=n_inst) for d in ("cuda", "cpu")}
    assert eng["cuda"].step_kind == "general"
    state = {d: e.init_state() for d, e in eng.items()}
    rng = np.random.default_rng(5)
    specials = np.array([-0.0, np.nan, 1e-40, -1e-40, 3.0])
    t, n_matches = 1000, 0
    for _ in range(6):
        part = rng.integers(0, 64, 300)
        v = rng.uniform(0, 8, 300)
        v[rng.random(300) < 0.05] = rng.choice(specials)
        cols = {"k": rng.integers(0, 3, 300), "v": v}
        ts = t + np.sort(rng.integers(0, 900, 300))
        t = int(ts[-1])
        res = {}
        for d, e in eng.items():
            state[d], ev, out = e.process(state[d], "S", part, cols, ts)
            res[d] = (ev, out)
        assert np.array_equal(res["cuda"][0], res["cpu"][0])
        got, want = res["cuda"][1], res["cpu"][1]
        assert got.dtype == want.dtype and got.shape == want.shape
        if got.dtype == object:
            got = np.array(got.tolist(), dtype=np.float64)
            want = np.array(want.tolist(), dtype=np.float64)
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
        n_matches += len(res["cpu"][0])
    assert n_matches > 0
    card, _ = state_to_numpy(eng["cuda"], state["cuda"])
    cpu, _ = state_to_numpy(eng["cpu"], state["cpu"])
    for k in cpu:
        assert np.array_equal(card[k].view(np.uint8), cpu[k].view(np.uint8)), k


def test_two_stream_logical_on_card_matches_cpu(cuda_device):
    """BASELINE config 4's shape, ``every (t=Tick[...] and n=News[...])
    within 5 sec``, on the card against the CPU over alternating
    batches: matches, output bits and the whole state (side bitmasks in
    ``counts``)."""
    from siddhi_tpu_torch import compile_pattern, state_to_numpy

    app = ("define stream Tick (sym long, price double); "
           "define stream News (sym long, score double); "
           "@info(name='q') from every (t=Tick[price > 10.0] and "
           "n=News[score > 0.5]) within 5 sec "
           "select t.price as p, n.score as sc insert into Alerts;")
    eng = {d: compile_pattern(app, "q", n_partitions=64, device=d)
           for d in ("cuda", "cpu")}
    state = {d: e.init_state() for d, e in eng.items()}
    rng = np.random.default_rng(6)
    n_matches = 0
    for i in range(8):
        stream, B = ("Tick", 400) if i % 2 == 0 else ("News", 60)
        part = rng.integers(0, 64, B)
        col = "price" if stream == "Tick" else "score"
        cols = {"sym": part, col: rng.uniform(0, 20 if i % 2 == 0 else 1, B)}
        ts = 1000 + 500 * i + np.sort(rng.integers(0, 500, B))
        res = {}
        for d, e in eng.items():
            state[d], ev, out = e.process(state[d], stream, part, cols, ts)
            res[d] = (ev, out)
        assert np.array_equal(res["cuda"][0], res["cpu"][0])
        assert np.array_equal(res["cuda"][1].view(np.uint8),
                              res["cpu"][1].view(np.uint8))
        n_matches += len(res["cpu"][0])
    assert n_matches > 0
    card, _ = state_to_numpy(eng["cuda"], state["cuda"])
    cpu, _ = state_to_numpy(eng["cpu"], state["cpu"])
    for k in cpu:
        assert np.array_equal(card[k].view(np.uint8), cpu[k].view(np.uint8)), k


def test_unpartitioned_capture_app_on_card_matches_cpu(cuda_device):
    """An unpartitioned capturing pattern (one partition, a round an
    event) through ``SiddhiManager`` on the card and on the CPU."""
    from siddhi_tpu_torch import SiddhiManager

    app = ("@app:playback @app:execution('tpu') "
           "define stream S (k long, u double, v double); @info(name='q') "
           "from every a=S[v > 10.0] -> b=S[v > a.v] within 3 sec "
           "select a.v as av, b.v as bv insert into Alerts;")
    rng = np.random.default_rng(8)
    sends = [([int(rng.integers(0, 3)), float(rng.uniform(0, 20)),
               float(rng.uniform(0, 20))], 1000 + 37 * i) for i in range(300)]
    rows = {}
    for d in ("cuda", "cpu"):
        mgr = SiddhiManager(device=d)
        rt = mgr.create_siddhi_app_runtime(app)
        got = []
        rt.add_callback("Alerts", lambda evs, got=got: got.extend(
            (e.timestamp, list(e.data)) for e in evs))
        rt.start()
        h = rt.get_input_handler("S")
        for row, ts in sends:
            h.send(row, timestamp=ts)
        assert rt.lowering(step_kinds=True) == {"q": "dense/general"}
        rt.shutdown()
        mgr.shutdown()
        rows[d] = got
    assert rows["cuda"] == rows["cpu"] and rows["cpu"]


ABSENT_APPS = {
    # a mid-chain absent node under within: kills, arming, timer advance
    "mid_within": (
        "define stream S (k long, v double); define stream T (k long, "
        "v double); @info(name='q') from every a=S[v > 6.0] -> "
        "not T[v > a.v] for 400 millisec -> c=S[v > a.v] within 2 sec "
        "select a.v as av, c.v as cv insert into Alerts;"),
    # `and not ... for`, then a trailing absent node: timer emits with
    # float and integer register outputs
    "and_not_trailing": (
        "define stream S (k long, v double); define stream T (k long, "
        "v double); @info(name='q') from every a=S[v > 6.0] -> "
        "(b=S[v > a.v] and not T[v > 7.0] for 300 millisec) -> "
        "not T[v > b.v] for 500 millisec "
        "select a.k as ak, b.v as bv insert into Alerts;"),
}


@pytest.mark.parametrize("case", sorted(ABSENT_APPS))
def test_timer_step_on_card_matches_cpu(cuda_device, case):
    """Absent deadlines on the card against the CPU: event batches on
    both streams (kills, and-not completions, deadline arming), each
    after a tick to its last timestamp as the scheduler runs them, then
    ticks past every deadline: the event matches, the timer fires (in
    (fire time, row, lane) order) and the whole state, ``deadline``
    included, bit for bit."""
    from siddhi_tpu_torch import compile_pattern, state_to_numpy

    app = ABSENT_APPS[case]
    eng = {d: compile_pattern(app, "q", n_partitions=64, device=d)
           for d in ("cuda", "cpu")}
    assert eng["cuda"].step_kind == "general" and eng["cuda"].has_deadlines
    state = {d: e.init_state() for d, e in eng.items()}
    rng = np.random.default_rng(9)
    t, n_fired, n_matches = 1000, 0, 0

    def tick(now):
        fired = {}
        for d, e in eng.items():
            state[d], fired[d] = e.on_time_state(state[d], now)
        assert (fired["cuda"] is None) == (fired["cpu"] is None)
        if fired["cpu"] is None:
            return 0
        for g, w in zip(fired["cuda"], fired["cpu"]):
            if g.dtype == object:
                g = np.array(g.tolist(), dtype=np.float64)
                w = np.array(w.tolist(), dtype=np.float64)
            assert np.array_equal(g.view(np.uint8), w.view(np.uint8))
        return len(fired["cpu"][1])

    for i in range(10):
        stream = "S" if i % 3 != 2 else "T"
        part = rng.integers(0, 64, 200)
        cols = {"k": rng.integers(0, 3, 200), "v": rng.uniform(0, 8, 200)}
        ts = t + np.sort(rng.integers(0, 300, 200))
        t = int(ts[-1])
        n_fired += tick(t)
        res = {}
        for d, e in eng.items():
            state[d], ev, out = e.process(state[d], stream, part, cols, ts)
            res[d] = (ev, out)
        assert np.array_equal(res["cuda"][0], res["cpu"][0])
        got, want = res["cuda"][1], res["cpu"][1]
        if got.dtype == object:
            got = np.array(got.tolist(), dtype=np.float64)
            want = np.array(want.tolist(), dtype=np.float64)
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
        n_matches += len(res["cpu"][0])
    for now in (t + 200, t + 400, t + 5000):
        n_fired += tick(now)
    # the trailing case emits from the timer, the mid-chain one from
    # events after the timer moved its instances on
    assert n_fired if case == "and_not_trailing" else n_matches
    assert eng["cuda"].next_wakeup_state(state["cuda"]) == \
        eng["cpu"].next_wakeup_state(state["cpu"])
    card, _ = state_to_numpy(eng["cuda"], state["cuda"])
    cpu, _ = state_to_numpy(eng["cpu"], state["cpu"])
    for k in cpu:
        assert np.array_equal(card[k].view(np.uint8), cpu[k].view(np.uint8)), k


def test_absent_purge_app_on_card_matches_cpu(cuda_device):
    """A partitioned absent app under ``@purge`` through ``SiddhiManager``
    on the card and on the CPU: timer matches at their deadlines, idle
    keys' rows recycled, the same callbacks and key maps."""
    from siddhi_tpu_torch import SiddhiManager

    app = ("@app:playback @app:execution('tpu', partitions='16') "
           "define stream S (k long, v double); "
           "define stream T (k long, v double); "
           "@purge(enable='true', interval='1 sec', idle.period='2 sec') "
           "partition with (k of S, k of T) begin @info(name='q') "
           "from every a=S[v > 5.0] -> not T[v > a.v] for 1 sec "
           "select a.k as ak, a.v as av insert into Alerts; end;")
    rng = np.random.default_rng(10)
    sends, t = [], 1000
    for i in range(300):
        # three phases of 8 keys each, 4 s apart: the keys churn
        t += int(rng.integers(1, 30)) + (4000 if i % 100 == 0 else 0)
        key = int(rng.integers(0, 8)) + 8 * (i // 100)
        sends.append(("S" if rng.random() < 0.6 else "T",
                      [key, float(rng.uniform(0, 8))], t))
    rows = {}
    for d in ("cuda", "cpu"):
        mgr = SiddhiManager(device=d)
        rt = mgr.create_siddhi_app_runtime(app)
        got = []
        rt.add_callback("Alerts", lambda evs, got=got: got.extend(
            (e.timestamp, list(e.data)) for e in evs))
        rt.start()
        for stream, row, ts in sends:
            rt.get_input_handler(stream).send(row, timestamp=ts)
        rt.get_input_handler("S").send([999, 0.0], timestamp=t + 10_000)
        proc = rt.pattern_runtimes()["q"]
        rows[d] = (got, dict(proc._key_rows), list(proc._free_rows),
                   proc.time_fires)
        rt.shutdown()
        mgr.shutdown()
    assert rows["cuda"] == rows["cpu"]
    assert rows["cpu"][0] and rows["cpu"][2] and rows["cpu"][3]


def batch_step_inputs(S, I, N, P, within, seed, long_seg=0):
    """Seeded batch-step inputs on the CPU: a mid-chain state (anchors
    only where active, some past ``within``), Zipf(1.2) partitions (every
    event on its own partition when ``N == P``; ``long_seg`` events on
    partition 0), ok flags and ascending ts."""
    from siddhi_tpu_torch.ops.dense_nfa import partition_segments

    rng = np.random.default_rng(seed)
    w = within or 600_000
    now = 5_000_000
    active = rng.random((P + 1, S, I)) < 0.3
    age = rng.integers(0, w + w // 4, (P + 1, S, I))
    first = np.where(active, now - age, 0).astype(np.int32)
    state = {"active": torch.from_numpy(active),
             "first_ts": torch.from_numpy(first),
             "overflow": torch.from_numpy(
                 rng.integers(0, 5, P + 1).astype(np.int32))}
    if N == P:
        part = rng.permutation(P)
    else:
        part = 1 + (rng.zipf(1.2, N) - 1) % (P - 1)
        part[rng.choice(N, long_seg, replace=False)] = 0
    ok = rng.random((N, S)) < 0.5
    ts = now + np.sort(rng.integers(0, w // 2, N))
    segs = partition_segments(part.astype(np.int32))
    return state, [torch.from_numpy(a) for a in segs] + [
        torch.from_numpy(ok), torch.from_numpy(ts.astype(np.int32))]


@pytest.mark.parametrize("S,I,N,P,within,long_seg", [
    (16, 4, 65536, 65536, 600_000, 0),   # the 1 M cell's shape, cut
    (2, 8, 8192, 4096, None, 600),       # a routed batch: one 600-event key
    (2, 8, 1, 16, None, 0),              # N = 1
    (32, 16, 2048, 512, 3000, 40),       # 16 lanes at 32 nodes
    (32, 32, 2048, 512, 3000, 40),       # the shared-memory ceiling
    (4, 32, 8192, 1024, None, 300),      # 32 lanes, a long segment
    (3, 7, 3000, 300, 50, 100),          # ragged lanes, short horizon
])
def test_batch_step_kernel_matches_plain(cuda_device, S, I, N, P, within,
                                         long_seg):
    """Bit for bit against ``batch_step_plain`` on the same card inputs,
    the in-place state included; two launches on clones of one state
    give the same bits; one counted launch a call."""
    host, batch = batch_step_inputs(S, I, N, P, within, seed=S * I + N,
                                    long_seg=long_seg)
    batch = [t.to(cuda_device) for t in batch]
    states = [{k: v.to(cuda_device) for k, v in host.items()}
              for _ in range(3)]
    before = dense_batch.batch_step.launches
    got = dense_batch.batch_step(states[0], *batch, n_inst=I, within=within)
    again = dense_batch.batch_step(states[1], *batch, n_inst=I,
                                   within=within)
    torch.cuda.synchronize()
    assert dense_batch.batch_step.launches == before + 2
    want = dense_batch.batch_step_plain(states[2], *batch, I, within)
    for name, g, a, w in zip(("emit", "anchor", "n_emit"), got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name
        assert torch.equal(g, a), name
    for k in host:
        assert torch.equal(states[0][k], states[2][k]), k
        assert torch.equal(states[0][k], states[1][k]), k
    if long_seg:
        assert int((batch[1][1:] - batch[1][:-1]).max()) >= long_seg


def scan_inputs(H, n, S, seed, device):
    """Seeded fused-scan inputs: 0/1 filter rows with all-zero padding,
    live starts mixed with NEG, integer-valued counts."""
    rng = np.random.default_rng(seed)
    F = (rng.random((H, n, S + 1)) < 0.55).astype(np.float32)
    for h, k in enumerate(rng.integers(1, n + 1, H)):
        F[h, k:] = 0.0
    ts = np.sort(rng.integers(1, 1 << 20, (H, n)), axis=1).astype(np.float32)
    live = rng.random((H, S)) < 0.6
    v = np.where(live, rng.integers(-5000, 100_000, (H, S)),
                 np.float32(scan_chain.NEG)).astype(np.float32)
    c = np.where(live, rng.integers(1, 100, (H, S)), 0).astype(np.float32)
    v[:, 0] = 0.0
    c[:, 0] = 1.0
    return [torch.from_numpy(a).to(device) for a in (F, ts, v, c)]


@pytest.mark.parametrize("H,n,S", [(1, 16, 2), (3, 16, 5), (8, 2048, 2),
                                   (5, 64, 32), (256, 128, 7),
                                   (4, 8192, 3), (256, 4096, 32)])
def test_scan_chain_kernel_matches_plain(cuda_device, H, n, S):
    """Bit for bit on every lane, dead lanes included; n = 8,192 and
    4,096 take more than one 2,048-event tile."""
    ins = scan_inputs(H, n, S, seed=H * n + S, device=cuda_device)
    before = scan_chain.fused_scan.launches
    got = scan_chain.fused_scan(*ins)
    torch.cuda.synchronize()
    assert scan_chain.fused_scan.launches == before + 1
    want = scan_chain.fused_scan_plain(*ins)
    for name, g, w in zip(("v", "c", "emit"), got, want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), name


def test_scan_chain_kernel_floors_dead_starts(cuda_device):
    """Every filter set moves each lane's start one lane up an event, so
    dead starts below NEG (-3e38) would reach the output unfloored; the
    kernel floors them at NEG as the plain version does."""
    H, n, S = 2, 16, 32
    ins = [torch.ones((H, n, S + 1)),
           torch.arange(1, H * n + 1, dtype=torch.float32).reshape(H, n),
           torch.full((H, S), -3.0e38),
           torch.arange(H * S, dtype=torch.float32).reshape(H, S)]
    got = scan_chain.fused_scan(*(t.to(cuda_device) for t in ins))
    want = scan_chain.fused_scan_plain(*ins)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))
    assert (want[0][:, 18:] == np.float32(scan_chain.NEG)).all()


def test_scan_chain_kernel_takes_unaligned_views(cuda_device):
    """The kernel reads F and ts as 16-byte vectors: views that start
    one float into their storage give the same bits as fresh tensors."""
    ins = scan_inputs(3, 64, 5, seed=5, device=cuda_device)
    views = []
    for t in ins[:2]:
        buf = torch.empty(t.numel() + 1, device=cuda_device)
        views.append(buf[1:].view(t.shape).copy_(t))
    assert all(t.data_ptr() % 16 for t in views)
    got = scan_chain.fused_scan(*views, *ins[2:])
    want = scan_chain.fused_scan(*ins)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def segmented_walk(F, ts, v, c):
    """The kernel's recurrence walked event by event: lane ``i`` a
    segmented max-scan and sum-scan of lane ``i-1``'s pre-update values
    (``kernels/scan_chain.py``), ``v`` floored at NEG on load, max
    propagating NaN."""
    H, n, Sp1 = F.shape
    S = Sp1 - 1
    neg = torch.tensor(scan_chain.NEG, dtype=torch.float32)
    v, c = torch.maximum(v, neg), c.clone()
    emit = torch.empty((H, n), dtype=torch.float32)
    for e in range(n):
        f = F[:, e] > 0.5
        emit[:, e] = torch.where(
            f[:, S] & (v[:, S - 1] > scan_chain.NEG / 2), c[:, S - 1], 0.0)
        src = torch.cat([v[:, :1], ts[:, e:e + 1], v[:, 1:S - 1]], dim=1)
        q = torch.cat([c[:, :1], c[:, :S - 1]], dim=1)
        fi, keep = f[:, :S], ~f[:, 1:]
        nv = torch.maximum(torch.where(fi, src, neg),
                           torch.where(keep, v, neg))
        nc = torch.where(fi, q, 0.0) + torch.where(keep, c, 0.0)
        nv[:, 0], nc[:, 0] = 0.0, 1.0
        v, c = nv, nc
    return v, c, emit


def test_scan_chain_kernel_on_nan(cuda_device):
    """NaN lies outside the kernel's domain; this pins what it does.  A
    NaN timestamp (slot 0, lane 1) and a NaN start (slot 1, lane 2): the
    kernel computes ``segmented_walk`` bit for bit, NaN positions
    included, so a NaN leaves a lane at its next reset.  The plain
    version (the Pallas body) keeps ``NEG + NaN`` on a lane for good and
    passes it up the chain: its NaNs are a superset of the kernel's, and
    off them the two agree; counts agree everywhere; the kernel emits
    wherever the plain version does, and also where the plain version's
    last lane is stuck at NaN.  Slots 2 and 3 hold no NaN and agree bit
    for bit."""
    H, n, S = 4, 4096, 4
    F, ts, v, c = scan_inputs(H, n, S, seed=77, device="cpu")
    rng = np.random.default_rng(78)
    F[:2] = torch.from_numpy((rng.random((2, n, S + 1)) < 0.55).astype(
        np.float32))
    F[0, 5, 1] = 1.0
    ts[0, 5] = float("nan")
    v[1, 2] = float("nan")
    got = [t.cpu() for t in scan_chain.fused_scan(
        *(t.to(cuda_device) for t in (F, ts, v, c)))]
    for g, w in zip(got, segmented_walk(F, ts, v, c)):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        keep = ~torch.isnan(w)
        assert torch.equal(g[keep].view(torch.int32), w[keep].view(torch.int32))
    (gv, gc, ge), (pv, pc, pe) = got, scan_chain.fused_scan_plain(F, ts, v, c)
    bits = lambda t: t.view(torch.int32)
    assert torch.equal(bits(gc), bits(pc))
    assert torch.isnan(pv[:2]).any() and not torch.isnan(gv).any()
    real = ~torch.isnan(pv)
    assert torch.equal(bits(gv[real]), bits(pv[real]))
    fired = pe > 0
    assert torch.equal(ge[fired], pe[fired]) and bool((ge >= pe).all())
    assert bool((ge[:2] > pe[:2]).any())
    assert torch.equal(bits(ge[2:]), bits(pe[2:]))
    assert torch.equal(bits(gv[2:]), bits(pv[2:]))


ROUTED_APP = ("@app:playback @app:execution('tpu', instances='8'{opts}) "
              "@app:hotkeys(k='4', promote='0.3', demote='0.1') "
              "define stream S (k long, u double, v double); "
              "partition with (k of S) begin @info(name='q') "
              "from every a=S[v > 8.0] -> b=S[u > 6.0] -> c=S[v > 12.0] "
              "select c.v as cv insert into Alerts; end;")


def test_hot_key_app_on_card_matches_cpu(cuda_device):
    """A routed app through SiddhiManager: the card's callbacks equal the
    CPU run's, and the scan and batch-step kernels both launched."""
    from siddhi_tpu_torch import SiddhiManager

    app = ROUTED_APP.format(opts="")
    rng = np.random.default_rng(9)
    sends, t = [], 1000
    for _ in range(300):
        t += int(rng.integers(1, 40))
        k = 7 if rng.random() < 0.8 else int(rng.integers(0, 30))
        sends.append(([k, float(rng.uniform(0, 20)),
                       float(rng.uniform(0, 20))], t))
    before = (scan_chain.fused_scan.launches,
              dense_batch.batch_step.launches)
    got = {}
    for d in ("cuda", "cpu"):
        rt = SiddhiManager(device=d).create_siddhi_app_runtime(app)
        out = got[d] = []
        rt.add_callback("Alerts", lambda evs, out=out: out.append(
            [(e.timestamp, e.data) for e in evs]))
        rt.start()
        h = rt.get_input_handler("S")
        for row, ts in sends:
            h.send(row, timestamp=ts)
        assert rt.pattern_runtimes()["q"].hot_metrics()["hotkeyPromotions"] >= 1
        rt.shutdown()
    assert got["cuda"] == got["cpu"] and got["cpu"]
    assert scan_chain.fused_scan.launches > before[0]
    assert dense_batch.batch_step.launches > before[1]


BANK_IDENT = {"float32": {"sum": 0.0, "count": 0.0, "min": float("inf"),
                          "max": float("-inf")},
              "int32": {"sum": 0, "min": 2**31 - 1, "max": -(2**31)}}


def bank_inputs(n, r_pad, op, dtype, seed, hot=False):
    """Zipf-skewed rows (all on row 0 when ``hot``), values of the lane
    kind; NaN, infinities and signed zeros mixed into float extrema."""
    rng = np.random.default_rng(seed)
    rows = (np.zeros(n) if hot else (rng.zipf(1.2, n) - 1) % r_pad)
    if op == "count":
        vals = np.ones(n)
    elif dtype == "int32":
        vals = rng.integers(-(2**31), 2**31 - 1, n)
    else:
        vals = rng.uniform(-500.0, 500.0, n)
        if op in ("min", "max"):
            sp = rng.random(n)
            vals[sp < 0.002] = np.nan
            vals[(sp >= 0.002) & (sp < 0.004)] = np.inf
            vals[(sp >= 0.004) & (sp < 0.006)] = -np.inf
            vals[(sp >= 0.006) & (sp < 0.01)] = -0.0
            vals[(sp >= 0.01) & (sp < 0.014)] = 0.0
    return (torch.from_numpy(rows.astype(np.int32)),
            torch.from_numpy(vals.astype(dtype)))


@pytest.mark.parametrize("n,r_pad,hot", [
    (256, 256, False), (32768, 4352, False), (32768, 4096, True),
    (4096, 8960, False), (1 << 17, 4352, False)])
@pytest.mark.parametrize("op,dtype", [
    ("sum", "float32"), ("count", "float32"), ("min", "float32"),
    ("max", "float32"), ("sum", "int32"), ("min", "int32"), ("max", "int32")])
def test_bank_scatter_kernel_matches_plain(cuda_device, n, r_pad, hot, op,
                                           dtype):
    rows, vals = bank_inputs(n, r_pad, op, dtype, seed=n + r_pad, hot=hot)
    ident = BANK_IDENT[dtype][op]
    r_d, v_d = rows.to(cuda_device), vals.to(cuda_device)
    before = bank_scatter.segmented_reduce.launches
    got = bank_scatter.segmented_reduce(r_d, v_d, r_pad, op, ident)
    again = bank_scatter.segmented_reduce(r_d, v_d, r_pad, op, ident)
    torch.cuda.synchronize()
    assert bank_scatter.segmented_reduce.launches == before + 2
    # deterministic: the same bits on every launch
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    got = got.cpu()
    want = bank_scatter.segmented_reduce_plain(rows, vals, r_pad, op, ident)
    if op == "sum" and dtype == "float32":
        n_r = torch.zeros(r_pad, dtype=torch.float64).index_add_(
            0, rows.long(), torch.ones(n, dtype=torch.float64))
        abs_r = torch.zeros(r_pad, dtype=torch.float64).index_add_(
            0, rows.long(), vals.double().abs())
        err = (got.double() - want.double()).abs()
        assert bool((err <= n_r * 2.0**-24 * abs_r).all())
        return
    nan = torch.isnan(want) if dtype == "float32" else torch.zeros_like(
        want, dtype=torch.bool)
    assert torch.equal(torch.isnan(got) if dtype == "float32" else nan, nan)
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def bank_acc(R, op, dtype, seed):
    """A live accumulator of the lane kind: earlier sums, counts or
    extrema, with NaN, infinities and signed zeros in float extrema."""
    rng = np.random.default_rng(seed)
    if op == "count":
        acc = rng.integers(0, 1000, R)
    elif dtype == "int32":
        acc = rng.integers(-(2**31), 2**31 - 1, R)
    else:
        acc = rng.uniform(-2000.0, 2000.0, R)
        if op in ("min", "max"):
            acc[rng.random(R) < 0.01] = np.nan
            acc[rng.random(R) < 0.01] = -np.inf if op == "max" else np.inf
            acc[rng.random(R) < 0.02] = -0.0
    return torch.from_numpy(acc.astype(dtype))


@pytest.mark.parametrize("n,R,hot", [
    (32768, 4097, False), (32768, 4097, True), (256, 333, False),
    (4096, 8960, False)])
@pytest.mark.parametrize("op,dtype", [
    ("sum", "float32"), ("count", "float32"), ("min", "float32"),
    ("max", "float32"), ("sum", "int32"), ("min", "int32"), ("max", "int32")])
def test_accumulate_kernel_matches_plain(cuda_device, n, R, hot, op, dtype):
    """``accumulate_`` in place against ``accumulate_plain``: the bank's
    shape (4,097 rows), every event on row 0, and ragged shapes.  Exact
    but for float32 sums, held per row to ``n * 2^-24 * sum|v|`` plus one
    rounding of the final add on each side; two launches on clones of
    one accumulator give the same bits; one counted launch a call."""
    rows, vals = bank_inputs(n, R, op, dtype, seed=n + R, hot=hot)
    acc = bank_acc(R, op, dtype, seed=R + n)
    r_d, v_d = rows.to(cuda_device), vals.to(cuda_device)
    got, again = acc.to(cuda_device), acc.to(cuda_device)
    before = (bank_scatter.accumulate_.launches,
              bank_scatter.segmented_reduce.launches)
    assert bank_scatter.accumulate_(got, r_d, v_d, op) is got
    assert bank_scatter.accumulate_.launches == before[0] + 1
    bank_scatter.accumulate_(again, r_d, v_d, op)
    torch.cuda.synchronize()
    assert (bank_scatter.accumulate_.launches,
            bank_scatter.segmented_reduce.launches) == (before[0] + 2,
                                                       before[1])
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    got = got.cpu()
    want = bank_scatter.accumulate_plain(acc.clone(), rows, vals, op)
    if op == "sum" and dtype == "float32":
        n_r = torch.zeros(R, dtype=torch.float64).index_add_(
            0, rows.long(), torch.ones(n, dtype=torch.float64))
        abs_r = torch.zeros(R, dtype=torch.float64).index_add_(
            0, rows.long(), vals.double().abs())
        g, w = got.double(), want.double()
        bound = n_r * 2.0**-24 * abs_r + 2.0**-24 * (g.abs() + w.abs())
        assert bool(((g - w).abs() <= bound).all())
        return
    nan = torch.isnan(want) if dtype == "float32" else torch.zeros_like(
        want, dtype=torch.bool)
    assert torch.equal(torch.isnan(got) if dtype == "float32" else nan, nan)
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def test_aggregation_app_on_card_matches_cpu(cuda_device):
    """The docs app through SiddhiManager on the card and on the CPU: the
    same pulls, and two kernel launches per banked batch (either entry)."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core.event import EventBatch

    base = 1_496_289_777_000
    app = ("@app:playback @app:execution('tpu') @app:kernels('bank') "
           "define stream T (symbol string, price double, volume long, "
           "timestamp long); define aggregation A from T select symbol, "
           "avg(price) as avgPrice, sum(price) as total, count() as n "
           "group by symbol aggregate by timestamp every sec ... year;")
    rng = np.random.default_rng(29)
    batches = []
    for b in range(6):
        i = np.arange(b * 4096, (b + 1) * 4096)
        sym = (rng.zipf(1.2, 4096) - 1) % 256
        batches.append({"symbol": np.asarray([f"S{s}" for s in sym], object),
                        "price": rng.uniform(1, 500, 4096),
                        "volume": rng.integers(1, 10_000, 4096),
                        "timestamp": base + i // 1000})
    out = {}
    launched = lambda: (bank_scatter.segmented_reduce.launches
                        + bank_scatter.accumulate_.launches)
    before = launched()
    for d in ("cuda", "cpu"):
        rt = SiddhiManager(device=d).create_siddhi_app_runtime(app)
        rt.start()
        h = rt.get_input_handler("T")
        for cols in batches:
            h.send_batch(EventBatch("T", list(cols), cols, cols["timestamp"]))
        out[d] = [[(e.timestamp, e.data) for e in rt.query(
            f"from A within {base - 60_000}, {base + 86_400_000} per '{p}' "
            "select symbol, avgPrice, total, n;")] for p in ("seconds", "minutes")]
        out[d + "_scatters"] = rt.aggregations["A"]._bank.scatters
        rt.shutdown()
    # the app's two lanes (sum, count) go through accumulate_
    assert launched() - before == 2 * out["cuda_scatters"]
    assert out["cuda_scatters"] == out["cpu_scatters"] == 6
    for got, want in zip(out["cuda"], out["cpu"]):
        assert len(got) == len(want) > 0
        for (tg, g), (tw, w) in zip(got, want):
            assert tg == tw and g[0] == w[0] and g[3] == w[3]
            assert g[2] == pytest.approx(w[2], rel=w[3] * 2.0**-24)
            assert g[1] == pytest.approx(w[1], rel=w[3] * 2.0**-24)


def _sends_card_vs_cpu(app, sends, out="Alerts", tick=None):
    """``sends`` through ``SiddhiManager`` on the card and on the CPU:
    the callbacks (values, timestamps, order) of each."""
    from siddhi_tpu_torch import SiddhiManager

    rows = {}
    for d in ("cuda", "cpu"):
        mgr = SiddhiManager(device=d)
        rt = mgr.create_siddhi_app_runtime(app)
        got = []
        rt.add_callback(out, lambda evs, got=got: got.extend(
            (e.timestamp, [v.hex() if isinstance(v, float) else v
                           for v in e.data]) for e in evs))
        rt.start()
        for stream, row, ts in sends:
            rt.get_input_handler(stream).send(row, timestamp=ts)
        if tick is not None:
            rt.get_input_handler(tick[0]).send(tick[1], timestamp=tick[2])
        rows[d] = got
        rt.shutdown()
        mgr.shutdown()
    return rows


def _txn(seed, n, cards):
    rng = np.random.default_rng(seed)
    out, t = [], 1000
    for _ in range(n):
        t += int(rng.integers(1, 60))
        out.append(("Txn", [int(rng.integers(0, cards)),
                            float(np.round(rng.lognormal(4.0, 1.0), 2))], t))
    return out


def test_fraud_rollup_on_card_matches_cpu(cuda_device):
    """BASELINE config 2's pattern under a per-card aggregating selector
    (``chip_smoke.py``'s ``fraud_rollup`` at 64 cards): the host selector
    over the card engine's match rows gives the CPU run's alerts."""
    app = ("@app:playback @app:execution('tpu', partitions='64') "
           "define stream Txn (card long, amount double); "
           "partition with (card of Txn) begin @info(name='fraud') "
           "from every a=Txn[amount > 100.0] -> b=Txn[amount > a.amount]"
           "<3:5> within 10 min select a.card as card, count() as alerts, "
           "max(a.amount) as top, sum(b[last].amount) as spent "
           "having alerts >= 2 insert into Alerts; end;")
    rows = _sends_card_vs_cpu(app, _txn(3, 2000, 64))
    assert rows["cuda"] == rows["cpu"] and rows["cpu"]


def test_rate_limited_dense_query_on_card_matches_cpu(cuda_device):
    """An unpartitioned dense pattern under ``output last every 1 sec``:
    the scheduler's rate task drains the card's emit queue before the
    limiter decides, as on the CPU."""
    app = ("@app:playback @app:execution('tpu') "
           "define stream Txn (card long, amount double); "
           "define stream Tick (x int); @info(name='q') "
           "from every a=Txn[amount > 80.0] -> b=Txn[amount > a.amount] "
           "select a.amount as base, b.amount as top "
           "output last every 1 sec insert into Alerts;")
    sends = _txn(5, 400, 4)
    rows = _sends_card_vs_cpu(app, sends,
                              tick=("Tick", [0], sends[-1][2] + 3000))
    assert rows["cuda"] == rows["cpu"] and rows["cpu"]


# -- the device query path ---------------------------------------------------

DQ_DEFINE = ("@app:playback @app:execution('tpu', partitions='64') "
             "define stream S (k long, v double, i int, ok bool); ")
DQ_APPS = {
    "running": ("@info(name='q') from S[v > 2.0] select k, sum(v) as s, "
                "count() as c, min(v) as lo, max(i) as hi, stdDev(v) as sd, "
                "maxForever(v) as xf, and(ok) as a group by k insert into "
                "Out;", ("s", "sd")),
    "sliding_time": ("@info(name='q') from S#window.time(300 ms) select k, "
                     "avg(v) as av, min(v) as lo, count() as c group by k "
                     "insert into Out;", ("av",)),
    "tumbling": ("@info(name='q') from S#window.lengthBatch(7) select k, "
                 "sum(v) as s, max(v) as m group by k insert into Out;",
                 ("s",)),
    "keyed_sliding": ("partition with (k of S) begin @info(name='q') from "
                      "S[v > 1.0]#window.length(4) select k, sum(v) as s, "
                      "max(v) as m, count() as c insert into Out; end;",
                      ("s",)),
}


def _dq_rows(app, device, seed=11, n=600, stats=None):
    """Seeded events (three-decimal values, so sums round) through the
    app in batches of 100 via ``send_batch``: the output rows.  With a
    ``stats`` list, the runtime's emit counters are appended to it."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core.event import EventBatch

    rng = np.random.default_rng(seed)
    mgr = SiddhiManager(device=device)
    try:
        rt = mgr.create_siddhi_app_runtime(app)
        got = []
        rt.add_callback("Out", lambda evs: got.extend(
            (e.timestamp, tuple(e.data)) for e in evs))
        rt.start()
        h = rt.get_input_handler("S")
        t = 1000
        for lo in range(0, n, 100):
            ts = t + np.cumsum(rng.integers(1, 40, 100)).astype(np.int64)
            t = int(ts[-1])
            h.send_batch(EventBatch("S", ["k", "v", "i", "ok"], {
                "k": rng.integers(0, 6, 100).astype(np.int64),
                "v": np.round(rng.uniform(0, 50, 100), 3),
                "i": rng.integers(-9, 9, 100).astype(np.int32),
                "ok": rng.random(100) < 0.8}, ts))
        assert set(rt.lowering().values()) == {"device"}
        if stats is not None:
            stats.append(_emit_stats(rt, "q"))
        rt.shutdown()
        return got
    finally:
        mgr.shutdown()


def _emit_stats(rt, name):
    """The emit counters of a query's device runtime (the router's are
    its dense runtime's)."""
    runtime = rt.device_runtimes()[name]
    return getattr(runtime, "_dense", runtime).emit_stats.as_dict()


@pytest.mark.parametrize("name", list(DQ_APPS))
def test_device_query_on_card_matches_cpu(cuda_device, name):
    """The device query engine on the card against ``device="cpu"``:
    every column bit for bit but the float32 sums (within the
    reference's ``rel=1e-4, abs=1e-3``; stdDev ``abs=5e-3``); two card
    runs bit for bit (no float atomics: the state scatters are
    ``accumulate_``)."""
    query, sums = DQ_APPS[name]
    app = DQ_DEFINE + query
    card, again, cpu = (_dq_rows(app, "cuda"), _dq_rows(app, "cuda"),
                        _dq_rows(app, "cpu"))
    assert card == again and card
    names = [n.split(" as ")[-1] for n in
             query.split("select ")[1].split(" group by")[0]
             .split(" insert")[0].split(", ")]
    assert len(card) == len(cpu)
    for (t1, r1), (t2, r2) in zip(card, cpu):
        assert t1 == t2
        for nm, a, b in zip(names, r1, r2):
            if nm in sums:
                assert abs(a - b) <= (5e-3 if nm == "sd" else
                                      1e-3 + 1e-4 * abs(b)), (nm, a, b)
            else:
                assert type(a) is type(b) and a == b, (nm, a, b)


def test_device_query_prefix_sums_ignore_tf32(cuda_device):
    """The ``[B, B]`` prefix products run in float64, out of TF32's
    reach, and leave the caller's matmul precision as it was: with
    ``'high'`` (TF32 allowed) set globally, a running sum gives the same
    bits as with ``'highest'``."""
    app = DQ_DEFINE + DQ_APPS["running"][0]
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        full = _dq_rows(app, "cuda", n=3000)
        torch.set_float32_matmul_precision("high")
        tf32 = _dq_rows(app, "cuda", n=3000)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert full == tf32 and full


HOST_APPS = {
    # BASELINE config 1 in the default mode: the host pattern engine
    "host_pattern": (
        "@app:playback define stream T (key long, p double); "
        "@info(name='q') from every e1=T[p > 10.0], e2=T[p > e1.p], "
        "e3=T[p > e2.p] within 1 sec select e1.p as p1, e3.p as p3 "
        "insert into O;"),
    # a pattern and a window on per-key partition instances
    "instances": (
        "@app:playback define stream T (key long, p double); "
        "partition with (key of T) begin @info(name='q') from every "
        "a=T[p > 10.0] -> b=T[p > a.p]<2:3> within 1 sec select a.key as k, "
        "a.p as ap, b[last].p as bp insert into O; @info(name='w') from "
        "T#window.length(3) select key, sum(p) as s insert into O; end;"),
}


def _host_rows(app, device):
    """``app`` over 20,000 seeded events through ``SiddhiManager()`` on
    ``device`` (None: its default, the card): the rows, the lowering and
    the card's allocation calls across it."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core.event import EventBatch

    rng = np.random.default_rng(5)
    allocs = lambda: torch.cuda.memory_stats().get(
        "allocation.all.allocated", 0)
    before = allocs()
    mgr = SiddhiManager() if device is None else SiddhiManager(device=device)
    try:
        rt = mgr.create_siddhi_app_runtime(app)
        got = []
        rt.add_callback("O", lambda evs: got.extend(
            (e.timestamp, tuple(e.data)) for e in evs))
        rt.start()
        h = rt.get_input_handler("T")
        for i in range(10):
            n = 2_000
            h.send_batch(EventBatch(
                "T", ["key", "p"],
                {"key": rng.integers(0, 50, n).astype(np.int64),
                 "p": rng.uniform(5, 30, n)},
                1000 + i * n + np.arange(n, dtype=np.int64)))
        low = rt.lowering()
        rt.shutdown()
    finally:
        mgr.shutdown()
    return got, low, allocs() - before


@pytest.mark.parametrize("name", list(HOST_APPS))
def test_host_pattern_app_on_card_allocates_nothing(cuda_device, name):
    """The host pattern engine and per-key partition instances through
    ``SiddhiManager()`` on its default device, the card: host lowering,
    no allocation on the card, and the rows of ``device="cpu"``."""
    got, low, allocs = _host_rows(HOST_APPS[name], None)
    assert set(low.values()) == {"host"} and allocs == 0 and got
    assert got == _host_rows(HOST_APPS[name], "cpu")[0]


@pytest.mark.parametrize("partitioned", [False, True])
def test_kernel_failure_on_card_fails_app_creation(cuda_device, monkeypatch,
                                                   partitioned):
    """A dense pattern under ``execution('tpu')`` on the card whose
    kernels do not build or launch: app creation raises, with no move to
    the host engine or to per-key instances."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core.exceptions import KernelUnavailableError

    monkeypatch.setattr(probe, "kernels_available", lambda device: (
        False, "kernel build or launch failed: patched"))
    q = ("@info(name='q') from every a=T[p > 10.0] -> b=T[p > a.p] "
         "select a.p as ap, b.p as bp insert into O;")
    body = f"partition with (key of T) begin {q} end;" if partitioned else q
    app = ("@app:playback @app:execution('tpu', partitions='64') "
           "define stream T (key long, p double); " + body)
    mgr = SiddhiManager()
    try:
        with pytest.raises(KernelUnavailableError, match="patched"):
            mgr.create_siddhi_app_runtime(app)
    finally:
        mgr.shutdown()


# -- adaptive depths and the single-key scan engine on the card ---------------

PRODUCT_DEPTHS = ", ingest.depth='2', emit.depth='auto'"


def _product_app(capturing, opts, P=4096, S=6):
    """``bench.py``'s partitioned chain (or its capture-free form, the
    batch step's class) cut to ``S`` nodes and ``P`` partitions."""
    if capturing:
        states = ["every e1=Txn[v > 0.0]"] + [
            f"e{i}=Txn[v > {float(i - 1)} and v > e1.v]"
            for i in range(2, S + 1)]
        sel = f"select e1.v as v1, e{S}.v as vs"
    else:
        states = ["every e1=Txn[v > 1.0]"] + [
            f"e{i}=Txn[v > {float(i)}]" for i in range(2, S + 1)]
        sel = f"select e{S}.v as v"
    return (f"@app:playback @app:execution('tpu', partitions='{P}'{opts}) "
            "define stream Txn (key long, v double); "
            "partition with (key of Txn) begin "
            f"@info(name='bench') from {' -> '.join(states)} within 10 min "
            f"{sel} insert into Alerts; end;")


def _product_rows(app, device, n_batches=12, B=8192, P=4096, S=6):
    """Stride-walked keys as ``bench.py``'s ``_product_batches``: the
    callback batches, ``pattern_state()`` and the ingest counters."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core.event import EventBatch

    rng = np.random.default_rng(11)
    mgr = SiddhiManager(device=device)
    try:
        rt = mgr.create_siddhi_app_runtime(app)
        got = []
        rt.add_callback("Alerts", lambda evs: got.append(
            [(e.timestamp, tuple(e.data)) for e in evs]))
        rt.start()
        h = rt.get_input_handler("Txn")
        for i in range(n_batches):
            keys = (np.arange(B, dtype=np.int64) * 524287 + i * B) % P
            h.send_batch(EventBatch("Txn", ["key", "v"], {
                "key": keys, "v": rng.uniform(0.0, S + 4.0, B)},
                np.full(B, 1000 + i * 10, dtype=np.int64)))
        state = rt.pattern_state()
        runtime = rt.partitions["partition_0"].dense_query_runtimes[
            "bench"].pattern_processor
        ist = runtime.ingest_stats.as_dict()
        est = runtime.emit_stats.as_dict()
        rt.shutdown()
        return got, state, ist, est
    finally:
        mgr.shutdown()


@pytest.mark.parametrize("capturing", [True, False], ids=["general", "batch"])
def test_adaptive_depths_on_card_match_depth_one(cuda_device, capturing):
    """At ``ingest.depth='2', emit.depth='auto'`` each staged batch's
    pending outputs must survive the next batch's in-place step (the
    general step, or ``batch_step`` for the capture-free chain): the
    callbacks and ``pattern_state()`` equal the depth-1 run's and the
    CPU run's, and the batch step launched once a batch."""
    before = dense_batch.batch_step.launches
    auto = _product_rows(_product_app(capturing, PRODUCT_DEPTHS), "cuda")
    one = _product_rows(_product_app(capturing, ""), "cuda")
    cpu = _product_rows(_product_app(capturing, PRODUCT_DEPTHS), "cpu")
    assert sum(map(len, auto[0])) > 0
    assert auto[0] == one[0] == cpu[0]
    assert auto[1] == one[1] == cpu[1]
    assert auto[2]["stagedBatches"] == 12
    assert (auto[2]["overlappedBatches"] + auto[2]["ingestStalls"]) == 11
    launched = dense_batch.batch_step.launches - before
    assert launched == (0 if capturing else 24)


def test_auto_depths_device_query_on_card(cuda_device):
    """A running group-by device query (its state scatters are
    ``accumulate_``) at auto depths: the same rows as at depth 1 on the
    card, bit for bit, and as on the CPU (the float32 sum within the
    reference's ``rel=1e-4, abs=1e-3``)."""
    base = (DQ_DEFINE + "@info(name='q') from S select k, sum(v) as s, "
            "count() as c group by k insert into Out;")
    auto = base.replace("partitions='64')",
                        "partitions='64', ingest.depth='auto', "
                        "emit.depth='auto')")
    assert auto != base
    before = bank_scatter.accumulate_.launches
    got = _dq_rows(auto, "cuda")
    assert bank_scatter.accumulate_.launches > before
    assert got == _dq_rows(base, "cuda") and got
    cpu = _dq_rows(auto, "cpu")
    assert len(got) == len(cpu)
    for (t1, (k1, s1, c1)), (t2, (k2, s2, c2)) in zip(got, cpu):
        assert (t1, k1, c1) == (t2, k2, c2)
        assert abs(s1 - s2) <= 1e-3 + 1e-4 * abs(s2), (s1, s2)


FIXED_DEPTHS = ", ingest.depth='2', emit.depth='4'"

def _routed_rows(app, device):
    """A Zipf-like stream (80% on key 7) through the routed app in
    batches of 32: the callback batches, ``pattern_state()`` and the
    emit counters."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core.event import EventBatch

    rng = np.random.default_rng(9)
    mgr = SiddhiManager(device=device)
    try:
        rt = mgr.create_siddhi_app_runtime(app)
        got = []
        rt.add_callback("Alerts", lambda evs: got.append(
            [(e.timestamp, tuple(e.data)) for e in evs]))
        rt.start()
        h = rt.get_input_handler("S")
        t = 1000
        for _ in range(24):
            n = 32
            ts = t + np.cumsum(rng.integers(1, 40, n)).astype(np.int64)
            t = int(ts[-1])
            hot = rng.random(n) < 0.8
            h.send_batch(EventBatch("S", ["k", "u", "v"], {
                "k": np.where(hot, 7, rng.integers(0, 30, n)).astype(
                    np.int64),
                "u": rng.uniform(0, 20, n), "v": rng.uniform(0, 20, n)},
                ts))
        assert rt.pattern_runtimes()["q"].hot_metrics()[
            "hotkeyPromotions"] >= 1
        state = rt.pattern_state()
        est = _emit_stats(rt, "q")
        rt.shutdown()
        return got, state, est
    finally:
        mgr.shutdown()


@pytest.mark.parametrize("path", ["general", "batch", "device_query",
                                  "routed"])
def test_fixed_depths_on_card_match_depth_one(cuda_device, path):
    """At ``ingest.depth='2', emit.depth='4'`` the emit queue holds
    several batches' pending outputs while later steps write state in
    place (the general step, ``batch_step``, the device query's
    ``accumulate_`` scatters, the router's scan and batch step), then
    fetches them in one coalesced copy: the callbacks, batch by batch,
    and ``pattern_state()`` equal the 1/1 run's on the card bit for
    bit."""
    counters = {"general": [], "batch": [dense_batch.batch_step],
                "device_query": [bank_scatter.accumulate_],
                "routed": [scan_chain.fused_scan, dense_batch.batch_step]}
    before = [k.launches for k in counters[path]]
    if path == "device_query":
        base = (DQ_DEFINE + "@info(name='q') from S select k, sum(v) as "
                "s, count() as c group by k insert into Out;")
        staged = base.replace("partitions='64')",
                              "partitions='64'" + FIXED_DEPTHS + ")")
        assert staged != base
        stats = []
        got = _dq_rows(staged, "cuda", stats=stats)
        one = _dq_rows(base, "cuda")
        assert got == one and got
        est = stats[0]
    elif path == "routed":
        got, state, est = _routed_rows(
            ROUTED_APP.format(opts=FIXED_DEPTHS), "cuda")
        one, one_state, _ = _routed_rows(ROUTED_APP.format(opts=""),
                                         "cuda")
        assert got == one and sum(map(len, got)) > 0
        assert state == one_state
    else:
        capturing = path == "general"
        got, state, _, est = _product_rows(
            _product_app(capturing, FIXED_DEPTHS), "cuda")
        one, one_state, _, _ = _product_rows(_product_app(capturing, ""),
                                             "cuda")
        assert got == one and sum(map(len, got)) > 0
        assert state == one_state
    # several pending batches at once, fetched together
    assert est["maxPendingDepth"] >= 2 and est["deferredBatches"] > 0
    for k, b in zip(counters[path], before):
        assert k.launches > b, k


def test_scan_engine_on_card_matches_cpu(cuda_device):
    """``compile_scan_pattern`` on the card against ``device="cpu"``: the
    same detections and starts, live lanes bit-equal, over batches that
    span several scan chunks."""
    from siddhi_tpu_torch.ops.nfa_scan import NEG, compile_scan_pattern

    states = ["every e1=S[v > 1.0]"] + [f"e{i}=S[v > {float(i)}]"
                                        for i in range(2, 9)]
    app = ("define stream S (v double, n int); @info(name='q') from "
           + " -> ".join(states) + " within 10 sec select e8.v as v "
           "insert into Out;")
    engines = [compile_scan_pattern(app, "q", device=d)
               for d in ("cuda", "cpu")]
    engines[0].SCAN_BYTES = {"cuda": 1 << 20}  # several chunks a batch
    states_ = [e.init_state() for e in engines]
    rng = np.random.default_rng(4)
    total = 0
    for b in range(4):
        n = 5000
        cols = {"v": rng.uniform(0, 12, n), "n": rng.integers(0, 5, n)}
        ts = 1000 + b * 20000 + np.cumsum(rng.integers(0, 5, n))
        outs = []
        for k, e in enumerate(engines):
            states_[k], idx, starts = e.process(states_[k], cols, ts)
            outs.append((idx, starts, states_[k].cpu().numpy()))
        (gi, gs, gv), (ci, cs, cv) = outs
        assert np.array_equal(gi, ci) and np.array_equal(gs, cs)
        live = cv > NEG / 2
        assert np.array_equal(live, gv > NEG / 2)
        assert gv[live].tobytes() == cv[live].tobytes()
        total += len(gi)
    assert total > 0


JOIN_DEFS = ("define stream A (sym string, x double, n int, f float, b bool); "
             "define stream B (sym2 string, y double, m int, g float, "
             "c bool); ")


def _join_probes(cond):
    """The port's probe for ``cond`` on the card and on the CPU."""
    from siddhi_tpu_torch.compiler import SiddhiCompiler
    from siddhi_tpu_torch.core.join import DeviceJoinProbe, JoinSide
    from siddhi_tpu_torch.planner.expr import Scope

    parsed = SiddhiCompiler.parse(
        JOIN_DEFS + f"from A join B on {cond} select A.n as n insert into O;")
    sides = [JoinSide(r, parsed.stream_definitions[r], [], None)
             for r in ("A", "B")]
    scope = Scope()
    for side in sides:
        for a in side.definition.attributes:
            scope.add(side.ref, a.name, side.qualified_key(a.name), a.type)
    expr = parsed.execution_elements[0].input_stream.on_condition
    return sides, [DeviceJoinProbe(expr, scope, *sides, d)
                   for d in ("cuda", "cpu")]


def _join_batch(rng, sid, names, n):
    from siddhi_tpu_torch.core.event import EventBatch

    special = np.array([0.0, -0.0, np.nan, np.inf, 1e-40, -1e-40, 1e-45,
                        1.18e-38, 3.0, 8.0], dtype=np.float64)
    ints = np.array([0, -1, 2**31 - 1, -2**31, 5], dtype=np.int32)
    cols = {names[0]: np.array(["s"] * n, dtype=object),
            names[1]: np.where(rng.random(n) < 0.4, rng.choice(special, n),
                               np.round(rng.uniform(-10, 10, n), 2)),
            names[2]: np.where(rng.random(n) < 0.4, rng.choice(ints, n),
                               rng.integers(-20, 20, n)).astype(np.int32),
            names[3]: np.where(rng.random(n) < 0.4, rng.choice(special, n),
                               rng.uniform(-5, 5, n)).astype(np.float32),
            names[4]: rng.random(n) < 0.5}
    return EventBatch(sid, names, cols, np.arange(n, dtype=np.int64))


@pytest.mark.parametrize("cond", [
    "A.x < B.y", "A.n + B.m > 0", "A.f == B.g", "A.x > 1.0E-40",
    "A.x * 1.0E30 > B.y or A.b", "A.n != B.m and A.x - B.y < 1.0E-39"])
@pytest.mark.parametrize("n_a,n_b", [(37, 53), (2049, 8193)])
def test_join_probe_on_card_matches_cpu(cuda_device, cond, n_a, n_b):
    """The device probe's mask and pairs on the card equal the CPU's
    (subnormals flushed, NaN, int32 wrap-around, the block edges past
    2,048 rows and 8,192 buffered rows)."""
    (left, right), (gpu, cpu) = _join_probes(cond)
    rng = np.random.default_rng(n_a + n_b)
    a = _join_batch(rng, "A", ["sym", "x", "n", "f", "b"], n_a)
    b = _join_batch(rng, "B", ["sym2", "y", "m", "g", "c"], n_b)
    assert np.array_equal(gpu.mask(left, a, right, b),
                          cpu.mask(left, a, right, b))
    got = gpu.pairs(left, a, right, b, outer=True)
    want = cpu.pairs(left, a, right, b, outer=True)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert gpu.bytes_fetched == cpu.bytes_fetched


def test_join_and_table_apps_on_card_match_cpu(cuda_device):
    """A windowed join and a stream-table join under
    ``execution('tpu')`` (the device probe), and pulls on the table, on
    the card and on the CPU: the same events and rows, typed."""
    from siddhi_tpu_torch import SiddhiManager

    app = ("@app:playback @app:execution('tpu') " + JOIN_DEFS +
           "define table T (n int, sym string); "
           "from B select m as n, sym2 as sym insert into T; "
           "@info(name='j') from A#window.length(20) join "
           "B#window.time(300 ms) on A.x < B.y and A.n != B.m "
           "select A.x as x, B.y as y, A.n as n insert into O; "
           "@info(name='t') from A join T on T.n == A.n "
           "select A.x as x, T.sym as sym insert into O2;")
    rng = np.random.default_rng(9)
    sends = []
    for i in range(400):
        sid = "A" if rng.random() < 0.5 else "B"
        sends.append((sid, [f"s{int(rng.integers(3))}",
                            float(rng.integers(0, 10)),
                            int(rng.integers(0, 6)),
                            float(rng.uniform(-1, 1)),
                            bool(rng.random() < 0.5)], 1000 + 7 * i))
    runs = []
    for device in ("cuda", "cpu"):
        mgr = SiddhiManager(device=device)
        rt = mgr.create_siddhi_app_runtime(app)
        got = []
        for o in ("O", "O2"):
            rt.add_callback(o, lambda evs, o=o: got.extend(
                (o, e.timestamp, e.is_expired,
                 tuple((type(v).__name__, v) for v in e.data))
                for e in evs))
        rt.start()
        for sid, row, ts in sends:
            rt.get_input_handler(sid).send(row, ts)
        pulls = [[tuple(e.data) for e in rt.query(q)] for q in (
            "from T select n, sym;", "from T on n > 2 select count() as c;")]
        runs.append((got, pulls, rt.lowering()))
        rt.shutdown()
        mgr.shutdown()
    assert runs[0] == runs[1]
    assert runs[0][2]["j"] == runs[0][2]["t"] == "device_probe"
    assert runs[0][0]


# -- persistence (checkpoint capture and restore on the card) ---------------

CKPT_APPS = {
    # the capture-free chain: batch_step writes the state rows in place
    "dense_batch": (
        "@app:name('ckpt') @app:playback "
        "@app:execution('tpu', partitions='4096', instances='4') "
        "define stream S (k long, v double); "
        "partition with (k of S) begin @info(name='q') from every "
        "e1=S[v > 1.0] -> e2=S[v > 2.0] -> e3=S[v > 3.0] within 10 min "
        "select e3.v as v insert into Out; end;"),
    # a keyed running sum: accumulate_ adds into the state in place
    "device_query": (
        "@app:name('ckpt') @app:playback "
        "@app:execution('tpu', partitions='4096') "
        "define stream S (k long, v double); "
        "partition with (k of S) begin @info(name='q') from S select k, "
        "sum(v) as s, count() as c insert into Out; end;"),
}


def _ckpt_batches(n, seed=4, size=8192):
    from siddhi_tpu_torch.core.event import EventBatch

    rng = np.random.default_rng(seed)
    return [EventBatch("S", ["k", "v"],
                       {"k": rng.integers(0, 4096, size).astype(np.int64),
                        "v": rng.uniform(0.0, 5.0, size)},
                       np.full(size, 1_000 + 10 * i, dtype=np.int64))
            for i in range(n)]


def _same_tree(a, b):
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same_tree(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.tobytes() == b.tobytes())
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("kind", sorted(CKPT_APPS))
def test_async_capture_on_card_matches_sync_snapshot(cuda_device, kind):
    """An async persist on the card queued behind a blocked writer, then
    a batch that steps the state tensors in place (``batch_step`` or
    ``accumulate_``): the committed tree is the sync ``snapshot()`` taken
    at the persist point, so the capture's device clones (waited on by
    the writer through their CUDA event) were not overwritten."""
    import pickle
    import threading

    from siddhi_tpu_torch import InMemoryPersistenceStore, SiddhiManager

    kernel = (dense_batch.batch_step if kind == "dense_batch"
              else bank_scatter.accumulate_)
    mgr = SiddhiManager(device="cuda")
    store = InMemoryPersistenceStore()
    mgr.set_persistence_store(store)
    try:
        rt = mgr.create_siddhi_app_runtime(CKPT_APPS[kind])
        rt.start()
        h = rt.get_input_handler("S")
        batches = _ckpt_batches(5)
        for b in batches[:4]:
            h.send_batch(b)
        gate = threading.Event()
        writer = rt._durability_writer()
        writer.submit("blocker", lambda: gate.wait(60))
        rev = rt.persist(mode="async")
        at_persist = pickle.loads(rt.snapshot())
        before = kernel.launches
        h.send_batch(batches[4])
        rt.drain()
        assert kernel.launches > before
        after = pickle.loads(rt.snapshot())
        assert not _same_tree(at_persist["partitions"], after["partitions"])
        gate.set()
        assert rt.wait_for_persist(rev, timeout=60) == "committed"
        committed = pickle.loads(store.load("ckpt", rev))
        assert _same_tree(committed["partitions"], at_persist["partitions"])
        rt.shutdown()
    finally:
        mgr.shutdown()


def test_restore_into_batch_step_kernel_on_card(cuda_device):
    """The capture-free chain on the card: a sync persist after batch 4,
    a simulated crash on ``ingest`` at batch 7, and a fresh runtime's
    ``restore_last_revision()`` replaying batches 5-7 through
    ``batch_step``: the callbacks across the crash equal the
    uninterrupted card run's and the CPU run's, and the kernel launched
    after the restore."""
    from siddhi_tpu_torch import InMemoryPersistenceStore, SiddhiManager
    from siddhi_tpu_torch.core.exceptions import SimulatedCrashError

    app = CKPT_APPS["dense_batch"].replace(
        "@app:playback ", "@app:playback @app:faults(journal='16') ")
    batches = _ckpt_batches(10, seed=7)

    def collect(rt, got):
        rt.add_callback("Out", lambda evs: got.extend(
            (e.timestamp, tuple(e.data)) for e in evs))

    refs = {}
    for device in ("cuda", "cpu"):
        m = SiddhiManager(device=device)
        try:
            rt = m.create_siddhi_app_runtime(CKPT_APPS["dense_batch"])
            got = []
            collect(rt, got)
            rt.start()
            for b in batches:
                rt.get_input_handler("S").send_batch(b)
            rt.shutdown()
            refs[device] = got
        finally:
            m.shutdown()
    m = SiddhiManager(device="cuda")
    m.set_persistence_store(InMemoryPersistenceStore())
    got = []
    try:
        rt = m.create_siddhi_app_runtime(app)
        collect(rt, got)
        rt.start()
        h = rt.get_input_handler("S")
        for b in batches[:4]:
            h.send_batch(b)
        rt.persist()
        for b in batches[4:6]:
            h.send_batch(b)
        rt.app_context.fault_injector.configure("ingest", "crash", count=1)
        with pytest.raises(SimulatedCrashError):
            h.send_batch(batches[6])
        rt.shutdown()
        rt = m.create_siddhi_app_runtime(app)
        collect(rt, got)
        rt.start()
        before = dense_batch.batch_step.launches
        assert rt.restore_last_revision() is not None
        assert rt.app_context.input_journal.stats.replayed_batches == 3
        h = rt.get_input_handler("S")
        for b in batches[7:]:
            h.send_batch(b)
        rt.shutdown()
        assert dense_batch.batch_step.launches - before == 6
    finally:
        m.shutdown()
    assert got == refs["cuda"] == refs["cpu"] and got


# -- stream-graph fusion and device tables ----------------------------------

FUSED_CARD_APP = (
    "@app:name('fz') @app:playback @app:execution('tpu') {fuse}"
    "define stream SIn (sym int, price float, vol int); "
    "define stream Mid (sym int, price float, vol int); "
    "define stream Win (sym int, total double); "
    "@info(name='q1') from SIn[price > 5.0] "
    "select sym, price, vol insert into Mid; "
    "@info(name='q2') from Mid#window.length(4) "
    "select sym, sum(price) as total insert into Win; "
    "@info(name='q3') from {tail} insert into Out;")
FUSED_TAILS = {
    "dense": "every e1=Win[total > 30.0] -> e2=Win[total > e1.total] "
             "select e1.sym as s1, e1.total as t1, e2.total as t2",
    "device": "Win[total > 60.0] select sym, total",
}


def _fused_rows(app, device, batches):
    from siddhi_tpu_torch import SiddhiManager

    m = SiddhiManager(device=device)
    try:
        rt = m.create_siddhi_app_runtime(app)
        got = []
        rt.add_callback("Out", lambda evs: got.extend(
            (e.timestamp, tuple(e.data)) for e in evs))
        rt.start()
        h = rt.get_input_handler("SIn")
        for b in batches:
            h.send_batch(b)
        low = rt.lowering()
        hops = (rt.junctions["Mid"].dispatches,
                rt.junctions["Win"].dispatches)
        rt.shutdown()
        return got, low, hops
    finally:
        m.shutdown()


@pytest.mark.parametrize("tail", sorted(FUSED_TAILS))
def test_fused_chain_on_card_matches_cpu(cuda_device, tail):
    """A fused chain (filter, ``length(4)`` sum, a dense or device tail)
    on the card: the rows of the ``device="cpu"`` run and of the unfused
    card run (float32 sums within the reference's bound), and no
    dispatch on the intermediate streams."""
    from siddhi_tpu_torch.core.event import EventBatch

    rng = np.random.default_rng(3)
    batches = []
    for i in range(6):
        n = 300 + 37 * i
        batches.append(EventBatch("SIn", ["sym", "price", "vol"], {
            "sym": rng.integers(0, 5, n).astype(np.int32),
            "price": rng.uniform(0, 30, n).astype(np.float32),
            "vol": rng.integers(1, 100, n).astype(np.int32)},
            1000 + 10 * i + np.arange(n, dtype=np.int64)))
    fused = FUSED_CARD_APP.format(fuse="@app:fuse ", tail=FUSED_TAILS[tail])
    plain = FUSED_CARD_APP.format(fuse="", tail=FUSED_TAILS[tail])
    card, low, hops = _fused_rows(fused, "cuda", batches)
    cpu, _low, _hops = _fused_rows(fused, "cpu", batches)
    unfused, ulow, _ = _fused_rows(plain, "cuda", batches)
    assert set(low.values()) == {"fused"} and hops == (0, 0)
    assert "fused" not in ulow.values()
    assert card
    for other in (cpu, unfused):
        assert len(other) == len(card)
        for (ta, ra), (tb, rb) in zip(card, other):
            assert ta == tb and ra[0] == rb[0]
            assert np.allclose(ra[1:], rb[1:], rtol=1e-4, atol=1e-3)


def test_devtable_scatter_and_probe_on_card_match_cpu(cuda_device):
    """A device table on the card: the last-writer-wins scatter (duplicate
    keys in one batch), deletes, the probe's slot and the join's rows
    equal the ``device="cpu"`` run's bit for bit, table contents too."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core.event import EventBatch

    app = ("@app:name('dtc') @app:playback @app:execution('tpu') "
           "@app:devtables(capacity='4096') "
           "define stream S (k int, x float); "
           "define stream Ups (k int, v float); "
           "define stream Del (k int); "
           "@PrimaryKey('k') define table T (k int, v float); "
           "from Del delete T on T.k == k; "
           "from Ups update or insert into T set T.v = v on T.k == k; "
           "@info(name='j') from S join T as t on S.k == t.k "
           "select S.k as k, S.x as x, t.v as v insert into Out;")
    rng = np.random.default_rng(9)
    sends = []
    for i in range(8):
        uk = rng.integers(0, 3000, 900).astype(np.int32)  # duplicates
        sends.append(EventBatch("Ups", ["k", "v"], {
            "k": uk, "v": rng.normal(size=900).astype(np.float32)},
            np.full(900, 1000 + 30 * i, dtype=np.int64)))
        dk = rng.integers(0, 3000, 100).astype(np.int32)
        sends.append(EventBatch("Del", ["k"], {"k": dk},
                                np.full(100, 1010 + 30 * i, dtype=np.int64)))
        pk = rng.integers(0, 6000, 5000).astype(np.int32)
        sends.append(EventBatch("S", ["k", "x"], {
            "k": pk, "x": rng.normal(size=5000).astype(np.float32)},
            np.full(5000, 1020 + 30 * i, dtype=np.int64)))
    out = {}
    for device in ("cuda", "cpu"):
        m = SiddhiManager(device=device)
        try:
            rt = m.create_siddhi_app_runtime(app)
            got = []
            rt.add_callback("Out", lambda evs, g=got: g.extend(
                (e.timestamp, tuple(e.data)) for e in evs))
            rt.start()
            for b in sends:
                rt.get_input_handler(b.stream_id).send_batch(b)
            rt.drain()
            t = rt.tables["T"]
            b = t.rows_batch()
            rows = sorted(zip(b.columns["k"].tolist(),
                              b.columns["v"].view(np.uint32).tolist()))
            out[device] = (got, rows, rt.lowering()["j"], t.demoted,
                           t.scatter_steps)
            rt.shutdown()
        finally:
            m.shutdown()
    card, cpu = out["cuda"], out["cpu"]
    assert card[2] == "devtable" and not card[3] and card[4] > 0
    assert card[0] and card[0] == cpu[0]
    assert card[1] == cpu[1]


MUX_TUMBLING = ("@app:name('mt{i}') @app:playback @app:execution('tpu', "
                "partitions='64') @app:multiplex(slots='4') "
                "define stream S (k long, v double); "
                "@info(name='q') from S#window.lengthBatch(40) "
                "select k, sum(v) as s, count() as c group by k "
                "insert into Out;")
MUX_DENSE = ("@app:name('md{i}') @app:playback @app:execution('tpu') "
             "@app:multiplex(slots='4') "
             "define stream Txn (key long, v double); "
             "@info(name='q') from every e1=Txn[v > 1.0] -> e2=Txn[v > 2.0] "
             "-> e3=Txn[v > 3.0] within 10 min "
             "select e3.v as v insert into Out;")


def _mux_rows(app, stream, device, sends, tenants=4):
    """Each tenant's rows, the lowering with its step, and the launches
    of ``batch_step`` and ``accumulate_`` across the run."""
    from siddhi_tpu_torch import SiddhiManager

    m = SiddhiManager(device=device)
    dense_batch.batch_step.launches = 0
    bank_scatter.accumulate_.launches = 0
    try:
        rts, outs = [], []
        for i in range(tenants):
            rt = m.create_siddhi_app_runtime(app.format(i=i))
            got = []
            rt.add_callback("Out", lambda evs, g=got: g.extend(
                (e.timestamp, tuple(e.data)) for e in evs))
            rt.start()
            rts.append(rt)
            outs.append(got)
        for cycle in sends:
            for rt, b in zip(rts, cycle):
                rt.get_input_handler(stream).send_batch(b)
        low = rts[0].lowering(step_kinds=True)
        groups = m.siddhi_context.multiplex_registry.open_groups()
        for rt in rts:
            rt.shutdown()
        return (outs, low, len(groups), dense_batch.batch_step.launches,
                bank_scatter.accumulate_.launches)
    finally:
        m.shutdown()


@pytest.mark.parametrize("kind", ["tumbling", "dense"])
def test_multiplex_group_on_card_matches_cpu(cuda_device, kind):
    """Four tenants in one shared group on the card: every tenant's rows
    equal the ``device="cpu"`` run's bit for bit (integer-valued sums,
    exact in any association); the tumbling group's state scatters
    launch ``accumulate_`` and the capture-free chain's cycles launch
    one ``batch_step`` each."""
    from siddhi_tpu_torch.core.event import EventBatch

    rng = np.random.default_rng(17)
    sends = []
    for c in range(10):
        cycle = []
        for i in range(4):
            n = 50 + 3 * i
            cols = {("k" if kind == "tumbling" else "key"):
                    rng.integers(0, 20, n).astype(np.int64),
                    "v": rng.integers(0, 5, n).astype(np.float64)}
            cycle.append(EventBatch(
                "S" if kind == "tumbling" else "Txn", list(cols), cols,
                1000 + 100 * c + np.arange(n, dtype=np.int64)))
        sends.append(cycle)
    app, stream = ((MUX_TUMBLING, "S") if kind == "tumbling"
                   else (MUX_DENSE, "Txn"))
    card = _mux_rows(app, stream, "cuda", sends)
    cpu = _mux_rows(app, stream, "cpu", sends)
    assert card[0] == cpu[0] and any(card[0])
    assert card[2] == 1
    if kind == "tumbling":
        assert card[1] == {"q": "multiplex"}
        assert card[4] > 0 and card[3] == 0
    else:
        assert card[1] == {"q": "multiplex/batch"}
        assert card[3] == len(sends) and card[4] == 0


def test_source_device_sink_app_on_card_matches_cpu(cuda_device):
    """An in-memory source, a tumbling group-by on the device query path
    and an in-memory sink on the card: the broker receives the
    ``device="cpu"`` run's messages, in order, and the device query's
    state scatters launched ``accumulate_``."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core.event import Event
    from siddhi_tpu_torch.transport.broker import (
        FunctionSubscriber,
        InMemoryBroker,
    )

    app = ("@app:name('tx') @app:playback @app:execution('tpu') "
           "@source(type='inMemory', topic='tx-in') "
           "define stream S (k long, v double); "
           "@sink(type='inMemory', topic='tx-out') "
           "define stream Out (k long, s double, c long); "
           "@info(name='q') from S#window.lengthBatch(64) "
           "select k, sum(v) as s, count() as c group by k insert into Out;")
    rng = np.random.default_rng(23)
    payloads = [[Event(1000 + 10 * i + j, [int(rng.integers(0, 9)),
                                          float(rng.integers(0, 7))])
                 for j in range(50)] for i in range(20)]
    out = {}
    for device in ("cuda", "cpu"):
        m = SiddhiManager(device=device)
        got = []
        sub = FunctionSubscriber("tx-out",
                                 lambda e, g=got: g.append(tuple(e.data)))
        InMemoryBroker.subscribe(sub)
        bank_scatter.accumulate_.launches = 0
        try:
            rt = m.create_siddhi_app_runtime(app)
            rt.start()
            for p in payloads:
                InMemoryBroker.publish("tx-in", p)
            out[device] = (got, rt.lowering(),
                           bank_scatter.accumulate_.launches)
            rt.shutdown()
        finally:
            InMemoryBroker.unsubscribe(sub)
            m.shutdown()
    assert out["cuda"][0] == out["cpu"][0] and out["cuda"][0]
    assert out["cuda"][1] == {"q": "device"}
    assert out["cuda"][2] > 0


# -- the kernels under a mesh (devices=) -------------------------------------

MESH_CHAIN = (
    "@app:playback @app:execution('tpu', partitions='64'{dev}) "
    "define stream Txn (key long, v double); partition with (key of Txn) "
    "begin @info(name='q') from every e1=Txn[v > 1.0] -> e2=Txn[v > 2.0] "
    "-> e3=Txn[v > 3.0] -> e4=Txn[v > 4.0] within 10 min select e4.v as v "
    "insert into Alerts; end;")
MESH_TUMBLING = (
    "@app:playback @app:execution('tpu', partitions='64'{dev}) "
    "define stream S (sym int, price float); @info(name='q0') from "
    "S#window.lengthBatch(700) select sym, sum(price) as total, count() "
    "as c group by sym insert into Out;")


def _mesh_rows(app, stream, out, batches, device):
    """``app`` over ``batches`` (``[(cols, ts)]``) on ``device``: the
    callback rows, the lowering with step kinds, and the ``dense_batch``
    and ``accumulate_`` launches from app creation on."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core.event import EventBatch

    dense_batch.batch_step.launches = 0
    bank_scatter.accumulate_.launches = 0
    m = SiddhiManager(device=device)
    try:
        rt = m.create_siddhi_app_runtime(app)
        got = []
        rt.add_callback(out, lambda evs: got.extend(
            (e.timestamp, tuple(e.data)) for e in evs))
        rt.start()
        h = rt.get_input_handler(stream)
        for cols, ts in batches:
            h.send_batch(EventBatch(stream, list(cols), cols, ts))
        lowering = rt.lowering(step_kinds=True)
        rt.shutdown()
    finally:
        m.shutdown()
    return got, lowering, (dense_batch.batch_step.launches,
                           bank_scatter.accumulate_.launches)


def test_sharded_batch_step_on_card_matches_cpu(cuda_device):
    """A capture-free chain under ``devices='4'`` on the card launches
    ``dense_batch`` once a shard with events and delivers the unsharded
    card run's rows and the CPU's."""
    rng = np.random.default_rng(5)
    batches = [({"key": rng.integers(0, 64, 256).astype(np.int64),
                 "v": rng.uniform(0.0, 8.0, 256)},
                np.full(256, 1_000 + 10 * i, dtype=np.int64))
               for i in range(6)]
    one = _mesh_rows(MESH_CHAIN.format(dev=""), "Txn", "Alerts", batches,
                     "cuda")
    four = _mesh_rows(MESH_CHAIN.format(dev=", devices='4'"), "Txn",
                      "Alerts", batches, "cuda")
    cpu = _mesh_rows(MESH_CHAIN.format(dev=", devices='4'"), "Txn",
                     "Alerts", batches, "cpu")
    assert four[0] == one[0] == cpu[0] and four[0]
    assert four[1] == one[1] == {"q": "dense/batch"}
    assert one[2][0] == len(batches)
    assert four[2][0] == 4 * len(batches)  # every shard has events


def test_sharded_tumbling_sums_on_card_keep_one_device_bits(cuda_device):
    """A lengthBatch group-by under ``devices='4'`` on the card: each
    shard's ``accumulate_`` takes the segment at the single-device
    positions, so every float32 sum has the one-device run's bits; keys
    and counts equal the CPU's."""
    rng = np.random.default_rng(9)
    batches = [({"sym": rng.integers(0, 24, 512).astype(np.int32),
                 "price": (rng.uniform(0.0, 1.0, 512)
                           * 10.0 ** rng.integers(-3, 4, 512))
                 .astype(np.float32)},
                1_000 + 512 * i + np.arange(512, dtype=np.int64))
               for i in range(6)]
    one = _mesh_rows(MESH_TUMBLING.format(dev=""), "S", "Out", batches,
                     "cuda")
    four = _mesh_rows(MESH_TUMBLING.format(dev=", devices='4'"), "S",
                      "Out", batches, "cuda")
    cpu = _mesh_rows(MESH_TUMBLING.format(dev=", devices='4'"), "S", "Out",
                     batches, "cpu")

    def bits(rows):
        return [(t, d[0], np.float64(d[1]).tobytes(), d[2])
                for t, d in rows]

    assert bits(four[0]) == bits(one[0]) and four[0]
    assert [(t, d[0], d[2]) for t, d in four[0]] == \
        [(t, d[0], d[2]) for t, d in cpu[0]]
    assert four[1] == one[1] == {"q0": "device"}
    assert one[2][1] > 0 and four[2][1] == 4 * one[2][1]


# -- the sync guard (the port's jax.transfer_guard("disallow")) ---------------

GUARD_APP = (
    "define stream Txn (card long, amount double); "
    "@info(name='q') "
    "from every a=Txn[amount > 100.0] -> b=Txn[amount > a.amount] "
    "within 10 min "
    "select a.amount as base, b.amount as bv insert into Alerts;")
GUARD_SENDS = [([1, 150.0], 1000), ([1, 90.0], 1500), ([1, 200.0], 2000),
               ([1, 300.0], 3000)]


def test_dense_every_rearm_under_the_sync_guard(cuda_device):
    """``tests/test_dense_integration.py``'s
    ``test_dense_every_rearm_matches_host`` on the card, its sends under
    ``SyncGuard`` where the reference's run under
    ``jax.transfer_guard("disallow")``: every sync lies in a sanctioned
    scope (the staging put, the count-gated drain, the host-sync
    allowlist) and the matches are the host engine's."""
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.analysis.sync_guard import SyncGuard

    def run(app, guard):
        m = SiddhiManager() if guard is not None else \
            SiddhiManager(device="cpu")
        rt = m.create_siddhi_app_runtime(app)
        got = []
        rt.add_callback("Alerts", lambda evs: got.extend(e.data for e in evs))
        rt.start()
        h = rt.get_input_handler("Txn")
        if guard is None:
            for row, ts in GUARD_SENDS:
                h.send(row, timestamp=ts)
        else:
            with guard:
                for row, ts in GUARD_SENDS:
                    h.send(row, timestamp=ts)
        rt.shutdown()
        m.shutdown()
        return got

    guard = SyncGuard()
    dense = run("@app:execution('tpu') " + GUARD_APP, guard)
    host = run(GUARD_APP, None)
    assert guard.unsanctioned() == {}
    assert guard.counts.get("<outside>", 0) == 0
    assert sum(guard.counts.values()) > 0  # the guard saw the drain
    assert torch.cuda.get_sync_debug_mode() == 0  # restored
    assert dense == host == [[150.0, 200.0], [200.0, 300.0]]


@pytest.mark.parametrize("name", ["general_via", "batch_chunk", "sharded",
                                  "multiplex", "fused", "full_lanes",
                                  "one_row"])
def test_compacted_emit_on_card_equals_the_dense_selection(cuda_device,
                                                           name):
    """``test_torch_emit_compaction.py``'s cases on the card: the
    compaction launches with no host sync (the sync debug mode raises on
    one), and the fetched rows equal the selection over the dense banks."""
    from test_torch_emit_compaction import CASES, check

    eng, pending = CASES[name](np.random.default_rng(7), "cuda")
    for p in pending if isinstance(pending, list) else [pending]:
        assert p.resolve() > 0
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            p.device_arrays()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert check(eng, p) > 0


@pytest.mark.parametrize("kind", ["several_per_event", "equal_anchors",
                                  "int32_extremes"])
def test_card_order_on_card_equals_the_host_lexsort(cuda_device, kind):
    """``test_torch_emit_compaction.py``'s order cases on the card, at a
    bank of 131,072 rows and 64 lanes: the packed key's sort and the
    gathers launch with no host sync, and the rows, their order and
    their values are the host's ``np.lexsort`` order."""
    from test_torch_emit_compaction import _anchor_set, _banks, host_compaction

    from siddhi_tpu_torch.ops.dense_nfa import compact_matches

    rng = np.random.default_rng(17)
    emit, f, i, anchor = _banks(rng, 131_072, 64, _anchor_set(kind), p=0.02)
    m, row0 = int(emit.sum()), 3
    dev = [torch.from_numpy(x).to(cuda_device) for x in (emit, f, i, anchor)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        head, flt = compact_matches(*dev, m, row0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    head, flt = head.cpu().numpy(), flt.cpu().numpy()
    want_rows, want_ints, want_f = host_compaction(emit, f, i, anchor, row0)
    assert np.array_equal(head[:, 0], want_rows)
    assert np.array_equal(head[:, 1:], want_ints)
    assert np.array_equal(flt.view(np.int32), want_f.view(np.int32))
