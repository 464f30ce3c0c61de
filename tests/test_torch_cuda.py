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


def test_hot_key_app_on_card_matches_cpu(cuda_device):
    """A routed app through SiddhiManager: the card's callbacks equal the
    CPU run's, and the scan and batch-step kernels both launched."""
    from siddhi_tpu_torch import SiddhiManager

    app = ("@app:playback @app:execution('tpu', instances='8') "
           "@app:hotkeys(k='4', promote='0.3', demote='0.1') "
           "define stream S (k long, u double, v double); "
           "partition with (k of S) begin @info(name='q') "
           "from every a=S[v > 8.0] -> b=S[u > 6.0] -> c=S[v > 12.0] "
           "select c.v as cv insert into Alerts; end;")
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


def _dq_rows(app, device, seed=11, n=600):
    """Seeded events (three-decimal values, so sums round) through the
    app in batches of 100 via ``send_batch``: the output rows."""
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
        rt.shutdown()
        return got
    finally:
        mgr.shutdown()


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
