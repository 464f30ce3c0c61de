"""Card-only checks of the port's CUDA kernels (marker ``cuda``).

These skip where ``torch.cuda.is_available()`` is false, as on the CPU
test machines.  They import neither JAX nor the JAX package, so on a
machine with a card and no JAX they run without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held bit for bit against its plain torch version on the
same inputs (the packed step is pure int32 arithmetic; the fused scan
does the same float32 operations in the same order).
"""

import numpy as np
import pytest
import torch

from siddhi_tpu_torch.kernels import dense_step, probe, scan_chain
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
                                   (5, 64, 32), (256, 128, 7)])
def test_scan_chain_kernel_matches_plain(cuda_device, H, n, S):
    """Bit for bit on every lane, dead lanes included."""
    ins = scan_inputs(H, n, S, seed=H * n + S, device=cuda_device)
    before = scan_chain.fused_scan.launches
    got = scan_chain.fused_scan(*ins)
    torch.cuda.synchronize()
    assert scan_chain.fused_scan.launches == before + 1
    want = scan_chain.fused_scan_plain(*ins)
    for name, g, w in zip(("v", "c", "emit"), got, want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), name


def test_hot_key_app_on_card_matches_cpu(cuda_device):
    """A routed app through SiddhiManager: the card's callbacks equal the
    CPU run's, and the scan and dense-step kernels both launched."""
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
              dense_step.packed_step.launches)
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
    assert dense_step.packed_step.launches > before[1]
