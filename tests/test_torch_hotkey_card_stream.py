"""bench.py's hot-key check on the card machine's own Zipf stream.

``bench.py``'s ``bench_hot_key`` draws its keys with
``default_rng(23).zipf(1.2, 8192)``.  numpy changed its Zipf sampler
between releases, so the card machine's numpy (2.3.5) draws another key
stream from the same seed than an older numpy does.  On that stream the
dense-only run drops 3 pending chains at ``instances='8'`` and the routed
run 2, so the two runs emit 43,938 and 43,939 rows over the warm-up and
the first window (``chip_smoke.py``'s skew-routed phase, NVIDIA H100 80GB
HBM3).

``test_torch_hotkey_card_stream.npz`` holds that stream's keys (10
batches of 8192, uint16) and, per batch, the position in seed 23's PCG64
stream where its ``u`` and ``v`` draws start; ``Generator.uniform`` draws
the same doubles under every numpy release, so ``u`` and ``v`` are
rebuilt exactly.  The test feeds the stream to the JAX package's
``SiddhiManager`` and to the port's (``device="cpu"``), routed and
dense-only: both packages agree on every row and every drop count, and
the reference emits the same 43,939 and 43,938 rows as the card.
"""

import os

import numpy as np
import pytest

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu.core.event import EventBatch as JaxEventBatch
from siddhi_tpu_torch import SiddhiManager
from siddhi_tpu_torch.core.event import EventBatch

DATA = os.path.join(os.path.dirname(__file__),
                    "test_torch_hotkey_card_stream.npz")
BATCH = 8192
WARMUP = 2

# chip_smoke.py's hot_key_app, verbatim (@app:kernels only in the port:
# the reference runs its XLA steps, which it pins identical to its kernels)
HEADER = "@app:playback @app:execution('tpu', instances='8') "
HOT = "@app:hotkeys(k='8', promote='0.1', demote='0.04') "
KERNELS = "@app:kernels('nfa,scan') "
APP = ("define stream S (k long, u double, v double); "
       "partition with (k of S) begin "
       "@info(name='q') from every a=S[v > 8.0] -> b=S[v > 12.0] "
       "select b.v as bv insert into Alerts; end;")

# the card run's numbers (chip_smoke.py, skew-routed phase)
CARD_ROWS = {"routed": 43_939, "dense": 43_938}
CARD_DROPS = {"routed": 2, "dense": 3}
CARD_DENSE_ROUNDS = [1422, 1464, 1509, 1527, 1460, 1468, 1486, 1516]


def card_stream():
    """The card run's 10 batches: warm-up at ts 1000 + 10 i, then the
    first window re-offset by 1e6 ms, as chip_smoke.py sends them."""
    d = np.load(DATA)
    out = []
    for i, (keys, start) in enumerate(zip(d["k"], d["offsets"])):
        rng = np.random.default_rng(23)
        rng.bit_generator.advance(int(start))
        u = rng.uniform(0.0, 20.0, BATCH)
        v = rng.uniform(0.0, 20.0, BATCH)
        ts = np.full(BATCH, 1_000 + i * 10, dtype=np.int64)
        if i >= WARMUP:
            ts += 1_000_000
        out.append((keys.astype(np.int64), u, v, ts))
    return out


def jax_query(rt):
    for pr in rt.partitions.values():
        for qr in pr.dense_query_runtimes.values():
            return qr.pattern_processor


def run(port, header, batches):
    """Every callback as [(timestamp, data), ...], the lowering, the
    router's counters and the dropped pending instances."""
    mgr = SiddhiManager(device="cpu") if port else JaxManager()
    rt = mgr.create_siddhi_app_runtime(header + (KERNELS if port else "")
                                       + APP)
    got = []
    rt.add_callback("Alerts", lambda evs: got.append(
        [(e.timestamp, list(e.data)) for e in evs]))
    rt.start()
    h = rt.get_input_handler("S")
    cls = EventBatch if port else JaxEventBatch
    for ks, u, v, ts in batches:
        h.send_batch(cls("S", ["k", "u", "v"], {"k": ks, "u": u, "v": v}, ts))
    q = rt.pattern_runtimes()["q"] if port else jax_query(rt)
    drops = q.overflow_total()
    hot = q.hot_metrics() if hasattr(q, "hot_metrics") else {}
    low = rt.lowering()
    rt.shutdown()
    mgr.shutdown()
    return got, low, hot, drops


def test_stream_is_the_card_runs():
    batches = card_stream()
    rounds = [int(np.unique(ks, return_counts=True)[1].max())
              for ks, *_ in batches[WARMUP:]]
    assert rounds == CARD_DENSE_ROUNDS


@pytest.mark.parametrize("mode", ["routed", "dense"])
def test_reference_emits_the_card_rows(mode):
    batches = card_stream()
    header = HEADER + (HOT if mode == "routed" else "")
    jgot, jlow, jhot, jdrops = run(False, header, batches)
    tgot, tlow, thot, tdrops = run(True, header, batches)
    assert (tlow, thot, tdrops) == (jlow, jhot, jdrops)
    assert tgot == jgot
    assert jlow == {"q": "hotkey" if mode == "routed" else "dense"}
    assert sum(len(b) for b in jgot) == CARD_ROWS[mode]
    assert jdrops == CARD_DROPS[mode]
