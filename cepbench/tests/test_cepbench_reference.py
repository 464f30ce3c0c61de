"""The plain references against hand-worked cases."""

import numpy as np
import torch

import _small  # noqa: F401  (puts the checkout on the path)
from cepbench.harness import load_module

FRAUD = load_module("reference", "fraud16_1m")
UNSET = FRAUD.UNSET


def chain(S=3, I=2, keys=1):
    return FRAUD.ChainState(torch, keys, S, I, "cpu")


def step(st, rows, vs, ts, within=1000, rnd=lambda x: x):
    """One round; the emitted rows as ``(row, e1.v, v)``."""
    S = st.act.shape[1]
    thr = torch.arange(S, dtype=torch.float32)  # v > 0, v > 1, v > 2, ...
    rows = torch.tensor(rows)
    v = torch.tensor(vs, dtype=torch.float32)
    e, v1 = FRAUD.step_round(torch, st, rows, v, torch.tensor(ts), thr,
                             within, rnd)
    return [(int(rows[k]), float(a), float(rnd(v)[k]))
            for k, a in zip(e.tolist(), v1.tolist())]


def feed(st, vs, ts, within=10_000):
    rows = []
    for v, t in zip(vs, ts):
        rows.extend((a, b) for _r, a, b in step(st, [0], [v], [t], within))
    return rows


def test_three_node_chain_emits_once_per_completed_instance():
    st = chain()
    # 5 starts A; 6 moves A on and starts B; 7 completes A (v1 5) and
    # moves B on; 8 completes B (v1 6) and moves C (7) on
    assert feed(st, [5, 6, 7, 8], [1, 2, 3, 4]) == [(5.0, 7.0), (6.0, 8.0)]


def test_no_instance_completes_two_nodes_on_one_event():
    st = chain()
    assert feed(st, [5, 19], [1, 2]) == []
    assert feed(st, [19.5], [3]) == [(5.0, 19.5)]


def test_lane_overflow_drops_and_counts():
    st = chain(S=3, I=2)
    # falling values pile up at node 1 (v > e1.v fails); the third finds
    # both lanes taken and is dropped
    feed(st, [10, 9, 8], [1, 2, 3])
    assert int(st.ovf[0]) == 1
    assert bool(st.act[0, 1].all())
    assert sorted(st.reg[0, 1].tolist()) == [9.0, 10.0]
    # 11 moves both on (the dropped 8 is gone), 12 completes both
    assert feed(st, [11, 12], [4, 5]) == [(10.0, 12.0), (9.0, 12.0)]


def test_lane_overflow_on_the_sixteen_node_chain():
    st = chain(S=16, I=4)
    # five falling values: the fifth finds node 1's four lanes taken
    feed(st, [19, 18, 17, 16.5, 16.25], [1, 2, 3, 4, 5])
    assert int(st.ovf[0]) == 1
    assert int(st.act[0, 1].sum()) == 4
    # fifteen rising values carry the four instances to the end
    rows = feed(st, [19.5 + k / 32 for k in range(15)],
                list(range(6, 21)))
    assert sorted(a for a, _b in rows) == [16.5, 17.0, 18.0, 19.0]
    assert {b for _a, b in rows} == {19.5 + 14 / 32}


def test_expired_instances_do_not_advance():
    st = chain()
    assert feed(st, [5, 6, 7], [0, 200, 400], within=100) == []


def test_rounds_keep_each_keys_order():
    st = chain(keys=2)
    step(st, [0, 1], [5, 4], [1, 1])
    step(st, [0], [6], [2])
    assert step(st, [1, 0], [9, 7], [3, 3]) == [(0, 5.0, 7.0)]


def test_bfloat16_control_emits_other_values():
    st, low = chain(), chain()
    vs = [5.001, 6.002, 7.003]
    assert feed(st, vs, [1, 2, 3]) == [(np.float32(5.001).item(),
                                        np.float32(7.003).item())]
    bf = lambda x: x.to(torch.bfloat16).to(torch.float32)  # noqa: E731
    for v, t in zip(vs, [1, 2, 3]):
        got = step(low, [0], [v], [t], 10_000, bf)
    assert got == [(0, 5.0, 7.0)]


class _Batches:
    """Hand-made batches for the references."""

    def __init__(self, batches, span=10):
        self.batches, self.span = batches, span

    def key_space(self, name):
        return 4

    def timestamps(self, i):
        return np.full(len(self.batches[i][0]), 1000 + i * self.span)

    def batch_of_ts(self, ts):
        return (np.asarray(ts) - 1000) // self.span

    def batch(self, i, extras=False):
        keys, vs = self.batches[i]
        return ({"key": np.array(keys, np.int64),
                 "v": np.array(vs, np.float32)}, self.timestamps(i))


FRAUD3 = {"key": "key", "value": "v", "thresholds": [0.0, 1.0, 2.0],
          "sizes": {"states": 3, "lanes": 2, "within_ms": 10_000}}


def test_fraud_reference_follows_every_key_through_rounds():
    # key 1 twice in batch 0 (two rounds), key 2 once a batch
    tr = _Batches([([1, 2, 1], [5, 3, 6]), ([2, 1, 3], [4, 7, 1]),
                   ([2], [5])])
    want = FRAUD.reference(FRAUD3, tr, 3)
    rows = list(zip(want["batch"].tolist(), want["key"].tolist(),
                    want["v1"].tolist(), want["v16"].tolist()))
    assert rows == [(1, 1, 5.0, 7.0), (2, 2, 3.0, 5.0)]
    assert want["dropped"] == {} and want["dropped_total"] == 0
    got, program = FRAUD.as_received(FRAUD3, tr, want)
    numbers = FRAUD.compare(FRAUD3, tr, 3, want, got, program)
    assert numbers["mismatched_rows"] == 0 and numbers["dropped_gap"] == 0
    # a drop the program counts and the reference does not
    program["dropped"] = {2: 1}
    program["dropped_total"] = 1
    numbers = FRAUD.compare(FRAUD3, tr, 3, want, got, program)
    assert numbers["dropped_gap"] == 1
    assert numbers["failed_batches"] == [0, 1, 2]


def test_bfloat16_rounding():
    x = torch.tensor([1.0, 1.00390625, 1.005859375, 699.9, 700.0])
    got = x.to(torch.bfloat16).to(torch.float32)
    assert got.tolist() == [1.0, 1.0, 1.0078125, 700.0, 700.0]


def test_fraud_reference_follows_every_key_through_rounds():
    # key 1 twice in batch 0 (two rounds), key 2 once a batch
    tr = _Batches([([1, 2, 1], [5, 3, 6]), ([2, 1, 3], [4, 7, 1]),
                   ([2], [5])])
    want = FRAUD.reference(FRAUD3, tr, 3)
    rows = list(zip(want["batch"].tolist(), want["key"].tolist(),
                    want["v1"].tolist(), want["v16"].tolist()))
    assert rows == [(1, 1, 5.0, 7.0), (2, 2, 3.0, 5.0)]
    assert want["dropped"] == {} and want["dropped_total"] == 0
    got, program = FRAUD.as_received(FRAUD3, tr, want)
    numbers = FRAUD.compare(FRAUD3, tr, 3, want, got, program)
    assert numbers["mismatched_rows"] == 0 and numbers["dropped_gap"] == 0
    # a drop the program counts and the reference does not
    program["dropped"] = {2: 1}
    program["dropped_total"] = 1
    numbers = FRAUD.compare(FRAUD3, tr, 3, want, got, program)
    assert numbers["dropped_gap"] == 1
    assert numbers["failed_batches"] == [0, 1, 2]
