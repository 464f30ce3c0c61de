"""The check against a broken timed path: a sound run on the CPU is
correct, and each fault a cell can have turns ``correct`` false.  The
runs skip the harness's look for a card (``device="cpu"``) and drive
the rest of a run at small sizes.  One card, so no exchange between
cards to leave out."""

import numpy as np
import pytest

from _small import small_cell
from cepbench import harness
from siddhi_tpu_torch.core.dense_pattern import DensePatternRuntime
from siddhi_tpu_torch.core.partition import _rows
from siddhi_tpu_torch.ops.dense_nfa import (
    DeferredDenseEmit,
    DensePatternEngine,
)

SEED = 2**31 + 101


def run(name, seconds=2.5):
    return harness.run(small_cell(name), SEED, seconds, False, device="cpu")


def state_unchanged_dense(mp):
    orig = DensePatternEngine.make_general_step

    def make(self, stream_key):
        step = orig(self, stream_key)

        def frozen(state, *a):
            out = step({k: v.clone() for k, v in state.items()}, *a)
            return (state,) + tuple(out[1:])
        return frozen
    mp.setattr(DensePatternEngine, "make_general_step", make)


def half_batch(cls):
    def fault(mp):
        orig = cls.process_partitioned

        def half(self, stream_id, batch, keys):
            n = len(batch) // 2
            return orig(self, stream_id, _rows(batch, 0, n),
                        np.asarray(keys)[:n])
        mp.setattr(cls, "process_partitioned", half)
    return fault


def altered_dense(mp):
    orig = DeferredDenseEmit.materialize

    def materialize(self, host):
        ev, out = orig(self, host)
        if len(out):
            out = out.copy()
            out[0, 0] += 1.0
        return ev, out
    mp.setattr(DeferredDenseEmit, "materialize", materialize)


FAULTS = {
    "fraud16_1m.uniform": {"state_unchanged": state_unchanged_dense,
                           "half_batch": half_batch(DensePatternRuntime),
                           "answer_altered": altered_dense},
    "fraud16_1m.hot100k": {"state_unchanged": state_unchanged_dense,
                           "half_batch": half_batch(DensePatternRuntime),
                           "answer_altered": altered_dense},
}


@pytest.mark.parametrize("name", ["fraud16_1m.uniform", "fraud16_1m.hot100k"])
def test_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0
    assert r["checks"]["rows_compared"]["value"] > 0


@pytest.mark.parametrize("name,fault", [(n, f) for n in FAULTS
                                        for f in FAULTS[n]])
def test_fault_is_caught(monkeypatch, name, fault):
    FAULTS[name][fault](monkeypatch)
    r = run(name)
    assert not r["correct"], (fault, r["checks"])
    assert r["failed"] > 0
