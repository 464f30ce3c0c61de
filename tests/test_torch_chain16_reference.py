"""The ``chain16_1m`` deployment at a small size on the CPU, held to the
benchmark's plain reference (``cepbench/reference/chain16_1m.py``).

The program runs the configuration's own app through ``SiddhiManager``
(the batch route: the capture-free chain in ``partition with``), fed a
fixed number of batches of the benchmark's generator: a stride mix
(distinct keys a batch), a hot mix (many events a key a batch) and a
hot mix at few lanes, where instances overflow.  Its rows and its
dropped instances per key (the benchmark's readout) equal the
reference's.  Batches are counted, not seconds, so a loaded host
changes nothing.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from siddhi_tpu_torch import SiddhiManager
from siddhi_tpu_torch.core.event import EventBatch
from siddhi_tpu_torch.core.stream import StreamCallback

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from cepbench.generator import Traffic, merge  # noqa: E402


def _load(kind: str, name: str):
    path = ROOT / "cepbench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"chain16_test_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load("reference", "chain16_1m")
READOUT = _load("readouts", "dense_overflow")
CONFIG = json.loads((ROOT / "cepbench" / "configs"
                     / "chain16_1m.json").read_text())

# (mix file, its small overrides, lanes, batches)
CASES = {
    "stride": ("txn_stride", {"batch": 256,
                              "columns": {"key": {"modulo": 256}}}, 32, 60),
    "hot": ("txn_hot100k", {"batch": 512,
                            "columns": {"key": {"high": 64}}}, 32, 8),
    "hot_overflow": ("txn_hot100k", {"batch": 384,
                                     "columns": {"key": {"high": 48}}},
                     3, 6),
}


class Keep(StreamCallback):
    def __init__(self):
        self.got = []

    def receive_batch(self, batch):
        self.got.append((batch.timestamps, batch.columns))


def run_program(config: dict, traffic: Traffic, n_batches: int):
    """The configuration's app on the CPU over ``n_batches`` batches:
    ``(route, rows as received, the readout)``."""
    mgr = SiddhiManager(device="cpu")
    rt = mgr.create_siddhi_app_runtime(
        config["app"].format(**config["sizes"]))
    keep = Keep()
    rt.add_callback(config["output"], keep)
    rt.start()
    h = rt.get_input_handler(config["input"])
    for i in range(n_batches):
        cols, ts = traffic.batch(i)
        h.send_batch(EventBatch(traffic.stream, traffic.names, cols, ts))
    rt.drain()
    (runtime,) = rt.pattern_runtimes().values()
    route = runtime.engine.step_kind
    program = READOUT.read(rt, config)
    rt.shutdown()
    mgr.shutdown()
    return route, keep.got, program


@pytest.mark.parametrize("case", sorted(CASES))
def test_program_equals_the_reference(case):
    mix, over, lanes, n_batches = CASES[case]
    config = merge(CONFIG, {"sizes": {"partitions": 256, "lanes": lanes}})
    spec = merge(json.loads((ROOT / "cepbench" / "traffic"
                             / f"{mix}.json").read_text()), over)
    traffic = Traffic(spec, 2**31 + 11)
    route, got, program = run_program(config, traffic, n_batches)
    assert route == "batch"
    want = REF.reference(config, traffic, n_batches)
    numbers = REF.compare(config, traffic, n_batches, want, got, program)
    assert numbers["rows_compared"] > 0
    assert numbers["mismatched_rows"] == 0
    assert numbers["dropped_gap"] == 0
    assert program["dropped"] == want["dropped"]
    assert program["dropped_total"] == want["dropped_total"]
    if case == "hot_overflow":
        assert want["dropped_total"] > 0
    else:
        assert want["dropped_total"] == 0


def test_a_planted_fault_is_seen():
    """One row's value off by a bit, and a drop moved to another key:
    both gaps count them."""
    mix, over, lanes, n_batches = CASES["hot_overflow"]
    config = merge(CONFIG, {"sizes": {"partitions": 256, "lanes": lanes}})
    spec = merge(json.loads((ROOT / "cepbench" / "traffic"
                             / f"{mix}.json").read_text()), over)
    traffic = Traffic(spec, 5)
    want = REF.reference(config, traffic, n_batches)
    got, program = REF.as_received(config, traffic, want)
    _ts, cols = got[-1]
    cols["v"] = cols["v"].copy()
    cols["v"][0] = np.nextafter(np.float32(cols["v"][0]),
                                np.float32(np.inf))
    key, n = next(iter(program["dropped"].items()))
    program["dropped"][key] = n - 1
    program["dropped"][-1] = 1
    numbers = REF.compare(config, traffic, n_batches, want, got, program)
    assert numbers["mismatched_rows"] == 2
    assert numbers["dropped_gap"] == 2


def test_reference_imports_nothing_of_the_program():
    code = (
        "import importlib.util, json, sys;"
        "spec = importlib.util.spec_from_file_location('r', "
        "'cepbench/reference/chain16_1m.py');"
        "m = importlib.util.module_from_spec(spec);"
        "spec.loader.exec_module(m);"
        "print(json.dumps(sorted({x.split('.')[0] for x in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "numpy" in tops
    assert not tops & {"siddhi_tpu_torch", "siddhi_tpu", "jax", "jaxlib"}
