"""``BENCHMARK.json`` and the result line against the benchmark's
contract, and the harness's isolation from JAX and the JAX package."""

import json
import re
import subprocess
import sys

import pytest

from _small import ROOT, small_cell
from cepbench import harness

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in SPEC["configs"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w[k] for w in SPEC["workloads"] for k in ("config", "traffic")]
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert len({w["name"] for w in SPEC["workloads"]}) == len(
        SPEC["workloads"])
    assert 1 <= SPEC["run_seconds"] <= 51


def test_every_named_file_exists():
    for c in SPEC["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert (ROOT / "cepbench" / "reference"
                / f"{conf['reference']}.py").exists()
        if conf.get("readout"):
            assert (ROOT / "cepbench" / "readouts"
                    / f"{conf['readout']}.py").exists()
    for w in SPEC["workloads"]:
        assert (ROOT / "cepbench" / "traffic"
                / f"{w['traffic']}.json").exists()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (ROOT / "cepbench" / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    cell = small_cell("fraud16_1m.hot100k")
    r = harness.run(cell, 7, 0.5, trace, device="cpu")
    assert r.pop("_forbidden") == []
    assert list(r)[-1] == "checks"
    assert set(r) == {"correct", "attempted", "failed", "metrics", "device",
                      "checks"}
    want = {m["name"] for m in cell.metrics(trace)}
    # device-trace metrics are read on a card only
    got = set(r["metrics"])
    assert got <= want
    assert {m["name"] for m in cell.metrics(trace)
            if m["source"] != "device_trace"} <= got
    for v in r["metrics"].values():
        assert set(v) == {"value", "unit"}
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}


def _modules_after(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_jax_after_a_run():
    code = (
        "import json, sys; sys.path.insert(0, 'cepbench/tests');"
        "from _small import small_cell; from cepbench import harness;"
        "harness.run(small_cell('fraud16_1m.uniform'), 3, 0.3, False,"
        " device='cpu');"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    tops = _modules_after(code)
    assert "siddhi_tpu_torch" in tops
    assert not set(tops) & {"jax", "jaxlib", "flax", "siddhi_tpu"}


@pytest.mark.parametrize("ref", ["fraud16_1m"])
def test_reference_imports_nothing_of_the_program(ref):
    code = (
        "import json, sys; sys.path.insert(0, '.');"
        "from cepbench.harness import load_module;"
        f"load_module('reference', '{ref}');"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    tops = _modules_after(code)
    assert not set(tops) & {"siddhi_tpu_torch", "siddhi_tpu", "jax",
                            "jaxlib"}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_run_on_the_card(card):
    # the hot cell: its keys see enough transactions in a few seconds of
    # batches to complete chains, so the check has rows to compare
    out = subprocess.run(
        [sys.executable, "cepbench/run.py", "--workload",
         "fraud16_1m.hot100k", "--seed", "3", "--seconds", "8",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
