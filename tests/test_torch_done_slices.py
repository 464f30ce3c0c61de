"""The JAX test files of the done slices that no other port test names,
held through both packages.

Each file runs twice a case, by ``test_torch_persistence.py``'s twin
runs: once as it is, once with the JAX names it took rebound to the
port's (``SiddhiManager`` is ``SiddhiManager(device="cpu")``), and the
modules a test imports inside its body (``siddhi_tpu`` itself, its
``query_api``, the fluent builder, the doc generator) standing for the
port's while it runs.  Both runs must pass the test's own assertions
and deliver the same events:

- ``tests/test_aggregator_library.py``: every case;
- ``tests/test_device_differential2.py``: every case (the device query
  runtime's ``step_invocations``, fault 12);
- ``tests/test_int_lanes.py``: every case, the ``devices=`` case
  included (item 16, on the port's eight-shard CPU mesh);
- ``tests/test_compiler.py``: every case, the fluent builder's two
  included (item 18);
- ``tests/test_docgen.py``: every case, the listing of every kind
  included; ``test_docgen_lists_the_reference_extensions_of_each_port_kind``
  holds the port's listing against the reference's, kind by kind.

``test_torch_async.py`` replays the async files the same way.
"""

from __future__ import annotations

import types

import pytest

import siddhi_tpu
import siddhi_tpu_torch
from test_torch_device_query import one_torch_thread  # noqa: F401
from test_torch_persistence import cases, check_twin, recording_manager

# the modules a test imports inside its body: the port's stand for them
INNER = ("siddhi_tpu.core.exceptions", "siddhi_tpu.core.event",
         "siddhi_tpu.query_api", "siddhi_tpu.query_api.builder",
         "siddhi_tpu.docgen", "siddhi_tpu.compiler")


def stand_ins(rec, port):
    """``siddhi_tpu`` itself while a test runs: the package of the run
    (the port's during the port's run), with its manager the recording
    one (the port's on the CPU)."""
    pkg = siddhi_tpu_torch if port else siddhi_tpu
    make = ((lambda: siddhi_tpu_torch.SiddhiManager(device="cpu")) if port
            else siddhi_tpu.SiddhiManager)
    root = types.ModuleType("siddhi_tpu")
    root.__path__ = pkg.__path__
    root.SiddhiManager = recording_manager(make, rec)
    root.__getattr__ = lambda name: getattr(pkg, name)
    return {"siddhi_tpu": root}


LEFT_OUT = {}
CORPORA = ("test_aggregator_library", "test_device_differential2",
           "test_int_lanes", "test_compiler", "test_docgen")
CASES = [c for corpus in CORPORA
         for c in cases(corpus, LEFT_OUT.get(corpus, {}))]


def test_the_corpora_were_read():
    counts = {}
    for p in CASES:
        counts[p.values[0]] = counts.get(p.values[0], 0) + 1
    assert counts == {"test_aggregator_library": 12,
                      "test_device_differential2": 16,
                      "test_int_lanes": 12, "test_compiler": 55,
                      "test_docgen": 2}


@pytest.mark.parametrize("corpus,cname,mname,k", CASES)
def test_done_slice_corpus_as_the_reference(corpus, cname, mname, k,
                                            tmp_path, request):
    check_twin(corpus, cname, mname, k, tmp_path, request, inner=INNER,
               stand_ins=stand_ins)


def test_docgen_lists_the_reference_extensions_of_each_port_kind():
    """The port's markdown lists, under each kind the port plans, the
    extensions the reference lists there (the port registers them all;
    its docstrings are its own)."""
    from siddhi_tpu.docgen import generate_markdown as jax_md
    from siddhi_tpu_torch.docgen import generate_markdown as port_md
    from siddhi_tpu_torch.extension.registry import KINDS

    def sections(md):
        out, cur = {}, None
        for line in md.splitlines():
            if line.startswith("## "):
                cur = out.setdefault(line, [])
            elif line.startswith("### ") and cur is not None:
                cur.append(line)
        return out

    jax, port = sections(jax_md()), sections(port_md())
    assert set(port) <= set(jax)
    assert len(port) == sum(
        1 for kind in KINDS if kind not in ("function", "aggregator",
                                            "stream_processor"))
    for heading, names in port.items():
        assert names == jax[heading], heading
