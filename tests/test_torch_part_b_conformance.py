"""The ``execution('tpu')`` apps of the reference's pattern and sequence
conformance corpora (``tests/test_conformance_patterns2.py``,
``tests/test_conformance_sequences2.py``) through the port.

Each corpus case calls its module's ``both(app, sends, expected)``.  A
private copy of each module is loaded with ``both`` recording its
arguments, so the cases are read, not re-typed.  For every recorded
app the JAX package's ``SiddhiManager`` runs it under
``@app:execution('tpu')``, and the port's ``SiddhiManager(device="cpu")``
must give the same rows, at the same timestamps, in the same order,
with the same ``lowering()`` and the same fallback WARNING:

- where the reference lowers the query densely, the port lowers it to
  the general (or the batch) step;
- where the reference keeps it on its host engine (string selects,
  optional counts, ``e2[1]`` refs, ...), the port falls back to its
  host pattern engine with the reference's WARNING.

The two corpora are written over ``symbol string`` streams, and the
reference lowers none of their 60 apps densely, so every case holds the
host engine's rows; a case the reference comes to lower densely is held
to the dense rows.
"""

import importlib.util
from pathlib import Path

import pytest

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager
from test_torch_device_query import FallbackLog

CORPORA = ("test_conformance_patterns2", "test_conformance_sequences2")


def _record(corpus: str):
    """``(id, app, sends, out)`` of every ``both`` call in a corpus."""
    path = Path(__file__).resolve().parent / f"{corpus}.py"
    spec = importlib.util.spec_from_file_location(f"_{corpus}_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cases = []

    def both(app, sends, expected, out="OutputStream"):
        cases.append((app, sends, out))
        return expected

    mod.both = both
    for cname in sorted(vars(mod)):
        cls = getattr(mod, cname)
        if not (cname.startswith("Test") and isinstance(cls, type)):
            continue
        for mname in sorted(vars(cls)):
            if not mname.startswith("test_"):
                continue
            start = len(cases)
            try:
                getattr(cls(), mname)()
            except Exception:
                pass  # a case that also checks its host run directly
            for k in range(start, len(cases)):
                suffix = f"-{k - start}" if len(cases) - start > 1 else ""
                cases[k] = (f"{cname}.{mname}{suffix}", *cases[k])
    return cases


CASES = [(corpus, *case) for corpus in CORPORA for case in _record(corpus)]


def _run(port, app, sends, out):
    mgr = SiddhiManager(device="cpu") if port else JaxManager()
    try:
        with FallbackLog("siddhi_tpu_torch" if port else "siddhi_tpu") as log:
            rt = mgr.create_siddhi_app_runtime(
                "@app:playback @app:execution('tpu') " + app)
        got = []
        rt.add_callback(out, lambda evs: got.extend(
            (e.timestamp, list(e.data)) for e in evs))
        rt.start()
        for stream, row, ts in sends:
            rt.get_input_handler(stream).send(row, timestamp=ts)
        low = rt.lowering(step_kinds=True) if port else rt.lowering()
        rt.shutdown()
        return got, low, log.messages
    finally:
        mgr.shutdown()


def test_the_corpora_were_read():
    assert len(CASES) >= 60
    assert len({c[1] for c in CASES}) == len(CASES)


@pytest.mark.parametrize("corpus,case,app,sends,out", CASES,
                         ids=[f"{c[0][17:]}:{c[1]}" for c in CASES])
def test_corpus_app_as_the_reference_lowers_it(corpus, case, app, sends,
                                               out):
    jgot, jlow, jwarn = _run(False, app, sends, out)
    tgot, tlow, twarn = _run(True, app, sends, out)
    assert set(tlow) == set(jlow)
    assert twarn == jwarn
    for q, where in jlow.items():
        if where == "dense":
            assert tlow[q] in ("dense/general", "dense/batch")
        else:
            assert tlow[q] == where == "host"
    assert tgot == jgot
