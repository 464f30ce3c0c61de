"""The ``execution('tpu')`` apps of the reference's pattern and sequence
conformance corpora (``tests/test_conformance_patterns2.py``,
``tests/test_conformance_sequences2.py``) through the port.

Each corpus case calls its module's ``both(app, sends, expected)``.  A
private copy of each module is loaded with ``both`` recording its
arguments, so the cases are read, not re-typed.  For every recorded
app the JAX package's ``SiddhiManager`` runs it under
``@app:execution('tpu')``:

- where the reference lowers the query densely, the port's
  ``SiddhiManager(device="cpu")`` must lower it to the general (or the
  batch) step and deliver the same rows, at the same timestamps, in the
  same order;
- where the reference keeps it on its host engine (string selects,
  optional counts, ...), the port must refuse it at creation: its host
  pattern engine is a later slice.

The two corpora are written over ``symbol string`` streams, and the
reference lowers none of their 60 apps densely (string captures and
selects, ``<0:n>`` and ``*`` counts, ``e2[1]`` refs), so today every
case checks the refusal; a case the reference comes to lower densely
is held to its rows.
"""

import importlib.util
from pathlib import Path

import pytest

from siddhi_tpu import SiddhiManager as JaxManager
from siddhi_tpu_torch import SiddhiManager
from siddhi_tpu_torch.core.exceptions import SiddhiAppCreationError

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
        return got, low
    finally:
        mgr.shutdown()


def test_the_corpora_were_read():
    assert len(CASES) >= 60
    assert len({c[1] for c in CASES}) == len(CASES)


@pytest.mark.parametrize("corpus,case,app,sends,out", CASES,
                         ids=[f"{c[0][17:]}:{c[1]}" for c in CASES])
def test_corpus_app_as_the_reference_lowers_it(corpus, case, app, sends,
                                               out):
    jgot, jlow = _run(False, app, sends, out)
    if set(jlow.values()) != {"dense"}:
        with pytest.raises(SiddhiAppCreationError):
            _run(True, app, sends, out)
        return
    tgot, tlow = _run(True, app, sends, out)
    assert set(tlow) == set(jlow)
    assert set(tlow.values()) <= {"dense/general", "dense/batch"}
    assert tgot == jgot
