"""The port's persistence held against the JAX package's.

The JAX package's persistence tests (``tests/test_persistence.py``,
``test_conformance_persistence2.py``; the durability and crash-recovery
files are replayed the same way by ``test_torch_durability.py`` and
``test_torch_crash_recovery.py``) run twice each, from private copies of
their module:

- once as they are, with the JAX package's ``SiddhiManager`` wrapped in
  a recorder;
- once with every name the module took from the JAX package rebound to
  the port's (``SiddhiManager`` becomes ``SiddhiManager(device="cpu")``
  in the same recorder, the stores, the checkpoint writer and the
  exceptions the port's), and the JAX modules a test imports inside its
  body (``siddhi_tpu.util.persistence``, ``siddhi_tpu.core.exceptions``,
  ``siddhi_tpu.durability``) standing for the port's while it runs.

Both runs must pass the test's own assertions (recovered sequences
equal to uninterrupted runs, the walk back past a corrupted revision,
the counters), and the recorders must hold the same events: every
callback's output in order, across every runtime the test builds, and
every pull query's rows.  Values are compared bit for bit, except the
float32 sums of an app on the device query path, which keep the
``rel=1e-4, abs=1e-3`` bound of ``test_torch_device_query.py``.  Each
run gets its own ``tmp_path`` directory.

Every case of the two files here runs; the durability and
crash-recovery files list the cases that wait for a later slice in
their ``LEFT_OUT`` with the ``ROADMAP.md`` item, as the corpus tests
do.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import inspect
import sys
from pathlib import Path

import pytest

import siddhi_tpu_torch
from siddhi_tpu import SiddhiManager as JaxManager
from test_torch_device_query import (  # noqa: F401 (a fixture)
    _param_sets,
    bound,
    one_torch_thread,
    same_rows,
)

pytestmark = pytest.mark.faults

TESTS = Path(__file__).resolve().parent

# the JAX modules a corpus test imports inside its body: the port's
# stand for them during the port's run
INNER_IMPORTS = ("siddhi_tpu.util.persistence", "siddhi_tpu.core.exceptions",
                 "siddhi_tpu.durability")


def _ev_row(e):
    return (e.timestamp, e.is_expired, tuple(e.data))


class Record:
    """What one run of a corpus test delivered."""

    def __init__(self):
        self.apps = []
        self.got = {}  # callback target -> rows, across runtimes
        self.pulls = []  # (query, rows)

    def tolerance(self):
        tols = [t for t in (bound(a) for a in self.apps) if t is not None]
        return max(tols) if tols else None


class _Runtime:
    """An app runtime whose callbacks and pulls are recorded."""

    def __init__(self, rt, rec):
        self._rt, self._rec = rt, rec

    def add_callback(self, target, cb):
        self._rt.add_callback(target, cb)
        got = self._rec.got.setdefault(target, [])
        if target in self._rt.junctions:
            self._rt.add_callback(target, lambda evs: got.extend(
                _ev_row(e) for e in evs))
        else:
            self._rt.add_callback(target, lambda ts, i, o: got.append(
                (ts, [_ev_row(e) for e in i or []],
                 [_ev_row(e) for e in o or []])))

    def query(self, q):
        out = self._rt.query(q)
        self._rec.pulls.append((q, [_ev_row(e) for e in out]))
        return out

    def __getattr__(self, name):
        return getattr(self._rt, name)


def recording_manager(make, rec):
    """A ``SiddhiManager`` class for a corpus module: ``make()`` builds
    the package's manager, whose runtimes are recorded into ``rec``."""

    class RecordingManager:
        def __init__(self, *a, **kw):
            self._m = make()

        def create_siddhi_app_runtime(self, app, **kw):
            # an app built with the fluent builder is each package's own
            # object: its class name is what compares
            rec.apps.append(app if isinstance(app, str)
                            else type(app).__name__)
            return getattr(rec, "runtime_class", _Runtime)(
                self._m.create_siddhi_app_runtime(app, **kw), rec)

        def __getattr__(self, name):
            return getattr(self._m, name)

    return RecordingManager


def _port_twin(obj):
    """The port's object of the same name and module as a JAX one."""
    mod = getattr(obj, "__module__", "") or ""
    if not mod.startswith("siddhi_tpu."):
        return obj
    port_mod = importlib.import_module(
        "siddhi_tpu_torch." + mod[len("siddhi_tpu."):])
    return getattr(port_mod, obj.__name__)


@contextlib.contextmanager
def port_modules(inner=INNER_IMPORTS, stand_ins=None):
    """The port's modules stand for the JAX ones in ``inner``, and the
    objects of ``stand_ins`` (JAX module name -> object) for theirs."""
    stand_ins = dict(stand_ins or {})
    for name in inner:
        stand_ins[name] = importlib.import_module(
            "siddhi_tpu_torch." + name[len("siddhi_tpu."):])
    saved = {name: sys.modules.get(name) for name in stand_ins}
    sys.modules.update(stand_ins)
    try:
        yield
    finally:
        for name, m in saved.items():
            if m is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = m


def load(corpus, port, rec):
    """A private copy of the corpus module for one run."""
    spec = importlib.util.spec_from_file_location(
        f"_{corpus}_{'port' if port else 'jax'}", TESTS / f"{corpus}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if port:
        for name, obj in list(vars(mod).items()):
            if isinstance(obj, type) or callable(obj):
                setattr(mod, name, _port_twin(obj))
        mod.SiddhiManager = recording_manager(
            lambda: siddhi_tpu_torch.SiddhiManager(device="cpu"), rec)
    else:
        mod.SiddhiManager = recording_manager(JaxManager, rec)
    return mod


def cases(corpus, left_out, left_out_params=()):
    """``(corpus, class, method, k)`` of every test of the corpus but
    those ``left_out`` (keyed ``(class, method)``, method None for a
    whole class) and the parameter sets whose values are in
    ``left_out_params``."""
    mod = load(corpus, False, Record())
    out = []
    for cname in sorted(vars(mod)):
        cls = getattr(mod, cname)
        if cname.startswith("Test") and isinstance(cls, type):
            if (cname, None) in left_out:
                continue
            fns = [(cname, m) for m in sorted(vars(cls))
                   if m.startswith("test_")]
        elif cname.startswith("test_") and callable(cls):
            fns = [(None, cname)]
        else:
            continue
        for c, m in fns:
            if (c, m) in left_out:
                continue
            fn = getattr(getattr(mod, c), m) if c else getattr(mod, m)
            for k, params in enumerate(_param_sets(fn)):
                if any(v in left_out_params for v in params.values()):
                    continue
                out.append(pytest.param(
                    corpus, c, m, k,
                    id=f"{c or ''}.{m}"
                    + (f"[{'-'.join(map(str, params.values()))}]"
                       if params else "")))
    return out


def run(corpus, cname, mname, k, port, tmp_path, request,
        inner=INNER_IMPORTS, stand_ins=None, record=Record, rebind=None):
    """One run of a corpus test; returns its record.  ``inner``,
    ``stand_ins``: what stands for the JAX modules the test imports
    inside its body during the port's run (``port_modules``;
    ``stand_ins(rec, port)`` gives the objects, in both runs);
    ``record``: the record class (its manager factory may wrap the
    runtimes further); ``rebind(mod, rec, port)``: names of the loaded
    module to rebind further, in both runs."""
    rec = record()
    mod = load(corpus, port, rec)
    if rebind is not None:
        rebind(mod, rec, port)
    owner = getattr(mod, cname)() if cname else mod
    fn = getattr(owner, mname)
    kwargs = dict(_param_sets(fn)[k])
    if port:
        ctx = port_modules(inner, stand_ins(rec, True) if stand_ins else None)
    elif stand_ins:
        ctx = port_modules((), stand_ins(rec, False))
    else:
        ctx = contextlib.nullcontext()
    finalizers = []
    try:
        with ctx:
            for name in inspect.signature(fn).parameters:
                if name in kwargs:
                    continue
                if name == "tmp_path":
                    d = tmp_path / ("port" if port else "jax")
                    d.mkdir()
                    kwargs[name] = d
                elif name in ("caplog", "monkeypatch"):
                    kwargs[name] = request.getfixturevalue(name)
                else:
                    # a fixture of the corpus module (its ``manager``),
                    # built as the run's modules stand: a generator's
                    # first value, or a plain fixture's return
                    gen = getattr(mod, name).__wrapped__()
                    if inspect.isgenerator(gen):
                        kwargs[name] = next(gen)
                        finalizers.append(gen)
                    else:
                        kwargs[name] = gen
            fn(**kwargs)
    finally:
        for gen in finalizers:
            with contextlib.suppress(StopIteration):
                next(gen)
    return rec


def _rows(rows, wall):
    """Rows with their timestamps, or without them for an app on the
    wall clock (no ``@app:playback``), whose two runs stamp
    differently."""
    return [(None,) + r[1:] if wall else r for r in rows]


def check_twin(corpus, cname, mname, k, tmp_path, request, **kw):
    """The corpus test passes in both packages, and both delivered the
    same events (``kw``: ``run``'s ``inner``, ``stand_ins``,
    ``record``, ``rebind``)."""
    jax = run(corpus, cname, mname, k, False, tmp_path, request,
              stand_ins=kw.get("stand_ins"), record=kw.get("record", Record),
              rebind=kw.get("rebind"))
    port = run(corpus, cname, mname, k, True, tmp_path, request, **kw)
    assert port.apps == jax.apps
    tol = jax.tolerance()
    wall = any("@app:playback" not in a for a in jax.apps)
    assert list(port.got) == list(jax.got)
    for target, rows in jax.got.items():
        prows = port.got[target]
        assert len(prows) == len(rows), target
        if rows and isinstance(rows[0][1], list):
            # query callbacks: (ts, in rows, out rows)
            for (jt, ji, jo), (tt, ti, to) in zip(rows, prows):
                assert wall or jt == tt, target
                assert same_rows(_rows(ji, wall), _rows(ti, wall), tol), \
                    target
                assert same_rows(_rows(jo, wall), _rows(to, wall), tol), \
                    target
        else:
            assert same_rows(_rows(rows, wall), _rows(prows, wall), tol), \
                target
    assert [q for q, _ in port.pulls] == [q for q, _ in jax.pulls]
    for (_, jrows), (_, trows) in zip(jax.pulls, port.pulls):
        assert same_rows(_rows(jrows, wall), _rows(trows, wall), tol)
    return jax, port


# -- tests/test_persistence.py and test_conformance_persistence2.py ----------

CASES = (cases("test_persistence", {})
         + cases("test_conformance_persistence2", {}))


def test_the_corpora_were_read():
    assert len(CASES) == 14


@pytest.mark.parametrize("corpus,cname,mname,k", CASES)
def test_persistence_corpus_as_the_reference(corpus, cname, mname, k,
                                             tmp_path, request):
    jax, port = check_twin(corpus, cname, mname, k, tmp_path, request)
    assert any(port.got.values()) or port.pulls or not jax.got
