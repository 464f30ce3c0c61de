"""The port's flow-sensitive rules, CFG and project layers, and its sync guard.

- **Differential replay** (the twins of ``test_torch_analysis.py``):
  ``tests/test_analysis_flow.py``'s lockset, lock-order and barrier
  fixtures and ``tests/test_analysis_project.py``'s rule fixtures go
  through both packages, findings equal as ``(rule, line, scope, key)``.
- **Port replay**: the CFG/dataflow units of ``test_analysis_cfg.py``
  and the import-map, MRO and call-graph units of
  ``test_analysis_project.py`` run with their imports bound to the
  port's modules (copies of the reference's: the same assertions must
  hold), and the CFG corpus sweep runs over the port's own functions.
- **The sync guard's attribution**, with warnings raised from the
  functions of a fixture package laid out as the port.
"""

import ast
import importlib
import importlib.util
import threading
import warnings
from pathlib import Path

import pytest

from siddhi_tpu_torch.analysis import index_package
from siddhi_tpu_torch.analysis.cfg import build_cfg
from siddhi_tpu_torch.analysis.dataflow import solve
from siddhi_tpu_torch.analysis.locksets import LocksetAnalysis
from siddhi_tpu_torch.analysis.sync_guard import (
    OUTSIDE, SYNC_MESSAGE, SyncGuard, attribute, bucket, unused_on_card_syncs)
from test_torch_analysis import (TWINS, load_reference, reference_tests,
                                 replay)

REPO = Path(__file__).resolve().parent.parent
TESTS = Path(__file__).resolve().parent


def port_bindings(modname):
    """The names ``modname`` imports from ``siddhi_tpu.analysis*``, bound
    to the port's same-named objects."""
    tree = ast.parse((TESTS / f"{modname}.py").read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 0 and \
                (node.module or "").startswith("siddhi_tpu.analysis"):
            mod = importlib.import_module(
                "siddhi_tpu_torch" + node.module[len("siddhi_tpu"):])
            for a in node.names:
                out[a.asname or a.name] = getattr(mod, a.name)
    return out


# -- tests/test_analysis_flow.py: every fixture, both packages ----------------

FLOW_TESTS = reference_tests("test_analysis_flow")
_FLOW_NS = load_reference("test_analysis_flow", TWINS)


@pytest.mark.parametrize("name", FLOW_TESTS)
def test_reference_flow_fixture_replays_on_the_port(name, request):
    assert replay(_FLOW_NS, name, request) >= 1


# -- tests/test_analysis_project.py -------------------------------------------

#: its rule fixtures for the framework rules, through both packages
PROJECT_RULE_TESTS = reference_tests("test_analysis_project",
                                     (r"jit_purity", r"retrace"))
PROJECT_RULE_TESTS = [n for n in PROJECT_RULE_TESTS if "lock" in n]
#: its resolution units, on the port's modules
PROJECT_UNIT_TESTS = [n for n in reference_tests("test_analysis_project")
                      if "lock" not in n and "jit" not in n
                      and "retrace" not in n]
_PROJECT_TWIN_NS = load_reference("test_analysis_project", TWINS)
_PROJECT_PORT_NS = load_reference("test_analysis_project",
                                  port_bindings("test_analysis_project"))


def test_the_replayed_files_were_read():
    assert len(FLOW_TESTS) == 15, FLOW_TESTS
    assert len(PROJECT_RULE_TESTS) == 2, PROJECT_RULE_TESTS
    assert len(PROJECT_UNIT_TESTS) == 8, PROJECT_UNIT_TESTS
    assert len(CFG_TESTS) == 16, CFG_TESTS


@pytest.mark.parametrize("name", PROJECT_RULE_TESTS)
def test_reference_project_rule_fixture_replays_on_the_port(name, request):
    assert replay(_PROJECT_TWIN_NS, name, request) >= 1


@pytest.mark.parametrize("name", PROJECT_UNIT_TESTS)
def test_reference_project_unit_holds_on_the_port(name, request):
    replay(_PROJECT_PORT_NS, name, request)


# -- tests/test_analysis_cfg.py -----------------------------------------------

CFG_TESTS = reference_tests("test_analysis_cfg", (r"every_package",))
_CFG_NS = load_reference("test_analysis_cfg",
                         port_bindings("test_analysis_cfg"))


@pytest.mark.parametrize("name", CFG_TESTS)
def test_reference_cfg_unit_holds_on_the_port(name, request):
    replay(_CFG_NS, name, request)


def test_every_port_function_builds_and_converges():
    """The reference's corpus sweep over the port's own functions."""
    check = _CFG_NS["check_consistency"]
    indexes = index_package(REPO / "siddhi_tpu_torch", REPO)
    n = 0
    for idx in indexes:
        for qual, fn in idx.functions.items():
            cfg = build_cfg(fn)
            check(cfg)
            assert cfg.entry.bid in cfg.reachable()
            res = solve(cfg, LocksetAnalysis(frozenset(), {}))
            assert res.converged, f"{idx.rel}:{qual} did not converge"
            n += 1
    assert n > 500, f"corpus suspiciously small: {n} functions"


# -- the sync guard -----------------------------------------------------------

def sync():
    """Stands in for a torch op that synchronises: the warning comes from
    outside the package, as TORCH_WARN's does."""
    warnings.warn(f"{SYNC_MESSAGE} (Triggered internally at x.cpp:1.)",
                  UserWarning)


FIXTURE = {
    "core/emit_queue.py": """
        def fetch_coalesced(sync):
            sync()
    """,
    "core/ingest_stage.py": """
        def staged_put(sync):
            return _put(sync)
        def _put(sync):
            sync()
    """,
    "ops/device_query.py": """
        def _split_i64(sync):
            sync()
    """,
    "ops/engine.py": """
        class E:
            def step(self, sync):
                sync()
                sync()
            def make(self, sync):
                def inner():
                    sync()
                return inner
            def lam(self, sync):
                return (lambda: sync())()
            def gen(self, sync):
                return list(sync() for _ in range(2))
            def other(self, sync):
                sync()
    """,
}


@pytest.fixture
def port_like(tmp_path):
    """A package laid out as the port (``siddhi_tpu_torch/...``): its
    root and its modules, loaded from their files."""
    root = tmp_path / "siddhi_tpu_torch"
    mods = {}
    for rel, src in FIXTURE.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(__import__("textwrap").dedent(src))
        name = "syncfix_" + rel.replace("/", "_")[:-3] + f"_{id(tmp_path)}"
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mods[rel] = mod
    return root, mods


KEY = "siddhi_tpu_torch/ops/engine.py"


def test_guard_attributes_each_sync_to_its_innermost_port_scope(port_like):
    root, mods = port_like
    e = mods["ops/engine.py"].E()
    with SyncGuard(root=root) as g:
        e.step(sync)
        e.make(sync)()
        e.lam(sync)
        e.gen(sync)
        sync()  # no frame of the package
    assert dict(g.counts) == {f"{KEY}:E.step": 2, f"{KEY}:E.make.inner": 1,
                              f"{KEY}:E.lam": 1, f"{KEY}:E.gen": 2,
                              OUTSIDE: 1}
    # "always": both syncs of one line count, and the line is kept
    assert sum(g.lines[f"{KEY}:E.gen"].values()) == 2
    assert g.unsanctioned() == {f"{KEY}:E.step": 2, f"{KEY}:E.make.inner": 1,
                                f"{KEY}:E.lam": 1, f"{KEY}:E.gen": 2}


def test_guard_buckets_the_sanctioned_scopes(port_like):
    root, mods = port_like
    e = mods["ops/engine.py"].E()
    on_card = {f"{KEY}:E.other": "a fixture's reason for this sync",
               f"{KEY}:E.never": "an entry no run reaches any more"}
    with SyncGuard(root=root, on_card=on_card) as g:
        mods["core/emit_queue.py"].fetch_coalesced(sync)
        mods["core/ingest_stage.py"].staged_put(sync)
        mods["ops/device_query.py"]._split_i64(sync)
        e.other(sync)
        e.step(sync)
    assert g.by_bucket() == {"drain": 1, "staging": 1, "allowlist": 1,
                             "on_card": 1, "unsanctioned": 2}
    assert g.unsanctioned() == {f"{KEY}:E.step": 2}
    assert {k for k in g.counts if bucket(k, on_card)} == {
        "siddhi_tpu_torch/core/emit_queue.py:fetch_coalesced",
        "siddhi_tpu_torch/core/ingest_stage.py:_put",
        "siddhi_tpu_torch/ops/device_query.py:_split_i64",
        f"{KEY}:E.other"}
    assert unused_on_card_syncs([g], on_card) == [f"{KEY}:E.never"]
    assert bucket("siddhi_tpu_torch/ops/x.py:f", {}) is None


def test_guard_reads_each_thread_by_its_own_stack(port_like):
    root, mods = port_like
    e = mods["ops/engine.py"].E()
    with SyncGuard(root=root) as g:
        t = threading.Thread(target=e.other, args=(sync,), name="drain-x")
        t.start()
        t.join()
        e.step(sync)
    assert g.threads == {f"{KEY}:E.other": {"drain-x"},
                         f"{KEY}:E.step": {"MainThread"}}


def test_guard_passes_other_warnings_on_and_restores_on_exit(port_like):
    root, mods = port_like
    before_show, before_filters = warnings.showwarning, warnings.filters[:]
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with pytest.raises(RuntimeError):
            with SyncGuard(root=root) as g:
                warnings.warn("not a sync", UserWarning)
                mods["ops/engine.py"].E().other(sync)
                raise RuntimeError("the loop failed")
    assert [str(w.message) for w in seen] == ["not a sync"]
    assert g.counts == {f"{KEY}:E.other": 1}
    assert warnings.showwarning is before_show
    assert warnings.filters == before_filters


def test_attribute_keys_the_real_port_as_its_allowlists_do():
    """A frame of the port itself is keyed as the allowlists key it: a
    host value whose ``__array__`` takes the frame that materialises it
    inside ``fetch_coalesced``."""
    import sys

    import numpy as np

    from siddhi_tpu_torch.core.emit_queue import fetch_coalesced

    keys = []

    class Probe:
        def __array__(self, dtype=None, copy=None):
            keys.append(attribute(sys._getframe(1)))
            return np.zeros(1)

    fetch_coalesced([Probe()])
    assert keys == ["siddhi_tpu_torch/core/emit_queue.py:fetch_coalesced"]
    assert bucket(keys[0]) == "drain"
    assert attribute(None) == OUTSIDE
