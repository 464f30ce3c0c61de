"""The port's static-analysis pass (``siddhi_tpu_torch.analysis``).

- **Differential replay**: the reference's rule fixtures
  (``tests/test_analysis_rules.py``) for the eight framework rules and
  the allowlist, SARIF and baseline cases run with the names they
  import bound to twins that drive both packages: every fixture goes
  through ``siddhi_tpu.analysis`` under its own paths and through
  ``siddhi_tpu_torch.analysis`` with ``siddhi_tpu/`` re-rooted to
  ``siddhi_tpu_torch/``, the findings must be equal as
  ``(rule, line, scope, key)``, and the reference's own assertions run
  on the reference's results.  ``test_torch_analysis_flow.py`` replays
  the flow, CFG and project files with the same twins.
- **Torch fixtures** for the four rules whose constructs the port
  redefines: host-sync (``.item()``/``.tolist()``/``.cpu()``/...),
  ingest-put (``.to(<device>)``/``.cuda()``/...), jit-purity (the step
  builders' closures and the engines' step methods) and retrace (step
  builders and ``build.load`` on the hot path).
- **The whole port passes**, with the rule catalog of the reference.
- **Fallback counting**: every family the port hands ``note_fallback``
  has its recorder and its context dict (the ``getattr`` the call graph
  cannot follow).
"""

import ast
import json
import re
import textwrap
from pathlib import Path

import pytest

import siddhi_tpu.analysis as REF
import siddhi_tpu_torch.analysis as PORT
from siddhi_tpu.analysis import reporting as ref_reporting
from siddhi_tpu_torch.analysis import reporting as port_reporting
from siddhi_tpu_torch.analysis.__main__ import main as port_main
from siddhi_tpu_torch.analysis.rules.host_sync import SCANNED

REPO = Path(__file__).resolve().parent.parent
TESTS = Path(__file__).resolve().parent

#: the rules whose semantics the port keeps unchanged (paths re-rooted)
FRAMEWORK_RULES = (
    "broad-except-swallow", "lock-discipline", "lockset-race",
    "lock-order-deadlock", "barrier-flush-completeness", "thread-lifecycle",
    "bounded-queue-discipline", "fallback-discipline")

#: suppressed findings the port's whole-package run must at least reach
SUPPRESSED_FLOOR = 150


# -- the twins ----------------------------------------------------------------

_ROOT_RE = re.compile(r"(^|:)siddhi_tpu/")


def port_key(key: str) -> str:
    """A reference path or key re-rooted at the port's package."""
    return _ROOT_RE.sub(r"\1siddhi_tpu_torch/", key)


def ident(f, rebase=False):
    key = port_key(f.key) if rebase else f.key
    return (f.rule, f.line, f.scope, key)


def same_findings(ref, port, where):
    """The reference's findings, re-rooted, equal the port's."""
    want = sorted(ident(f, rebase=True) for f in ref)
    got = sorted(ident(f) for f in port)
    assert got == want, f"{where}: the packages disagree"
    TWIN_CALLS.append(where)


#: every twin comparison made, so a replay proves it compared something
TWIN_CALLS = []


class TwinIndex:
    """``ModuleIndex`` over both packages: the reference's under the
    fixture's path, the port's under the re-rooted one."""

    def __init__(self, path, rel, source=None):
        self.ref = REF.ModuleIndex(path, rel, source=source)
        self.port = PORT.ModuleIndex(path, port_key(rel), source=source)

    def __getattr__(self, name):
        return getattr(self.ref, name)


class TwinRule:
    def __init__(self, name):
        self.name = name
        self.ref = REF.get_rule(name)
        self.port = PORT.get_rule(name)

    def __getattr__(self, name):
        return getattr(self.ref, name)

    def begin(self):
        self.ref.begin()
        self.port.begin()

    def check(self, index):
        ref = list(self.ref.check(index.ref))
        port = list(self.port.check(index.port))
        same_findings(ref, port, f"{self.name}.check({index.rel})")
        return ref

    def finish(self):
        ref = list(self.ref.finish())
        same_findings(ref, list(self.port.finish()), f"{self.name}.finish")
        return ref


class TwinAllowlist:
    """Both packages' ``Allowlist``: either both accept the entries or
    both refuse them (the reference's error is raised)."""

    def __init__(self, rule, entries=None):
        entries = dict(entries or {})
        errors = []
        for cls, ents, slot in ((PORT.Allowlist, {port_key(k): v for k, v in
                                                  entries.items()}, "port"),
                                (REF.Allowlist, entries, "ref")):
            try:
                setattr(self, slot, cls(rule, ents))
            except ValueError as e:
                errors.append(e)
        assert len(errors) in (0, 2), errors
        if errors:
            TWIN_CALLS.append(f"Allowlist({rule}) refused in both")
            raise errors[1]
        self.rule = rule
        self.entries = entries


def twin_get_rule(name):
    return TwinRule(name)


def twin_run_rules(indexes, rules=None, allowlists=None, project=None):
    assert rules is not None and project is None, \
        "replayed fixtures pass their rules"
    res = {}
    for side in ("ref", "port"):
        res[side] = (REF if side == "ref" else PORT).run_rules(
            [getattr(i, side) for i in indexes],
            [getattr(r, side) for r in rules],
            None if allowlists is None else
            {k: getattr(a, side) for k, a in allowlists.items()})
    names = ",".join(r.name for r in rules)
    for part in ("findings", "suppressed"):
        same_findings(res["ref"][part], res["port"][part],
                      f"run_rules[{names}].{part}")
    return res["ref"]


def to_port(f):
    """A reference finding as the port reports it."""
    return PORT.Finding(f.rule, port_key(f.rel), f.line, f.scope, f.message,
                        key=port_key(f.key))


def _port_rules(rules):
    return [PORT.get_rule(r.name) for r in rules]


def _sarif_rebased(doc):
    """A reference SARIF document as the port writes it; the catalog's
    descriptions kept for the framework rules only (the port words the
    other four for its own constructs)."""
    doc = json.loads(port_key(json.dumps(doc)).replace(
        '"uri": "siddhi_tpu/', '"uri": "siddhi_tpu_torch/'))
    doc["runs"][0]["tool"]["driver"]["name"] = "siddhi-tpu-torch-analysis"
    return _framework_catalog(doc)


def _framework_catalog(doc):
    for rule in doc["runs"][0]["tool"]["driver"]["rules"]:
        if rule["id"] not in FRAMEWORK_RULES:
            rule.pop("shortDescription", None)
            rule.pop("fullDescription", None)
    return doc


class TwinReporting:
    """``reporting`` over both packages: renders and baselines compared."""

    @staticmethod
    def render_sarif(findings, rules):
        ref = ref_reporting.render_sarif(findings, rules)
        port = port_reporting.render_sarif([to_port(f) for f in findings],
                                           _port_rules(rules))
        assert _sarif_rebased(json.loads(ref)) == \
            _framework_catalog(json.loads(port))
        TWIN_CALLS.append("render_sarif")
        return ref

    @staticmethod
    def write_baseline(path, findings):
        ref_reporting.write_baseline(path, findings)
        port_path = Path(str(path) + ".port")
        port_reporting.write_baseline(port_path, [to_port(f)
                                                  for f in findings])
        ref_doc = json.loads(Path(path).read_text())
        assert json.loads(port_key(json.dumps(ref_doc))) == \
            json.loads(port_path.read_text())
        TWIN_CALLS.append("write_baseline")

    @staticmethod
    def load_baseline(path):
        ref = ref_reporting.load_baseline(path)
        port = port_reporting.load_baseline(Path(str(path) + ".port"))
        assert {port_key(k) for k in ref} == set(port)
        return ref

    @staticmethod
    def apply_baseline(findings, baseline):
        ref = ref_reporting.apply_baseline(findings, baseline)
        port = port_reporting.apply_baseline(
            [to_port(f) for f in findings], {port_key(k) for k in baseline})
        for r, p in zip(ref[:2], port[:2]):
            same_findings(r, p, "apply_baseline")
        assert [port_key(k) for k in ref[2]] == list(port[2])
        return ref


def twin_all_rules():
    return [TwinRule(r.name) for r in REF.all_rules()]


TWINS = {"ModuleIndex": TwinIndex, "get_rule": twin_get_rule,
         "run_rules": twin_run_rules, "Allowlist": TwinAllowlist,
         "reporting": TwinReporting, "all_rules": twin_all_rules}


def load_reference(modname, bindings):
    """The reference test module's namespace, executed afresh, with
    ``bindings`` replacing the names it imported."""
    path = TESTS / f"{modname}.py"
    ns = {"__name__": f"_replay_{modname}", "__file__": str(path)}
    exec(compile(path.read_text(), str(path), "exec"), ns)
    ns.update(bindings)
    return ns


def reference_tests(modname, skip=()):
    """The ``test_*`` function names of a reference module, by AST (no
    import), minus ``skip`` (names matching any of its patterns)."""
    tree = ast.parse((TESTS / f"{modname}.py").read_text())
    names = [n.name for n in tree.body if isinstance(n, ast.FunctionDef)
             and n.name.startswith("test_")]
    return [n for n in names if not any(re.search(s, n) for s in skip)]


def replay(ns, name, request):
    """Runs reference test ``name`` from namespace ``ns``, its fixture
    arguments taken from pytest."""
    fn = ns[name]
    args = fn.__code__.co_varnames[:fn.__code__.co_argcount]
    before = len(TWIN_CALLS)
    fn(*[request.getfixturevalue(a) for a in args])
    return len(TWIN_CALLS) - before


# -- differential replay of tests/test_analysis_rules.py ----------------------

#: the rules whose torch forms this file tests on its own fixtures below
TORCH_FORMS = (r"host_sync", r"ingest_put", r"jit_purity", r"retrace")
RULE_TESTS = reference_tests("test_analysis_rules", TORCH_FORMS)
_RULES_NS = load_reference("test_analysis_rules", TWINS)


def test_the_rule_fixtures_were_read():
    assert len(RULE_TESTS) == 19, RULE_TESTS


@pytest.mark.parametrize("name", RULE_TESTS)
def test_reference_rule_fixture_replays_on_the_port(name, request):
    assert replay(_RULES_NS, name, request) >= 1, \
        "the replay compared nothing"


# -- torch fixtures -------------------------------------------------------------

def check(rule_name, rel, src):
    """Raw findings of one port rule over one fixture module."""
    rule = PORT.get_rule(rule_name)
    rule.begin()
    idx = PORT.ModuleIndex(Path("fixture.py"), rel,
                           source=textwrap.dedent(src))
    return list(rule.check(idx))


def project_run(rule_name, files):
    """One port rule in project mode over fixture modules, no allowlist."""
    indexes = [PORT.ModuleIndex(Path(rel), rel, source=textwrap.dedent(src))
               for rel, src in files.items()]
    res = PORT.run_rules(indexes, [PORT.get_rule(rule_name)],
                         {rule_name: PORT.Allowlist(rule_name, {})})
    return res["findings"]


DEVICE_RT = "siddhi_tpu_torch/ops/device_query.py"  # scanned
HOST_MOD = "siddhi_tpu_torch/core/event.py"  # not scanned

MATERIALIZERS = {
    "item": "return out.item()",
    "tolist": "return out.tolist()",
    "cpu": "return out.cpu()",
    "numpy": "return out.numpy()",
    "to_cpu": 'return out.to("cpu")',
    "to_cpu_kw": 'return out.to(device="cpu")',
    "to_cpu_device": 'return out.to(torch.device("cpu"))',
    "synchronize": "torch.cuda.synchronize()",
    "np_asarray": "return np.asarray(out)",
    "np_array": "return np.array(out)",
}


@pytest.mark.parametrize("form", sorted(MATERIALIZERS))
def test_host_sync_fires_on_each_materializer_and_only_in_scanned_modules(
        form):
    src = ("import numpy as np\nimport torch\nclass E:\n"
           "    def process(self, out):\n"
           f"        {MATERIALIZERS[form]}\n")
    hits = check("host-sync-hazard", DEVICE_RT, src)
    assert [(f.line, f.scope, f.key) for f in hits] == \
        [(5, "E.process", f"{DEVICE_RT}:E.process")]
    assert check("host-sync-hazard", HOST_MOD, src) == []


def test_host_sync_sees_through_receiver_chains():
    hits = check("host-sync-hazard", DEVICE_RT, """
        class E:
            def a(self):
                return self.state["n"].sum().item()
            def b(self):
                return self.engine.step(self.s)[0].tolist()
            def c(self, out):
                return out.detach().cpu().numpy()
    """)
    assert [(f.line, f.scope) for f in hits] == \
        [(4, "E.a"), (6, "E.b"), (8, "E.c"), (8, "E.c")]


def test_host_sync_quiet_on_device_work_and_other_moves():
    hits = check("host-sync-hazard", DEVICE_RT, """
        import torch
        class E:
            def process(self, q, out, dev):
                q.push(out)                       # stays on the device
                x = out.to(torch.int32)           # a dtype, not the host
                y = out.to(dev, non_blocking=True)
                return torch.cuda.current_stream(dev), x, y
    """)
    assert hits == []


def test_host_sync_reports_a_stale_scanned_entry():
    rule = PORT.get_rule("host-sync-hazard")
    res = PORT.run_rules([], [rule], {rule.name: PORT.Allowlist(rule.name)})
    missing = {f.key for f in res["findings"]}
    assert missing == {f"{rel}:<missing>" for rel in SCANNED}


PUTS = {
    "to_device": "return torch.from_numpy(cols).to(self.device)",
    "to_device_kw": "return x.to(device=dev)",
    "to_cuda_literal": 'return x.to("cuda")',
    "to_device_non_blocking": "return x.to(dev, non_blocking=True)",
    "cuda": "return x.cuda()",
    "as_tensor": "return torch.as_tensor(cols, device=dev)",
    "tensor": "return torch.tensor([1, 2], device=self.device)",
    "copy_from_numpy": "return state.copy_(torch.from_numpy(cols))",
    "copy_from_np": "return state.copy_(np.zeros(4))",
}


@pytest.mark.parametrize("form", sorted(PUTS))
def test_ingest_put_fires_on_each_put_form_anywhere(form):
    src = ("import numpy as np\nimport torch\nclass E:\n"
           "    def ingest(self, cols, x, dev, state):\n"
           f"        {PUTS[form]}\n")
    for rel in (DEVICE_RT, HOST_MOD, "siddhi_tpu_torch/planner/x.py"):
        hits = check("ingest-put-bypass", rel, src)
        assert [(f.line, f.scope) for f in hits] == [(5, "E.ingest")], rel


def test_ingest_put_sees_through_receiver_chains():
    hits = check("ingest-put-bypass", HOST_MOD, """
        class E:
            def a(self):
                return self.host["x"][0].to(self.device)
            def b(self):
                return self.build().rows.cuda()
    """)
    assert [(f.line, f.scope) for f in hits] == [(4, "E.a"), (6, "E.b")]


def test_ingest_put_quiet_on_allocations_dtypes_and_staging():
    hits = check("ingest-put-bypass", HOST_MOD, """
        import torch
        from siddhi_tpu_torch.core.ingest_stage import staged_put
        i32 = torch.int32
        _F32 = torch.float32
        def f(self, x, dev, n):
            a = torch.zeros((n,), dtype=torch.int32, device=dev)
            b = torch.full((n,), 7, device=dev)
            c = torch.empty(n, device=self.device)
            d = torch.arange(n, device=dev)
            e = torch.ones_like(x)
            g = x.to(torch.int64) + x.to(i32) + x.to(_F32) + x.to(x.dtype)
            h = x.to(dtype=torch.float64).to("cpu").to(None)
            k = torch.as_tensor(x) + torch.tensor(3, device="cpu")
            x.copy_(a)
            return staged_put(x, dev), a, b, c, d, e, g, h, k
    """)
    assert hits == []


STEP_EFFECTS = """
    import time
    import numpy as np
    class E:
        def make_general_step(self, fi, log):
            def step(state, cols):
                fi.check("device.step")        # fault hook
                log.debug("stepping")          # logging
                t0 = time.time()               # host clock
                self.stats.batches += 1        # stats counter
                n = int(state.sum())           # host materialization
                m = state.max().item()         # host materialization
                return state, n, m, t0
            return step
"""


def test_jit_purity_fires_on_host_effects_in_a_builder_closure():
    hits = check("jit-purity", "siddhi_tpu_torch/ops/x.py", STEP_EFFECTS)
    assert len(hits) == 6, [f.message for f in hits]
    assert all(f.scope == "E.make_general_step.step" for f in hits)


def test_jit_purity_fires_in_engine_step_methods_only_in_engine_dirs():
    src = """
        import time
        class Q:
            def _running_step(self, state):
                return state, time.perf_counter()
            def acc_step(self, state, log):
                log.info("acc")
                return state
            def process(self, state):
                return time.time()          # host side: fine
    """
    hits = check("jit-purity", "siddhi_tpu_torch/ops/x.py", src)
    assert sorted(f.scope for f in hits) == ["Q._running_step", "Q.acc_step"]
    # a step-named method outside the engines' packages is not a step
    assert check("jit-purity", "siddhi_tpu_torch/robustness/x.py", src) == []


def test_jit_purity_quiet_on_pure_steps_and_unreturned_closures():
    hits = check("jit-purity", "siddhi_tpu_torch/ops/x.py", """
        import time
        import torch
        class E:
            def make_time_step(self):
                S = int(self.S)                      # builder side: fine
                def helper():
                    return time.time()               # not returned
                def time_step(state, now: int):
                    fire = state["deadline"] <= now
                    return state, fire, fire.sum(dtype=torch.int32)
                return time_step
            def process(self, state):
                self.stats.steps += 1                # host side: fine
                return self._step(state)
    """)
    assert hits == []


def test_jit_purity_follows_helpers_across_modules():
    hits = project_run("jit-purity", {
        "pkg/__init__.py": "",
        "pkg/low.py": """
            def leaf(x):
                print("step")          # effect two hops down
                return x
        """,
        "pkg/mid.py": """
            from pkg.low import leaf
            def helper(x):
                return leaf(x)
        """,
        "pkg/ops/__init__.py": "",
        "pkg/ops/eng.py": """
            from pkg.mid import helper
            class E:
                def step(self, state):
                    return helper(state)
        """,
    })
    assert [(f.rel, f.scope) for f in hits] == [("pkg/low.py", "leaf")]


def test_retrace_fires_on_an_unmemoized_builder_or_load_per_batch():
    hits = check("retrace-hazard", "siddhi_tpu_torch/ops/x.py", """
        from siddhi_tpu_torch.kernels import build
        def make_scan(c):
            def scan(x):
                return x * c
            return scan
        class E:
            def process_batch(self, cols):
                f = make_scan(2)             # a fresh closure per batch
                return f(cols)
            def _kernel(self, cols):
                return build.load("probe")   # loader on the hot path, here
            def process(self, eng, cols):
                return eng.make_general_step("S")(cols)   # untyped receiver
    """)
    assert sorted(f.scope for f in hits) == \
        ["E._kernel", "E.process", "E.process_batch"]


def test_retrace_quiet_when_memoized_or_off_the_hot_path():
    memo_site = """
        class E:
            def process_batch(self, cols):
                if self._f is None:
                    self._f = self.engine.make_step("S")
                return self._f(cols)
    """
    memo_builder = """
        class E:
            def make_general_step(self, key):
                fn = self._general_cache.get(key)
                if fn is None:
                    def step(x):
                        return x
                    fn = self._general_cache[key] = step
                return fn
            def process_deferred(self, cols):
                return self.make_general_step("S")(cols)
    """
    module_cache = """
        _LOADED = {}
        def load(name):
            lib = _LOADED.get(name)
            if lib is None:
                lib = _LOADED[name] = object()
            return lib
        def dispatch(x):
            return load("probe"), x
    """
    cold = """
        class E:
            def __init__(self):
                self._step = self.make_time_step()
            def build(self):
                return self.make_step("S")
    """
    for src in (memo_site, memo_builder, module_cache, cold):
        assert check("retrace-hazard", "siddhi_tpu_torch/ops/x.py",
                     src) == [], src


def test_retrace_follows_one_hop_to_a_rebuilding_helper():
    files = {
        "pkg/__init__.py": "",
        "pkg/help.py": """
            def make_scan(c):
                def scan(x):
                    return x * c
                return scan
            def scan_of(c):
                return make_scan(c)        # no cache: a build a call
        """,
        "pkg/hot.py": """
            from pkg.help import scan_of
            class E:
                def process_batch(self, cols):
                    return scan_of(2)(cols)
        """,
    }
    hits = project_run("retrace-hazard", files)
    assert [(f.rel, f.scope) for f in hits] == \
        [("pkg/hot.py", "E.process_batch")]


# -- the whole port -------------------------------------------------------------

@pytest.fixture(scope="module")
def port_report():
    """One CLI run over the port, in JSON (the index and the parse cache
    are shared by every test of the module)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_main(["--format", "json"])
    return rc, json.loads(out.getvalue())


def test_whole_port_passes_the_pass(port_report):
    rc, doc = port_report
    assert rc == 0, doc["findings"][:10]
    assert doc["finding_count"] == 0
    assert doc["modules"] > 100
    assert doc["allowlisted"] > SUPPRESSED_FLOOR


def test_the_pass_scans_the_port_by_default(port_report):
    _rc, doc = port_report
    assert doc["rule_count"] == 12


def test_no_scanned_module_is_stale():
    for rel in SCANNED:
        assert (REPO / rel).is_file(), rel


def test_rule_catalog_equals_the_reference(capsys):
    assert port_main(["--list-rules"]) == 0
    names = [ln.split(":", 1)[0] for ln in
             capsys.readouterr().out.splitlines()]
    assert names == [r.name for r in REF.all_rules()]
    assert len(names) == 12
    assert set(FRAMEWORK_RULES) < set(names)


def test_every_allowlist_entry_says_why_and_is_rooted_at_the_port():
    from siddhi_tpu_torch.analysis.allowlists import (ALLOWLISTS,
                                                      ON_CARD_SYNCS)

    assert set(ALLOWLISTS) == {r.name for r in PORT.all_rules()}
    for table in (*ALLOWLISTS.values(), ON_CARD_SYNCS):
        for key, why in table.items():
            assert key.startswith("siddhi_tpu_torch/") and ":" in key, key
            assert re.search(r":\d+$", key) is None, key  # line-free
            assert isinstance(why, str) and len(why.split()) >= 4, key


def test_cli_sarif_names_the_port(capsys):
    rc = port_main(["--rules", "broad-except-swallow", "--format", "sarif"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert doc["runs"][0]["tool"]["driver"]["name"] == \
        "siddhi-tpu-torch-analysis"
    assert doc["runs"][0]["results"] == []


def test_cli_baseline_round_trip_on_a_planted_package(tmp_path, capsys):
    pkg = tmp_path / "siddhi_tpu_torch"
    (pkg / "core").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "core" / "__init__.py").write_text("")
    (pkg / "core" / "x.py").write_text(
        "def f():\n    try:\n        g()\n    except Exception:\n"
        "        pass\n")
    args = ["--root", str(pkg), "--rules", "broad-except-swallow"]
    assert port_main(args) == 1
    base = tmp_path / "base.json"
    assert port_main(args + ["--write-baseline", str(base)]) == 0
    assert port_main(args + ["--baseline", str(base)]) == 0
    out = capsys.readouterr().out
    assert "siddhi_tpu_torch/core/x.py" in out


def test_the_analysis_imports_neither_jax_nor_the_reference():
    for path in (REPO / "siddhi_tpu_torch" / "analysis").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    and node.level == 0 else [])
            for m in mods:
                root = m.split(".")[0]
                assert root not in ("jax", "jaxlib", "siddhi_tpu"), \
                    f"{path}: imports {m}"


# -- fallback counting ------------------------------------------------------------

def _note_fallback_families():
    """(file, line, family) of every ``note_fallback`` call in the port."""
    out = []
    for path in sorted((REPO / "siddhi_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and (
                    getattr(node.func, "id", None) == "note_fallback"
                    or getattr(node.func, "attr", None) == "note_fallback"):
                fam = node.args[1] if len(node.args) > 1 else None
                assert isinstance(fam, ast.Constant) and \
                    isinstance(fam.value, str), \
                    f"{path}:{node.lineno}: the family must be a literal"
                out.append((path.name, node.lineno, fam.value))
    return out


def test_every_note_fallback_family_is_recorded_and_kept():
    """``note_fallback`` (``planner/app_planner.py``) counts through
    ``getattr(sm, f"record_{family}_fallback")``, which the static
    pass cannot follow (its gates are allowlisted for it): every family
    the port passes must have the recorder on the statistics manager and
    the ``<family>_fallbacks`` dict on the app context."""
    from siddhi_tpu_torch.planner.app_planner import AppContext, note_fallback
    from siddhi_tpu_torch.util.statistics import StatisticsManager

    calls = _note_fallback_families()
    families = {fam for _f, _l, fam in calls}
    assert families >= {"devtable", "hotkey", "multiplex", "fused"}, calls
    for fam in sorted(families):
        ctx = AppContext("app", "cpu")
        sm = ctx.statistics_manager = StatisticsManager("app")
        assert callable(getattr(sm, f"record_{fam}_fallback", None)), fam
        assert isinstance(getattr(ctx, f"{fam}_fallbacks", None), dict), fam
        note_fallback(ctx, fam, "q", "the reason")
        assert getattr(ctx, f"{fam}_fallbacks") == {"q": "the reason"}
        counted = getattr(sm, f"{fam}_fallbacks", None)
        assert counted == {"q": 1}, (fam, counted)


def test_the_ports_lock_names_produce_lock_tokens():
    """Every ``with <...>lock:`` of the port is a lock token for the
    lock rules, the engine lock as one node wherever it is reached
    (``self.app_context.process_lock``, ``self.app.app_context...``)."""
    from siddhi_tpu_torch.analysis.locksets import lock_token
    from siddhi_tpu_torch.analysis.project import plain_dotted

    tokens = set()
    for path in sorted((REPO / "siddhi_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.With):
                continue
            for item in node.items:
                name = plain_dotted(item.context_expr) or ""
                if name.lower().endswith("lock"):
                    tok = lock_token(item.context_expr, {})
                    assert tok is not None, f"{path}:{node.lineno} {name}"
                    tokens.add(tok)
    assert ("chain", "app_context.process_lock") in tokens
    assert len(tokens) >= 5, tokens
