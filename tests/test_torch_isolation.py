"""The PyTorch port stands alone: it imports neither JAX nor anything of
the JAX package ``siddhi_tpu``, not even its JAX-free modules."""

import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+siddhi_tpu\b(?!_torch)"
    r"|from\s+siddhi_tpu\b(?!_torch))", re.MULTILINE)


def test_port_imports_with_jax_blocked():
    """Every module of the port imports with ``jax`` blocked in
    ``sys.modules``, and none of them loads a ``siddhi_tpu`` module."""
    code = (
        "import sys, pkgutil, importlib\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "sys.modules['jax'] = None\n"
        "import siddhi_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'siddhi_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and "
        "(m == 'siddhi_tpu' or m.startswith(('siddhi_tpu.', 'jax')))]\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO))
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 15
    # the skew-routed slice's modules are among those checked
    slice2 = {"core.event", "core.dense_pattern", "core.hotkey_router",
              "core.partition", "core.stream", "core.app_runtime",
              "core.manager", "planner.app_planner", "planner.query_planner",
              "planner.hotkeys", "ops.nfa_scan", "ops.hotkey_scan",
              "kernels.scan_chain"}
    assert {f"siddhi_tpu_torch.{m}" for m in slice2} <= names
    # and the aggregation slice's
    slice3 = {"aggregation", "aggregation.runtime", "aggregation.device_bank",
              "kernels.bank_scatter", "planner.host_expr", "core.query",
              "core.on_demand", "planner.kernels"}
    assert {f"siddhi_tpu_torch.{m}" for m in slice3} <= names


def test_no_jax_import_statement_in_the_port():
    files = sorted((REPO / "siddhi_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "scan_sweep.py"]
    assert len(files) > 15
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(REPO)}: {hits}"
