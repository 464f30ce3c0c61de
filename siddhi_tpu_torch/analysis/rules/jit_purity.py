"""jit-purity: the engines' step callables stay pure.

The port has no ``jax.jit``: where the JAX package hands a step to the
compiler, the port's engines hold a step callable in torch ops and run
it once per batch (or collision round, or timer tick).  The name is the
reference's so the two catalogs line up; in the port it means that the
steps keep every effect — fault checks, EmitStats / IngestStats
increments, logging, wall-clock reads, host materialization — on the
host side of the step boundary, as the reference's jitted steps do.  A
step that logs or counts would do so per round where the reference does
so per batch, and a materializer inside a step stalls the host on the
card every round.

The step roots are:

- the closures a step builder returns — ``make_step`` /
  ``make_general_step`` / ``make_time_step`` (``ops/dense_nfa.py``),
  ``build_packed_nfa`` (``kernels/dense_step.py``) and ``make_scan``
  (``ops/nfa_scan.py``): every nested def (or lambda) the builder
  ``return``s;
- the step methods of the device engines — ``step``, ``_step`` and
  ``*_step`` functions in ``ops/``, ``parallel/``, ``kernels/`` and
  ``devtable/`` (the device-query, fused-graph, hot-key scan and device
  table steps, the kernels' step wrappers).

The rule reports banned constructs anywhere in a root's subtree:

- host clocks: ``time.time`` / ``time.monotonic`` / ``time.perf_counter``
  / ``datetime.now``
- logging / printing: any call on a ``log`` / ``logger`` / ``logging``
  receiver, bare ``print``
- fault hooks: ``.check(...)`` on a fault-injector receiver
  (``fi`` / ``faults`` / ``fault_injector`` / ``injector``)
- stats counters: writes to a ``*.stats.*`` attribute chain
- host materialization: the host-sync rule's materializers
  (``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
  ``.to("cpu")`` / ``torch.cuda.synchronize`` / ``np.asarray`` /
  ``np.array``), and bare ``float()`` / ``int()`` / ``bool()`` on a
  non-literal argument (on a tensor, a sync)

Without a ``ProjectIndex`` only each root's own subtree is searched;
with one — the normal whole-program run — the scan follows
project-resolved **helper calls** transitively: everything a step calls
runs with it, so a ``time.time()`` two hops away in another file is the
same bug as one written inline.  Findings on a helper are attributed to
the helper's own file and scope.  Edges the project cannot resolve
statically (arbitrary object attributes, container lookups) are
skipped — conservative, never guessed.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, Iterator, List, Set, Tuple

from ..framework import Finding, Rule, register
from ..index import ModuleIndex
from .host_sync import materializer_name

#: builders whose returned closures are step roots
STEP_BUILDERS = {"make_step", "make_general_step", "make_time_step",
                 "build_packed_nfa", "make_scan"}
#: step functions of the device engines
STEP_NAME_RE = re.compile(r"^_?(?:\w+_)?step$")
#: the packages that hold device engines (repo-relative path segments)
STEP_DIRS = ("/ops/", "/parallel/", "/kernels/", "/devtable/")

_CLOCKS = {"time.time", "time.monotonic", "time.perf_counter",
           "time.perf_counter_ns", "datetime.now", "datetime.datetime.now"}
_LOG_RECEIVERS = {"log", "logger", "logging"}
_FAULT_RECEIVERS = {"fi", "faults", "fault_injector", "injector"}
_CASTS = {"float", "int", "bool"}


def _returned_defs(index: ModuleIndex, builder: ast.AST) -> List[ast.AST]:
    """The nested defs and lambdas ``builder`` returns."""
    local = {n.name: n for n in ast.walk(builder)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
             and n is not builder}
    out = []
    for node in ast.walk(builder):
        if not isinstance(node, ast.Return) or node.value is None:
            continue
        if index.enclosing(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)) is not builder:
            continue
        v = node.value
        if isinstance(v, ast.Lambda):
            out.append(v)
        elif isinstance(v, ast.Name) and v.id in local:
            out.append(local[v.id])
    return out


def step_roots(index: ModuleIndex) -> List[Tuple[ast.AST, ast.AST]]:
    """(site, step callable) for every step root of the module; the
    site is the builder for a returned closure, the def itself for a
    step method."""
    out = []
    in_step_dir = any(d in "/" + index.rel for d in STEP_DIRS)
    for fn in index.functions.values():
        if fn.name in STEP_BUILDERS:
            out.extend((fn, d) for d in _returned_defs(index, fn))
        elif in_step_dir and STEP_NAME_RE.match(fn.name) and \
                not any(isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and a.name in STEP_BUILDERS
                        for a in index.ancestors(fn)):
            out.append((fn, fn))
    return out


def impure_constructs(index: ModuleIndex, fn: ast.AST
                      ) -> List[Tuple[int, str]]:
    """(line, description) for every banned construct in a step's
    subtree (nested local defs run with it, so the whole subtree
    counts)."""
    hits: List[Tuple[int, str]] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            mat = materializer_name(index, node)
            name = index.dotted(node.func)
            if mat is not None:
                hits.append((node.lineno, f"host materialization {mat}"))
                continue
            if name is None:
                continue
            base = name.split(".")[0]
            leaf = name.split(".")[-1]
            if name in _CLOCKS:
                hits.append((node.lineno, f"host clock {name}()"))
            elif base in _LOG_RECEIVERS and base != leaf:
                hits.append((node.lineno, f"logging call {name}()"))
            elif name == "print":
                hits.append((node.lineno, "print()"))
            elif leaf == "check" and base in _FAULT_RECEIVERS:
                hits.append((node.lineno, f"fault hook {name}()"))
            elif name in _CASTS and node.args and \
                    not isinstance(node.args[0], ast.Constant):
                hits.append((node.lineno,
                             f"host materialization {name}() on a "
                             "non-literal"))
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                tname = index.dotted(t) if isinstance(t, ast.Attribute) \
                    else None
                if tname and "stats" in tname.split(".")[:-1]:
                    hits.append((t.lineno,
                                 f"stats counter write {tname}"))
    return hits


@register
class JitPurityRule(Rule):
    name = "jit-purity"
    description = (
        "host clock / logging / fault hook / stats counter / host "
        "materialization inside an engine's step callable")

    #: transitive helper-following cap per step root
    MAX_HELPER_DEFS = 50

    def begin(self):
        # (rel, scope, line) already reported — one helper reached from
        # steps in several modules is one finding
        self._reported: Set[Tuple[str, str, int]] = set()

    def check(self, index: ModuleIndex) -> Iterable[Finding]:
        reported = getattr(self, "_reported", None)
        if reported is None:
            reported = self._reported = set()
        for _site, fn in step_roots(index):
            for d_idx, d_fn in self._traced_defs(index, fn):
                d_qual = d_idx.def_qualname(d_fn)
                for line, what in impure_constructs(d_idx, d_fn):
                    key = (d_idx.rel, d_qual, line)
                    if key in reported:
                        continue  # same fn reached from several steps
                    reported.add(key)
                    inline = d_idx is index and d_fn is fn
                    yield Finding(
                        rule=self.name,
                        rel=d_idx.rel,
                        line=line,
                        scope=d_qual,
                        message=(
                            f"{what} inside a step callable"
                            + ("" if inline else
                               " (helper reached from a step)")
                            + " — effects run once per round (or stall "
                            "the host on the card); hoist to the host "
                            "side of the step boundary, or allowlist "
                            "with a justification"),
                    )

    def _traced_defs(self, fn_idx: ModuleIndex, fn: ast.AST
                     ) -> Iterator[Tuple[ModuleIndex, ast.AST]]:
        """The step plus — in project mode — every project-resolved
        helper its body (transitively) calls: they all run together."""
        yield (fn_idx, fn)
        if self.project is None:
            return
        visited: Set[Tuple[int, int]] = {(id(fn_idx), id(fn))}
        work: List[Tuple[ModuleIndex, ast.AST]] = [(fn_idx, fn)]
        while work and len(visited) <= self.MAX_HELPER_DEFS:
            cur_idx, cur_fn = work.pop()
            for node in ast.walk(cur_fn):
                if not isinstance(node, ast.Call):
                    continue
                hit = self.project.resolve_call(cur_idx, node)
                if hit is None:
                    continue
                t_idx, t_fn, _fq = hit
                key = (id(t_idx), id(t_fn))
                if key in visited:
                    continue
                visited.add(key)
                work.append((t_idx, t_fn))
                yield (t_idx, t_fn)
