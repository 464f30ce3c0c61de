"""Rule registry, findings, and allowlist discipline.

A ``Rule`` visits pre-parsed ``ModuleIndex`` objects and yields
``Finding``s.  Every finding carries a stable **key**
(``<relpath>:<scope-or-attribute>``) that allowlists and baselines match
on — keys deliberately exclude line numbers so unrelated edits above a
sanctioned site don't churn the lists.

Allowlist contract (enforced, not advisory):

- every entry MUST carry a non-empty written justification — the
  decision to sanction a violation stays visible in review;
- entries expire: after a run, an allowlisted key that no longer
  matches any finding becomes a ``stale-allowlist`` finding itself, so
  the lists can only shrink when the code improves (the old guard
  tests' ``test_allowlist_not_stale`` generalized).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

from .index import ModuleIndex

#: rule name -> Rule instance, in registration order
_REGISTRY: Dict[str, "Rule"] = {}


@dataclass(frozen=True)
class Finding:
    rule: str
    rel: str          # repo-relative posix path
    line: int
    scope: str        # qualified enclosing scope ("Class.method")
    message: str
    #: allowlist/baseline key; defaults to "<rel>:<scope>"
    key: str = field(default="")

    def __post_init__(self):
        if not self.key:
            object.__setattr__(self, "key", f"{self.rel}:{self.scope}")

    def as_dict(self) -> dict:
        return {
            "rule": self.rule,
            "file": self.rel,
            "line": self.line,
            "scope": self.scope,
            "key": self.key,
            "message": self.message,
        }

    def render(self) -> str:
        return f"{self.rel}:{self.line} [{self.rule}] {self.scope}: {self.message}"


class Allowlist:
    """Per-rule sanctioned findings: key -> written justification."""

    def __init__(self, rule: str, entries: Optional[Dict[str, str]] = None):
        self.rule = rule
        self.entries: Dict[str, str] = dict(entries or {})
        for key, why in self.entries.items():
            if not (isinstance(why, str) and why.strip()):
                raise ValueError(
                    f"allowlist entry {rule}:{key!r} has no justification "
                    "— every sanctioned violation must say why")

    def __contains__(self, key: str) -> bool:
        return key in self.entries

    def split(self, findings: Sequence[Finding]):
        """(kept, suppressed, stale) — ``stale`` are synthetic findings
        for entries that matched nothing (expiry)."""
        kept: List[Finding] = []
        suppressed: List[Finding] = []
        matched = set()
        for f in findings:
            if f.key in self.entries:
                matched.add(f.key)
                suppressed.append(f)
            else:
                kept.append(f)
        stale = [
            Finding(
                rule="stale-allowlist",
                rel=key.split(":", 1)[0],
                line=0,
                scope=key.split(":", 1)[1] if ":" in key else key,
                message=(f"allowlisted for rule '{self.rule}' but no "
                         "longer trips it — prune the entry "
                         f"(justification was: {self.entries[key]!r})"),
                key=f"{self.rule}:{key}",
            )
            for key in sorted(set(self.entries) - matched)
        ]
        return kept, suppressed, stale


class Rule:
    """One invariant.  Subclasses set ``name``/``description`` and
    implement ``check(index) -> Iterable[Finding]``; the default
    allowlist ships in ``allowlists.py`` and can be overridden per run
    (tests exercise rules against fixture allowlists this way)."""

    name: str = ""
    description: str = ""
    #: the whole-program ``ProjectIndex`` for the current run, set by
    #: ``run_rules`` before ``begin()``.  ``None`` = single-module
    #: lexical mode (rules degrade to their pre-cross-module behavior;
    #: fixture tests pin both resolutions this way).
    project = None

    def begin(self):
        """Hook: called once per run before any module is visited —
        cross-module rules reset their accumulated state here (rule
        instances are registry singletons shared across runs)."""

    def check(self, index: ModuleIndex) -> Iterable[Finding]:
        raise NotImplementedError

    def finish(self) -> Iterable[Finding]:
        """Hook for cross-module rules: called once after every index
        has been visited."""
        return ()

    def default_allowlist(self) -> Allowlist:
        from . import allowlists

        return Allowlist(self.name, allowlists.ALLOWLISTS.get(self.name, {}))


def register(cls):
    """Class decorator: instantiate and register a rule by name."""
    rule = cls()
    if not rule.name:
        raise ValueError(f"{cls.__name__} has no rule name")
    if rule.name in _REGISTRY:
        raise ValueError(f"duplicate rule name {rule.name!r}")
    _REGISTRY[rule.name] = rule
    return cls


def all_rules() -> List[Rule]:
    return list(_REGISTRY.values())


def get_rule(name: str) -> Rule:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown rule {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def run_rules(indexes: Sequence[ModuleIndex],
              rules: Optional[Sequence[Rule]] = None,
              allowlists: Optional[Dict[str, Allowlist]] = None,
              project=None,
              ) -> Dict[str, List[Finding]]:
    """Run rules over pre-parsed modules.

    A ``ProjectIndex`` over ``indexes`` is built (or taken from
    ``project``) and handed to every rule as ``rule.project`` — the
    cross-module resolution layer for imports, class hierarchies, and
    the call graph.

    Returns ``{"findings": unsuppressed (stale entries included),
    "suppressed": allowlisted}`` — the caller applies any baseline."""
    from .project import ProjectIndex

    rules = list(rules) if rules is not None else all_rules()
    if project is None:
        project = ProjectIndex(indexes)
    findings: List[Finding] = []
    suppressed: List[Finding] = []
    for rule in rules:
        rule.project = project
        rule.begin()
        raw: List[Finding] = []
        for index in indexes:
            raw.extend(rule.check(index))
        raw.extend(rule.finish())
        al = (allowlists or {}).get(rule.name) or rule.default_allowlist()
        kept, supp, stale = al.split(raw)
        findings.extend(kept)
        findings.extend(stale)
        suppressed.extend(supp)
        # registry rules are singletons: drop the project reference so
        # a later direct rule.check() (fixture tests) runs lexically
        rule.project = None
    findings.sort(key=lambda f: (f.rel, f.line, f.rule))
    return {"findings": findings, "suppressed": suppressed}
