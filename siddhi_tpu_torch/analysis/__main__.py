"""``python -m siddhi_tpu_torch.analysis`` — run the invariant pass.

Exit status 0 when the package is clean (zero unbaselined findings,
no stale allowlist entries), 1 otherwise, 2 on usage errors.

Examples::

    python -m siddhi_tpu_torch.analysis                  # whole package, text
    python -m siddhi_tpu_torch.analysis --format json
    python -m siddhi_tpu_torch.analysis --format sarif   # SARIF 2.1.0 for CI
    python -m siddhi_tpu_torch.analysis --list-rules
    python -m siddhi_tpu_torch.analysis --rules jit-purity,retrace-hazard
    python -m siddhi_tpu_torch.analysis --baseline analysis_baseline.json
    python -m siddhi_tpu_torch.analysis --write-baseline analysis_baseline.json
    python -m siddhi_tpu_torch.analysis --changed-only origin/main  # pre-push

``--changed-only GITREF`` is the pre-push check: the whole package is
still indexed (the parse cache makes that one parse per file, and the
whole-program rules need the full call graph anyway), but only
findings in modules that differ from ``GITREF`` are reported, and
allowlist staleness — a whole-list property — is not judged.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

from .framework import all_rules, get_rule, run_rules
from .index import index_package
from . import reporting


def changed_rels(rel_base: Path, gitref: str):
    """Repo-relative paths that differ from ``gitref`` (committed,
    staged, or worktree changes) plus untracked files."""
    out = set()
    for cmd in (["git", "diff", "--name-only", gitref],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        proc = subprocess.run(
            cmd, cwd=rel_base, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{' '.join(cmd)} failed: {proc.stderr.strip()}")
        out.update(line.strip() for line in proc.stdout.splitlines()
                   if line.strip())
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m siddhi_tpu_torch.analysis",
        description=("Unified static-analysis pass for siddhi_tpu_torch's "
                     "device-contract, concurrency, and jit-purity "
                     "invariants."))
    parser.add_argument(
        "--root", default=None,
        help="package directory to scan (default: the installed "
             "siddhi_tpu_torch package)")
    parser.add_argument(
        "--rules", default=None,
        help="comma-separated subset of rule names (default: all)")
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit")
    parser.add_argument(
        "--format", choices=("text", "json", "sarif"), default=None,
        help="report format on stdout (default: text)")
    parser.add_argument(
        "--json", action="store_true",
        help="alias for --format json (kept for compatibility)")
    parser.add_argument(
        "--baseline", default=None, metavar="FILE",
        help="JSON file of acknowledged finding identities to subtract")
    parser.add_argument(
        "--write-baseline", default=None, metavar="FILE",
        help="write current unallowlisted findings as a baseline and "
             "exit 0")
    parser.add_argument(
        "--changed-only", default=None, metavar="GITREF",
        help="report only findings in modules that differ from GITREF "
             "(the cheap pre-push check; stale-allowlist enforcement "
             "is skipped — staleness is a whole-package property)")
    args = parser.parse_args(argv)

    rules = all_rules()
    if args.rules:
        try:
            rules = [get_rule(n.strip()) for n in args.rules.split(",")
                     if n.strip()]
        except KeyError as e:
            parser.error(str(e))
    if args.list_rules:
        for r in rules:
            print(f"{r.name}: {r.description}")
        return 0

    if args.root is not None:
        root = Path(args.root)
        rel_base = root.parent
    else:
        root = Path(__file__).resolve().parent.parent
        rel_base = root.parent
    if not root.is_dir():
        parser.error(f"--root {root} is not a directory")

    indexes = index_package(root, rel_base)
    result = run_rules(indexes, rules)
    findings = result["findings"]
    suppressed = result["suppressed"]

    if args.changed_only:
        try:
            changed = changed_rels(rel_base, args.changed_only)
        except (OSError, RuntimeError) as e:
            parser.error(f"--changed-only: {e}")
        findings = [f for f in findings
                    if f.rel in changed and f.rule != "stale-allowlist"]

    if args.write_baseline:
        reporting.write_baseline(args.write_baseline, findings)
        print(f"wrote {len(findings)} finding identity(ies) to "
              f"{args.write_baseline}")
        return 0

    baselined_count = 0
    stale_baseline = ()
    if args.baseline:
        baseline = reporting.load_baseline(args.baseline)
        findings, baselined, stale_baseline = \
            reporting.apply_baseline(findings, baseline)
        baselined_count = len(baselined)

    fmt = args.format or ("json" if args.json else "text")
    if fmt == "json":
        print(reporting.render_json(
            findings, rules, suppressed, baselined_count,
            stale_baseline, modules=len(indexes)))
    elif fmt == "sarif":
        print(reporting.render_sarif(findings, rules))
    else:
        print(reporting.render_text(
            findings, rules, len(suppressed), baselined_count,
            stale_baseline, modules=len(indexes)))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
