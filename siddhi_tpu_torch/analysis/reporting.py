"""Text / JSON / SARIF reporters and baseline handling for the CLI.

A baseline is a JSON file (``analysis_baseline.json``) listing finding
identities (``"<rule>:<key>"``) that are acknowledged-but-unfixed; the
CLI subtracts them so a legacy violation doesn't block the run while a
NEW one still fails it.  Like allowlist entries, baselined identities
that no longer match anything are reported (``--prune-baseline`` style
hygiene is left to the operator — they are listed as ``stale`` in the
report, not failures, since a baseline is a ratchet, not a sanction).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Sequence

from .framework import Finding, Rule


def finding_identity(f: Finding) -> str:
    return f"{f.rule}:{f.key}"


def load_baseline(path) -> List[str]:
    data = json.loads(Path(path).read_text())
    if isinstance(data, dict):
        data = data.get("findings", [])
    if not isinstance(data, list) or \
            not all(isinstance(x, str) for x in data):
        raise ValueError(
            f"baseline {path}: expected a JSON list of "
            '"<rule>:<key>" strings (or {"findings": [...]})')
    return data


def write_baseline(path, findings: Sequence[Finding]):
    ids = sorted({finding_identity(f) for f in findings})
    Path(path).write_text(json.dumps({"findings": ids}, indent=2) + "\n")


def apply_baseline(findings: Sequence[Finding], baseline: Sequence[str]):
    """(unbaselined, baselined, stale_baseline_ids)."""
    known = set(baseline)
    kept = [f for f in findings if finding_identity(f) not in known]
    suppressed = [f for f in findings if finding_identity(f) in known]
    stale = sorted(known - {finding_identity(f) for f in findings})
    return kept, suppressed, stale


def render_text(findings: Sequence[Finding], rules: Sequence[Rule],
                suppressed_count: int = 0, baselined_count: int = 0,
                stale_baseline: Sequence[str] = (),
                modules: int = 0) -> str:
    lines: List[str] = []
    for f in findings:
        lines.append(f.render())
    if findings:
        lines.append("")
    lines.append(
        f"{len(findings)} finding(s) from {len(rules)} rule(s) over "
        f"{modules} module(s); {suppressed_count} allowlisted, "
        f"{baselined_count} baselined")
    for ident in stale_baseline:
        lines.append(f"note: baseline entry no longer matches: {ident}")
    return "\n".join(lines)


def render_json(findings: Sequence[Finding], rules: Sequence[Rule],
                suppressed: Sequence[Finding] = (),
                baselined_count: int = 0,
                stale_baseline: Sequence[str] = (),
                modules: int = 0) -> str:
    return json.dumps({
        # header stamps for trend tracking: CI diffs these two numbers
        # across runs without parsing the body
        "rule_count": len(rules),
        "finding_count": len(findings),
        "rules": [{"name": r.name, "description": r.description}
                  for r in rules],
        "modules": modules,
        "findings": [f.as_dict() for f in findings],
        "allowlisted": len(suppressed),
        "baselined": baselined_count,
        "stale_baseline": list(stale_baseline),
    }, indent=2)


#: SARIF 2.1.0 — the minimal profile editors/CI ingest: one run, the
#: rule catalog on tool.driver, one result per finding with a physical
#: location and a stable partialFingerprint (the allowlist key, which
#: is deliberately line-number-free).
SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")


def render_sarif(findings: Sequence[Finding], rules: Sequence[Rule]) -> str:
    rule_index = {r.name: i for i, r in enumerate(rules)}
    results = []
    for f in findings:
        results.append({
            "ruleId": f.rule,
            # stale-allowlist findings are synthesized by the framework
            # and have no registered rule entry to index
            **({"ruleIndex": rule_index[f.rule]}
               if f.rule in rule_index else {}),
            "level": "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.rel},
                    "region": {"startLine": max(f.line, 1)},
                },
            }],
            "partialFingerprints": {"analysisKey/v1": f"{f.rule}:{f.key}"},
        })
    return json.dumps({
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {
                "driver": {
                    "name": "siddhi-tpu-torch-analysis",
                    "rules": [{
                        "id": r.name,
                        "shortDescription": {"text": r.description},
                    } for r in rules],
                },
            },
            "results": results,
        }],
    }, indent=2)
