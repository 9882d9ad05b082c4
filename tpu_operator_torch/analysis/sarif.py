"""Minimal SARIF 2.1.0 serialization of gpuop-lint findings, so CI can
surface them as code-scanning annotations alongside human/JSON output.

Only the fields code-scanning ingestion actually reads are emitted: tool
driver with rule metadata, and one result per finding with physical
location + message. Baselined and suppressed findings are not emitted —
SARIF consumers treat every result as actionable.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

from .core import Finding, all_checkers

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")


def to_sarif(findings: Iterable[Finding]) -> Dict:
    findings = list(findings)
    registry = all_checkers()
    used_rules = sorted({f.rule for f in findings})
    rules: List[Dict] = []
    for name in used_rules:
        cls = registry.get(name)
        rules.append({
            "id": name,
            "shortDescription": {
                "text": cls.description if cls else name},
        })
    rule_index = {name: i for i, name in enumerate(used_rules)}
    results = [{
        "ruleId": f.rule,
        "ruleIndex": rule_index[f.rule],
        "level": "error",
        "message": {"text": f.message},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": f.path,
                                     "uriBaseId": "SRCROOT"},
                "region": {"startLine": f.line,
                           "startColumn": f.col},
            },
        }],
    } for f in findings]
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": "gpuop-lint",
                "informationUri": "README.md#gpuop-lint",
                "rules": rules,
            }},
            "results": results,
        }],
    }
