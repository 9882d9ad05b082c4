"""Grandfathered-findings baseline.

A finding's fingerprint hashes (rule, path, flagged-line text, occurrence
index among identical lines) — NOT the line number, so edits elsewhere in
the file don't churn the baseline, and NOT the message, so improving a
checker's wording doesn't either. The occurrence index disambiguates two
identical offending lines in one file (suppressing one must not grandfather
both).

The baseline is committed (``.gpuop-lint-baseline.json``) and regenerated only
deliberately via ``gpuop-lint --write-baseline`` — a lint run never rewrites it.
Stale entries (fixed findings) are reported so the baseline shrinks over
time instead of silently hiding regressions that happen to hash alike.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Iterable, List, Tuple

from .core import Finding

BASELINE_VERSION = 1
DEFAULT_BASELINE = ".gpuop-lint-baseline.json"


def fingerprint(finding: Finding, occurrence: int) -> str:
    raw = "\0".join([finding.rule, finding.path, finding.line_text,
                     str(occurrence)])
    return hashlib.sha1(raw.encode("utf-8")).hexdigest()[:16]


def fingerprints(findings: Iterable[Finding]) -> List[Tuple[Finding, str]]:
    """Pair each finding with its fingerprint, numbering identical
    (rule, path, line_text) occurrences in line order."""
    seen: Dict[Tuple[str, str, str], int] = {}
    out: List[Tuple[Finding, str]] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)):
        key = (f.rule, f.path, f.line_text)
        occurrence = seen.get(key, 0)
        seen[key] = occurrence + 1
        out.append((f, fingerprint(f, occurrence)))
    return out


def save(path: str, findings: Iterable[Finding]) -> dict:
    doc = {
        "version": BASELINE_VERSION,
        "comment": ("grandfathered gpuop-lint findings — regenerate with "
                    "`gpuop-lint --write-baseline`, never by hand"),
        "findings": [
            {"rule": f.rule, "path": f.path, "fingerprint": fp,
             "line": f.line, "message": f.message}
            for f, fp in fingerprints(findings)
        ],
    }
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return doc


def load(path: str) -> Dict[str, dict]:
    """fingerprint -> entry; {} when the file is absent."""
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        doc = json.load(fh)
    if doc.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path}: unsupported version {doc.get('version')!r} "
            f"(expected {BASELINE_VERSION}); regenerate with gpuop-lint --write-baseline")
    return {e["fingerprint"]: e for e in doc.get("findings", [])}


def apply(findings: Iterable[Finding], baseline: Dict[str, dict]
          ) -> Tuple[List[Finding], int, List[dict]]:
    """Split findings into (new, baselined_count, stale_entries)."""
    new: List[Finding] = []
    used = set()
    for f, fp in fingerprints(findings):
        if fp in baseline:
            used.add(fp)
        else:
            new.append(f)
    stale = [e for fp, e in sorted(baseline.items()) if fp not in used]
    return new, len(used), stale
