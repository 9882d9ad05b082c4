"""``python -m tpu_operator_torch.cmd.opsan`` (``gpuop-opsan``): the opsan
report gate (copy of tpu_operator/cmd/opsan.py).

Subcommands:

* ``check`` — union one or more opsan JSON reports (written by sanitized
  processes through ``GPU_OPERATOR_OPSAN_REPORT``), rebuild ``gpuop-lint``'s
  static lock graph of ``tpu_operator_torch/``, and run the static↔dynamic
  cross-check. Exit 1 on any unsuppressed race or any dynamic-only lock
  edge that the committed fixture file does not cover; exit 0 otherwise.
  Statically predicted edges that no run exercised are *reported*
  (coverage), never fatal. ``--json`` gives the machine-readable result.
* ``report`` — pretty-print one report file.

This is the teeth of the race-soak lane (tests/test_torch_race_soak.py):
the soaks run with ``GPU_OPERATOR_OPSAN=1`` and a pinned seed, each process
dumps its report at exit, and this gate turns the union into a verdict. It
imports no torch.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import List, Optional

from ..analysis.runner import _AstCache, _build_project
from ..analysis.core import LintConfig
from ..sanitizer import crosscheck as cc

DEFAULT_FIXTURES = os.path.join("tests", "cases", "torch_opsan",
                                "dynamic_edges.json")


def _expand_reports(patterns: List[str]) -> List[str]:
    paths: List[str] = []
    for pat in patterns:
        if os.path.isdir(pat):
            paths.extend(sorted(glob.glob(os.path.join(pat, "opsan-*.json"))))
        else:
            matched = sorted(glob.glob(pat))
            paths.extend(matched if matched else [pat])
    return paths


def _cmd_check(args, out) -> int:
    paths = _expand_reports(args.reports)
    if not paths:
        print(f"opsan check: no report files matched {args.reports} — "
              f"did the soak run with GPU_OPERATOR_OPSAN_REPORT set?",
              file=out)
        return 1
    dynamic_edges, sites, races = cc.load_reports(paths)
    cache = _AstCache(args.root)
    project = _build_project(args.root, cache, LintConfig())
    static = cc.static_lock_edges(project)
    try:
        fixtures = cc.load_fixtures(args.fixtures)
    except ValueError as err:
        print(f"opsan check: {err}", file=out)
        return 2
    result = cc.crosscheck(static, dynamic_edges, sites, fixtures)
    if args.json:
        payload = {
            "reports": paths,
            "coverage": result.coverage(),
            "static_edges": [list(e) for e in result.static_edges],
            "dynamic_edges": [list(e) for e in result.dynamic_edges],
            "static_only": [list(e) for e in result.static_only],
            "dynamic_only": [list(e) for e in result.dynamic_only],
            "unfixtured": [list(e) for e in result.unfixtured],
            "stale_fixtures": [list(e) for e in result.stale_fixtures],
            "races": races,
            "ok": result.ok() and not races,
        }
        json.dump(payload, out, indent=2, sort_keys=True)
        out.write("\n")
    else:
        print(f"opsan check: {len(paths)} report(s)", file=out)
        print(cc.render(result, races), file=out)
    return 0 if result.ok() and not races else 1


def _cmd_report(args, out) -> int:
    with open(args.path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    print(f"opsan report {args.path} (version {data.get('version')})",
          file=out)
    print(f"  accesses: {data.get('accesses_total', 0)}", file=out)
    print(f"  tracked vars: {len(data.get('tracked_vars', []))}", file=out)
    print(f"  locks: {len(data.get('locks', []))}", file=out)
    print(f"  lock edges: {len(data.get('lock_edges', []))}", file=out)
    for src, dst, site in data.get("lock_edges", []):
        print(f"    {src} -> {dst} at {site}", file=out)
    races = data.get("races", [])
    print(f"  races: {len(races)}", file=out)
    for r in races:
        held = ", ".join(r.get("held", [])) or "no locks"
        print(f"    {r['var']}: {r.get('kind')} at {r.get('site')} "
              f"({r.get('thread')}, holding {held}) vs "
              f"{r.get('prior_site')} ({r.get('prior_thread')})", file=out)
    for prefix, reason in sorted(data.get("suppressions", {}).items()):
        print(f"  suppressed {prefix}: {reason}", file=out)
    return 0


def main(argv: Optional[List[str]] = None, out=None) -> int:
    out = out or sys.stdout
    parser = argparse.ArgumentParser(
        prog="gpuop-opsan",
        description="opsan race-sanitizer report gate")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_check = sub.add_parser(
        "check", help="cross-check soak reports against the static graph")
    p_check.add_argument("--reports", nargs="+", required=True,
                         help="report files, globs, or directories")
    p_check.add_argument("--root", default=".",
                         help="repo root for the static graph build")
    p_check.add_argument("--fixtures", default=DEFAULT_FIXTURES,
                         help="committed dynamic-only edge fixtures")
    p_check.add_argument("--json", action="store_true",
                         help="machine-readable output")

    p_report = sub.add_parser("report", help="pretty-print one report")
    p_report.add_argument("path")

    args = parser.parse_args(argv)
    if args.cmd == "check":
        return _cmd_check(args, out)
    return _cmd_report(args, out)


if __name__ == "__main__":
    sys.exit(main())
