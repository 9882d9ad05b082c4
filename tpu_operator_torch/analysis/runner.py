"""gpuop-lint runner: walk a tree, build the whole-program graph once, run
every checker, apply suppressions and the committed baseline, emit human
/ JSON / SARIF output with CI exit codes.

Exit codes: 0 = no non-baselined findings and no stale baseline entries;
1 = findings or stale entries (a stale entry means the grandfathered
finding was fixed — prune it with ``gpuop-lint --write-baseline`` so it can't
mask a future regression at the same fingerprint); 2 = usage/internal
error. ``--write-baseline`` regenerates the grandfathered-findings file
and always exits 0 — that regeneration is a deliberate act
(``gpuop-lint --write-baseline``), reviewed like any other diff.

v2: every run parses the *full* package tree once (AST cache shared
between the graph build and per-file linting) and hands checkers a
``ProjectContext`` — so ``--changed[=REF]`` incremental mode lints only
the files changed vs a git ref while interprocedural rules still see the
whole program; a cross-file regression introduced by a changed file is
reported if it surfaces in that file, and the full run on main catches
the rest.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import subprocess
import sys
from typing import Dict, Iterable, List, Optional, Tuple

from . import baseline as baseline_mod
from . import graph as graph_mod
from . import sarif as sarif_mod
from .core import (
    Checker,
    FileContext,
    Finding,
    LintConfig,
    all_checkers,
    apply_suppressions,
    suppressions,
)

DOCS_RELPATH = os.path.join("docs", "gpu", "operations.md")
MANIFESTS_RELPATH = os.path.join("tpu_operator_torch", "manifests")
#: the package tree the whole-program graph is always built from
PROJECT_TREE = "tpu_operator_torch"
#: path fragments never linted: generated protobuf code and caches
SKIP_PARTS = ("__pycache__", os.path.join("deviceplugin", "proto"))


def iter_py_files(root: str, paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(full):
            out.append(full)
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames.sort()
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return [f for f in out
            if not any(part in f for part in SKIP_PARTS)]


def load_manifest_texts(root: str) -> Dict[str, str]:
    """Manifest template sources for the operand-dag cross-file check:
    posix relpath -> text. Empty when the tree has no manifests dir (e.g.
    fixture trees), which disables only that rule."""
    out: Dict[str, str] = {}
    mdir = os.path.join(root, MANIFESTS_RELPATH)
    for dirpath, dirnames, filenames in os.walk(mdir):
        dirnames.sort()
        for fn in sorted(filenames):
            if not fn.endswith((".yaml", ".yml", ".j2")):
                continue
            full = os.path.join(dirpath, fn)
            rel = os.path.relpath(full, root).replace(os.sep, "/")
            with open(full, encoding="utf-8") as fh:
                out[rel] = fh.read()
    return out


class _AstCache:
    """relpath -> (src, tree-or-None, parse-error-Finding-or-None), parsed
    at most once per run and shared by the graph build and the linter."""

    def __init__(self, root: str):
        self.root = root
        self.entries: Dict[str, Tuple[str, Optional[ast.Module],
                                      Optional[Finding]]] = {}

    def load(self, path: str) -> str:
        relpath = os.path.relpath(path, self.root).replace(os.sep, "/")
        if relpath in self.entries:
            return relpath
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        try:
            tree: Optional[ast.Module] = ast.parse(src, filename=path)
            err: Optional[Finding] = None
        except SyntaxError as e:
            tree = None
            err = Finding(rule="parse-error", path=relpath,
                          line=e.lineno or 1, col=(e.offset or 0) + 1,
                          message=f"cannot parse: {e.msg}", line_text="")
        self.entries[relpath] = (src, tree, err)
        return relpath


def _build_project(root: str, cache: _AstCache,
                   config: LintConfig) -> graph_mod.ProjectContext:
    tree_dir = os.path.join(root, PROJECT_TREE)
    roots = [PROJECT_TREE] if os.path.isdir(tree_dir) else []
    parsed: Dict[str, Tuple[str, ast.Module]] = {}
    if roots:
        for path in iter_py_files(root, roots):
            relpath = cache.load(path)
            src, tree, _err = cache.entries[relpath]
            if tree is not None:
                parsed[relpath] = (src, tree)
    return graph_mod.build_project(parsed, config)


def lint_source(relpath: str, src: str, tree: Optional[ast.Module],
                parse_err: Optional[Finding], checkers: List[Checker],
                config: LintConfig, project) -> Tuple[List[Finding], int]:
    """(findings, suppressed_count) for one already-parsed file."""
    if tree is None:
        return [parse_err] if parse_err else [], 0
    ctx = FileContext(relpath, src, tree, config, project=project)
    found: List[Finding] = []
    for checker in checkers:
        found.extend(checker.check(ctx))
    return apply_suppressions(found, suppressions(src))


def changed_files(root: str, ref: str) -> List[str]:
    """Python files changed vs ``ref`` (committed diff + staged +
    untracked), absolute paths, restricted to the project tree. Raises
    RuntimeError when git can't answer (not a repo, bad ref)."""
    def _git(*args: str) -> List[str]:
        proc = subprocess.run(
            ["git", "-C", root, *args],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"git {' '.join(args[:2])} failed: "
                f"{proc.stderr.strip() or 'unknown error'}")
        return [line for line in proc.stdout.splitlines() if line]

    rels = set(_git("diff", "--name-only", ref, "--"))
    rels.update(_git("ls-files", "--others", "--exclude-standard"))
    out: List[str] = []
    for rel in sorted(rels):
        posix = rel.replace("\\", "/")
        if not posix.endswith(".py"):
            continue
        if not posix.startswith(PROJECT_TREE + "/"):
            continue
        if any(part in posix for part in
               (p.replace(os.sep, "/") for p in SKIP_PARTS)):
            continue
        full = os.path.join(root, rel)
        if os.path.isfile(full):          # deleted files have no findings
            out.append(full)
    return out


def run(root: str, paths: Iterable[str],
        rules: Optional[Iterable[str]] = None,
        docs_path: Optional[str] = None,
        files: Optional[List[str]] = None
        ) -> Tuple[List[Finding], int, int]:
    """(findings, suppressed_total, files_linted) over a tree.

    ``files`` overrides the lint set (absolute paths; used by --changed);
    the whole-program graph is built from the full project tree either
    way.
    """
    registry = all_checkers()
    if rules is not None:
        unknown = sorted(set(rules) - set(registry))
        if unknown:
            raise ValueError(f"unknown rule(s): {', '.join(unknown)} "
                             f"(see --list-rules)")
        registry = {k: v for k, v in registry.items() if k in set(rules)}
    checkers = [cls() for _, cls in sorted(registry.items())]

    docs_file = docs_path or os.path.join(root, DOCS_RELPATH)
    docs_text = None
    if os.path.exists(docs_file):
        with open(docs_file, encoding="utf-8") as fh:
            docs_text = fh.read()
    config = LintConfig(root=root, docs_text=docs_text,
                        manifest_texts=load_manifest_texts(root))

    cache = _AstCache(root)
    project = _build_project(root, cache, config)

    findings: List[Finding] = []
    suppressed_total = 0
    lint_paths = files if files is not None else iter_py_files(root, paths)
    for path in lint_paths:
        relpath = cache.load(path)
        src, tree, err = cache.entries[relpath]
        found, suppressed = lint_source(relpath, src, tree, err, checkers,
                                        config, project)
        findings.extend(found)
        suppressed_total += suppressed
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, suppressed_total, len(lint_paths)


# -- CLI ----------------------------------------------------------------------

def _print_human(new: List[Finding], baselined: int, suppressed: int,
                 stale: List[dict], nfiles: int, out) -> None:
    for f in new:
        print(f"{f.location()}: [{f.rule}] {f.message}", file=out)
    for entry in stale:
        print(f"stale baseline entry {entry['fingerprint']} "
              f"({entry['rule']} at {entry['path']}): finding no longer "
              f"present — run `gpuop-lint --write-baseline` to prune", file=out)
    verdict = "FAIL" if new or stale else "ok"
    print(f"gpuop-lint: {verdict}: {len(new)} new finding(s), {baselined} "
          f"baselined, {suppressed} suppressed, {len(stale)} stale baseline "
          f"entr{'y' if len(stale) == 1 else 'ies'} across {nfiles} files",
          file=out)


def main(argv: Optional[List[str]] = None, out=None) -> int:
    out = out or sys.stdout
    parser = argparse.ArgumentParser(
        prog="gpuop-lint",
        description="gpuop-lint: whole-program operator invariant checker")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files/dirs to lint (default: tpu_operator_torch)")
    parser.add_argument("--root", default=".",
                        help="project root (baseline + docs live here)")
    parser.add_argument("--format", choices=("human", "json", "sarif"),
                        default="human")
    parser.add_argument("--changed", nargs="?", const="HEAD", default=None,
                        metavar="REF",
                        help="lint only files changed vs REF (default "
                             "HEAD: committed+staged+untracked); the "
                             "whole-program graph still covers the full "
                             "tree")
    parser.add_argument("--baseline", default=None,
                        help=f"baseline file (default: "
                             f"<root>/{baseline_mod.DEFAULT_BASELINE})")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore the baseline: report every finding")
    parser.add_argument("--write-baseline", action="store_true",
                        help="regenerate the baseline from current findings "
                             "and exit 0 (a deliberate act, reviewed as a diff)")
    parser.add_argument("--rules", default=None,
                        help="comma-separated subset of rules to run")
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)

    if args.list_rules:
        for name, cls in sorted(all_checkers().items()):
            print(f"{name}: {cls.description}", file=out)
        return 0

    root = os.path.abspath(args.root)
    paths = args.paths or [PROJECT_TREE]
    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    files: Optional[List[str]] = None
    if args.changed is not None:
        try:
            files = changed_files(root, args.changed)
        except RuntimeError as e:
            print(f"gpuop-lint: error: {e}", file=sys.stderr)
            return 2
    try:
        findings, suppressed, nfiles = run(root, paths, rules=rules,
                                           files=files)
    except (ValueError, OSError) as e:
        print(f"gpuop-lint: error: {e}", file=sys.stderr)
        return 2

    baseline_path = args.baseline or os.path.join(
        root, baseline_mod.DEFAULT_BASELINE)
    if args.write_baseline:
        doc = baseline_mod.save(baseline_path, findings)
        print(f"gpuop-lint: wrote {len(doc['findings'])} finding(s) to "
              f"{baseline_path}", file=out)
        return 0

    baseline: Dict[str, dict] = {}
    if not args.no_baseline:
        try:
            baseline = baseline_mod.load(baseline_path)
        except (ValueError, json.JSONDecodeError) as e:
            print(f"gpuop-lint: error: {e}", file=sys.stderr)
            return 2
    new, baselined, stale = baseline_mod.apply(findings, baseline)
    if args.changed is not None:
        # an incremental run sees only a slice of the tree: entries for
        # unlinted files aren't stale, they're simply out of scope
        linted = {os.path.relpath(p, root).replace(os.sep, "/")
                  for p in (files or [])}
        stale = [e for e in stale if e.get("path") in linted]

    if args.format == "json":
        json.dump({
            "findings": [f.to_dict() for f in new],
            "baselined": baselined,
            "suppressed": suppressed,
            "stale_baseline": stale,
            "files": nfiles,
        }, out, indent=2)
        print(file=out)
    elif args.format == "sarif":
        json.dump(sarif_mod.to_sarif(new), out, indent=2)
        print(file=out)
    else:
        _print_human(new, baselined, suppressed, stale, nfiles, out)
    return 1 if new or stale else 0
