"""The port's whole-program layer (``tpu_operator_torch.analysis.graph``)
twin for twin with the reference's tests/test_analysis_graph.py: symbol,
call and lock-graph resolution, the two-class lock inversion, the seeded
graph-build fuzz, the self-lint gate and the performance budgets (full tree
under 30 s, a one-file incremental lint under 5 s).

Every synthetic tree is the reference's, mapped from ``tpu_operator`` to
``tpu_operator_torch`` (``test_torch_operator_mapping.map_lint_text``),
built by both packages' graph layers; what the rules consume (modules,
resolved and raw calls, registry constants, lock edges, inferred
attribute types) must be equal, read back in the reference's names.
"""

import ast
import io
import os
import random
import textwrap
import time
from pathlib import Path

import pytest

import test_analysis_graph as ref_g
from test_torch_operator_mapping import map_lint_text, unmap_lint_text
from tpu_operator.analysis import core as ref_core
from tpu_operator.analysis import graph as ref_graph
from tpu_operator_torch.analysis import core, graph
from tpu_operator_torch.analysis.runner import main, run

REPO_ROOT = Path(__file__).resolve().parents[1]


def unmap(value):
    """A graph observation (nested tuples, lists, dicts of names) in the
    reference's names."""
    if isinstance(value, str):
        return unmap_lint_text(value)
    if isinstance(value, dict):
        return {unmap(k): unmap(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(unmap(v) for v in value)
    return value


def builds(sources):
    """(reference project, port project) over the same tree, mapped."""
    srcs = {k: textwrap.dedent(v) for k, v in sources.items()}
    ref = ref_graph.build_from_sources(srcs, ref_core.LintConfig())
    port = graph.build_from_sources({map_lint_text(k): map_lint_text(v)
                                     for k, v in srcs.items()}, core.LintConfig())
    return ref, port


def both(sources, observe):
    """``observe(project, tree)`` on both builds, equal in the reference's
    names; ``tree`` is the package name each build saw."""
    ref, port = builds(sources)
    want = observe(ref, "tpu_operator")
    got = unmap(observe(port, "tpu_operator_torch"))
    assert got == want
    return want


# -- resolution unit checks ------------------------------------------------------------

@pytest.mark.parametrize("relpath,want", [
    ("tpu_operator/state/pool.py", "tpu_operator.state.pool"),
    ("tpu_operator/api/__init__.py", "tpu_operator.api"),
])
def test_module_name_mapping(relpath, want):
    assert ref_graph.module_name(relpath) == want
    assert graph.module_name(map_lint_text(relpath)) == map_lint_text(want)


def test_reexport_chain_resolves_to_definer():
    got = both({
        "tpu_operator/core.py": "def make():\n    return 1\n",
        "tpu_operator/api/__init__.py": "from ..core import make\n",
        "tpu_operator/cmd/tool.py":
            "from ..api import make\n\ndef main():\n    return make()\n",
    }, lambda p, t: (p.resolve_symbol(f"{t}.cmd.tool", "make"),
                     [c for c, _ in p.functions[f"{t}.cmd.tool:main"].calls]))
    assert got == (("func", "tpu_operator.core:make"), ["tpu_operator.core:make"])


def test_import_cycle_resolution_terminates():
    assert both({"tpu_operator/a.py": "from .b import thing\n",
                 "tpu_operator/b.py": "from .a import thing\n"},
                lambda p, t: p.resolve_symbol(f"{t}.a", "thing")) is None


def test_over_deep_relative_import_tolerated():
    got = both({"tpu_operator/a.py":
                "from ...... import nothing\n\ndef f():\n    return nothing()\n"},
               lambda p, t: (p.resolve_symbol(f"{t}.a", "nothing"),
                             p.functions[f"{t}.a:f"].calls))
    assert got == (None, [])


def test_constructor_call_and_self_dispatch_resolution():
    src = """
        class Pool:
            def __init__(self):
                self.n = 0

            def fill(self):
                self.bump()

            def bump(self):
                self.n += 1

        def make():
            return Pool()
    """
    got = both({"tpu_operator/state/pool.py": src}, lambda p, t: (
        [c for c, _ in p.functions[f"{t}.state.pool:make"].calls],
        [c for c, _ in p.functions[f"{t}.state.pool:Pool.fill"].calls]))
    assert got == (["tpu_operator.state.pool:Pool.__init__"],
                   ["tpu_operator.state.pool:Pool.bump"])


def test_syntax_error_files_are_skipped_not_fatal():
    got = both({"tpu_operator/good.py": "def f():\n    return 1\n",
                "tpu_operator/bad.py": "def oops(:\n"}, lambda p, t: sorted(p.modules))
    assert got == ["tpu_operator.good"]


# -- two-class lock inversion -----------------------------------------------------------

def test_two_class_lock_inversion_detected():
    labels = both(ref_g.TWO_CLASS_INVERSION, lambda p, t: sorted(
        (e.src.label(), e.dst.label()) for e, _ in p.lock_cycle_edges()))
    assert ("Worker._lock", "Coordinator._lock") in labels
    assert ("Coordinator._lock", "Worker._lock") in labels


def test_two_class_lock_inversion_flagged_by_rule():
    def flagged(m_core, m_graph, mapper):
        sources = {mapper(k): mapper(textwrap.dedent(v))
                   for k, v in ref_g.TWO_CLASS_INVERSION.items()}
        config = m_core.LintConfig()
        project = m_graph.build_from_sources(sources, config)
        relpath = mapper("tpu_operator/state/coord.py")
        src = sources[relpath]
        ctx = m_core.FileContext(relpath, src, ast.parse(src), config, project=project)
        found = list(m_core.all_checkers()["lock-order-inversion"]().check(ctx))
        kept, _ = m_core.apply_suppressions(found, m_core.suppressions(src))
        return [unmap((f.rule, f.path, f.line, f.col, f.message)) for f in kept]

    got = flagged(core, graph, map_lint_text)
    assert got == flagged(ref_core, ref_graph, lambda t: t)
    assert len(got) == 2
    msgs = " | ".join(f[4] for f in got)
    assert "Worker._lock" in msgs and "Coordinator._lock" in msgs


def test_no_inversion_when_order_is_consistent():
    src = ref_g.TWO_CLASS_INVERSION["tpu_operator/state/coord.py"].replace(
        "with self._lock:\n                    self._worker.poke()",
        "self._worker.poke()")
    assert both({"tpu_operator/state/coord.py": src}, lambda p, t: p.lock_cycle_edges()) == []


# -- seeded graph-build fuzz ----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(12))
def test_graph_fuzz_no_crash_and_deterministic(seed):
    sources = ref_g._synth_sources(random.Random(seed))
    mapped = {map_lint_text(k): map_lint_text(v) for k, v in sources.items()}
    p1 = graph.build_from_sources(mapped)
    p2 = graph.build_from_sources(dict(reversed(list(mapped.items()))))
    assert ref_g._fingerprint(p1) == ref_g._fingerprint(p2)
    # and every resolution is the reference's over the same tree
    assert unmap(ref_g._fingerprint(p1)) == ref_g._fingerprint(
        ref_graph.build_from_sources(sources))
    roots = sorted(p1.functions)[:3]
    p1.reachable_from(roots)
    for fid in sorted(p1.functions)[:5]:
        p1.sample_path(roots, fid)
    p1.lock_cycle_edges()


def _port_sources():
    sources = {}
    for path in sorted((REPO_ROOT / "tpu_operator_torch").rglob("*.py")):
        rel = path.relative_to(REPO_ROOT).as_posix()
        if "__pycache__" in rel or "deviceplugin/proto" in rel:
            continue
        sources[rel] = path.read_text(encoding="utf-8")
    return sources


def test_real_tree_graph_build_is_deterministic():
    sources = _port_sources()
    p1 = graph.build_from_sources(sources)
    p2 = graph.build_from_sources(dict(reversed(list(sources.items()))))
    assert ref_g._fingerprint(p1) == ref_g._fingerprint(p2)
    # the port's tree has no lock-order cycle, and its registry is read
    assert p1.lock_cycle_edges() == []
    assert p1.const_values["KUBELET_SIM_DS_LABEL"] == "tpu.ai/kubelet-sim-ds"


def test_the_port_s_registry_constants_reach_the_graph_rules():
    """``consts_used`` resolves the port's registry: the durable-state and
    protocol constants the graph rules scope on are seen where the port's
    autoscaler and migration controller use them."""
    p = graph.build_from_sources(_port_sources())
    used = {}
    for fn in p.functions.values():
        for name in fn.consts_used:
            used.setdefault(name, set()).add(fn.modname)
    assert "tpu_operator_torch.autoscale.controller" in used["AUTOSCALE_STATE_ANNOTATION"]
    assert "tpu_operator_torch.migrate.controller" in used["MIGRATION_STATE_ANNOTATION"]


# -- self-lint gate and performance budgets --------------------------------------------------

def test_self_lint_analysis_package_clean():
    out = io.StringIO()
    code = main(["--root", str(REPO_ROOT), "--no-baseline", "tpu_operator_torch/analysis"],
                out=out)
    assert code == 0, out.getvalue()


def test_full_tree_lint_under_budget():
    start = time.monotonic()
    code = main(["--root", str(REPO_ROOT)], out=io.StringIO())
    elapsed = time.monotonic() - start
    assert code == 0
    assert elapsed < 30.0, f"full-tree lint took {elapsed:.1f}s"


def test_incremental_single_file_under_budget():
    target = os.path.join(str(REPO_ROOT), "tpu_operator_torch", "analysis", "runner.py")
    start = time.monotonic()
    _findings, _sup, nfiles = run(str(REPO_ROOT), ["tpu_operator_torch"], files=[target])
    elapsed = time.monotonic() - start
    assert nfiles == 1
    assert elapsed < 5.0, f"single-file incremental lint took {elapsed:.1f}s"


def test_the_trees_parse_alike():
    """The port's graph build over the reference's own tree resolves exactly
    as the reference's: the two layers are one mechanism."""
    sources = {}
    for path in sorted((REPO_ROOT / "tpu_operator").rglob("*.py")):
        rel = path.relative_to(REPO_ROOT).as_posix()
        if "__pycache__" in rel or "deviceplugin/proto" in rel:
            continue
        sources[rel] = path.read_text(encoding="utf-8")
    ref = ref_graph.build_from_sources(sources)
    port = graph.build_from_sources(sources, core.LintConfig(consts_module="tpu_operator.consts"))
    assert ref_g._fingerprint(port) == ref_g._fingerprint(ref)
    assert {fid: sorted(fn.consts_used) for fid, fn in port.functions.items()} == \
        {fid: sorted(fn.consts_used) for fid, fn in ref.functions.items()}
    assert ast.dump(port.modules["tpu_operator.consts"].tree) == \
        ast.dump(ref.modules["tpu_operator.consts"].tree)
