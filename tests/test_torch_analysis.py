"""The port's static checker (``tpu_operator_torch.analysis``, ``gpuop-lint``)
twin for twin with the reference's tests/test_analysis.py: every rule's
positive, negative and suppressed fixtures, the suppression mechanics, the
baseline round trip and the CLI's exit codes.

Each reference fixture runs through both linters: the reference's as
written, the port's with its paths and sources mapped from
``tpu_operator`` to ``tpu_operator_torch``
(``test_torch_operator_mapping.map_lint_text``). Their findings are
compared field by field: rule, path, line, column, message and flagged
text, the port's read back in the reference's names
(``unmap_lint_text``). The two rules whose idiom the port maps
(``api-bypass``, ``metrics-discipline``; ``LINT_IDIOM_RULES``) also get
positive and negative fixtures in the port's own idiom, and the port's
real tree lints clean with an empty baseline and every suppression
carrying its reason.
"""

import ast
import io
import json
import os
import re
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest

import test_analysis as ref_t
from test_torch_operator_mapping import (LINT_IDIOM_RULES, LINT_NAMES,
                                         LINT_REFERENCE_BASELINED, map_lint_text,
                                         unmap_lint_text)
from tpu_operator.analysis import baseline as ref_baseline
from tpu_operator.analysis import core as ref_core
from tpu_operator.analysis import graph as ref_graph
from tpu_operator.analysis import runner as ref_runner
from tpu_operator_torch.analysis import baseline
from tpu_operator_torch.analysis import core
from tpu_operator_torch.analysis import graph
from tpu_operator_torch.analysis import runner

REPO_ROOT = Path(__file__).resolve().parents[1]

REF = types.SimpleNamespace(name="reference", core=ref_core, graph=ref_graph,
                            runner=ref_runner, baseline=ref_baseline, map=lambda t: t)
PORT = types.SimpleNamespace(name="port", core=core, graph=graph, runner=runner,
                             baseline=baseline, map=map_lint_text)


def both(scenario):
    """``scenario(m)`` on the reference's linter, then on the port's with
    mapped inputs: the observations must be equal."""
    want = scenario(REF)
    got = scenario(PORT)
    assert got == want
    return got


def seen(m, f):
    """A finding as observed, in the reference's names."""
    un = unmap_lint_text if m is PORT else (lambda t: t)
    return (f.rule, un(f.path), f.line, f.col, un(f.message), un(f.line_text))


def rules_of(findings):
    return [f[0] for f in findings]


def lint(m, src, relpath, rule, docs_text=None):
    """(kept, dropped) findings of one rule over one in-memory file."""
    src = m.map(textwrap.dedent(src))
    relpath = m.map(relpath)
    ctx = m.core.FileContext(relpath, src, ast.parse(src),
                             m.core.LintConfig(docs_text=docs_text))
    found = list(m.core.all_checkers()[rule]().check(ctx))
    kept, dropped = m.core.apply_suppressions(found, m.core.suppressions(src))
    return [seen(m, f) for f in kept], dropped


def lint_dag(m, src, manifest_texts, relpath="tpu_operator/state/operands.py"):
    src = m.map(textwrap.dedent(src))
    ctx = m.core.FileContext(m.map(relpath), src, ast.parse(src),
                             m.core.LintConfig(manifest_texts={
                                 m.map(k): textwrap.dedent(v)
                                 for k, v in manifest_texts.items()}))
    found = list(m.core.all_checkers()["operand-dag"]().check(ctx))
    kept, dropped = m.core.apply_suppressions(found, m.core.suppressions(src))
    return [seen(m, f) for f in kept], dropped


def lint_in_project(m, sources, relpath, rule, docs_text=None):
    srcs = {m.map(k): m.map(textwrap.dedent(v)) for k, v in sources.items()}
    config = m.core.LintConfig(docs_text=docs_text)
    project = m.graph.build_from_sources(srcs, config)
    relpath = m.map(relpath)
    src = srcs[relpath]
    ctx = m.core.FileContext(relpath, src, ast.parse(src), config, project=project)
    found = list(m.core.all_checkers()[rule]().check(ctx))
    kept, dropped = m.core.apply_suppressions(found, m.core.suppressions(src))
    return [seen(m, f) for f in kept], dropped


def tree(m, base, files):
    """The fixture files, mapped, under ``base/<side>``; the root's path."""
    root = base / m.name
    for rel, src in files.items():
        p = root / m.map(rel)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(m.map(textwrap.dedent(src)))
    return root


def cli(m, root, *argv):
    """(exit code, output in the reference's names) of one ``main`` run."""
    out = io.StringIO()
    code = m.runner.main(["--root", str(root), *argv], out=out)
    text = out.getvalue()
    return code, unmap_lint_text(text) if m is PORT else text


# -- lock-discipline -------------------------------------------------------------------

LOCKED = ref_t.LOCKED_CLASS


@pytest.mark.parametrize("case", ["positive", "negative_guarded_and_init",
                                  "negative_locked_suffix_convention",
                                  "unguarded_vs_locked_method_flagged", "suppressed"])
def test_lock_discipline(case):
    sources = {
        "positive": LOCKED.format(drain_body="self.items = []"),
        "negative_guarded_and_init": LOCKED.format(
            drain_body="with self._lock:\n                self.items = []"),
        "negative_locked_suffix_convention": """
            import threading

            class Pool:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.items = []

                def add(self, x):
                    with self._lock:
                        self._add_locked(x)

                def _add_locked(self, x):
                    self.items.append(x)
        """,
        "unguarded_vs_locked_method_flagged": """
            import threading

            class Pool:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.items = []

                def _add_locked(self, x):
                    self.items.append(x)

                def reset(self):
                    self.items = []
        """,
        "suppressed": LOCKED.format(
            drain_body="self.items = []  # opalint: disable=lock-discipline — drained post-join"),
    }
    kept, dropped = both(lambda m: lint(m, sources[case], "controllers/pool.py",
                                        "lock-discipline"))
    want = {"positive": (["lock-discipline"], 0), "negative_guarded_and_init": ([], 0),
            "negative_locked_suffix_convention": ([], 0),
            "unguarded_vs_locked_method_flagged": (["lock-discipline"], 0),
            "suppressed": ([], 1)}[case]
    assert (rules_of(kept), dropped) == want


# -- api-bypass --------------------------------------------------------------------------

def test_api_bypass_positive_requests_and_restclient():
    kept, _ = both(lambda m: lint(m, """
        import requests
        from tpu_operator.client.rest import RestClient

        def refresh(url):
            requests.get(url, timeout=5)
            return RestClient()
    """, "controllers/sync.py", "api-bypass"))
    assert rules_of(kept) == ["api-bypass", "api-bypass"]


@pytest.mark.parametrize("src,relpath", [
    ("import requests\nrequests.get('u', timeout=5)\n", "client/rest.py"),
    ("RestClient(base_url='u')\n", "cmd/operator.py"),
    ("""
        import requests

        def fetch(call):
            try:
                return call()
            except requests.RequestException:
                return None
    """, "validator/workload.py"),
], ids=["client-zone", "cmd-root", "exception-types"])
def test_api_bypass_negative_client_cmd_and_exception_types(src, relpath):
    assert both(lambda m: lint(m, src, relpath, "api-bypass")) == ([], 0)


def test_api_bypass_suppressed():
    src = "RestClient()  # opalint: disable=api-bypass — wrapped on the next line\n"
    assert both(lambda m: lint(m, src, "validator/main.py", "api-bypass")) == ([], 1)


# the port's own idiom: its client speaks http.client

def port_lint(src, relpath, rule, docs_text=None):
    return lint(PORT, src, relpath, rule, docs_text=docs_text)


@pytest.mark.parametrize("src", [
    """
        import http.client

        def fetch(host):
            conn = http.client.HTTPSConnection(host, 443, timeout=5)
            conn.request("GET", "/api/v1/nodes")
    """,
    """
        from http.client import HTTPConnection as Conn

        def fetch(host):
            return Conn(host, 8080, timeout=5)
    """,
], ids=["module-attribute", "imported-name"])
def test_api_bypass_port_idiom_flags_a_raw_connection(src):
    kept, _ = port_lint(src, "tpu_operator/controllers/sync.py", "api-bypass")
    assert rules_of(kept) == ["api-bypass"]
    assert "raw http.client.HTTPSConnection()" in kept[0][4] or "raw Conn()" in kept[0][4]
    # the reference's rule has no such idiom: the bypass is the port's to see
    assert lint(REF, src, "tpu_operator/controllers/sync.py", "api-bypass") == ([], 0)


@pytest.mark.parametrize("src,relpath", [
    ("import http.client\nhttp.client.HTTPConnection('h', 80, timeout=1)\n",
     "tpu_operator/client/rest.py"),
    ("""
        import http.client
        import urllib.request

        def scrape(url):
            try:
                with urllib.request.urlopen(url, timeout=3) as r:
                    return r.read()
            except (OSError, http.client.HTTPException):
                return None
    """, "tpu_operator/cmd/must_gather.py"),
    ("import urllib.request\nurllib.request.urlopen('http://n/metrics', timeout=2)\n",
     "tpu_operator/validator/telemetry.py"),
    ("from ..client.rest import RestClient\nRestClient(base_url='u')\n",
     "tpu_operator/simulator/engine.py"),
], ids=["client-zone", "exception-types-and-urlopen", "metrics-scrape", "composition-root"])
def test_api_bypass_port_idiom_negative(src, relpath):
    assert port_lint(src, relpath, "api-bypass") == ([], 0)


# -- blocking-call --------------------------------------------------------------------

def test_blocking_call_positive():
    kept, _ = both(lambda m: lint(m, """
        import time
        import urllib.request

        def reconcile(req, thread):
            time.sleep(1.0)
            thread.join()
            urllib.request.urlopen("http://kubelet/healthz")
    """, "controllers/runtime.py", "blocking-call"))
    assert rules_of(kept) == ["blocking-call"] * 3


@pytest.mark.parametrize("src,relpath", [
    ("""
        import urllib.request

        def reconcile(req, thread, evt, parts):
            thread.join(timeout=5.0)
            evt.wait(2.0)
            urllib.request.urlopen("http://kubelet/healthz", timeout=3)
            return ",".join(parts)
    """, "state/driver.py"),
    ("import time\ntime.sleep(5)\n", "validator/perf.py"),
], ids=["bounded", "out-of-scope"])
def test_blocking_call_negative_bounded_and_out_of_scope(src, relpath):
    assert both(lambda m: lint(m, src, relpath, "blocking-call")) == ([], 0)


def test_blocking_call_suppressed():
    src = "import time\ntime.sleep(1)  # opalint: disable=blocking-call — test helper\n"
    assert both(lambda m: lint(m, src, "controllers/runtime.py", "blocking-call")) == ([], 1)


# -- exception-hygiene ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["positive", "negative", "suppressed"])
def test_exception_hygiene(case):
    src = {"positive": """
        def a(call):
            try:
                call()
            except:
                return None

        def b(call):
            try:
                call()
            except Exception:
                pass
    """, "negative": """
        import logging

        def a(call):
            try:
                call()
            except KeyError:
                pass  # narrow swallow is idiomatic

        def b(call):
            try:
                call()
            except Exception:
                logging.exception("call failed")
    """, "suppressed": """
        def a(call):
            try:
                call()
            except Exception:  # opalint: disable=exception-hygiene — telemetry guard
                pass
    """}[case]
    kept, dropped = both(lambda m: lint(m, src, "validator/driver.py", "exception-hygiene"))
    want = {"positive": (["exception-hygiene"] * 2, 0), "negative": ([], 0),
            "suppressed": ([], 1)}[case]
    assert (rules_of(kept), dropped) == want
    if case == "positive":
        assert "bare" in kept[0][4]


# -- breaker-swallow ---------------------------------------------------------------------

def test_breaker_swallow_positive():
    kept, _ = both(lambda m: lint(m, """
        import logging

        def sync(state):
            try:
                state.sync()
            except Exception as e:
                logging.warning("state failed: %s", e)
    """, "state/manager.py", "breaker-swallow"))
    assert rules_of(kept) == ["breaker-swallow"]


@pytest.mark.parametrize("src,relpath", [
    ("""
        import logging
        from tpu_operator.client.errors import BreakerOpenError

        def sync(state):
            try:
                state.sync()
            except BreakerOpenError:
                raise
            except Exception as e:
                logging.warning("state failed: %s", e)
    """, "state/manager.py"),
    ("""
        def sync(state):
            try:
                state.sync()
            except Exception:
                raise
    """, "controllers/runtime.py"),
    ("""
        def sync(state):
            try:
                state.sync()
            except Exception:
                return None
    """, "validator/main.py"),
], ids=["sibling", "reraise", "path"])
def test_breaker_swallow_negative_sibling_reraise_and_path(src, relpath):
    assert both(lambda m: lint(m, src, relpath, "breaker-swallow")) == ([], 0)


def test_breaker_swallow_suppressed():
    src = """
        def sync(state):
            try:
                state.sync()
            except Exception:  # opalint: disable=breaker-swallow — elector must survive
                return None
    """
    assert both(lambda m: lint(m, src, "controllers/leader.py", "breaker-swallow")) == ([], 1)


def test_breaker_swallow_finds_the_folded_breaker_in_the_state_sweep():
    """The fault the checker found in the port: ``Manager.sync_state``
    folded an open breaker into a failed state. The port's sweep as it
    stood is flagged, its repaired sweep is not."""
    path = REPO_ROOT / "tpu_operator_torch" / "state" / "manager.py"
    src = path.read_text()
    repaired, _ = port_lint(src, "tpu_operator_torch/state/manager.py", "breaker-swallow")
    assert repaired == []
    start = src.index("                except BreakerOpenError:")
    end = src.index("                except Exception as e:")
    folded, _ = port_lint(src[:start] + src[end:], "tpu_operator_torch/state/manager.py",
                          "breaker-swallow")
    assert rules_of(folded) == ["breaker-swallow"]


# -- metrics-discipline -------------------------------------------------------------------

METRICS_CASES = {
    "positive": ("""
        from prometheus_client import Counter

        ERRS = Counter("reconcile_errors", "doc", ["pod"])
    """, "controllers/metrics.py", "nothing documented here"),
    "negative": ("""
        import collections
        from prometheus_client import CollectorRegistry, Counter, Gauge

        REG = CollectorRegistry()
        ERRS = Counter("reconcile_errors", "doc", ["controller"], registry=REG)
        UP = Gauge("operator_up", "doc", registry=REG)
        COUNTS = collections.Counter("abc")
    """, "controllers/metrics.py",
        "| `reconcile_errors_total` | ... | | `operator_up` | ... |"),
    "dynamic_name_skips_doc_check": ("""
        from prometheus_client import CollectorRegistry, Gauge

        def make(reg, name):
            return Gauge(name, "doc", registry=reg)
    """, "validator/telemetry.py", "no families documented"),
    "no_docs_text_disables_doc_check_only": ("""
        from prometheus_client import Counter

        ERRS = Counter("reconcile_errors", "doc")
    """, "controllers/metrics.py", None),
    "suppressed": ("""
        from prometheus_client import Counter

        ERRS = Counter("x", "doc")  # opalint: disable=metrics-discipline — scratch registry
    """, "controllers/metrics.py", ""),
}


@pytest.mark.parametrize("case", sorted(METRICS_CASES))
def test_metrics_discipline(case):
    src, relpath, docs = METRICS_CASES[case]
    kept, dropped = both(lambda m: lint(m, src, relpath, "metrics-discipline",
                                        docs_text=docs))
    want = {"positive": 3, "negative": 0, "dynamic_name_skips_doc_check": 0,
            "no_docs_text_disables_doc_check_only": 1, "suppressed": 0}[case]
    assert len(kept) == want
    assert dropped == (2 if case == "suppressed" else 0)
    if case == "positive":
        msgs = " | ".join(f[4] for f in kept)
        assert "registry=" in msgs and "reconcile_errors_total" in msgs and "'pod'" in msgs


# the port's own idiom: its families are its own classes, kept by an owner

PORT_METRICS_LOOSE = """
    from tpu_operator_torch.controllers.metrics import Counter

    ERRS = Counter("tpu_operator_reconcile_errors_total", "doc", ["pod"])
"""

PORT_METRICS_OWNED = """
    import collections

    from .metrics import Counter, Gauge


    class NodeThing:
        def __init__(self):
            self.errs = Counter("tpu_operator_reconcile_errors_total", "doc", ("controller",))
            self.per = {k: Gauge(f"tpu_operator_node_{k}", "doc") for k in ("a", "b")}
            self.counts = collections.Counter("abc")

        def scrape(self):
            return b""
"""


def test_metrics_discipline_port_idiom_positive():
    kept, _ = port_lint(PORT_METRICS_LOOSE, "tpu_operator/controllers/sync.py",
                        "metrics-discipline", docs_text="nothing documented here")
    msgs = " | ".join(f[4] for f in kept)
    assert len(kept) == 3  # outside any owner, undocumented, unbounded label
    assert "outside any metrics owner" in msgs
    assert "'tpu_operator_reconcile_errors_total' is not documented" in msgs
    assert "'pod'" in msgs
    # the reference's rule binds only prometheus_client: the port's family
    # is the port's to see
    assert lint(REF, PORT_METRICS_LOOSE, "tpu_operator/controllers/sync.py",
                "metrics-discipline", docs_text="nothing documented here") == ([], 0)


def test_metrics_discipline_port_idiom_negative():
    docs = "| `tpu_operator_reconcile_errors_total` | ... |"
    assert port_lint(PORT_METRICS_OWNED, "tpu_operator/validator/telemetry.py",
                     "metrics-discipline", docs_text=docs) == ([], 0)
    # the relative import binds only from a metrics module: elsewhere the
    # same names are someone else's
    assert port_lint(PORT_METRICS_OWNED.replace("from .metrics", "from .counting"),
                     "tpu_operator/validator/telemetry.py", "metrics-discipline",
                     docs_text="") == ([], 0)


def test_metrics_discipline_port_idiom_binds_the_defining_module():
    src = """
        class Gauge:
            def __init__(self, name, documentation, labelnames=()):
                self.name = name

        UP = Gauge("tpu_operator_up", "doc")
    """
    kept, _ = port_lint(src, "tpu_operator/controllers/metrics.py", "metrics-discipline",
                        docs_text="")
    assert rules_of(kept) == ["metrics-discipline"] * 2  # outside an owner, undocumented
    assert port_lint(src, "tpu_operator/controllers/other.py", "metrics-discipline",
                     docs_text="") == ([], 0)


@pytest.mark.parametrize("relpath", ["controllers/metrics.py", "validator/metrics.py",
                                     "validator/telemetry.py"])
def test_metrics_discipline_is_live_on_the_port_s_families(relpath):
    """Every literal family of the port's metrics modules is seen: with no
    documentation each is flagged, with the port's runbook none is."""
    path = f"tpu_operator_torch/{relpath}"
    src = (REPO_ROOT / path).read_text()
    families = len(re.findall(r"\b(?:Counter|Gauge|Histogram)\(\s*\"", src))
    assert families
    kept, _ = port_lint(src, path.replace("tpu_operator_torch", "tpu_operator"),
                        "metrics-discipline", docs_text="")
    assert len(kept) == families
    docs = (REPO_ROOT / LINT_NAMES["port"]["docs"]).read_text()
    assert port_lint(src, path.replace("tpu_operator_torch", "tpu_operator"),
                     "metrics-discipline", docs_text=docs) == ([], 0)


# -- suppression mechanics -------------------------------------------------------------

def test_suppression_comment_only_line_targets_next_line():
    src = ("# opalint: disable=exception-hygiene — guard explained here\n"
           "try:\n    pass\nexcept Exception:\n    pass\n")
    assert both(lambda m: m.core.suppressions(src)) == {2: {"exception-hygiene"}}


def test_suppression_multiple_rules_and_all():
    src = ("x = 1  # opalint: disable=api-bypass,blocking-call\n"
           "y = 2  # opalint: disable=all\n")
    sup = both(lambda m: m.core.suppressions(src))
    assert sup == {1: {"api-bypass", "blocking-call"}, 2: {"all"}}


# -- baseline round trip ----------------------------------------------------------------

BAD_SYNC = ref_t.BAD_SYNC


def test_baseline_round_trip(tmp_path):
    def scenario(m):
        root = tree(m, tmp_path, {"tpu_operator/controllers/sync.py": BAD_SYNC})
        tree_dir = m.map("tpu_operator")
        obs = []
        findings, _, nfiles = m.runner.run(str(root), [tree_dir])
        obs.append((nfiles, [seen(m, f) for f in findings]))
        bl_path = str(root / "baseline.json")
        m.baseline.save(bl_path, findings)
        loaded = m.baseline.load(bl_path)
        new, baselined, stale = m.baseline.apply(findings, loaded)
        obs.append((new, baselined, stale))
        (root / m.map("tpu_operator/controllers/sync.py")).write_text(textwrap.dedent("""
            import time

            def reconcile(req, thread):
                time.sleep(1.0)
                thread.join()
        """))
        new, baselined, stale = m.baseline.apply(m.runner.run(str(root), [tree_dir])[0], loaded)
        obs.append(([f.line_text for f in new], baselined, stale))
        (root / m.map("tpu_operator/controllers/sync.py")).write_text(
            "def reconcile(req):\n    return None\n")
        new, baselined, stale = m.baseline.apply(m.runner.run(str(root), [tree_dir])[0], loaded)
        obs.append((new, baselined, [(e["rule"], unmap_lint_text(e["path"]), e["line"])
                                     for e in stale]))
        return obs

    obs = both(scenario)
    assert obs[0][0] == 1 and rules_of(obs[0][1]) == ["blocking-call"]
    assert obs[1] == ([], 1, [])
    assert obs[2] == (["thread.join()"], 1, [])
    assert obs[3][:2] == ([], 0) and [e[0] for e in obs[3][2]] == ["blocking-call"]


def test_baseline_fingerprint_disambiguates_identical_lines(tmp_path):
    def scenario(m):
        root = tree(m, tmp_path, {"tpu_operator/controllers/sync.py": """
            import time

            def reconcile(req):
                time.sleep(1.0)
                time.sleep(1.0)
        """})
        findings, _, _ = m.runner.run(str(root), [m.map("tpu_operator")])
        pairs = m.baseline.fingerprints(findings)
        return len(pairs), len({fp for _, fp in pairs})

    assert both(scenario) == (2, 2)


def test_baseline_version_mismatch_rejected(tmp_path):
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({"version": 99, "findings": []}))

    def scenario(m):
        with pytest.raises(ValueError, match="unsupported version") as e:
            m.baseline.load(str(p))
        return unmap_lint_text(str(e.value))

    both(scenario)


def test_the_port_s_baseline_is_its_own_and_empty():
    assert baseline.DEFAULT_BASELINE == LINT_NAMES["port"]["baseline"]
    with open(REPO_ROOT / baseline.DEFAULT_BASELINE) as f:
        doc = json.load(f)
    assert doc["version"] == baseline.BASELINE_VERSION and doc["findings"] == []


# -- unfenced-write -----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["positive_retrying_over_raw_transport",
                                  "negative_fenced_chain", "negative_inline_fenced_chain",
                                  "positive_unbound_fence", "suppressed"])
def test_unfenced_write(case):
    inline = """
        from tpu_operator.client.fenced import FencedClient
        from tpu_operator.client.resilience import RetryingClient

        def build(transport, elector):
            return RetryingClient(FencedClient(transport, fence=elector))
    """
    unbound = """
        from tpu_operator.client.fenced import FencedClient
        from tpu_operator.client.resilience import RetryingClient

        def build(transport):
            fenced = FencedClient(transport)
            return RetryingClient(fenced)
    """
    suppressed = ref_t.UNFENCED_CHAIN.replace(
        "RetryingClient(RestClient(base_url=url))",
        "RetryingClient(RestClient(base_url=url))  "
        "# opalint: disable=unfenced-write — read-only diagnostic chain")
    src, relpath, want = {
        "positive_retrying_over_raw_transport": (
            ref_t.UNFENCED_CHAIN, "tpu_operator/controllers/manager.py",
            (["unfenced-write"], 0)),
        "negative_fenced_chain": (ref_t.FENCED_CHAIN, "tpu_operator/controllers/manager.py",
                                  ([], 0)),
        "negative_inline_fenced_chain": (inline, "tpu_operator/cmd/operator.py", ([], 0)),
        "positive_unbound_fence": (unbound, "tpu_operator/controllers/manager.py",
                                   (["unfenced-write"], 0)),
        "suppressed": (suppressed, "tpu_operator/controllers/manager.py", ([], 1)),
    }[case]
    kept, dropped = both(lambda m: lint(m, src, relpath, "unfenced-write"))
    assert (rules_of(kept), dropped) == want
    if case == "positive_unbound_fence":
        assert "never bound" in kept[0][4]


@pytest.mark.parametrize("relpath", ["tpu_operator/validator/main.py",
                                     "tpu_operator/client/resilience.py"])
def test_unfenced_write_out_of_scope_dirs_skipped(relpath):
    assert both(lambda m: lint(m, ref_t.UNFENCED_CHAIN, relpath, "unfenced-write")) == ([], 0)


# -- unbatched-sweep-write --------------------------------------------------------------

BATCHED_ROUTES = """
    from tpu_operator.client.batch import coalesced_patch
    from tpu_operator.client.preconditions import preconditioned_patch

    def label_fleet(client, batcher, nodes):
        for node in nodes:
            name = node["metadata"]["name"]
            coalesced_patch(client, "v1", "Node", name,
                            {"metadata": {"labels": {"a": "b"}}})
            preconditioned_patch(client, "v1", "Node", name,
                                 lambda cur: {"metadata": {}})
            batcher.defer_patch("v1", "Node", name,
                                lambda cur: {"metadata": {}})
"""

BARRIER_VERBS = """
    def reconcile(client, pods):
        client.patch("v1", "Node", "tpu-0", {"metadata": {}})
        for pod in pods:
            client.evict("v1", "Pod", pod["metadata"]["name"])
            client.delete("v1", "Pod", pod["metadata"]["name"])
"""


@pytest.mark.parametrize("src,relpath,want", [
    (ref_t.SWEEP_LOOP_WRITE, "tpu_operator/nodeinfo/labeler.py", 1),
    ("""
        def drain(client, queue):
            while queue:
                obj = queue.pop()
                client.update_status("tpu.ai/v1", "TPUDriver",
                                     obj["metadata"]["name"], obj)
    """, "tpu_operator/state/manager.py", 1),
    (BATCHED_ROUTES, "tpu_operator/nodeinfo/labeler.py", 0),
    (BARRIER_VERBS, "tpu_operator/upgrade/machine.py", 0),
    (ref_t.SWEEP_LOOP_WRITE, "tpu_operator/client/batch.py", 0),
    (ref_t.SWEEP_LOOP_WRITE, "tpu_operator/validator/main.py", 0),
], ids=["positive-loop-patch", "positive-while-update-status", "negative-batched-routes",
        "negative-barrier-verbs", "out-of-scope-client", "out-of-scope-validator"])
def test_unbatched_sweep_write(src, relpath, want):
    kept, _ = both(lambda m: lint(m, src, relpath, "unbatched-sweep-write"))
    assert rules_of(kept) == ["unbatched-sweep-write"] * want
    if want:
        assert "write batcher" in kept[0][4]


def test_unbatched_sweep_write_suppressed():
    src = ref_t.SWEEP_LOOP_WRITE.replace(
        'client.patch("v1", "Node", node["metadata"]["name"],',
        'client.patch("v1", "Node", node["metadata"]["name"],  '
        '# opalint: disable=unbatched-sweep-write — bootstrap path, fleet of 1')
    assert both(lambda m: lint(m, src, "tpu_operator/nodeinfo/labeler.py",
                               "unbatched-sweep-write")) == ([], 1)


# -- operand-dag ---------------------------------------------------------------------------

TELEMETRY_DS = "tpu_operator/manifests/state-telemetry/0500_daemonset.yaml"


def test_operand_dag_positive_undeclared_literal_gate():
    kept, _ = both(lambda m: lint_dag(m, ref_t.OPERANDS_SRC,
                                      {TELEMETRY_DS: ref_t.STRAY_WAIT_MANIFEST}))
    assert rules_of(kept) == ["operand-dag"]
    assert "state-telemetry" in kept[0][4] and "'driver'" in kept[0][4]
    assert "OPERAND_DAG" in kept[0][5]


def test_operand_dag_positive_literal_wait_for_macro_call():
    kept, _ = both(lambda m: lint_dag(m, ref_t.OPERANDS_SRC, {
        TELEMETRY_DS: '{{ common.wait_for(data, "plugin") }}\n'}))
    assert rules_of(kept) == ["operand-dag"] and "'plugin'" in kept[0][4]


def test_operand_dag_negative_declared_and_templated_gates():
    assert both(lambda m: lint_dag(m, ref_t.OPERANDS_SRC, {
        "tpu_operator/manifests/state-device-plugin/0500_daemonset.yaml":
            ref_t.STRAY_WAIT_MANIFEST,
        "tpu_operator/manifests/state-operator-serving/0500_daemonset.yaml":
            "args: [-c, wait, --for={{ barrier }}, --status-dir=/x]\n",
        "tpu_operator/manifests/_includes/common.j2":
            "args: [-c, wait, --for=anything, --status-dir=/x]\n",
    })) == ([], 0)


@pytest.mark.parametrize("manifests,relpath", [
    ({}, "tpu_operator/state/operands.py"),
    ({TELEMETRY_DS: ref_t.STRAY_WAIT_MANIFEST}, "tpu_operator/controllers/manager.py"),
], ids=["no-manifests", "elsewhere"])
def test_operand_dag_disabled_without_manifests_or_elsewhere(manifests, relpath):
    assert both(lambda m: lint_dag(m, ref_t.OPERANDS_SRC, manifests, relpath)) == ([], 0)


def test_operand_dag_suppressed():
    src = ref_t.OPERANDS_SRC.replace(
        "OPERAND_DAG = {",
        "OPERAND_DAG = {  # opalint: disable=operand-dag — staged migration, gate lands next PR")
    assert both(lambda m: lint_dag(m, src, {TELEMETRY_DS: ref_t.STRAY_WAIT_MANIFEST})) == ([], 1)


def test_operand_dag_is_live_on_the_port_s_manifests():
    """The port's OPERAND_DAG and its manifests: a stray literal gate
    added to one of its templates is found, the shipped ones are clean."""
    texts = runner.load_manifest_texts(str(REPO_ROOT))
    assert any(rel.startswith("tpu_operator_torch/manifests/state-") for rel in texts)
    path = "tpu_operator_torch/state/operands.py"
    src = (REPO_ROOT / path).read_text()

    def findings(manifest_texts):
        ctx = core.FileContext(path, src, ast.parse(src),
                               core.LintConfig(manifest_texts=manifest_texts))
        return list(core.all_checkers()["operand-dag"]().check(ctx))

    assert findings(texts) == []
    stray = dict(texts)
    target = sorted(rel for rel in texts if "/state-" in rel)[0]
    stray[target] += "\n# args: [-c, wait, --for=nowhere]\n"
    assert [f.rule for f in findings(stray)] == ["operand-dag"]


# -- graph-backed rules -------------------------------------------------------------------

@pytest.mark.parametrize("rule", ref_t.GRAPH_RULES)
def test_graph_rules_silent_without_project(rule):
    src = """
        import urllib.request

        KEY = "tpu.ai/raw-key"

        def reconcile(req):
            urllib.request.urlopen("http://x")
    """
    assert both(lambda m: lint(m, src, "tpu_operator/controllers/x.py", rule)) == ([], 0)


# -- annotation-registry -------------------------------------------------------------------

def test_annotation_registry_positive_known_and_unknown_literal():
    kept, _ = both(lambda m: lint_in_project(m, {
        "tpu_operator/consts.py": ref_t.REGISTRY_CONSTS,
        "tpu_operator/controllers/drain.py":
            'KEY = "tpu.ai/drain"\nOTHER = "tpu.ai/unregistered"\n',
    }, "tpu_operator/controllers/drain.py", "annotation-registry"))
    assert rules_of(kept) == ["annotation-registry"] * 2
    assert "use consts.DRAIN_LABEL" in kept[0][4]
    assert "add a named constant" in kept[1][4]


def test_annotation_registry_negative_api_version_and_prose():
    assert both(lambda m: lint_in_project(m, {
        "tpu_operator/consts.py": ref_t.REGISTRY_CONSTS,
        "tpu_operator/api/types.py": """
            API_VERSION = "tpu.ai/v1alpha1"
            GROUP_V1 = "tpu.ai/v1"
            HELP = "set the tpu.ai/drain annotation to request a drain"
        """,
    }, "tpu_operator/api/types.py", "annotation-registry")) == ([], 0)


@pytest.mark.parametrize("docs,want", [
    ("| `tpu.ai/drain` | drain request |", 0), ("no registry table here", 1), (None, 0),
], ids=["documented", "undocumented", "no-docs"])
def test_annotation_registry_docs_check_in_registry_module(docs, want):
    kept, _ = both(lambda m: lint_in_project(
        m, {"tpu_operator/consts.py": ref_t.REGISTRY_CONSTS}, "tpu_operator/consts.py",
        "annotation-registry", docs_text=docs))
    assert rules_of(kept) == ["annotation-registry"] * want


def test_annotation_registry_suppressed():
    assert both(lambda m: lint_in_project(m, {
        "tpu_operator/consts.py": ref_t.REGISTRY_CONSTS,
        "tpu_operator/controllers/drain.py":
            'KEY = "tpu.ai/drain"  # opalint: disable=annotation-registry — migration shim\n',
    }, "tpu_operator/controllers/drain.py", "annotation-registry")) == ([], 1)


def test_annotation_registry_resolves_the_port_s_registry():
    """``consts_module`` is the port's: a raw key of the port's registry
    outside it is flagged with its constant's name."""
    assert core.LintConfig().consts_module == LINT_NAMES["port"]["consts"]
    consts_src = (REPO_ROOT / "tpu_operator_torch" / "consts.py").read_text()
    kept, _ = lint_in_project(PORT, {
        "tpu_operator/consts.py": consts_src,
        "tpu_operator/testing/sim.py": 'LABEL = "tpu.ai/kubelet-sim-ds"\n',
    }, "tpu_operator/testing/sim.py", "annotation-registry")
    assert rules_of(kept) == ["annotation-registry"]
    assert "use consts.KUBELET_SIM_DS_LABEL" in kept[0][4]


# -- state-before-actuation -------------------------------------------------------------

_actuation_tree = ref_t._actuation_tree


@pytest.mark.parametrize("body,want", [
    ('client.create({"kind": "Node"})\n            self._persist(client)', 1),
    ('self._scale_up(client)\n            self._persist(client)', 2),
    ('self._persist(client)\n            client.create({"kind": "Node"})', 0),
    ('events.create(client, "Scaled")\n            self._persist(client)', 0),
], ids=["positive-direct", "positive-through-helper", "negative-persist-first",
        "negative-events"])
def test_state_before_actuation(body, want):
    kept, _ = both(lambda m: lint_in_project(m, _actuation_tree(body),
                                             "tpu_operator/autoscale/controller.py",
                                             "state-before-actuation"))
    assert rules_of(kept) == ["state-before-actuation"] * want
    if want == 2:
        msgs = " | ".join(f[4] for f in kept)
        assert "Reconciler._scale_up actuates" in msgs
        assert "Reconciler.reconcile actuates" in msgs


def test_state_before_actuation_out_of_scope_dir():
    t = _actuation_tree('client.create({"kind": "Node"})\n            self._persist(client)')
    t["tpu_operator/cmd/tool.py"] = t.pop("tpu_operator/autoscale/controller.py")
    assert both(lambda m: lint_in_project(m, t, "tpu_operator/cmd/tool.py",
                                          "state-before-actuation")) == ([], 0)


def test_state_before_actuation_suppressed():
    assert both(lambda m: lint_in_project(m, _actuation_tree(
        '# create-first is proven safe here by the crash matrix\n'
        '            # opalint: disable=state-before-actuation\n'
        '            client.create({"kind": "Node"})\n'
        '            self._persist(client)'),
        "tpu_operator/autoscale/controller.py", "state-before-actuation")) == ([], 1)


# -- provenance-discipline --------------------------------------------------------------

PROV = ref_t._provenance_tree


@pytest.mark.parametrize("sources,relpath,want", [
    (PROV('client.delete("v1", "Node", "n")'), "tpu_operator/health/machine.py", 1),
    ({"tpu_operator/health/sweep.py": """
        class Sweeper:
            def reconcile(self, client):
                self._rogue_delete(client, "p")

            def _rogue_delete(self, client, pod):
                client.delete("v1", "Pod", pod)
    """}, "tpu_operator/health/sweep.py", 1),
    (PROV('self._publish_plan("n")'), "tpu_operator/health/machine.py", 1),
    (PROV('self._record_and_recycle(client, "p")'), "tpu_operator/health/machine.py", 0),
    (PROV('self.journal.record_decision(\n                "health", "recycle", "ep-1", {})\n'
          '            client.delete("v1", "Node", "n")'), "tpu_operator/health/machine.py", 0),
    (PROV('events.delete(client, "stale")'), "tpu_operator/health/machine.py", 0),
    (PROV('client.delete("v1", "Node", "n")', relpath="tpu_operator/cmd/tool.py"),
     "tpu_operator/cmd/tool.py", 0),
], ids=["positive-direct-delete", "positive-uncovered-helper", "positive-plan-publish",
        "negative-recorder-reaches-helper", "negative-recorder-actuates-inline",
        "negative-events", "negative-out-of-scope"])
def test_provenance_discipline(sources, relpath, want):
    kept, _ = both(lambda m: lint_in_project(m, sources, relpath, "provenance-discipline"))
    assert rules_of(kept) == ["provenance-discipline"] * want


def test_provenance_discipline_suppressed():
    assert both(lambda m: lint_in_project(m, PROV(
        '# opalint: disable=provenance-discipline — scratch-object GC\n'
        '            client.delete("v1", "ConfigMap", "tmp")'),
        "tpu_operator/health/machine.py", "provenance-discipline")) == ([], 1)


# -- deadline-propagation -------------------------------------------------------------

@pytest.mark.parametrize("sources,want", [
    ({"tpu_operator/controllers/sync.py": ref_t.DEADLINE_ENTRY,
      "tpu_operator/validator/probe.py": ref_t.DEADLINE_HELPER}, 1),
    ({"tpu_operator/controllers/sync.py": ref_t.DEADLINE_ENTRY,
      "tpu_operator/validator/probe.py": ref_t.DEADLINE_HELPER.replace(
          '"http://node:8080/healthz"', '"http://node:8080/healthz", timeout=3')}, 0),
    ({"tpu_operator/validator/probe.py": ref_t.DEADLINE_HELPER}, 0),
    ({"tpu_operator/controllers/sync.py": """
        from ..client import rest

        def reconcile(req):
            return rest.fetch()
    """, "tpu_operator/client/rest.py": """
        from ..validator import probe

        def fetch():
            return probe.check()
    """, "tpu_operator/validator/probe.py": ref_t.DEADLINE_HELPER}, 0),
], ids=["positive-with-chain", "negative-timeout", "negative-unreachable",
        "prunes-at-client-stack"])
def test_deadline_propagation(sources, want):
    kept, _ = both(lambda m: lint_in_project(m, sources, "tpu_operator/validator/probe.py",
                                             "deadline-propagation"))
    assert rules_of(kept) == ["deadline-propagation"] * want
    if want:
        assert "tpu_operator.controllers.sync:reconcile" in kept[0][4]
        assert "tpu_operator.validator.probe:check" in kept[0][4]


def test_deadline_propagation_suppressed():
    assert both(lambda m: lint_in_project(m, {
        "tpu_operator/controllers/sync.py": ref_t.DEADLINE_ENTRY,
        "tpu_operator/validator/probe.py": ref_t.DEADLINE_HELPER.replace(
            "return urllib.request.urlopen",
            "# kubelet-local socket, bounded by the kernel\n"
            "        # opalint: disable=deadline-propagation\n"
            "        return urllib.request.urlopen"),
    }, "tpu_operator/validator/probe.py", "deadline-propagation")) == ([], 1)


# -- exactly-once-event -------------------------------------------------------------------

@pytest.mark.parametrize("sources,want", [
    ({"tpu_operator/consts.py": ref_t.PROTOCOL_CONSTS,
      "tpu_operator/health/machine.py":
          ref_t.PROTOCOL_WRITER.format(record="record")
          + "\n    def episode(client, events):\n"
            "        publish(client, events)\n"
            "        events.record(\"EpisodeDone\", \"finished\")\n"}, 2),
    ({"tpu_operator/consts.py": ref_t.PROTOCOL_CONSTS,
      "tpu_operator/health/machine.py": ref_t.PROTOCOL_WRITER.format(record="record_once")}, 0),
    ({"tpu_operator/consts.py": ref_t.PROTOCOL_CONSTS,
      "tpu_operator/health/machine.py": """
        def note(events):
            events.record("NodeSeen", "informational")
    """}, 0),
], ids=["positive-writer-and-direct-caller", "negative-record-once", "negative-off-path"])
def test_exactly_once_event(sources, want):
    kept, _ = both(lambda m: lint_in_project(m, sources, "tpu_operator/health/machine.py",
                                             "exactly-once-event"))
    assert rules_of(kept) == ["exactly-once-event"] * want
    if want:
        msgs = " | ".join(f[4] for f in kept)
        assert "events.record in publish" in msgs and "events.record in episode" in msgs


def test_exactly_once_event_suppressed():
    assert both(lambda m: lint_in_project(m, {
        "tpu_operator/consts.py": ref_t.PROTOCOL_CONSTS,
        "tpu_operator/health/machine.py":
            ref_t.PROTOCOL_WRITER.format(record="record").replace(
                'events.record("RetilePlanned", "plan published")',
                '# aggregated counter Event, duplicates intended\n'
                '        # opalint: disable=exactly-once-event\n'
                '        events.record("RetilePlanned", "plan published")'),
    }, "tpu_operator/health/machine.py", "exactly-once-event")) == ([], 1)


# -- lock-order-inversion -----------------------------------------------------------------

INVERTED = ref_t.INVERTED_LOCKS


@pytest.mark.parametrize("src,want,dropped", [
    (INVERTED, 2, 0),
    (INVERTED.replace("with self._b_lock:\n                with self._a_lock:",
                      "with self._a_lock:\n                with self._b_lock:"), 0, 0),
    (INVERTED.replace("with self._b_lock:\n                with self._a_lock:",
                      "with self._b_lock:\n                "
                      "# shutdown path, fill() provably quiesced\n                "
                      "# opalint: disable=lock-order-inversion\n                "
                      "with self._a_lock:"), 1, 1),
], ids=["positive-ab-ba", "negative-total-order", "suppressed"])
def test_lock_order_inversion(src, want, dropped):
    kept, got_dropped = both(lambda m: lint_in_project(
        m, {"tpu_operator/state/pool.py": src}, "tpu_operator/state/pool.py",
        "lock-order-inversion"))
    assert rules_of(kept) == ["lock-order-inversion"] * want and got_dropped == dropped
    if want == 2:
        assert "lock-order cycle" in kept[0][4]
        assert "Pool._a_lock" in kept[0][4] and "Pool._b_lock" in kept[0][4]


# -- CLI ----------------------------------------------------------------------------------

POSITIVE = ref_t.POSITIVE_FIXTURES


def _files(rule):
    fixture = POSITIVE[rule]
    return fixture if isinstance(fixture, dict) else {fixture[0]: fixture[1]}


@pytest.mark.parametrize("rule", sorted(POSITIVE))
def test_cli_exits_nonzero_on_each_positive_fixture(rule, tmp_path):
    code, out = both(lambda m: cli(m, tree(m, tmp_path, _files(rule)), "--no-baseline"))
    assert code == 1 and f"[{rule}]" in out


def test_cli_clean_tree_exits_zero(tmp_path):
    code, out = both(lambda m: cli(m, tree(m, tmp_path, {
        "tpu_operator/controllers/ok.py": "def reconcile(req):\n    return None\n"})))
    assert code == 0 and "ok: 0 new finding(s)" in out


def test_cli_write_baseline_then_clean(tmp_path):
    def scenario(m):
        root = tree(m, tmp_path, {"tpu_operator/controllers/sync.py": BAD_SYNC})
        return [cli(m, root, "--write-baseline")[0], cli(m, root)[0],
                cli(m, root, "--no-baseline")[0],
                (root / m.baseline.DEFAULT_BASELINE).exists()]

    assert both(scenario) == [0, 0, 1, True]


@pytest.mark.parametrize("fmt", ["json", "sarif"])
def test_cli_formats(fmt, tmp_path):
    def scenario(m):
        root = tree(m, tmp_path, {"tpu_operator/controllers/sync.py": BAD_SYNC})
        code, out = cli(m, root, "--no-baseline", "--format", fmt)
        doc = json.loads(out)
        if fmt == "sarif":  # each tool's own documentation
            doc["runs"][0]["tool"]["driver"].pop("informationUri")
        return code, doc

    code, doc = both(scenario)
    assert code == 1
    if fmt == "json":
        assert [f["rule"] for f in doc["findings"]] == ["blocking-call"] and doc["files"] == 1
    else:
        assert doc["version"] == "2.1.0"
        assert doc["runs"][0]["tool"]["driver"]["name"] == "opalint"  # read back
        loc = doc["runs"][0]["results"][0]["locations"][0]["physicalLocation"]
        assert loc["artifactLocation"]["uri"] == "tpu_operator/controllers/sync.py"


def test_the_sarif_run_names_the_port_s_tool(tmp_path):
    root = tree(PORT, tmp_path, {"tpu_operator/controllers/sync.py": BAD_SYNC})
    out = io.StringIO()
    assert runner.main(["--root", str(root), "--no-baseline", "--format=sarif"], out=out) == 1
    driver = json.loads(out.getvalue())["runs"][0]["tool"]["driver"]
    assert driver["name"] == LINT_NAMES["port"]["tool"]
    assert [r["id"] for r in driver["rules"]] == ["blocking-call"]


def test_cli_stale_baseline_entry_fails(tmp_path):
    def scenario(m):
        root = tree(m, tmp_path, {"tpu_operator/controllers/sync.py": BAD_SYNC})
        obs = [cli(m, root, "--write-baseline")[0]]
        (root / m.map("tpu_operator/controllers/sync.py")).write_text(
            "def reconcile(req):\n    return None\n")
        code, out = cli(m, root)
        obs += [code, "stale baseline entry" in out, "FAIL" in out]
        obs += [cli(m, root, "--write-baseline")[0], cli(m, root)[0]]
        return obs

    assert both(scenario) == [0, 1, True, True, 0, 0]


_git_seed = ref_t._git_seed


def test_cli_changed_mode_lints_only_the_diff(tmp_path):
    def scenario(m):
        root = tree(m, tmp_path, {
            "tpu_operator/controllers/clean.py": "def reconcile(req):\n    return None\n",
            "tpu_operator/controllers/sync.py": BAD_SYNC})
        _git_seed(root)
        obs = [cli(m, root, "--no-baseline", "--changed")]
        (root / m.map("tpu_operator/controllers/clean.py")).write_text(
            "def reconcile(req):\n    return 1\n")
        obs.append(cli(m, root, "--no-baseline", "--changed"))
        (root / m.map("tpu_operator/controllers/sync.py")).write_text(
            textwrap.dedent(BAD_SYNC) + "\n")
        obs.append(cli(m, root, "--no-baseline", "--changed"))
        obs.append(cli(m, root, "--changed=no-such-ref")[0])
        return obs

    obs = both(scenario)
    assert obs[0][0] == 0 and "across 0 files" in obs[0][1]
    assert obs[1][0] == 0 and "across 1 files" in obs[1][1]
    assert obs[2][0] == 1 and "[blocking-call]" in obs[2][1]
    assert obs[3] == 2


def test_cli_changed_mode_graph_still_covers_full_tree(tmp_path):
    def scenario(m):
        root = tree(m, tmp_path, {
            "tpu_operator/consts.py": ref_t.REGISTRY_CONSTS,
            "tpu_operator/controllers/sync.py": "def reconcile(req):\n    return None\n"})
        _git_seed(root)
        (root / m.map("tpu_operator/controllers/drain.py")).write_text('KEY = "tpu.ai/drain"\n')
        return cli(m, root, "--no-baseline", "--changed")

    code, out = both(scenario)
    assert code == 1 and "[annotation-registry]" in out and "consts.DRAIN_LABEL" in out


def test_cli_changed_mode_scopes_staleness_to_linted_files(tmp_path):
    def scenario(m):
        root = tree(m, tmp_path, {
            "tpu_operator/controllers/clean.py": "def reconcile(req):\n    return None\n",
            "tpu_operator/controllers/sync.py": BAD_SYNC})
        obs = [cli(m, root, "--write-baseline")[0]]
        (root / m.map("tpu_operator/controllers/sync.py")).write_text(
            "def reconcile(req):\n    return None\n")
        _git_seed(root)
        (root / m.map("tpu_operator/controllers/clean.py")).write_text(
            "def reconcile(req):\n    return 2\n")
        obs.append(cli(m, root, "--changed")[0])
        (root / m.map("tpu_operator/controllers/sync.py")).write_text(
            "def reconcile(req):\n    return 3\n")
        code, out = cli(m, root, "--changed")
        return obs + [code, "stale baseline entry" in out]

    assert both(scenario) == [0, 0, 1, True]


def test_cli_changed_mode_keeps_to_the_port_s_tree(tmp_path):
    """``--changed`` filters on the port's tree: a changed file of the
    reference's package beside it is not the port's to lint."""
    root = tmp_path / "both"
    for rel in ("tpu_operator/controllers/sync.py", "tpu_operator_torch/controllers/ok.py"):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text("def reconcile(req):\n    return None\n")
    _git_seed(root)
    for rel in ("tpu_operator/controllers/sync.py", "tpu_operator_torch/controllers/ok.py"):
        (root / rel).write_text(textwrap.dedent(BAD_SYNC))
    assert [os.path.relpath(p, root) for p in runner.changed_files(str(root), "HEAD")] == [
        "tpu_operator_torch/controllers/ok.py"]


def test_cli_parse_error_is_a_finding(tmp_path):
    code, out = both(lambda m: cli(m, tree(m, tmp_path, {"tpu_operator/broken.py": "def oops(:\n"}),
                                   "--no-baseline"))
    assert code == 1 and "[parse-error]" in out


def test_cli_rules_subset_and_unknown_rule(tmp_path):
    def scenario(m):
        root = tree(m, tmp_path, {"tpu_operator/controllers/sync.py": BAD_SYNC})
        return (cli(m, root, "--no-baseline", "--rules", "api-bypass")[0],
                cli(m, root, "--rules", "no-such-rule")[0])

    assert both(scenario) == (0, 2)


def test_cli_list_rules():
    def scenario(m):
        out = io.StringIO()
        code = m.runner.main(["--list-rules"], out=out)
        return code, sorted(line.split(":")[0] for line in out.getvalue().splitlines())

    code, names = both(scenario)
    assert code == 0 and set(names) == set(POSITIVE) and len(names) == 17


# -- the port's real tree -------------------------------------------------------------------

def test_real_tree_clean_under_the_empty_baseline():
    """The gate: the port's tree lints clean, every finding settled in
    place (the baseline holds none)."""
    out = io.StringIO()
    code = runner.main(["--root", str(REPO_ROOT)], out=out)
    assert code == 0, out.getvalue()
    assert " 0 baselined, " in out.getvalue() and "0 stale baseline" in out.getvalue()


SUPPRESSION = re.compile(r"#\s*opalint:\s*disable=([A-Za-z0-9_,\- ]+?)(?:\s+—\s*(.*))?$")


def _suppressions():
    """(relpath, line, rules, reason) of every in-place suppression in the
    port's tree, the reason being the prose after the rule list or, for a
    bare one, the comment lines right above it."""
    out = []
    for path in sorted((REPO_ROOT / "tpu_operator_torch").rglob("*.py")):
        rel = path.relative_to(REPO_ROOT).as_posix()
        if "/analysis/" in rel:
            continue
        lines = path.read_text().splitlines()
        for i, line in enumerate(lines):
            m = SUPPRESSION.search(line)
            if not m:
                continue
            reason = (m.group(2) or "").strip()
            if not reason:
                before = line[:m.start()].strip()
                if before.startswith("#"):
                    reason = before.lstrip("# ").strip()
                j = i - 1
                while not reason and j >= 0 and lines[j].strip().startswith("#"):
                    reason = lines[j].strip().lstrip("# ").strip()
                    j -= 1
            out.append((rel, i + 1, m.group(1).strip(), reason))
    return out


def test_every_suppression_carries_a_reason():
    found = _suppressions()
    assert len(found) == 32
    assert [s for s in found if not s[3]] == []
    # each names a rule the linter has
    names = set(core.all_checkers())
    assert {r.strip() for s in found for r in s[2].split(",")} <= names


def test_the_reference_s_grandfathered_sites_are_settled_in_place():
    """The reference's baseline grandfathers two leader.py findings; the
    port's copies of those handlers carry suppressions instead."""
    with open(REPO_ROOT / ".opalint-baseline.json") as f:
        grandfathered = json.load(f)["findings"]
    got = {(e["rule"], e["path"], sum(1 for g in grandfathered if g["path"] == e["path"]))
           for e in grandfathered}
    assert got == LINT_REFERENCE_BASELINED
    leader = [s for s in _suppressions() if s[0] == "tpu_operator_torch/controllers/leader.py"]
    assert [s[2] for s in leader] == ["breaker-swallow"] * 3


def test_the_tree_s_files_are_the_port_s():
    assert runner.PROJECT_TREE == LINT_NAMES["port"]["tree"]
    assert runner.MANIFESTS_RELPATH.replace(os.sep, "/") == LINT_NAMES["port"]["manifests"]
    files = runner.iter_py_files(str(REPO_ROOT), [runner.PROJECT_TREE])
    assert files and all(os.path.relpath(f, REPO_ROOT).startswith("tpu_operator_torch/")
                         for f in files)
    assert not any("deviceplugin/proto" in f for f in files)


@pytest.mark.parametrize("rule", LINT_IDIOM_RULES)
def test_the_idiom_rules_have_a_port_positive(rule):
    """No rule is dead: each idiom rule fires on the port's own idiom."""
    case = {"api-bypass": ("import http.client\nhttp.client.HTTPConnection('h')\n",
                           "tpu_operator/controllers/x.py", None),
            "metrics-discipline": (PORT_METRICS_LOOSE, "tpu_operator/controllers/x.py", "")}
    src, relpath, docs = case[rule]
    assert rules_of(port_lint(src, relpath, rule, docs_text=docs)[0])[:1] == [rule]


def test_the_lint_cli_imports_no_torch():
    """``gpuop-lint`` runs in a process that loads neither torch nor the
    reference package."""
    script = ("import io, sys\n"
              "from tpu_operator_torch.cmd.lint import main\n"
              "rc = main(['--root', sys.argv[1], '--list-rules'], out=io.StringIO())\n"
              "bad = sorted(m for m in sys.modules if m == 'torch' or m.startswith('torch.')\n"
              "             or m == 'tpu_operator' or m.startswith('tpu_operator.'))\n"
              "print(rc, bad)\n")
    out = subprocess.run([sys.executable, "-c", script, str(REPO_ROOT)], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "0 []", out.stderr
