"""The port's runbook, docs/gpu/operations.md, against what the port emits
(the twin of tests/test_metrics_docs.py over the port's three registries):
every metric family documented, every registered key in the registry table,
every alert of the port's PrometheusRules with its runbook section. The
port's alerts name the port's tool and runbook, never the reference's, and
keep the reference's alert names and expressions.
"""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import yaml

from test_torch_operator_mapping import RUNBOOKS
from tpu_operator_torch import consts
from tpu_operator_torch.analysis import runner
from tpu_operator_torch.controllers import metrics as operator_metrics
from tpu_operator_torch.validator import telemetry
from tpu_operator_torch.validator.metrics import NodeMetrics

REPO = pathlib.Path(__file__).resolve().parent.parent
DOCS = REPO / RUNBOOKS["port"]
PORT_MANIFESTS = REPO / "tpu_operator_torch" / "manifests"
ALERT_RULES = "state-operator-metrics/0300_prometheusrule.yaml"
#: every file the port installs from: the operator's templates, the chart,
#: the static install and the OLM bundle
INSTALL_FILES = sorted(
    [p for p in PORT_MANIFESTS.rglob("*") if p.is_file()]
    + [p for p in (REPO / "deployments" / "gpu-operator").rglob("*") if p.is_file()]
    + [REPO / "deploy" / "gpu-operator.yaml"]
    + [p for p in (REPO / "bundle-gpu").rglob("*") if p.is_file()])


def _operator_families(metrics):
    return {f.name + ("_total" if isinstance(f, operator_metrics.Counter) else "")
            for f in metrics.families}


def _node_families():
    metrics = NodeMetrics()
    metrics._set_ici(1.0)  # the all-reduce gauge exists once measured
    return {f.name for f in metrics.families()}


def _telemetry_families():
    metrics = telemetry.TelemetryMetrics(sources=[])
    return set(telemetry.FAMILIES) | {metrics.source_up.name, metrics.scrape_errors.name}


def _missing(names, docs):
    return sorted(n for n in names if f"`{n}`" not in docs)


@pytest.mark.parametrize("registry", ["operator", "node", "telemetry"])
def test_every_family_is_documented(registry):
    families = {"operator": lambda: _operator_families(operator_metrics.OperatorMetrics()),
                "node": _node_families, "telemetry": _telemetry_families}[registry]()
    assert families
    assert _missing(families, DOCS.read_text()) == [], \
        f"{registry} families missing from {RUNBOOKS['port']}: add a row to the metrics reference"


def test_an_undocumented_family_fails():
    """A family the operator registers without a runbook row is found."""
    metrics = operator_metrics.OperatorMetrics()
    metrics.families.append(operator_metrics.Counter(
        "tpu_operator_undocumented_things_total", "a family nobody wrote up"))
    assert _missing(_operator_families(metrics), DOCS.read_text()) == \
        ["tpu_operator_undocumented_things_total"]


def test_families_do_not_collide_across_registries():
    operator = _operator_families(operator_metrics.OperatorMetrics())
    assert not operator & _node_families()
    assert not operator & _telemetry_families()
    assert not _node_families() & _telemetry_families()


def test_the_linter_reads_the_port_s_runbook():
    assert runner.DOCS_RELPATH == os.path.join(*RUNBOOKS["port"].split("/"))


def _registry_keys():
    src = (REPO / "tpu_operator_torch" / "consts.py").read_text()
    return sorted(set(re.findall(r'^[A-Z_]+ = "(tpu\.ai/(?!v\d)[A-Za-z0-9._/-]+)"$', src, re.M)))


def test_every_registered_key_is_in_the_registry_table():
    keys = _registry_keys()
    assert consts.GPU_PRESENT_LABEL in keys and consts.UPGRADE_EPISODE_ANNOTATION in keys
    docs = DOCS.read_text()
    assert [k for k in keys if k not in docs] == []


def test_no_registry_key_is_suppressed_in_consts():
    src = (REPO / "tpu_operator_torch" / "consts.py").read_text()
    assert "disable=annotation-registry" not in src


def test_a_key_missing_from_the_runbook_fails_the_linter(tmp_path):
    """gpuop-lint over a copy whose runbook lost the renamed presence label
    finds exactly that key."""
    shutil.copytree(REPO / "tpu_operator_torch", tmp_path / "tpu_operator_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "docs" / "gpu").mkdir(parents=True)
    text = DOCS.read_text().replace(f"`{consts.GPU_PRESENT_LABEL}`", "`the presence label`")
    (tmp_path / RUNBOOKS["port"]).write_text(text)
    shutil.copy(REPO / ".gpuop-lint-baseline.json", tmp_path)
    result = subprocess.run(
        [sys.executable, "-m", "tpu_operator_torch.cmd.lint", f"--root={tmp_path}",
         "--rules=annotation-registry"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert result.returncode == 1, result.stdout + result.stderr
    flagged = [line for line in result.stdout.splitlines() if "[annotation-registry]" in line]
    assert len(flagged) == 1 and consts.GPU_PRESENT_LABEL in flagged[0], result.stdout


# -- the alerts ----------------------------------------------------------------------

def _rules(path):
    docs = yaml.safe_load(re.sub(r"\{\{[^}]*\}\}", "x", path.read_text()))
    return [rule for group in docs["spec"]["groups"] for rule in group["rules"]]


@pytest.mark.parametrize("path", INSTALL_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_port_manifest_names_the_reference_s_tool_or_runbook(path):
    text = path.read_text().replace(RUNBOOKS["port"], "")
    for word in ("tpuop-", "tpu-validator", RUNBOOKS["reference"]):
        assert word not in text, f"{path.name} names {word!r}"


def test_the_alert_names_and_expressions_are_the_reference_s():
    port = _rules(PORT_MANIFESTS / ALERT_RULES)
    ref = _rules(REPO / "tpu_operator" / "manifests" / ALERT_RULES)
    shape = lambda rules: [(r["alert"], r["expr"], r.get("for"), r["labels"]) for r in rules]  # noqa: E731
    assert shape(port) == shape(ref)


RULE_FILES = sorted(PORT_MANIFESTS.glob("*/*prometheusrule*.yaml"))
#: words for TPU hardware and its software that no alert text of the port
#: may use (alert names and label names such as ``chip`` stay the reference's)
TPU_HARDWARE = re.compile(r"\bTPU\b|libtpu|\bICI\b|\bMXU\b|\bchips?\b", re.I)


def _alert_text(rule):
    """A rule's summary and description, its template references (label
    names such as ``$labels.chip``) and the API group's keys
    (``tpu.ai/...``, kept by the port) left out."""
    return " ".join(re.sub(r"\{\{[^}]*\}\}|tpu\.ai/\S+", "", v)
                    for v in rule["annotations"].values())


@pytest.mark.parametrize("path", RULE_FILES, ids=lambda p: p.parent.name)
def test_no_port_alert_text_names_tpu_hardware(path):
    raw = path.read_text()
    # the escaped Prometheus templates kept, the manifest's own variables set
    text = re.sub(r"\{\{ \w+ \}\}", "x", re.sub(r"\{\{ '(\{\{[^}]*\}\})' \}\}", r"\1", raw))
    docs = yaml.safe_load(text)
    rules = [r for group in docs["spec"]["groups"] for r in group["rules"]]
    assert rules
    assert {r["alert"]: TPU_HARDWARE.findall(_alert_text(r)) for r in rules} == \
        {r["alert"]: [] for r in rules}


@pytest.mark.parametrize("path", RULE_FILES, ids=lambda p: p.parent.name)
def test_every_rule_file_keeps_the_reference_s_alert_names_and_expressions(path):
    port = _rules(path)
    ref = _rules(REPO / "tpu_operator" / path.relative_to(REPO / "tpu_operator_torch"))
    shape = lambda rules: [(r["alert"], r["expr"], r.get("for"), r["labels"]) for r in rules]  # noqa: E731
    assert shape(port) == shape(ref)


def test_the_hardware_check_finds_a_tpu_word():
    rule = {"annotations": {"summary": "libtpu driver validation not passing on a TPU node",
                            "description": "GPU {{ $labels.chip }} (tpu.ai/health-state)"}}
    assert TPU_HARDWARE.findall(_alert_text(rule)) == ["libtpu", "TPU"]


def test_the_alerts_name_the_port_s_tool_and_runbook():
    text = " ".join(v for r in _rules(PORT_MANIFESTS / ALERT_RULES)
                    for v in r["annotations"].values())
    assert "`gpuop-cfg status`" in text and "gpuop-cfg explain" in text
    assert text.count(RUNBOOKS["port"]) == 3


@pytest.mark.parametrize("path", sorted(PORT_MANIFESTS.glob("*/*prometheusrule*.yaml")),
                         ids=lambda p: p.parent.name)
def test_every_alert_has_its_runbook_section(path):
    sections = set(re.findall(r"^### (\w+) ", DOCS.read_text(), re.M))
    alerts = [r["alert"] for r in _rules(path)]
    assert alerts and [a for a in alerts if a not in sections] == []


def test_every_runbook_an_alert_names_is_a_section():
    headings = {h.lower() for h in re.findall(r"^## (.+)$", DOCS.read_text(), re.M)}
    text = " ".join(v for r in _rules(PORT_MANIFESTS / ALERT_RULES)
                    for v in r["annotations"].values())
    named = re.findall(r"the ([a-z-]+) runbook in " + re.escape(RUNBOOKS["port"]), text)
    assert sorted(named) == ["capacity-observatory", "incident-forensics", "migration"]
    for name in named:
        words = name.replace("-", " ")
        assert any(words in h for h in headings), f"no section for the {name} runbook"
