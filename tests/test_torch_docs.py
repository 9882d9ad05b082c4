"""The port's user documents, ``docs/gpu/``, held to the code they describe
(the counterparts of the reference's ``docs/quickstart.md``,
``configuration.md``, ``design.md`` and ``static-analysis.md``).

Every ``tpu_operator_torch/...:line`` they cite names a file that exists and
a line within it, and the definition of the name it sits beside (a call
stack's function, a listed symbol), and every repository path they name
exists; the
configuration reference's field tables are the generated CRDs' fields, types
and defaults, and its label table is every label key of ``consts``; the
static-analysis guide names exactly the registered rules and the sanitizer's
switches; the quickstart's ``--set`` keys are the chart's and render, its
workload Pod asks for ``nvidia.com/gpu``; the design document has a section
for each of the reference's 20; and no line names TPU hardware or the
reference's tools unless it names the reference as such (the word rules of
tests/test_torch_metrics_docs.py for the alerts).
"""

import inspect
import json
import os
import re

import pytest
import yaml

from test_torch_metrics_docs import TPU_HARDWARE
from tpu_operator_torch import consts, yamlsubset
from tpu_operator_torch.analysis.core import all_checkers
from tpu_operator_torch.api import schema_gen, schema_validate
from tpu_operator_torch.sanitizer import core as opsan_core
from tpu_operator_torch.sanitizer import perturb
from tpu_operator_torch.testing.helmlite import HelmLite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(REPO, "docs", "gpu")
#: the documents this suite holds, beside the runbook (operations.md), which
#: tests/test_torch_metrics_docs.py holds
GUIDES = ("quickstart.md", "configuration.md", "design.md", "static-analysis.md")
CRDS = os.path.join(REPO, "tpu_operator_torch", "api", "crds")

CITATION = re.compile(r"(tpu_operator_torch/[\w/.-]*\w)(?::(\d+))?")
#: a repository path named in backticks, outside the package
REPO_PATH = re.compile(r"`((?:config|deploy|deployments|docs|hack|tests|bundle-gpu|\.github)"
                       r"/[\w/.-]*\w)`")
#: the reference's tools and hardware: the alert texts' rules and three more
TPU_WORDS = re.compile(TPU_HARDWARE.pattern + r"|google\.com/tpu|tpuop-cfg|opalint", re.I)
#: names the port keeps from the reference, whatever they say: its API group
#: and keys, the package, the namespace, its default host directories,
#: identifiers (constants, env vars, metric families, alert names), the
#: metrics' ``chip`` label, the partition table's ``chips`` key and the
#: suppression marker
KEPT = re.compile(r"\btpu\.ai[\w./<>*-]*|\btpu_operator\w*|\btpu-operator\b|/run/tpu/validations"
                  r"|/var/lib/tpu-partitions|\b[Tt][Pp][Uu]_\w+|\bTPU(?=[A-Z*])\w*\*?"
                  r"|`chips?`|\bchip=|\bchips:|#\s*opalint:\s*disable")
#: a line that names the reference as such may use its words
NAMES_THE_REFERENCE = re.compile(r"reference", re.I)


def _read(name: str) -> str:
    with open(os.path.join(DOCS, name)) as f:
        return f.read()


def _section(text: str, heading: str) -> str:
    """The text under a ``## heading`` up to the next heading of that level."""
    start = text.index(f"\n## {heading}\n")
    end = text.find("\n## ", start + 1)
    return text[start:end if end != -1 else len(text)]


def _table_rows(text: str) -> list:
    return [[c.strip() for c in line.strip().strip("|").split("|")]
            for line in text.splitlines()
            if line.startswith("|") and not set(line) <= set("|-: ")]


# -- citations -----------------------------------------------------------------

@pytest.mark.parametrize("name", GUIDES)
def test_every_citation_names_a_file_and_a_line_within_it(name):
    text = _read(name)
    cited = CITATION.findall(text)
    assert len([1 for _, line in cited if line]) >= 10
    for path, line in cited:
        full = os.path.join(REPO, path)
        assert os.path.exists(full), f"{name} cites {path}, which does not exist"
        if line:
            with open(full) as f:
                n = sum(1 for _ in f)
            assert 1 <= int(line) <= n, f"{name} cites {path}:{line}; it has {n} lines"
    for path in REPO_PATH.findall(text):
        assert os.path.exists(os.path.join(REPO, path)), f"{name} names {path}"
    for link in re.findall(r"\]\(([\w.-]+\.md)\)", text):
        assert os.path.exists(os.path.join(DOCS, link)), f"{name} links {link}"


def test_a_missing_file_or_a_line_past_its_end_is_caught():
    cited = CITATION.findall("see `tpu_operator_torch/consts.py:99999` and "
                             "`tpu_operator_torch/nothing.py`")
    assert cited == [("tpu_operator_torch/consts.py", "99999"),
                     ("tpu_operator_torch/nothing.py", "")]
    with open(os.path.join(REPO, cited[0][0])) as f:
        assert sum(1 for _ in f) < 99999
    assert not os.path.exists(os.path.join(REPO, cited[1][0]))


#: a run of backticked names a prose citation is listed with, as in
#: "(`coalesced_patch`, `defer_patch`, `tpu_operator_torch/client/batch.py:444`)"
PROSE_NAMES = re.compile(r"((?:`[A-Za-z_][\w.]*`\s*[,(]\s*)+)`(tpu_operator_torch/[\w/.-]*\w):(\d+)`")
IDENTIFIER = re.compile(r"[A-Za-z_]\w*(?:\.[A-Za-z_]\w*)*")


def _named_citations(text: str) -> list:
    """(path, line, names) for each citation that sits next to names: in a
    call-stack block, the names on its line, or on the line before when it
    stands alone; in prose, the backticked names listed just before it."""
    out, in_block, before = [], False, ""
    for line in text.splitlines():
        if line.startswith("```"):
            in_block, before = not in_block, ""
            continue
        if in_block:
            rest = CITATION.sub(" ", line)
            names = IDENTIFIER.findall(rest) or IDENTIFIER.findall(CITATION.sub(" ", before))
            out += [(path, n, names) for path, n in CITATION.findall(line) if n]
            before = line
            continue
        out += [(path, n, re.findall(r"`([^`]+)`", names))
                for names, path, n in PROSE_NAMES.findall(line)]
    return out


def _definition(path: str, name: str) -> re.Pattern:
    """A line of ``path`` that defines ``name``: a def or class (a method
    too), a module-level assignment, or in C++ a function's declarator."""
    last = re.escape(name)
    if path.endswith(".py"):
        return re.compile(rf"\s*(?:async\s+)?(?:def|class)\s+{last}\b|{last}\s*(?::[^=]*)?=[^=]")
    return re.compile(rf"(?:[\w:<>*&]+\s+)+\**{last}\s*\(")


def _defines_one_of(path: str, line: int, names: list):
    """None when ``path`` defines none of ``names`` (words, not symbols);
    else whether its line ``line`` defines one of them (of a dotted
    ``Class.method``, the class or the method)."""
    with open(os.path.join(REPO, path)) as f:
        lines = f.read().splitlines()
    parts = [part for name in names for part in name.split(".")]
    defined = [p for p in parts if any(_definition(path, p).match(t) for t in lines)]
    if not defined:
        return None
    return any(_definition(path, p).match(lines[line - 1]) for p in defined)


@pytest.mark.parametrize("name", GUIDES)
def test_a_citation_beside_a_name_is_that_name_s_definition(name):
    """Where a citation sits beside a name the cited file defines (the
    design's call stacks, "`OPERAND_DAG`, `.../operands.py:52`"), the cited
    line is that definition, so an edit that moves it is caught."""
    checked = 0
    for path, line, names in _named_citations(_read(name)):
        verdict = _defines_one_of(path, int(line), names)
        if verdict is None:
            continue
        checked += 1
        assert verdict, f"{name} cites {path}:{line} beside {names}, which it does not define"
    assert checked >= {"configuration.md": 1, "design.md": 80, "static-analysis.md": 4}.get(name, 0)


def test_a_moved_definition_is_caught():
    text = ("```\n└─ run_operator                  tpu_operator_torch/controllers/manager.py:2\n"
            "└─ build_client\n                    tpu_operator_torch/controllers/manager.py:3\n```\n"
            "the DAG (`OPERAND_DAG`, `tpu_operator_torch/state/operands.py:1`)\n")
    cited = _named_citations(text)
    assert [(p.rsplit("/", 1)[1], n, names[0]) for p, n, names in cited] == [
        ("manager.py", "2", "run_operator"), ("manager.py", "3", "build_client"),
        ("operands.py", "1", "OPERAND_DAG")]
    assert [_defines_one_of(p, int(n), names) for p, n, names in cited] == [False] * 3
    assert _defines_one_of("tpu_operator_torch/state/operands.py", 1, ["the", "DAG"]) is None


# -- configuration.md ------------------------------------------------------------

def _crd_rows(filename: str) -> list:
    """(field, type, default) for every leaf of a generated CRD's spec, as the
    configuration reference writes them."""
    with open(os.path.join(CRDS, filename)) as f:
        crd = yamlsubset.parse(f.read())
    spec = crd["spec"]["versions"][0]["schema"]["openAPIV3Schema"]["properties"]["spec"]
    rows = []

    def walk(node, path):
        if node.get("type") == "object" and node.get("properties"):
            for key, child in node["properties"].items():
                walk(child, f"{path}.{key}")
            return
        kind = node.get("type") or "any"
        if node.get("x-kubernetes-int-or-string"):
            kind = "int-or-string"
        elif kind == "array":
            kind = f"array of {node.get('items', {}).get('type', 'any')}"
        default = "—" if "default" not in node else f"`{json.dumps(node['default'])}`"
        rows.append([f"`{path}`", kind, default])

    walk(spec, "spec")
    return rows


def _field_tables(text: str) -> list:
    """The field tables: each run of rows whose first cell is a spec path."""
    tables, current = [], []
    for line in text.splitlines():
        if line.startswith("| `spec."):
            current.append([c.strip() for c in line.strip().strip("|").split("|")])
        elif current:
            tables.append(current)
            current = []
    return tables + ([current] if current else [])


def test_the_field_tables_are_the_crds():
    tables = _field_tables(_read("configuration.md"))
    assert tables == [_crd_rows("tpu.ai_clusterpolicies.yaml"), _crd_rows("tpu.ai_gpudrivers.yaml")]


def test_a_field_left_out_of_a_table_is_caught():
    text = _read("configuration.md")
    dropped = text.replace("| `spec.psa.enabled` | boolean | `false` |\n", "")
    assert dropped != text
    assert _field_tables(dropped)[0] != _crd_rows("tpu.ai_clusterpolicies.yaml")


def _label_keys() -> set:
    keys = set()
    for name in dir(consts):
        value = getattr(consts, name)
        if "LABEL" in name and isinstance(value, str):
            keys.add(value + "<operand>" if name.endswith("_PREFIX") else value)
    return keys


def test_the_label_table_is_every_label_of_consts():
    rows = _table_rows(_section(_read("configuration.md"), "Labels"))
    documented = set()
    for row in rows[1:]:
        documented |= set(re.findall(r"`([^`]+)`", row[0]))
    assert documented == _label_keys()
    assert consts.deploy_label("<operand>") in documented


# -- static-analysis.md --------------------------------------------------------------

def test_the_rule_table_is_the_registry():
    rows = _table_rows(_section(_read("static-analysis.md"), "Rules"))
    header, body = rows[0], rows[1:]
    assert header[:2] == ["Rule", "Checker"]
    rules = [row[0].strip("`") for row in body]
    registry = all_checkers()
    assert sorted(rules) == sorted(registry) and len(rules) == 17
    for row in body:
        cls = registry[row[0].strip("`")]
        path = os.path.relpath(inspect.getsourcefile(cls), REPO)
        assert row[1] == f"`{path}:{inspect.getsourcelines(cls)[1]}`"


def test_the_guide_names_the_sanitizer_s_switches_and_its_gate():
    text = _read("static-analysis.md")
    switches = [row[0].split("=")[0].strip("`") for row in
                _table_rows(_section(text, "opsan (dynamic)"))[1:]]
    assert switches == [opsan_core.OPSAN_ENV, opsan_core.OPSAN_PERTURB_ENV,
                        opsan_core.OPSAN_REPORT_ENV, perturb.OPSAN_SEED_ENV]
    assert str(perturb.DEFAULT_OPSAN_SEED) in text
    assert "python -m tpu_operator_torch.cmd.opsan check" in text
    assert "tests/cases/torch_opsan/dynamic_edges.json" in text
    assert "`.gpuop-lint-baseline.json`" in text
    with open(os.path.join(REPO, ".gpuop-lint-baseline.json")) as f:
        assert json.load(f)["findings"] == []


# -- quickstart.md ------------------------------------------------------------------

def _set_keys(text: str) -> dict:
    return dict(re.findall(r"--set ([\w.]+)=(\S+)", text))


def test_the_quickstart_s_set_keys_are_the_chart_s_and_render():
    sets = _set_keys(_read("quickstart.md"))
    assert {"operator.image", "operator.version", "driver.repository",
            "driver.version"} <= set(sets)
    chart = os.path.join(REPO, "deployments", "gpu-operator")
    with open(os.path.join(chart, "values.yaml")) as f:
        values = yamlsubset.parse(f.read())
    overrides = {}
    for key, value in sets.items():
        *parents, leaf = key.split(".")
        section, target = values, overrides
        for part in parents:
            section = section[part]
            target = target.setdefault(part, {})
        assert leaf in section, f"--set {key}: no such value in values.yaml"
        target[leaf] = value
    rendered = HelmLite(chart, values=overrides).render_all()
    [cp] = [o for o in rendered if o["kind"] == "ClusterPolicy"]
    assert schema_validate.validate_cr(cp, schema_gen.clusterpolicy_crd()) == []
    assert cp["spec"]["driver"]["repository"] == sets["driver.repository"]
    [deployment] = [o for o in rendered if o["kind"] == "Deployment"]
    [container] = deployment["spec"]["template"]["spec"]["containers"]
    assert container["image"] == f"{sets['operator.image']}:{sets['operator.version']}"


def test_the_quickstart_s_workload_pod_asks_for_a_gpu():
    import chip_smoke

    manifests = chip_smoke.quickstart_manifests(REPO)
    [container] = manifests["pod"]["spec"]["containers"]
    assert container["resources"]["limits"] == {consts.GPU_RESOURCE_NAME: 1}
    assert manifests["pod"]["spec"]["nodeSelector"] == {consts.GPU_PRESENT_LABEL: "true"}
    assert "torch.cuda.device_count()" in " ".join(container["command"])
    assert manifests["disable"] == {"spec": {"telemetry": {"enabled": False}}}
    assert manifests["enable"] == {"spec": {"telemetry": {"enabled": True}}}


@pytest.mark.parametrize("name", GUIDES)
def test_every_yaml_block_is_in_the_port_s_subset(name):
    for block in re.findall(r"```yaml\n(.*?)```", _read(name), re.S):
        assert yamlsubset.parse(block) == yaml.safe_load(block)


# -- design.md ----------------------------------------------------------------------

def _numbered_sections(text: str) -> list:
    return re.findall(r"^## (\d+a?)\. ", text, re.M)


def test_the_design_has_a_section_for_each_of_the_reference_s():
    with open(os.path.join(REPO, "docs", "design.md")) as f:
        reference = _numbered_sections(f.read())
    assert len(reference) == 20
    assert _numbered_sections(_read("design.md")) == reference


# -- words ----------------------------------------------------------------------------

def tpu_words(line: str) -> list:
    """The TPU hardware and reference-tool words a line uses for the port."""
    if NAMES_THE_REFERENCE.search(line):
        return []
    return TPU_WORDS.findall(KEPT.sub("", line))


@pytest.mark.parametrize("name", sorted(os.listdir(DOCS)))
def test_no_line_names_tpu_hardware_or_the_reference_s_tools(name):
    found = {i: tpu_words(line) for i, line in enumerate(_read(name).splitlines(), 1)}
    assert {i: words for i, words in found.items() if words} == {}


def test_the_word_rules_find_a_tpu_word_and_spare_kept_names():
    assert tpu_words("run tpuop-cfg status; libtpu on the TPU's ICI, its MXU chips") == [
        "tpuop-cfg", "libtpu", "TPU", "ICI", "MXU", "chips"]
    assert tpu_words("a `google.com/tpu` limit") == ["google.com/tpu"]
    assert tpu_words("# opalint: disable=api-bypass") == []
    assert tpu_words("the reference's opalint reads libtpu") == []
    assert tpu_words("`tpu.ai/tpu.chip-type` in `/run/tpu/validations`, "
                     "`TPU_CHIP_TYPE_LABEL`, `tpu_chip_up{chip=\"0\"}`, TPUNodeDriverNotReady") == []
