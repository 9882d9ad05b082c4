"""The port's install channels against the reference's (the twins of
tests/test_chart.py): the chart ``deployments/gpu-operator`` rendered by the
port's helmlite, the static install ``deploy/gpu-operator.yaml`` and the OLM
bundle ``bundle-gpu/manifests/``.

Where the two are comparable the same values go through both charts and the
reference's render is mapped (tests/test_torch_operator_mapping.py:
:func:`map_chart_object`) before a field-by-field comparison. The one
deliberate difference is the ClusterRole: it is derived from the requests
the port's operator makes, which the reference's rules do not all grant
(:data:`~test_torch_operator_mapping.RBAC_NOT_IN_REFERENCE`), and
:func:`test_the_cluster_role_grants_every_request_the_operator_makes` holds
it to them.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import yaml

from test_torch_operator_mapping import (
    RBAC_NOT_IN_REFERENCE,
    map_chart_object,
    map_chart_values,
    map_labels,
)
from tpu_operator.api import schema_gen as ref_schema_gen
from tpu_operator.testing.helmlite import HelmLite as RefHelmLite
from tpu_operator_torch import consts, yamlsubset
from tpu_operator_torch.api import schema_gen, schema_validate
from tpu_operator_torch.cfgtool.main import run
from tpu_operator_torch.testing.helmlite import HelmLite, apply, install_order

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHART = os.path.join(REPO, "deployments", "gpu-operator")
REF_CHART = os.path.join(REPO, "deployments", "tpu-operator")
STATIC = os.path.join(REPO, "deploy", "gpu-operator.yaml")
BUNDLE = os.path.join(REPO, "bundle-gpu", "manifests")
CSV = os.path.join(BUNDLE, "gpu-operator.clusterserviceversion.yaml")

#: values keys that configure the chart itself, not the ClusterPolicy spec
CHART_ONLY_KEYS = {"gpuDriver"}
#: operator-section keys the Deployment template reads, not the CR
OPERATOR_CHART_KEYS = {"image", "version", "imagePullPolicy", "replicas",
                       "resources", "leaderElect", "logLevel", "extraArgs"}


@pytest.fixture(scope="module")
def rendered():
    return HelmLite(CHART).render_all()


def _spec_props(crd):
    return crd["spec"]["versions"][0]["schema"]["openAPIV3Schema"]["properties"]["spec"][
        "properties"]


def _kinds(objs):
    return sorted((o["kind"], o["metadata"]["name"]) for o in objs)


def test_render_produces_all_install_objects(rendered):
    kinds = _kinds(rendered)
    for want in (("ClusterPolicy", "cluster-policy"), ("Deployment", "gpu-operator"),
                 ("ServiceAccount", "gpu-operator"), ("ClusterRole", "gpu-operator"),
                 ("ClusterRoleBinding", "gpu-operator"),
                 ("CustomResourceDefinition", "clusterpolicies.tpu.ai"),
                 ("CustomResourceDefinition", "gpudrivers.tpu.ai")):
        assert want in kinds
    # the reference's chart renders the same objects, renamed
    assert _kinds(map_chart_object(o) for o in RefHelmLite(REF_CHART).render_all()) == kinds


def test_rendered_clusterpolicy_passes_crd_schema(rendered):
    """The CR the chart installs is admitted by the schema a real apiserver
    enforces, and its spec loads into the dataclasses."""
    from tpu_operator_torch.api.clusterpolicy import ClusterPolicy

    cp = next(o for o in rendered if o["kind"] == "ClusterPolicy")
    assert schema_validate.validate_cr(cp, schema_gen.clusterpolicy_crd()) == []
    assert ClusterPolicy.from_obj(cp).spec.validate() == []


OPERATOR_VALUES = {"operator": {"runtimeClass": "custom-gpu", "labels": {"team": "ml"},
                                "annotations": {"note": "x"},
                                "initContainer": {"image": "busybox", "version": "1.36"}}}


def test_operator_cr_fields_actually_render():
    """operator.runtimeClass, labels, annotations and initContainer land in
    the CR, as in the reference's render of the same values."""
    cp = next(o for o in HelmLite(CHART, values=OPERATOR_VALUES).render_all()
              if o["kind"] == "ClusterPolicy")
    ref_values = {"operator": dict(OPERATOR_VALUES["operator"], runtimeClass="custom-tpu")}
    ref = next(o for o in RefHelmLite(REF_CHART, values=ref_values).render_all()
               if o["kind"] == "ClusterPolicy")
    op = cp["spec"]["operator"]
    assert op == dict(ref["spec"]["operator"], runtimeClass="custom-gpu")
    assert op["labels"] == {"team": "ml"} and op["initContainer"]["image"] == "busybox"
    assert schema_validate.validate_cr(cp, schema_gen.clusterpolicy_crd()) == []


def test_gpudriver_variant_passes_crd_schema():
    ref_values = {"tpuDriver": {"enabled": True, "name": "pool-a", "nodeSelector": {
        "cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice"}}}
    ref = next(o for o in RefHelmLite(REF_CHART, values=ref_values).render_all()
               if o["kind"] == "TPUDriver")
    values = map_chart_values(ref_values)
    assert values == {"gpuDriver": {"enabled": True, "name": "pool-a", "nodeSelector": {
        consts.GKE_ACCELERATOR_LABEL: "nvidia-h100-80gb"}}}
    drv = next(o for o in HelmLite(CHART, values=values).render_all() if o["kind"] == "GPUDriver")
    assert schema_validate.validate_cr(drv, schema_gen.gpudriver_crd()) == []
    assert drv["spec"]["nodeSelector"] == map_labels(ref["spec"]["nodeSelector"])
    assert drv["metadata"] == {"name": "pool-a"}
    assert drv["spec"]["driverType"] == "standard"
    # the driver's version rides along when set
    drv = next(o for o in HelmLite(CHART, values=dict(values, driver={
        "driverVersion": "580.95.05"})).render_all() if o["kind"] == "GPUDriver")
    assert drv["spec"]["driverVersion"] == "580.95.05"
    assert schema_validate.validate_cr(drv, schema_gen.gpudriver_crd()) == []


def test_values_cover_every_crd_spec_field():
    """1:1 coverage: every property the ClusterPolicy schema accepts appears
    in values.yaml, as a live key or a documented commented-out default,
    as the reference's values cover its CRD."""
    values_text = open(os.path.join(CHART, "values.yaml")).read()
    values = yamlsubset.parse(values_text)
    missing = []
    for section, schema in _spec_props(schema_gen.clusterpolicy_crd()).items():
        section_values = values.get(section)
        if section_values is None:
            missing.append(section)
            continue
        m = re.search(rf"^{section}:\n((?:[ #].*\n|\n)*)", values_text, re.MULTILINE)
        section_text = m.group(1) if m else ""
        for prop in schema.get("properties", {}):
            if section == "operator" and prop in OPERATOR_CHART_KEYS:
                continue
            if prop in section_values or f"{prop}:" in section_text:
                continue
            missing.append(f"{section}.{prop}")
    assert missing == [], f"values.yaml misses CRD fields: {missing}"
    # the port's CRD has every section of the reference's: the chart covers
    # the same spec
    assert set(_spec_props(schema_gen.clusterpolicy_crd())) == \
        set(_spec_props(ref_schema_gen.clusterpolicy_crd()))


def test_no_unknown_values_keys():
    """Every ClusterPolicy-bound values key is one the schema accepts, and
    each default is the CRD's own."""
    spec_props = _spec_props(schema_gen.clusterpolicy_crd())
    values = yamlsubset.parse(open(os.path.join(CHART, "values.yaml")).read())
    for section, content in values.items():
        if section in CHART_ONLY_KEYS:
            continue
        assert section in spec_props, f"values section {section} not in CRD"
        schema = spec_props[section].get("properties", {})
        for key, value in (content or {}).items():
            if section == "operator" and key in OPERATOR_CHART_KEYS:
                continue
            assert key in schema, f"values.{section}.{key} not in CRD schema"
            if "default" in schema[key]:
                assert value == schema[key]["default"], f"values.{section}.{key}"


def _container(dep):
    return dep["spec"]["template"]["spec"]["containers"][0]


def _static_docs():
    with open(STATIC) as f:
        return yamlsubset.parse_all(f.read())


def test_chart_deployment_matches_static_install(rendered):
    """The chart and the static install are two routes to the same operator:
    past the CRDs, the static install holds exactly the chart's render at
    default values (its Namespace the one helm install --create-namespace
    makes), and their container is the reference's with the port's names."""
    static = _static_docs()
    assert [d["kind"] for d in static] == [
        "CustomResourceDefinition", "CustomResourceDefinition", "Namespace",
        "ServiceAccount", "ClusterRole", "ClusterRoleBinding", "Deployment"]
    chart = install_order([o for o in HelmLite(CHART).render_all(create_namespace=True)
                           if o["kind"] not in ("ClusterPolicy", "CustomResourceDefinition")])
    assert static[2:] == chart
    ctr = _container(next(o for o in rendered if o["kind"] == "Deployment"))
    ref = _container(next(o for o in RefHelmLite(REF_CHART).render_all()
                          if o["kind"] == "Deployment"))
    assert ctr["command"] == ["gpu-operator"] == [map_chart_object(ref)["command"][0]]
    assert [e["name"] for e in ctr["env"]] == [e["name"] for e in ref["env"]]
    assert [p["containerPort"] for p in ctr["ports"]] == \
        [p["containerPort"] for p in ref["ports"]]
    # the command is the console script of the operator's entry point
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["gpu-operator"] == "tpu_operator_torch.cmd.operator:main"
    # its flags are the operator's own
    from tpu_operator_torch.cmd.operator import build_parser

    args = build_parser().parse_args(ctr["args"])
    assert args.leader_elect and args.log_level == "info"
    # the six image envs the port's specs read as their defaults
    from tpu_operator_torch.api import clusterpolicy

    envs = {f.default for cls in vars(clusterpolicy).values() if isinstance(cls, type)
            for f in getattr(cls, "__dataclass_fields__", {}).values()
            if f.name == "DEFAULT_IMAGE_ENV"} - {""}
    assert envs == {e["name"] for e in ctr["env"]} - {"OPERATOR_NAMESPACE"}
    namespace_env = next(e for e in ctr["env"] if e["name"] == consts.NAMESPACE_ENV)
    assert namespace_env["valueFrom"]["fieldRef"]["fieldPath"] == "metadata.namespace"


def test_chart_crds_identical_to_canonical():
    for fname in sorted(schema_gen.generate_crds()):
        canonical = open(os.path.join(REPO, "tpu_operator_torch", "api", "crds", fname)).read()
        assert open(os.path.join(CHART, "crds", fname)).read() == canonical
        assert open(os.path.join(BUNDLE, fname)).read() == canonical
    crds = [d for d in _static_docs() if d["kind"] == "CustomResourceDefinition"]
    assert crds == list(schema_gen.generate_crds().values())


def test_validate_csv_checks_crd_presence(capsys):
    assert run(["validate-csv", CSV]) == 0
    out = capsys.readouterr().out
    assert "clusterpolicies.tpu.ai: shipped" in out
    assert "gpudrivers.tpu.ai: shipped" in out


def test_validate_csv_fails_when_crds_absent(tmp_path, capsys):
    dst = tmp_path / "csv.yaml"
    shutil.copy(CSV, dst)  # the CSV alone, no CRD file beside it
    assert run(["validate-csv", str(dst)]) == 1
    assert "NOT shipped" in capsys.readouterr().out


def _csv():
    with open(CSV) as f:
        return yamlsubset.parse(f.read())


def _rules(objs, name="gpu-operator"):
    return next(o for o in objs if o["kind"] == "ClusterRole"
                and o["metadata"]["name"] == name)["rules"]


def _norm(rules):
    return sorted((tuple(sorted(r.get("apiGroups", []))), tuple(sorted(r.get("resources", []))),
                   tuple(sorted(r.get("verbs", [])))) for r in rules)


def test_rbac_rules_identical_across_install_channels(rendered):
    """The ClusterRole exists in three copies (the chart's rbac.yaml, the
    static install, the CSV's clusterPermissions): a rule added to one and
    not the others ships a channel whose operator gets Forbidden. The CSV's
    Deployment is the chart's, its images digest-pinned."""
    chart_rules = _rules(rendered)
    csv = _csv()
    csv_rules = csv["spec"]["install"]["spec"]["clusterPermissions"][0]["rules"]
    assert _norm(chart_rules) == _norm(_rules(_static_docs())) == _norm(csv_rules)
    # least privilege: no channel grants a wildcard
    for rule in chart_rules:
        for field in ("apiGroups", "resources", "verbs"):
            assert "*" not in rule.get(field, []), rule
    [csv_dep] = csv["spec"]["install"]["spec"]["deployments"]
    chart_dep = next(o for o in rendered if o["kind"] == "Deployment")

    def unpinned(spec):
        text = json.dumps(spec)
        return json.loads(re.sub(r"@sha256:[0-9a-f]{64}", "", text))

    assert csv_dep["name"] == chart_dep["metadata"]["name"]
    assert unpinned(csv_dep["spec"]) == chart_dep["spec"]
    assert csv["spec"]["install"]["spec"]["clusterPermissions"][0]["serviceAccountName"] == \
        next(o for o in rendered if o["kind"] == "ServiceAccount")["metadata"]["name"]


# -- helmlite against PyYAML ----------------------------------------------------------

@pytest.mark.parametrize("values", [None, OPERATOR_VALUES,
                                    {"gpuDriver": {"enabled": True}, "operator": {
                                        "leaderElect": False, "extraArgs": ["--no-cache-reads"]}}],
                         ids=["defaults", "operator-fields", "gpudriver-no-election"])
def test_helmlite_parses_each_render_as_pyyaml_does(values):
    """Every template's render, the chart's files and its CRDs read the same
    through the subset as through yaml.safe_load (PyYAML only here)."""
    helm = HelmLite(CHART, values=values)
    for fname in sorted(os.listdir(os.path.join(CHART, "templates"))):
        if fname.startswith("_"):
            continue
        text = helm.render_template(fname)
        assert yamlsubset.parse_all(text) == [d for d in yaml.safe_load_all(text) if d], fname
    for path in (os.path.join(CHART, "Chart.yaml"), os.path.join(CHART, "values.yaml"),
                 STATIC, CSV):
        text = open(path).read()
        assert yamlsubset.parse_all(text) == [d for d in yaml.safe_load_all(text) if d], path
    dep = next(o for o in helm.render_all() if o["kind"] == "Deployment")
    if values and "gpuDriver" in values:
        assert _container(dep)["args"] == ["--log-level=info", "--no-cache-reads"]


@pytest.mark.parametrize("template", [
    "x: {{ .Values.operator }}\n",                   # a structure inline
    "x: {{ .Foo }}\n",                                # outside .Values/.Release/.Chart
    "{{- with .Values.operator }}\nx: {{ .Values.operator.image }}\n{{- end }}\n",
    "x: {{ .Values.operator.image | quote }}\n",     # a pipeline
    "{{- if .Values.operator.leaderElect }}\nx: 1\n",  # no end
], ids=["structure", "root", "with-rebinds", "pipeline", "unterminated"])
def test_helmlite_raises_outside_its_subset(tmp_path, template):
    chart = tmp_path / "chart"
    shutil.copytree(CHART, chart)
    (chart / "templates" / "probe.yaml").write_text(template)
    with pytest.raises(ValueError):
        HelmLite(str(chart)).render_all()
    with pytest.raises(ValueError):
        RefHelmLite(str(chart)).render_all()


# -- schema_gen --check covers every copy ---------------------------------------------

def test_schema_gen_check_passes_on_the_tree():
    result = subprocess.run([sys.executable, "-m", "tpu_operator_torch.api.schema_gen",
                             "--check"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr


@pytest.mark.parametrize("copy", ["tpu_operator_torch/api/crds/tpu.ai_gpudrivers.yaml",
                                  "deployments/gpu-operator/crds/tpu.ai_clusterpolicies.yaml",
                                  "bundle-gpu/manifests/tpu.ai_gpudrivers.yaml",
                                  "deploy/gpu-operator.yaml"])
def test_schema_gen_check_fails_on_one_edited_copy(tmp_path, copy):
    for rel in ("tpu_operator_torch/api/crds", "deployments/gpu-operator/crds",
                "bundle-gpu/manifests"):
        shutil.copytree(os.path.join(REPO, rel), tmp_path / rel)
    (tmp_path / "deploy").mkdir()
    shutil.copy(STATIC, tmp_path / "deploy" / "gpu-operator.yaml")
    argv = [sys.executable, "-m", "tpu_operator_torch.api.schema_gen", "--repo", str(tmp_path)]
    check = subprocess.run(argv + ["--check"], cwd=REPO, capture_output=True, text=True,
                           timeout=120)
    assert check.returncode == 0, check.stderr
    path = tmp_path / copy
    path.write_text(path.read_text().replace("format: \"int64\"", "format: \"int32\"", 1))
    check = subprocess.run(argv + ["--check"], cwd=REPO, capture_output=True, text=True,
                           timeout=120)
    assert check.returncode == 1 and f"STALE: {path}" in check.stderr
    assert subprocess.run(argv + ["--write"], cwd=REPO, capture_output=True,
                          timeout=120).returncode == 0
    assert subprocess.run(argv + ["--check"], cwd=REPO, capture_output=True,
                          timeout=120).returncode == 0


# -- the ClusterRole against the operator's own requests --------------------------------

NS = consts.DEFAULT_NAMESPACE
#: the chart values the RBAC drive installs with: the driver rolls on a
#: version bump and drains the tenant's pods, the autoscaler and the
#: migration controller are on, PSA labels the namespace
RBAC_VALUES = {
    "driver": {"repository": "registry.example", "image": "driver", "version": "1.0",
               "upgradePolicy": {"autoUpgrade": True, "maxParallelUpgrades": 2,
                                 "maxUnavailable": "100%",
                                 "podDeletion": {"timeoutSeconds": 60},
                                 "drain": {"enable": True, "podSelector": "team=ml",
                                           "timeoutSeconds": 60}}},
    "validator": {"revalidateIntervalS": 0},
    "health": {"enabled": False, "drainDeadlineS": 30},
    "psa": {"enabled": True},
    "autoscale": {"enabled": True, "cooldownS": 0, "scaleDownDelayS": 3600, "windowS": 10,
                  "minNodes": {"default": 1}, "maxNodes": {"default": 5}},
    "migrate": {"enabled": True, "snapshotWaitS": 10, "restoreWaitS": 30},
}
GPU_MODEL = "nvidia-h100-80gb"
#: each wait's own bound
WAIT_S = 60.0


def rbac_of(method: str, path: str):
    """(apiGroup, resource[/subresource], verb) a request needs, or None for
    a non-resource URL (``/version``, which every authenticated user may
    read)."""
    parts = [p for p in path.split("?")[0].split("/") if p]
    if parts[:1] == ["api"]:
        group, rest = "", parts[2:]
    elif parts[:1] == ["apis"]:
        group, rest = parts[1], parts[3:]
    else:
        return None
    if rest[:1] == ["namespaces"] and len(rest) >= 3:
        rest = rest[2:]
    resource = rest[0] + (f"/{rest[2]}" if len(rest) > 2 else "")
    named = len(rest) > 1
    verb = {"WATCH": "watch", "GET": "get" if named else "list", "POST": "create",
            "PUT": "update", "PATCH": "patch",
            "DELETE": "delete" if named else "deletecollection"}[method]
    return group, resource, verb


def grants(rules, need) -> bool:
    group, resource, verb = need
    return any(group in r.get("apiGroups", []) and resource in r.get("resources", [])
               and verb in r.get("verbs", []) for r in rules)


def _wait(predicate, message, timeout=WAIT_S, state=None):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if predicate():
                return
        except Exception:  # a read racing a write: try again
            pass
        time.sleep(0.05)
    raise AssertionError(f"timed out ({timeout} s) waiting for {message}"
                         + (f": {state()}" if state else ""))


def _gpu_node(name):
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": {consts.NFD_NVIDIA_PCI_LABEL: "true",
                                                  consts.GKE_ACCELERATOR_LABEL: GPU_MODEL}},
            "spec": {}, "status": {"capacity": {consts.GPU_RESOURCE_NAME: "8"}}}


def drive_the_operator(monkeypatch, tmp_path) -> set:
    """The port's operator, as run_operator assembles it under
    --leader-elect, over a RestClient against a MiniApiServer, installed from
    the chart: ready; a GPUDriver and back; a driver upgrade that evicts a
    tenant's pod under a PodDisruptionBudget; an autoscale up; one migration;
    an autoscale down. Everything else (the kubelet, the tenant, the admin)
    writes to the server's backend in process, so the operator is the one
    HTTP client. Returns the (method, path) of every request it made."""
    from tpu_operator_torch.client import rest
    from tpu_operator_torch.cmd.operator import build_parser
    from tpu_operator_torch.controllers.leader import LeaderElector
    from tpu_operator_torch.controllers.manager import OperatorApp, build_client
    from tpu_operator_torch.health import drain
    from tpu_operator_torch.migrate import agent
    from tpu_operator_torch.migrate.controller import migration_state
    from tpu_operator_torch.testing.apiserver import MiniApiServer
    from tpu_operator_torch.testing.kubelet import KubeletSimulator
    from tpu_operator_torch.testing.trainjob import SimulatedTrainingJob
    from tpu_operator_torch.upgrade import machine
    from tpu_operator_torch.validator.status import StatusFiles

    requests = set()
    real_request, real_stream = rest.RestClient._request, rest._RestWatch._stream

    def recording_request(self, method, path, *args, **kw):
        requests.add((method, path))
        return real_request(self, method, path, *args, **kw)

    def recording_stream(self, rv):
        requests.add(("WATCH", self._client.resource_path(self._api_version, self._kind,
                                                          self._namespace)))
        return real_stream(self, rv)

    monkeypatch.setattr(rest.RestClient, "_request", recording_request)
    monkeypatch.setattr(rest._RestWatch, "_stream", recording_stream)
    monkeypatch.setenv(agent.TRANSFER_DIR_ENV, str(tmp_path / "transfer"))

    helm = HelmLite(CHART, values=RBAC_VALUES, release_namespace=NS)
    objs = helm.render_all(create_namespace=True)
    # the operator's env is the rendered Deployment's
    for env in _container(next(o for o in objs if o["kind"] == "Deployment"))["env"]:
        if "value" in env:
            monkeypatch.setenv(env["name"], env["value"])
    monkeypatch.setenv(consts.NAMESPACE_ENV, NS)

    srv = MiniApiServer()
    base = srv.start()
    raw = srv.backend
    apply(raw, objs)
    for name in ("gpu-node-0", "gpu-node-1"):
        raw.create(_gpu_node(name))
    status = {n: StatusFiles(str(tmp_path / "status" / n)) for n in ("gpu-node-0", "gpu-node-1")}
    kubelet = KubeletSimulator(raw, NS, interval=0.05)
    for name, st in status.items():
        kubelet.attach_migrate_agent(name, st)
    kubelet.start()

    direct = rest.RestClient(base_url=base)
    args = build_parser().parse_args([f"--api-server={base}", "--leader-elect",
                                      *_container(next(o for o in objs
                                                       if o["kind"] == "Deployment"))["args"]])
    client, fenced = build_client(args, direct)
    app = OperatorApp(client, namespace=NS)
    elector = LeaderElector(direct, NS)
    app.elector = elector
    fenced.bind(elector)
    elector.run(on_started=app.start_controllers, on_stopped=lambda: None)

    def policy():
        return raw.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")

    def ready():
        return (policy().get("status") or {}).get("state") == "ready"

    def node(name):
        return raw.get("v1", "Node", name)

    try:
        _wait(ready, "the chart's ClusterPolicy ready")
        # a GPUDriver takes the driver over, and hands it back when deleted
        sample = json.load(open(os.path.join(REPO, "tpu_operator_torch", "manifests",
                                             "samples", "v1alpha1_gpudriver.json")))
        raw.create(sample)
        _wait(lambda: (raw.get("tpu.ai/v1alpha1", "GPUDriver", "default").get("status")
                       or {}).get("state"), "the GPUDriver's status")
        raw.delete("tpu.ai/v1alpha1", "GPUDriver", "default")
        _wait(lambda: raw.get("apps/v1", "DaemonSet", "gpu-driver", NS), "the driver back")
        _wait(ready, "ready after the hand-back")

        # a driver upgrade evicting a tenant's pod under a budget
        raw.create({"apiVersion": "v1", "kind": "Pod",
                    "metadata": {"name": "train-0", "namespace": "ml-team",
                                 "labels": {"team": "ml"}},
                    "spec": {"nodeName": "gpu-node-0", "containers": [{
                        "name": "c", "image": "user:1",
                        "resources": {"limits": {consts.GPU_RESOURCE_NAME: "8"}}}]},
                    "status": {"phase": "Running",
                               "conditions": [{"type": "Ready", "status": "True"}]}})
        raw.create({"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
                    "metadata": {"name": "train", "namespace": "ml-team"},
                    "spec": {"selector": {"matchLabels": {"team": "ml"}}, "minAvailable": 1}})
        raw.patch("tpu.ai/v1", "ClusterPolicy", "cluster-policy",
                  {"spec": {"driver": {"version": "2.0"}}})
        _wait(lambda: any(code == 429 for _, _, _, code in srv.evictions),
              "an eviction the budget refuses")
        raw.delete("policy/v1", "PodDisruptionBudget", "train", "ml-team")
        def driver_images():
            return {p["spec"]["nodeName"]: p["spec"]["containers"][0]["image"]
                    for p in raw.list("v1", "Pod", NS)
                    if p["metadata"]["name"].startswith("gpu-driver-")}

        # done, then settled (the machine clears upgrade-done on its next pass)
        _wait(lambda: driver_images() == {n: "registry.example/driver:2.0" for n in status}
              and all(machine.node_upgrade_state(node(n)) in (machine.DONE, machine.UNKNOWN)
                      and not node(n)["spec"].get("unschedulable") for n in status),
              "the upgrade done on both nodes",
              state=lambda: {n: (node(n)["metadata"]["labels"], node(n)["spec"],
                                 [(p["metadata"]["name"], p["spec"]["containers"][0]["image"])
                                  for p in raw.list("v1", "Pod", NS)
                                  if p["spec"].get("nodeName") == n])
                             for n in status})
        assert any(code == 201 for _, _, name, code in srv.evictions if name == "train-0")

        # autoscale up: a backlog wanting more nodes than the pool has
        def fed(backlog, predicate):
            """``predicate``, with a traffic snapshot at ``backlog`` every
            0.5 s meanwhile, as a traffic feed posts them."""
            last = [0.0]

            def check():
                if time.monotonic() - last[0] >= 0.5:
                    last[0] = time.monotonic()
                    raw.patch("tpu.ai/v1", "ClusterPolicy", "cluster-policy", {"metadata": {
                        "annotations": {consts.TRAFFIC_SNAPSHOT_ANNOTATION: json.dumps({
                            "ts": time.time(), "queue_depth": 0, "backlog_chips": backlog,
                            "attainment": 1.0})}}})
                return predicate()

            return check

        def registered():
            return sorted(n["metadata"]["name"] for n in raw.list("v1", "Node")
                          if consts.AUTOSCALE_MANAGED_LABEL in n["metadata"].get("labels", {}))

        _wait(fed(20.0, registered), "a node registered by the autoscaler")

        # one migration, the tenant acking its drain as its trainer would
        job = SimulatedTrainingJob(raw, "gpu-node-0", status["gpu-node-0"])
        for _ in range(3):
            job.tick()
        raw.patch("v1", "Node", "gpu-node-0", {"metadata": {"annotations": {
            consts.MIGRATE_REQUEST_ANNOTATION: json.dumps({"reason": "rbac",
                                                           "dst": "gpu-node-1"})}}})
        _wait(lambda: drain.node_plan(node("gpu-node-0")) is not None, "the migration's plan")
        job.tick()
        ack = drain.read_drain_ack(status["gpu-node-0"])
        raw.patch("v1", "Node", "gpu-node-0", {"metadata": {"annotations": {
            consts.DRAIN_ACK_ANNOTATION: drain.ack_annotation_value(ack)}}})
        _wait(lambda: (migration_state(node("gpu-node-0")) or {}).get("phase") == "done",
              "the migration done")

        # autoscale down, by a plain drain past its deadline
        raw.patch("tpu.ai/v1", "ClusterPolicy", "cluster-policy", {"spec": {
            "migrate": {"enabled": False}, "health": {"drainDeadlineS": 1},
            "autoscale": {"scaleDownDelayS": 0}}})
        before = registered()
        _wait(fed(0.0, lambda: len(registered()) < len(before)),
              "a node removed by the autoscaler")
    finally:
        elector.release()
        app.stop()
        client.stop()
        direct.stop()
        kubelet.stop()
        srv.stop()
    return requests


def test_the_cluster_role_grants_every_request_the_operator_makes(monkeypatch, tmp_path):
    """Each request the operator makes, as (apiGroup, resource, verb), is
    granted by the chart's ClusterRole (and so by the static install's and
    the CSV's, which carry the same rules). The reference's ClusterRole,
    renamed, does not grant them all: its autoscaler's node create and
    delete would get 403 from a real apiserver
    (:data:`RBAC_NOT_IN_REFERENCE`), and so would its cache's reads of the
    namespace it labels for PSA."""
    requests = drive_the_operator(monkeypatch, tmp_path)
    needs = {rbac_of(m, p) for m, p in requests} - {None}
    rules = _rules(HelmLite(CHART).render_all())
    assert sorted(n for n in needs if not grants(rules, n)) == []
    # what the drive covered: every controller's writes, the eviction, the
    # lease, the registrations and the removal
    for need in (("", "nodes", "create"), ("", "nodes", "delete"), ("", "nodes", "patch"),
                 ("", "pods/eviction", "create"), ("coordination.k8s.io", "leases", "update"),
                 ("tpu.ai", "gpudrivers/status", "update"), ("", "namespaces", "patch"),
                 ("tpu.ai", "clusterpolicies/status", "update"), ("apps", "daemonsets", "watch"),
                 ("", "namespaces", "watch")):
        assert need in needs, need
    ref_rules = [map_chart_object(r) for r in _rules(RefHelmLite(REF_CHART).render_all(),
                                                     "tpu-operator")]
    assert {n for n in needs if not grants(ref_rules, n)} == RBAC_NOT_IN_REFERENCE


def test_the_apiserver_routes_a_namespace_and_keeps_its_framing():
    """The port's apiserver serves a Namespace by name (the PSA label
    patch above), and a request it refuses before reading its body leaves
    the keep-alive connection's next request intact. The reference's
    server answers the Namespace's path 404 (ROADMAP Queue 3)."""
    import http.client

    from tpu_operator.testing import MiniApiServer as RefServer
    from tpu_operator_torch.testing.apiserver import MiniApiServer

    answers = []
    for Server in (RefServer, MiniApiServer):
        srv = Server()
        base = srv.start()
        try:
            srv.backend.create({"apiVersion": "v1", "kind": "Namespace",
                                "metadata": {"name": NS}})
            conn = http.client.HTTPConnection(base.split("//", 1)[1], timeout=10)
            got = []
            for method, path, body in (
                    ("PATCH", f"/api/v1/namespaces/{NS}/nopes/x", {"metadata": {}}),
                    ("PATCH", f"/api/v1/namespaces/{NS}",
                     {"metadata": {"labels": {"pod-security.kubernetes.io/enforce":
                                              "privileged"}}}),
                    ("GET", f"/api/v1/namespaces/{NS}", None)):
                conn.request(method, path, body=None if body is None else json.dumps(body),
                             headers={"Content-Type": "application/merge-patch+json"})
                resp = conn.getresponse()
                payload = resp.read()
                got.append((resp.status, (json.loads(payload).get("metadata") or {}).get(
                    "labels") if resp.status == 200 else None))
            conn.close()
            answers.append(got)
        finally:
            srv.stop()
    ref, port = answers
    assert port == [(404, None),
                    (200, {"pod-security.kubernetes.io/enforce": "privileged"}),
                    (200, {"pod-security.kubernetes.io/enforce": "privileged"})]
    assert ref[0][0] == 404 and ref[1][0] != 200
