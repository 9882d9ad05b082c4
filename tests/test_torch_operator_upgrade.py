"""The operator's own upgrade, on each package (the twins of
tests/test_operator_upgrade.py): a CRD field added or removed over live
CRs, a ``helm upgrade`` of each package's chart over live CRs, and the
CSV's ``replaces`` edge.

Each e2e runs on both packages, each package's operator over its
``RestClient`` against its own ``MiniApiServer``, with its in-memory
kubelet; the reference's Node is mapped onto the port's
(tests/test_torch_operator_mapping.py), and the two must end alike: the
same state, the same conditions verdict, the same surviving and pruned
fields. Every wait has its own bound of 45 s.
"""

import copy
import os
import shutil
import time
import types

import pytest
import yaml

from test_torch_operator_mapping import map_node
from tpu_operator import consts as ref_consts
from tpu_operator.api.clusterpolicy import new_cluster_policy as ref_new_policy
from tpu_operator.cfgtool.main import run as ref_run
from tpu_operator.client.errors import AlreadyExistsError as RefAlreadyExists
from tpu_operator.client.errors import InvalidError as RefInvalid
from tpu_operator.client.fake import _default_crd_schemas as ref_schemas
from tpu_operator.client.rest import RestClient as RefRest
from tpu_operator.controllers.manager import OperatorApp as RefApp
from tpu_operator.testing import MiniApiServer as RefServer
from tpu_operator.testing.helmlite import HelmLite as RefHelm
from tpu_operator.testing.kubelet import KubeletSimulator as RefKubelet
from tpu_operator_torch import yamlsubset
from tpu_operator_torch.api.clusterpolicy import new_cluster_policy
from tpu_operator_torch.cfgtool.main import run
from tpu_operator_torch.client.errors import InvalidError
from tpu_operator_torch.client.fake import _default_crd_schemas
from tpu_operator_torch.client.rest import RestClient
from tpu_operator_torch.controllers.manager import OperatorApp
from tpu_operator_torch.testing import helmlite
from tpu_operator_torch.testing.apiserver import MiniApiServer
from tpu_operator_torch.testing.kubelet import KubeletSimulator
from tpu_operator_torch.utils import deep_get

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CP_KEY = ("tpu.ai/v1", "ClusterPolicy")
TPU_LABELS = {ref_consts.GKE_TPU_ACCELERATOR_LABEL: "tpu-v5-lite-podslice",
              ref_consts.GKE_TPU_TOPOLOGY_LABEL: "2x4"}


def _ref_helm_apply(client, objs):
    """The reference test's ``helm upgrade``: create, or update over the live
    object (the reference has no helmlite ``apply``)."""
    for obj in objs:
        try:
            client.create(obj)
        except RefAlreadyExists:
            live = client.get(obj["apiVersion"], obj["kind"], obj["metadata"]["name"],
                              obj["metadata"].get("namespace"))
            obj = copy.deepcopy(obj)
            obj["metadata"]["resourceVersion"] = live["metadata"]["resourceVersion"]
            client.update(obj)


REF = types.SimpleNamespace(
    name="reference", port=False, Server=RefServer, Rest=RefRest, App=RefApp,
    Kubelet=lambda c: RefKubelet(c, interval=0.03), schemas=ref_schemas,
    new_policy=ref_new_policy, Invalid=RefInvalid,
    chart=lambda: RefHelm(os.path.join(REPO, "deployments", "tpu-operator"), values={
        "operator": {"repository": "gcr.io/tpu", "image": "tpu-operator", "version": "0.2.0"}}),
    apply=_ref_helm_apply,
    node=lambda: {"apiVersion": "v1", "kind": "Node",
                  "metadata": {"name": "tpu-0", "labels": dict(TPU_LABELS)}, "status": {}})
PORT = types.SimpleNamespace(
    name="port", port=True, Server=MiniApiServer, Rest=RestClient, App=OperatorApp,
    Kubelet=lambda c: KubeletSimulator(c, interval=0.03), schemas=_default_crd_schemas,
    new_policy=new_cluster_policy, Invalid=InvalidError,
    chart=lambda: helmlite.HelmLite(os.path.join(REPO, "deployments", "gpu-operator"), values={
        "operator": {"image": "registry.example.com/gpu-operator/gpu-operator",
                     "version": "0.2.0"}}),
    apply=lambda client, objs: helmlite.apply(client, objs),
    node=lambda: map_node(REF.node()))


@pytest.fixture(autouse=True)
def default_images(monkeypatch):
    for env in ("DRIVER_IMAGE", "VALIDATOR_IMAGE", "FEATURE_DISCOVERY_IMAGE",
                "TELEMETRY_EXPORTER_IMAGE", "SLICE_PARTITIONER_IMAGE"):
        monkeypatch.setenv(env, "registry.example/validator:0.1.0")
    monkeypatch.setenv("DEVICE_PLUGIN_IMAGE", "registry.example/device-plugin:0.1.0")


def wait_for(predicate, timeout=45.0, interval=0.05, message="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {message}")


class Cluster:
    """One package's harness: its server, a plain client, its in-memory
    kubelet and the operators started on it."""

    def __init__(self, s):
        self.s = s
        self.srv = s.Server()
        self.base = self.srv.start()
        self.client = s.Rest(base_url=self.base)
        self.kubelet = s.Kubelet(self.client).start()
        self.apps = []

    def start_operator(self):
        app = self.s.App(self.s.Rest(base_url=self.base))
        self.apps.append(app)
        app.start()
        return app

    def policy(self):
        return self.client.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")

    def state(self):
        return deep_get(self.policy(), "status", "state")

    def wait_ready(self, message):
        wait_for(lambda: self.state() == "ready", message=f"{self.s.name}: {message}")

    def converge_v1(self, spec=None):
        self.client.create(self.s.node())
        self.client.create(self.s.new_policy(spec=spec))
        app = self.start_operator()
        self.wait_ready("initial ready")
        return app

    def stop(self):
        for app in self.apps:
            app.stop()
        self.kubelet.stop()
        self.srv.stop()


def on_both(case):
    """``case`` on each package; the observations must agree."""
    out = []
    for s in (REF, PORT):
        cluster = Cluster(s)
        try:
            out.append(case(cluster))
        finally:
            cluster.stop()
    ref, port = out
    assert port == ref
    return port


def schemas_with(schemas, field, description):
    out = copy.deepcopy(schemas())
    out[CP_KEY]["properties"]["spec"]["properties"][field] = {
        "type": "string", "description": description}
    return out


def test_crd_upgrade_added_field_over_live_crs():
    """vN -> vN+1 adds a spec field: the live CR written under vN reconciles
    under the new operator and schema, keeps its status, takes the new field
    and still refuses a typo."""
    def case(c):
        old_app = c.converge_v1()
        before = c.policy()
        old_app.stop()
        c.srv.backend._crd_schemas = schemas_with(c.s.schemas, "futureFeature", "added in vN+1")
        c.start_operator()
        c.wait_ready("ready under vN+1")
        after = c.policy()
        ready = [cond["status"] for cond in after["status"]["conditions"]
                 if cond["type"] == "Ready"]
        same_uid = after["metadata"]["uid"] == before["metadata"]["uid"]
        c.client.patch("tpu.ai/v1", "ClusterPolicy", "cluster-policy",
                       {"spec": {"futureFeature": "on"}})
        written = c.policy()["spec"]["futureFeature"]
        c.wait_ready("ready after the new field's write")
        with pytest.raises(c.s.Invalid):
            c.client.create(c.s.new_policy("typo", {"futureFeatuer": "x"}))
        return {"state": after["status"]["state"], "ready": ready, "same_uid": same_uid,
                "written": written}

    assert on_both(case) == {"state": "ready", "ready": ["True"], "same_uid": True,
                             "written": "on"}


def test_crd_upgrade_removed_field_prunes_not_wedges():
    """A CR stored under vN with a field vN+1 removed keeps reconciling:
    the next persisting write prunes the field instead of every status
    update being refused (the operator-upgrade wedge)."""
    def case(c):
        c.srv.backend._crd_schemas = schemas_with(c.s.schemas, "legacyKnob",
                                                  "deprecated; removed in vN+1")
        old_app = c.converge_v1(spec={"legacyKnob": "tuned"})
        stored = c.policy()["spec"]["legacyKnob"]
        old_app.stop()
        c.srv.backend._crd_schemas = c.s.schemas()
        c.start_operator()
        c.wait_ready("ready under vN+1 after the field's removal")
        c.client.patch("tpu.ai/v1", "ClusterPolicy", "cluster-policy",
                       {"metadata": {"labels": {"edited": "true"}}})
        pruned = "legacyKnob" not in c.policy().get("spec", {})
        c.wait_ready("ready after the pruning write")
        return {"stored": stored, "pruned": pruned, "state": c.state()}

    assert on_both(case) == {"stored": "tuned", "pruned": True, "state": "ready"}


def test_helm_upgrade_over_live_crs():
    """``helm upgrade``: the vN+1 chart's objects (CRDs, RBAC, the operator's
    Deployment) apply over the live cluster; the running CR keeps its status
    and the operator reconverges. The live CR is left alone, as helm's
    three-way merge would leave it; the CRD schema swap is the case above."""
    def case(c):
        c.converge_v1()
        rendered = c.s.chart().render_all()
        kinds = sorted(o["kind"] for o in rendered if o["kind"] != "ClusterPolicy")
        c.s.apply(c.client, [o for o in rendered if o["kind"] != "ClusterPolicy"])
        c.wait_ready("ready after the helm upgrade")
        dep = [o for o in rendered if o["kind"] == "Deployment"][0]
        image = dep["spec"]["template"]["spec"]["containers"][0]["image"]
        live = c.client.get("apps/v1", "Deployment", dep["metadata"]["name"],
                            dep["metadata"]["namespace"])
        return {"kinds": kinds, "state": c.state(), "version": image.rsplit(":", 1)[1],
                "live_image": live["spec"]["template"]["spec"]["containers"][0]["image"]
                == image}

    got = on_both(case)
    assert got["state"] == "ready" and got["version"] == "0.2.0" and got["live_image"]
    assert got["kinds"] == ["ClusterRole", "ClusterRoleBinding", "CustomResourceDefinition",
                            "CustomResourceDefinition", "Deployment", "ServiceAccount"]


# -- the OLM replaces chain ------------------------------------------------------------

def _bundle(tmp_path, port):
    """Each package's CSV and the CRD files beside it, copied to its own
    dir."""
    src = os.path.join(REPO, "bundle-gpu" if port else "bundle", "manifests")
    dst = tmp_path / ("port" if port else "ref")
    dst.mkdir()
    for fname in os.listdir(src):
        if fname.startswith("tpu.ai_"):
            shutil.copy(os.path.join(src, fname), dst / fname)
    name = "gpu-operator" if port else "tpu-operator"
    with open(os.path.join(src, f"{name}.clusterserviceversion.yaml")) as f:
        csv = yamlsubset.parse(f.read()) if port else yaml.safe_load(f)
    return csv, dst / "csv.yaml", name


def _write(path, csv, port):
    path.write_text(yamlsubset.dump(csv) + "\n" if port else yaml.safe_dump(csv))


def _replaces_on_both(tmp_path, capsys, edit):
    """``edit(csv, package)`` on each package's CSV; both exit codes and the
    verdict lines on the edge, with the package's name as ``<pkg>``."""
    out = []
    for port, runner in ((False, ref_run), (True, run)):
        csv, path, name = _bundle(tmp_path, port)
        edit(csv, name)
        _write(path, csv, port)
        rc = runner(["validate-csv", str(path)])
        messages = [line.split(": ", 1)[1].replace(name, "<pkg>")
                    for line in capsys.readouterr().out.splitlines()]
        lines = [m for m in messages if "replaces" in m or "CSV name" in m]
        out.append((rc, lines))
    assert out[1] == out[0]
    return out[1]


@pytest.mark.parametrize("replaces,rc,needle", [
    ("<pkg>.v0.1.0", 0, "replaces <pkg>.v0.1.0: OK"),
    ("<pkg>.v0.2.0", 1, "replaces itself"),
    ("<pkg>.v0.3.0", 1, "not older than"),
    ("some-other-operator-v1", 1, "is not <package>.v<semver>"),
], ids=["vN+1-replaces-vN", "self", "forward", "malformed"])
def test_csv_replaces_chain_validated(tmp_path, capsys, replaces, rc, needle):
    """The vN+1 CSV names its predecessor in spec.replaces for OLM to walk
    the upgrade graph; validate-csv checks the edge's shape as the
    reference's does."""
    def edit(csv, name):
        csv["metadata"]["name"] = f"{name}.v0.2.0"
        csv["spec"]["version"] = "0.2.0"
        csv["spec"]["replaces"] = replaces.replace("<pkg>", name)

    got_rc, lines = _replaces_on_both(tmp_path, capsys, edit)
    assert got_rc == rc and any(needle in line for line in lines), lines


def test_csv_replaces_prerelease_edge(tmp_path, capsys):
    """Semver precedence: v0.1.0 replacing v0.1.0-rc.1 is a valid edge (a
    prerelease sorts below its release); it is the port's shipped edge."""
    def edit(csv, name):
        csv["spec"]["replaces"] = f"{name}.v0.1.0-rc.1"

    assert _replaces_on_both(tmp_path, capsys, edit) == (0, ["replaces <pkg>.v0.1.0-rc.1: OK"])
    with open(os.path.join(REPO, "bundle-gpu", "manifests",
                           "gpu-operator.clusterserviceversion.yaml")) as f:
        shipped = yamlsubset.parse(f.read())
    assert shipped["spec"]["replaces"] == "gpu-operator.v0.1.0-rc.1"
