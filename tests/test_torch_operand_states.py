"""The twin of tests/test_operand_states.py: every operand state of the
port (``tpu_operator_torch/state/operands.py``) renders, gates its
DaemonSets on a deploy label and tolerates the GPU taint, waits on exactly
its DAG parents; the validator's chain, the built-in and external device
plugin, the manager's sweep with states off, deleted, failing and without
the monitoring CRDs; the operator-wide metadata and the template
fingerprint. The reference's cases with the port's names (``gpu-*``
DaemonSets, ``nvidia.com/gpu``, the ``GPU_*`` variables, the kernel cache).
"""

from tpu_operator_torch.client import FakeClient
import pytest

from tpu_operator_torch import consts
from tpu_operator_torch.api.clusterpolicy import ClusterPolicy, new_cluster_policy
from tpu_operator_torch.state.manager import (
    INFO_CLUSTER_POLICY,
    INFO_NAMESPACE,
    InfoCatalog,
    Manager,
)
from tpu_operator_torch.state.operands import cluster_policy_states
from tpu_operator_torch.state.skel import SyncState
from tpu_operator_torch.utils import deep_get


@pytest.fixture(autouse=True)
def default_images(monkeypatch):
    monkeypatch.setenv("DRIVER_IMAGE", "registry.example.com/gpu-validator:0.1.0")
    monkeypatch.setenv("VALIDATOR_IMAGE", "registry.example.com/gpu-validator:0.1.0")
    monkeypatch.setenv("DEVICE_PLUGIN_IMAGE", "registry.example.com/device-plugin:0.1.0")
    monkeypatch.setenv("FEATURE_DISCOVERY_IMAGE", "registry.example.com/gpu-validator:0.1.0")
    monkeypatch.setenv("TELEMETRY_EXPORTER_IMAGE", "registry.example.com/gpu-validator:0.1.0")
    monkeypatch.setenv("SLICE_PARTITIONER_IMAGE", "registry.example.com/gpu-validator:0.1.0")


@pytest.fixture
def fake_client():
    return FakeClient()


def policy(spec=None):
    return ClusterPolicy.from_obj(new_cluster_policy(spec=spec or {}))


def catalog(p):
    c = InfoCatalog()
    c[INFO_CLUSTER_POLICY] = p
    c[INFO_NAMESPACE] = "tpu-operator"
    return c


def render_all(fake_client, spec=None):
    p = policy(spec)
    out = {}
    for state in cluster_policy_states(fake_client):
        if hasattr(state, "render_objects"):
            try:
                out[state.name] = state.render_objects(p, "tpu-operator")
            except TypeError:
                out[state.name] = state.renderer.render_objects({"namespace": "tpu-operator"})
        elif hasattr(state, "renderer"):
            out[state.name] = state.renderer.render_objects({"namespace": "tpu-operator"})
        # states without a manifest dir (e.g. multihost validation) build
        # their objects programmatically and are covered by their own tests
    return out


def test_all_states_render(fake_client):
    spec = {"slicePartitioner": {"enabled": True}}
    rendered = render_all(fake_client, spec)
    assert set(rendered) == {
        "pre-requisites", "state-operator-metrics", "state-driver",
        "state-operator-validation", "state-device-plugin",
        "state-feature-discovery", "state-telemetry",
        "state-node-status-exporter", "state-slice-partitioner",
        "state-operator-serving",
    }
    for name, objs in rendered.items():
        assert objs, f"{name} rendered nothing"
        for obj in objs:
            assert obj.get("kind"), f"{name}: object missing kind"
            assert deep_get(obj, "metadata", "name"), f"{name}: object missing name"


def test_daemonsets_are_gated_and_tolerant(fake_client):
    rendered = render_all(fake_client, {"slicePartitioner": {"enabled": True}})
    for name, objs in rendered.items():
        for obj in objs:
            if obj["kind"] != "DaemonSet":
                continue
            pod = obj["spec"]["template"]["spec"]
            sel = pod["nodeSelector"]
            assert any(k.startswith(consts.DEPLOY_LABEL_PREFIX) for k in sel), \
                f"{name}: DS not gated on a deploy label"
            assert any(t.get("key") == consts.GPU_RESOURCE_NAME for t in pod["tolerations"]), \
                f"{name}: DS missing the GPU taint's toleration"


def _wait_targets(ds):
    """Barriers the DS's wait init containers gate on, in render order."""
    inits = deep_get(ds, "spec", "template", "spec", "initContainers",
                     default=[]) or []
    targets = []
    for c in inits:
        for arg in c.get("args") or []:
            if str(arg).startswith("--for="):
                targets.append(str(arg).split("=", 1)[1])
    return targets


def test_operands_wait_on_exactly_their_dag_parents(fake_client):
    """Every rendered operand DS gates on EXACTLY its declared DAG parents
    (state/operands.py OPERAND_DAG) — no more (a stray wait re-serializes
    the pipelined join), no less (a missing wait breaks the barrier
    ordering guarantee)."""
    from tpu_operator_torch.state.operands import OPERAND_DAG

    rendered = render_all(
        fake_client, {"slicePartitioner": {"enabled": True},
                      "serving": {"enabled": True}})
    checked = 0
    for name, objs in rendered.items():
        for obj in objs:
            if obj["kind"] != "DaemonSet":
                continue
            declared = list(OPERAND_DAG.get(name, ()))
            assert _wait_targets(obj) == declared, (
                f"{name}: wait inits {_wait_targets(obj)} != declared DAG "
                f"parents {declared}")
            checked += 1
    assert checked >= 6  # the assertion above must have real coverage
    # spot-check the pipelining itself: telemetry rolls concurrently (no
    # parents), the plugin still serializes behind the driver
    assert OPERAND_DAG["state-telemetry"] == ()
    assert OPERAND_DAG["state-device-plugin"] == ("driver",)


def test_duration_seconds_parses_spec_durations():
    from tpu_operator_torch.state.operands import _duration_seconds

    assert _duration_seconds("60s") == 60.0
    assert _duration_seconds("1.5s") == 1.5      # fractional mantissa
    assert _duration_seconds("500ms") == 0.5     # ms, not 500 minutes-of-s
    assert _duration_seconds("0.5ms") == 0.0005
    assert _duration_seconds("5m") == 300.0
    assert _duration_seconds("2h") == 7200.0
    assert _duration_seconds("42") == 42.0       # bare number
    assert _duration_seconds(15) == 15.0
    with pytest.raises(ValueError):
        _duration_seconds("abcs")


def test_validator_ds_has_validation_chain(fake_client):
    rendered = render_all(fake_client)
    ds = [o for o in rendered["state-operator-validation"] if o["kind"] == "DaemonSet"][0]
    inits = ds["spec"]["template"]["spec"]["initContainers"]
    assert [c["name"] for c in inits] == [
        "driver-validation", "plugin-validation", "workload-validation"]
    # the cache prewarm rides the plugin step (concurrent with the
    # resource poll), not a serial init container of its own
    plugin = inits[1]
    assert "--prewarm" in plugin["args"]
    assert any(e.get("name") == "GPU_COMPILATION_CACHE_DIR"
               for e in plugin["env"])
    assert any(m["name"] == "kernel-cache" for m in plugin["volumeMounts"])


def test_device_plugin_builtin_vs_external(fake_client):
    # builtin (default): the gpu-validator entrypoint forced
    rendered = render_all(fake_client)
    ds = [o for o in rendered["state-device-plugin"] if o["kind"] == "DaemonSet"][0]
    ctr = ds["spec"]["template"]["spec"]["containers"][0]
    assert ctr["command"] == ["gpu-validator"]
    assert "-c" in ctr["args"] and "device-plugin" in ctr["args"]
    # external image: no command override; image entrypoint + optional args
    rendered = render_all(fake_client, {"devicePlugin": {
        "builtinPlugin": False, "args": ["--flag=1"]}})
    ds = [o for o in rendered["state-device-plugin"] if o["kind"] == "DaemonSet"][0]
    ctr = ds["spec"]["template"]["spec"]["containers"][0]
    assert "command" not in ctr
    assert ctr["args"] == ["--flag=1"]
    # external image, no args: bare entrypoint
    rendered = render_all(fake_client, {"devicePlugin": {"builtinPlugin": False}})
    ctr = [o for o in rendered["state-device-plugin"] if o["kind"] == "DaemonSet"][0][
        "spec"]["template"]["spec"]["containers"][0]
    assert "command" not in ctr and "args" not in ctr


def test_manager_full_sweep_with_disabled_states(fake_client):
    p = policy({"telemetry": {"enabled": False}})
    manager = Manager(cluster_policy_states(fake_client))
    results = manager.sync_state(catalog(p))
    by_name = {r.state_name: r for r in results.results}
    assert by_name["state-telemetry"].status == SyncState.IGNORE
    assert by_name["state-slice-partitioner"].status == SyncState.IGNORE  # opt-in
    # everything else applied; readiness vacuous (no nodes -> desired 0)
    assert results.ready
    # applied objects exist
    assert fake_client.get("apps/v1", "DaemonSet", "gpu-driver", "tpu-operator")
    assert fake_client.get("apps/v1", "DaemonSet", "gpu-device-plugin", "tpu-operator")


def test_disabling_state_deletes_objects(fake_client):
    manager = Manager(cluster_policy_states(fake_client))
    manager.sync_state(catalog(policy()))
    assert fake_client.get("apps/v1", "DaemonSet", "gpu-telemetry-exporter", "tpu-operator")
    manager.sync_state(catalog(policy({"telemetry": {"enabled": False}})))
    from tpu_operator_torch.client import NotFoundError
    with pytest.raises(NotFoundError):
        fake_client.get("apps/v1", "DaemonSet", "gpu-telemetry-exporter", "tpu-operator")


def test_state_error_is_contained(fake_client):
    p = policy()
    states = cluster_policy_states(fake_client)

    class Boom:
        name = "state-boom"

        def sync(self, catalog):
            raise RuntimeError("kaboom")

    manager = Manager(states[:1] + [Boom()] + states[1:])
    results = manager.sync_state(catalog(p))
    by_name = {r.state_name: r for r in results.results}
    assert by_name["state-boom"].status == SyncState.ERROR
    assert not results.ready
    assert len(results.results) == len(states) + 1


def test_monitoring_objects_optional_without_crds():
    """Clusters without prometheus-operator: ServiceMonitor/PrometheusRule
    manifests are skipped (and disable-cleanup stays silent) instead of
    erroring the state — the monitoring API group is an optional add-on."""
    from tpu_operator_torch.client import FakeClient
    from tpu_operator_torch.client.scheme import Scheme, default_scheme

    bare = Scheme()
    for (api_version, kind), info in default_scheme()._kinds.items():
        if not api_version.startswith("monitoring.coreos.com"):
            bare.register(api_version, kind, info.plural, info.namespaced)
    client = FakeClient(bare)

    manager = Manager(cluster_policy_states(client))
    results = manager.sync_state(catalog(policy()))
    by_name = {r.state_name: r for r in results.results}
    for name in ("state-operator-metrics", "state-node-status-exporter",
                 "state-telemetry"):
        assert by_name[name].status != SyncState.ERROR, by_name[name]
    # DaemonSets and Services still applied
    assert client.get("apps/v1", "DaemonSet", "gpu-node-status-exporter", "tpu-operator")
    assert client.get("v1", "Service", "gpu-node-status-exporter", "tpu-operator")
    # disabling the operand must not error on the unserved monitoring kinds
    results = manager.sync_state(catalog(policy({"nodeStatusExporter": {"enabled": False}})))
    by_name = {r.state_name: r for r in results.results}
    assert by_name["state-node-status-exporter"].status == SyncState.IGNORE


class TestOperatorWideMetadata:
    """The operator-wide spec fields each render consumes:
    operator.labels/annotations, daemonsets.labels/annotations,
    operator.runtimeClass, operator.initContainer, cdi.default."""

    def _policy(self, extra_spec=None):
        from tpu_operator_torch.api.clusterpolicy import ClusterPolicy, new_cluster_policy

        spec = {
            "operator": {"runtimeClass": "nvidia",
                         "labels": {"team": "ml"},
                         "annotations": {"audit": "r3"},
                         "initContainer": {"repository": "registry.example.com",
                                           "image": "waiter",
                                           "version": "9"}},
            "daemonsets": {"labels": {"podlbl": "v"},
                           "annotations": {"podann": "w"}},
            "driver": {"repository": "g", "image": "i", "version": "1"},
            "devicePlugin": {"repository": "g", "image": "i", "version": "1"},
            "validator": {"repository": "g", "image": "i", "version": "1"},
            "telemetry": {"repository": "g", "image": "i", "version": "1"},
            "featureDiscovery": {"repository": "g", "image": "i", "version": "1"},
            "nodeStatusExporter": {"repository": "g", "image": "i", "version": "1"},
            "cdi": {"enabled": True, "default": True},
        }
        spec.update(extra_spec or {})
        return ClusterPolicy.from_obj(new_cluster_policy(spec=spec))

    def _render(self, state_name):
        from tpu_operator_torch.state.operands import cluster_policy_states

        state = next(s for s in cluster_policy_states(client=None)
                     if s.name == state_name)
        return state.render_objects(self._policy(), "ns")

    def test_operator_meta_stamped_on_every_object(self):
        for obj in self._render("state-device-plugin"):
            assert obj["metadata"]["labels"]["team"] == "ml", obj["kind"]
            assert obj["metadata"]["annotations"]["audit"] == "r3", obj["kind"]

    def test_daemonset_pod_template_gets_extras_and_runtime_class(self):
        ds = [o for o in self._render("state-telemetry")
              if o["kind"] == "DaemonSet"][0]
        tpl = ds["spec"]["template"]
        assert tpl["metadata"]["labels"]["podlbl"] == "v"
        assert tpl["metadata"]["annotations"]["podann"] == "w"
        assert tpl["spec"]["runtimeClassName"] == "nvidia"

    def test_init_container_image_override_used_by_wait_inits(self):
        ds = [o for o in self._render("state-device-plugin")
              if o["kind"] == "DaemonSet"][0]
        inits = ds["spec"]["template"]["spec"]["initContainers"]
        assert inits[0]["image"] == "registry.example.com/waiter:9"

    def test_cdi_default_switches_plugin_to_cdi(self):
        ds = [o for o in self._render("state-device-plugin")
              if o["kind"] == "DaemonSet"][0]
        env = {e["name"]: e.get("value")
               for e in ds["spec"]["template"]["spec"]["containers"][0]["env"]}
        assert env["GPU_USE_CDI"] == "1"

    def test_driver_state_also_stamped(self):
        from tpu_operator_torch.state.driver import StateDriver

        ds = [o for o in StateDriver(client=None).render_objects(
                  self._policy(), "ns") if o["kind"] == "DaemonSet"][0]
        assert ds["metadata"]["labels"]["team"] == "ml"
        assert ds["spec"]["template"]["spec"]["runtimeClassName"] == "nvidia"

    def test_feature_discovery_sleep_interval_reaches_args(self):
        from tpu_operator_torch.api.clusterpolicy import ClusterPolicy, new_cluster_policy
        from tpu_operator_torch.state.operands import cluster_policy_states

        policy = ClusterPolicy.from_obj(new_cluster_policy(spec={
            "featureDiscovery": {"repository": "g", "image": "i",
                                 "version": "1", "sleepInterval": "5m"},
            "validator": {"repository": "g", "image": "i", "version": "1"},
        }))
        state = next(s for s in cluster_policy_states(client=None)
                     if s.name == "state-feature-discovery")
        ds = [o for o in state.render_objects(policy, "ns")
              if o["kind"] == "DaemonSet"][0]
        args = ds["spec"]["template"]["spec"]["containers"][0]["args"]
        assert "--sleep-interval=300.0" in args

    def test_device_plugin_config_tunables_consumed(self, tmp_path, monkeypatch):
        """spec.devicePlugin.config is a real surface for the builtin
        plugin, not a decorative mount."""
        import tpu_operator_torch.validator.main as vmain
        from tpu_operator_torch.deviceplugin import plugin as deviceplugin

        cfg = tmp_path / "config.yaml"
        cfg.write_text("healthIntervalS: 3\nabsenceGraceS: 120\n")
        monkeypatch.setenv("GPU_PLUGIN_CONFIG", str(cfg))
        captured = {}

        class FakePlugin:
            def __init__(self, **kw):
                captured.update(kw)

            def run_forever(self):
                return 0

            def stop(self):  # the port's CLI stops the plugin it ran
                pass

        monkeypatch.setattr(deviceplugin, "GPUDevicePlugin", FakePlugin)
        assert vmain.run(["-c", "device-plugin"]) == 0
        assert captured["health_interval"] == 3.0
        assert captured["absence_grace_s"] == 120.0


def test_stamp_sets_template_fingerprint_label():
    """Every rendered DaemonSet pod template carries the whole-template
    fingerprint label (the upgrade machine's currency signal), computed
    AFTER all other template mutations and stable across re-stamps."""
    from tpu_operator_torch.api.clusterpolicy import ClusterPolicy, new_cluster_policy
    from tpu_operator_torch.state.operands import stamp_operator_meta
    from tpu_operator_torch.utils.hash import template_fingerprint
    from tpu_operator_torch import consts

    policy = ClusterPolicy.from_obj(new_cluster_policy())
    ds = {"apiVersion": "apps/v1", "kind": "DaemonSet",
          "metadata": {"name": "d", "namespace": "ns"},
          "spec": {"template": {
              "metadata": {"labels": {"app": "x"}},
              "spec": {"containers": [{"name": "c", "image": "img:1"}]}}}}
    [stamped] = stamp_operator_meta([ds], policy)
    tpl = stamped["spec"]["template"]
    label = tpl["metadata"]["labels"][consts.TEMPLATE_HASH_LABEL]
    assert label == template_fingerprint(tpl)  # self-consistent (label excluded)
    # idempotent: re-stamping an already-stamped template keeps the value
    [restamped] = stamp_operator_meta([stamped], policy)
    assert restamped["spec"]["template"]["metadata"]["labels"][
        consts.TEMPLATE_HASH_LABEL] == label
    # and a template change changes it
    ds2 = {"apiVersion": "apps/v1", "kind": "DaemonSet",
           "metadata": {"name": "d", "namespace": "ns"},
           "spec": {"template": {
               "metadata": {"labels": {"app": "x"}},
               "spec": {"containers": [{"name": "c", "image": "img:1",
                                        "env": [{"name": "E", "value": "1"}]}]}}}}
    [stamped2] = stamp_operator_meta([ds2], policy)
    assert stamped2["spec"]["template"]["metadata"]["labels"][
        consts.TEMPLATE_HASH_LABEL] != label


def test_both_packages_declare_the_same_operand_dag():
    from tpu_operator.state.operands import OPERAND_DAG as REF_DAG
    from tpu_operator_torch.state.operands import OPERAND_DAG

    assert OPERAND_DAG == REF_DAG
