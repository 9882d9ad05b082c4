"""The twin of tests/test_api.py: the reference's twelve cases on the
port's typed specs (``tpu_operator_torch/api``): the ClusterPolicy spec's
defaults (the CUDA driver's install dir and ``nvidia.com/gpu``, where the
reference's are libtpu's and ``google.com/tpu``), unknown fields kept, the
camel-case mapping, image paths, validation, the wrappers and the
``GPUDriver``. Beside them, seeded specs (numpy) through both packages'
``from_dict``/``to_dict``/``validate`` must give the mapped same output
and errors (tests/test_torch_operator_mapping.py: ``map_spec``, and the
driver's default install dir through its string rules).
"""

import copy

import numpy as np
import pytest

from test_torch_operator_mapping import _map_string, map_spec
from tpu_operator.api import ClusterPolicySpec as RefSpec
from tpu_operator_torch import consts
from tpu_operator_torch.api import ClusterPolicy, ClusterPolicySpec, GPUDriver
from tpu_operator_torch.api.clusterpolicy import new_cluster_policy
from tpu_operator_torch.api.common import SpecValidationError
from tpu_operator_torch.api.gpudriver import GPU_DRIVER_API_VERSION, GPU_DRIVER_KIND


def _gpu_driver(name, spec=None):
    return {"apiVersion": GPU_DRIVER_API_VERSION, "kind": GPU_DRIVER_KIND,
            "metadata": {"name": name}, "spec": spec or {}}


def test_empty_spec_gets_full_defaults():
    spec = ClusterPolicySpec.from_dict({})
    assert spec.driver.is_enabled() is True
    assert spec.driver.install_dir == consts.DEFAULT_DRIVER_LIB_DIR
    assert spec.device_plugin.resource_name == consts.GPU_RESOURCE_NAME
    assert spec.slice_partitioner.is_enabled() is False  # opt-in, as MIG
    assert spec.operator.runtime_class is None
    assert spec.daemonsets.priority_class_name == "system-node-critical"
    assert spec.validate() == []


def test_round_trip_preserves_unknown_fields():
    data = {"driver": {"enabled": False, "futureField": {"x": 1}}, "topLevelUnknown": True}
    out = ClusterPolicySpec.from_dict(data).to_dict()
    assert out["driver"]["futureField"] == {"x": 1}
    assert out["topLevelUnknown"] is True
    assert out["driver"]["enabled"] is False


def test_camel_case_mapping():
    spec = ClusterPolicySpec.from_dict({
        "devicePlugin": {"resourceName": "nvidia.com/gpu-h100", "imagePullPolicy": "Always"},
        "featureDiscovery": {"sleepInterval": "30s"}})
    assert spec.device_plugin.resource_name == "nvidia.com/gpu-h100"
    assert spec.device_plugin.image_pull_policy == "Always"
    assert spec.feature_discovery.sleep_interval == "30s"


def test_image_path_resolution_cr_fields():
    spec = ClusterPolicySpec.from_dict({"driver": {
        "repository": "registry.example.com", "image": "gpu-driver-installer",
        "version": "1.2.3"}})
    assert spec.driver.image_path() == "registry.example.com/gpu-driver-installer:1.2.3"


def test_image_path_digest_uses_at_separator():
    spec = ClusterPolicySpec.from_dict({"driver": {
        "image": "gpu-driver-installer", "version": "sha256:" + "a" * 64}})
    assert "@sha256:" in spec.driver.image_path()


def test_image_path_env_fallback(monkeypatch):
    monkeypatch.setenv("DEVICE_PLUGIN_IMAGE", "registry.example.com/device-plugin:9")
    assert ClusterPolicySpec.from_dict({}).device_plugin.image_path() == \
        "registry.example.com/device-plugin:9"


def test_image_path_error_when_unresolvable(monkeypatch):
    monkeypatch.delenv("DRIVER_IMAGE", raising=False)
    with pytest.raises(SpecValidationError):
        ClusterPolicySpec.from_dict({}).driver.image_path()


def test_validation_catches_bad_values():
    errors = ClusterPolicySpec.from_dict({
        "daemonsets": {"updateStrategy": "BlueGreen"},
        "driver": {"imagePullPolicy": "Sometimes", "upgradePolicy": {"maxParallelUpgrades": -1}},
    }).validate()
    assert any("updateStrategy" in e for e in errors)
    assert any("imagePullPolicy" in e for e in errors)
    assert any("maxParallelUpgrades" in e for e in errors)


def test_cluster_policy_wrapper():
    obj = new_cluster_policy(spec={"driver": {"enabled": True}})
    cp = ClusterPolicy.from_obj(obj)
    assert cp.name == "cluster-policy"
    cp.set_state("ready", "tpu-operator")
    assert obj["status"] == {"state": "ready", "namespace": "tpu-operator"}
    with pytest.raises(SpecValidationError):
        ClusterPolicy.from_obj({"kind": "Pod"})


def test_gpudriver_defaults_and_selector():
    drv = GPUDriver.from_obj(_gpu_driver("pool-a"))
    assert drv.spec.get_node_selector() == {consts.GPU_PRESENT_LABEL: "true"}
    drv2 = GPUDriver.from_obj(_gpu_driver("pool-b", {"nodeSelector": {"pool": "b"}}))
    assert drv2.spec.get_node_selector() == {"pool": "b"}
    assert drv.spec.validate() == []


def test_gpudriver_validation():
    drv = GPUDriver.from_obj(_gpu_driver("x", {"driverType": "vgpu"}))
    assert any("driverType" in e for e in drv.spec.validate())


def test_env_list_parsing():
    spec = ClusterPolicySpec.from_dict({
        "driver": {"env": [{"name": "A", "value": "1"}, {"name": "B"}]}})
    assert spec.driver.env_map() == {"A": "1", "B": ""}


def _random_spec(rng):
    """A reference spec of a few sections, valid or not."""
    spec = {}
    if rng.random() < 0.7:
        spec["driver"] = {"enabled": bool(rng.integers(0, 2)),
                          "imagePullPolicy": str(rng.choice(["Always", "IfNotPresent",
                                                              "Sometimes"])),
                          "upgradePolicy": {"maxParallelUpgrades": int(rng.integers(-1, 4))}}
    if rng.random() < 0.5:
        spec["daemonsets"] = {"updateStrategy": str(rng.choice(["RollingUpdate", "OnDelete",
                                                                "BlueGreen"]))}
    if rng.random() < 0.5:
        spec["featureDiscovery"] = {"sleepInterval": f"{int(rng.integers(1, 90))}s"}
    if rng.random() < 0.3:
        spec["futureSection"] = {"x": int(rng.integers(0, 9))}
    return spec


@pytest.mark.parametrize("seed", range(4))
def test_both_packages_read_and_validate_a_spec_alike(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        ref_spec = _random_spec(rng)
        mine = ClusterPolicySpec.from_dict(map_spec(copy.deepcopy(ref_spec)))
        theirs = RefSpec.from_dict(copy.deepcopy(ref_spec))
        expected = map_spec(theirs.to_dict())
        # the driver's default install dir, mapped as the renders map it
        expected["driver"]["installDir"] = _map_string(expected["driver"]["installDir"])
        assert mine.to_dict() == expected
        assert mine.validate() == theirs.validate()
