"""The twin of tests/test_host_paths.py: ``spec.hostPaths`` rewrites every
rendered mount, volume, argument and environment variable of the port's
operands (the status dir, the CUDA driver's install dir, the device globs,
the partition handoff dir); no compiled-in default survives into the
manifests. The reference's cases with the port's keys and paths.
"""

import yaml

from tpu_operator_torch import consts
from tpu_operator_torch.api.clusterpolicy import ClusterPolicy, new_cluster_policy
from tpu_operator_torch.state.driver import StateDriver
from tpu_operator_torch.state.operands import cluster_policy_states

OVERRIDES = {
    "hostPaths": {
        "validationStatusDir": "/var/lib/gpu/validations",
        "driverInstallDir": "/var/lib/nvidia/lib64",
        "devGlobs": ["/dev/nvidia[0-9]*"],
        "partitionHandoffDir": "/srv/gpu/handoff",
    },
    "driver": {"repository": "registry.example.com", "image": "gpu-validator",
               "version": "0.1.0"},
    "devicePlugin": {"repository": "registry.example.com", "image": "gpu-device-plugin",
                     "version": "0.1.0"},
    "featureDiscovery": {"repository": "registry.example.com", "image": "gpu-validator",
                         "version": "0.1.0"},
    "telemetry": {"repository": "registry.example.com", "image": "gpu-validator",
                  "version": "0.1.0"},
    "nodeStatusExporter": {"repository": "registry.example.com", "image": "gpu-validator",
                           "version": "0.1.0"},
    "validator": {"repository": "registry.example.com", "image": "gpu-validator",
                  "version": "0.1.0"},
    "slicePartitioner": {"enabled": True, "repository": "registry.example.com",
                         "image": "gpu-validator", "version": "0.1.0"},
    "serving": {"repository": "registry.example.com", "image": "gpu-validator",
                "version": "0.1.0"},
}


def _policy(spec=None) -> ClusterPolicy:
    return ClusterPolicy.from_obj(new_cluster_policy(spec=spec or OVERRIDES))


def _render_all(policy):
    objs = []
    for state in cluster_policy_states(client=None):
        # the multi-node validation builds its pods itself (no templates);
        # every other state renders, and one that raises fails the test
        if hasattr(state, "render_objects"):
            objs += state.render_objects(policy, "tpu-operator")
    return objs


def test_no_default_paths_survive_in_rendered_manifests():
    policy = _policy()
    rendered = yaml.dump_all(_render_all(policy))
    assert consts.VALIDATION_STATUS_DIR not in rendered
    assert consts.DEFAULT_DRIVER_LIB_DIR + "\n" not in rendered
    assert consts.DEFAULT_HANDOFF_DIR not in rendered
    assert "/var/lib/gpu/validations" in rendered
    assert "/var/lib/nvidia/lib64" in rendered
    assert "/srv/gpu/handoff" in rendered


def test_host_env_carries_overrides_into_every_barrier_consumer():
    policy = _policy()
    for obj in _render_all(policy):
        if obj.get("kind") != "DaemonSet":
            continue
        spec = obj["spec"]["template"]["spec"]
        for ctr in spec.get("initContainers", []) + spec["containers"]:
            mounts = {m["mountPath"] for m in ctr.get("volumeMounts", [])}
            if not any("/validations" in m for m in mounts):
                continue
            assert "/var/lib/gpu/validations" in mounts, (
                obj["metadata"]["name"], ctr["name"])
            env = {e["name"]: e.get("value") for e in ctr.get("env", [])}
            args = " ".join(ctr.get("args", []))
            # every consumer learns the layout via env or explicit flag
            assert (env.get("STATUS_DIR") == "/var/lib/gpu/validations"
                    or "--status-dir=/var/lib/gpu/validations" in args), (
                obj["metadata"]["name"], ctr["name"])
            if "STATUS_DIR" in env:
                assert env.get(consts.GPU_DEV_GLOBS_ENV) == "/dev/nvidia[0-9]*"


def test_driver_ds_honors_driver_install_override():
    policy = _policy()
    ds = [o for o in StateDriver(client=None).render_objects(policy, "ns")
          if o.get("kind") == "DaemonSet"][0]
    text = yaml.dump(ds)
    assert "--install-dir=/var/lib/nvidia/lib64" in text
    assert consts.DEFAULT_DRIVER_LIB_DIR not in text
    vols = {v["name"]: v for v in ds["spec"]["template"]["spec"]["volumes"]}
    assert vols["install-dir"]["hostPath"]["path"] == "/var/lib/nvidia/lib64"


def test_driver_dir_falls_back_to_driver_install_dir():
    policy = _policy({"driver": {"repository": "g", "image": "i",
                                 "version": "1",
                                 "installDir": "/custom/driver/dir"}})
    assert policy.spec.driver_dir() == "/custom/driver/dir"
    policy = _policy()
    assert policy.spec.driver_dir() == "/var/lib/nvidia/lib64"


def test_host_paths_validation_rejects_relative_paths():
    policy = _policy({"hostPaths": {"validationStatusDir": "relative/path"}})
    errors = policy.spec.validate()
    assert any("absolute" in e for e in errors)
    policy = _policy({"hostPaths": {"devGlobs": []}})
    assert any("devGlobs" in e for e in policy.spec.validate())
    # globs travel comma-joined in GPU_DEV_GLOBS: a comma inside one glob
    # would silently corrupt device discovery
    policy = _policy({"hostPaths": {"devGlobs": ["/dev/nvidia{0,1}"]}})
    assert any("','" in e for e in policy.spec.validate())


def test_partition_handoff_crosses_pod_boundaries():
    """The partitioner writes the applied partition and the device plugin
    reads it from a DIFFERENT pod: both DaemonSets must mount the same
    hostPath (without it the handoff file never leaves the partitioner's
    container filesystem and partitions silently don't take effect)."""
    policy = _policy()
    host_paths = {}
    consumers = ("gpu-device-plugin", "gpu-slice-partitioner",
                 "gpu-telemetry-exporter")  # RecordsSource reads it too
    for obj in _render_all(policy):
        if obj.get("kind") != "DaemonSet":
            continue
        name = obj["metadata"]["name"]
        if name not in consumers:
            continue
        spec_tpl = obj["spec"]["template"]["spec"]
        vols = {v["name"]: v for v in spec_tpl["volumes"]}
        assert vols["handoff"]["hostPath"]["path"] == "/srv/gpu/handoff", name
        ctr = spec_tpl["containers"][0]
        mounts = {m["name"]: m["mountPath"] for m in ctr["volumeMounts"]}
        assert mounts["handoff"] == "/srv/gpu/handoff", name
        env = {e["name"]: e.get("value") for e in ctr.get("env", [])}
        assert ("--handoff-dir=/srv/gpu/handoff" in " ".join(ctr["args"])
                or env.get(consts.HANDOFF_DIR_ENV) == "/srv/gpu/handoff"), name
        host_paths[name] = vols["handoff"]["hostPath"]["path"]
    assert set(host_paths) == set(consumers), \
        f"every handoff consumer must mount it: {host_paths}"


def test_every_device_enumerating_container_mounts_dev():
    """Components that glob host device nodes (discover_devices) must have
    /dev mounted — a missing mount doesn't error, it just makes the node
    look GPU-less (a node-status exporter without it reads a device-node
    gauge of 0 forever)."""
    DEVICE_ENUMERATING = {"driver", "driver-daemon", "driver-probe",
                          "device-plugin", "metrics", "feature-discovery",
                          "slice-partitioner", "telemetry"}
    policy = _policy()
    checked = set()
    for obj in _render_all(policy):
        if obj.get("kind") != "DaemonSet":
            continue
        spec_tpl = obj["spec"]["template"]["spec"]
        for ctr in spec_tpl.get("initContainers", []) + spec_tpl["containers"]:
            args = ctr.get("args", [])
            try:
                component = args[args.index("-c") + 1]
            except (ValueError, IndexError):
                continue
            if component not in DEVICE_ENUMERATING:
                continue
            mounts = {m["mountPath"] for m in ctr.get("volumeMounts", [])}
            assert "/dev" in mounts, (obj["metadata"]["name"], ctr["name"])
            checked.add(component)
    # the sweep must have actually seen the device-enumerating components
    assert {"driver-daemon", "device-plugin", "metrics",
            "feature-discovery", "telemetry"} <= checked, checked
