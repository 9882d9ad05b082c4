# Case: an env-only driver template change (image and args untouched)
# starts the per-node rolling upgrade: the whole template's hash
# (tpu.ai/template-hash, the controller-revision-hash analog) is the
# currency signal, driven through the real operator process (the
# counterpart of tests/cases/env-only-upgrade.sh). The env rolled is
# GPU_HOST_DRIVER_PATHS, which the port's driver container reads
# (tpu_operator_torch/validator/driver.py:find_host_driver).

set -eu

IMG_BEFORE="$(ds_image gpu-driver)"

# a GPU-holding user pod: its eviction is the durable proof that the
# upgrade machine drained the node for this change (the state labels are
# transient, cleared again once the upgrade completes)
kpost "api/v1/namespaces/ml-team/pods" '{
  "apiVersion": "v1", "kind": "Pod",
  "metadata": {"name": "env-roll-canary", "namespace": "ml-team"},
  "spec": {"nodeName": "gpu-node-0",
           "containers": [{"name": "train", "image": "user:1",
                           "resources": {"limits": {"nvidia.com/gpu": "4"}}}]},
  "status": {"phase": "Running"}
}' >/dev/null

kpatch "${CP_PATH}" '{"spec": {"driver": {
  "env": [{"name": "GPU_HOST_DRIVER_PATHS",
           "value": "/usr/local/nvidia/lib64/libcuda.so.1"}],
  "upgradePolicy": {"autoUpgrade": true, "maxParallelUpgrades": 4,
                    "maxUnavailable": "100%",
                    "drain": {"enable": true, "force": true,
                              "timeoutSeconds": 60},
                    "podDeletion": {"force": true, "timeoutSeconds": 60}}
}}}' >/dev/null

ds_env_rolled() {
    kget "apis/apps/v1/namespaces/${NS}/daemonsets/gpu-driver" | jsonq '
"ok" if any(e.get("name") == "GPU_HOST_DRIVER_PATHS"
            for c in obj["spec"]["template"]["spec"]["containers"]
            for e in (c.get("env") or [])) else sys.exit(1)'
}
canary_evicted() { ! kget "api/v1/namespaces/ml-team/pods/env-roll-canary"; }
nodes_settled() {
    kget "api/v1/nodes" | jsonq '"ok" if all(
        "tpu.ai/tpu-driver-upgrade-state" not in (n["metadata"].get("labels") or {})
        and not (n.get("spec") or {}).get("unschedulable")
        for n in obj["items"]) else sys.exit(1)'
}

wait_for "driver DS env rolled" 120 ds_env_rolled
wait_for "GPU-holding canary evicted by the env-only upgrade" 240 canary_evicted
wait_for "nodes uncordoned, upgrade labels cleared" 240 nodes_settled
wait_for "ClusterPolicy ready after env-only upgrade" 120 cp_state_is ready

# the image never changed: this roll was driven by the template hash alone
IMG_AFTER="$(ds_image gpu-driver)"
if [ "${IMG_BEFORE}" != "${IMG_AFTER}" ]; then
    echo "FAIL: image changed (${IMG_BEFORE} -> ${IMG_AFTER}); case proves nothing" >&2
    exit 1
fi
echo "ok: upgrade rolled on env change alone (image stable at ${IMG_AFTER})"

# revert for later cases
kpatch "${CP_PATH}" '{"spec": {"driver": {
  "env": [],
  "upgradePolicy": {"autoUpgrade": false}}}}' >/dev/null
wait_for "ClusterPolicy ready after revert" 120 cp_state_is ready
wait_for "nodes settled after revert" 120 nodes_settled
