# Case: the GPUDriver CRD path (the counterpart of tests/cases/tpudriver.sh):
# creating a GPUDriver hands driver ownership over from the ClusterPolicy's
# state-driver to per-pool DaemonSets (gpu-driver-<instance>-<pool>);
# deleting it hands back.

set -eu
# REPO_ROOT is exported by end-to-end.sh ($0 inside a `bash -c` case run
# does not point at the orchestrator)
: "${REPO_ROOT:?end-to-end.sh must export REPO_ROOT}"

kpost "apis/tpu.ai/v1alpha1/gpudrivers" \
    "$(cat "${REPO_ROOT}/tpu_operator_torch/manifests/samples/v1alpha1_gpudriver.json")" >/dev/null

pool_ds_name() {
    kget "apis/apps/v1/namespaces/${NS}/daemonsets" | jsonq '
next(d["metadata"]["name"] for d in obj["items"]
     if d["metadata"]["name"].startswith("gpu-driver-default-"))'
}
wait_for "per-pool driver DS created" 30 pool_ds_name
POOL_DS="$(pool_ds_name)"
wait_for "per-pool driver DS ready" 60 ds_ready "${POOL_DS}"
wait_for "ClusterPolicy driver DS handed over (deleted)" 30 ds_absent gpu-driver

gpudriver_ready() {
    [ "$(kget "apis/tpu.ai/v1alpha1/gpudrivers/default" \
        | jsonq 'obj.get("status", {}).get("state")')" = "ready" ]
}
wait_for "GPUDriver status ready" 60 gpudriver_ready
wait_for "ClusterPolicy still ready" 60 cp_state_is ready

# hand back: delete the instance, the ClusterPolicy's driver DS returns
kdel "apis/tpu.ai/v1alpha1/gpudrivers/default" >/dev/null
wait_for "per-pool DS cleaned up" 30 ds_absent "${POOL_DS}"
wait_for "ClusterPolicy driver DS restored" 60 ds_ready gpu-driver
wait_for "ClusterPolicy ready after hand-back" 60 cp_state_is ready
