# Case: default install sanity (the counterpart of tests/cases/default.sh).
# Everything verify-operator.sh checked, plus object ownership: operand
# DaemonSets carry the operator's state label and an ownerReference to the
# ClusterPolicy, and the nodes carry their discovery labels.

set -eu

for ds in gpu-driver gpu-device-plugin; do
    kget "apis/apps/v1/namespaces/${NS}/daemonsets/${ds}" > "${WORK_DIR}/ds.json"
    state_label="$(jsonq 'obj["metadata"]["labels"].get("tpu.ai/operator.state", "")' < "${WORK_DIR}/ds.json")"
    [ -n "${state_label}" ] || { echo "missing state label on ${ds}" >&2; exit 1; }
    owner="$(jsonq 'obj["metadata"].get("ownerReferences", [{}])[0].get("kind", "")' < "${WORK_DIR}/ds.json")"
    [ "${owner}" = "ClusterPolicy" ] || { echo "missing ClusterPolicy ownerRef on ${ds}" >&2; exit 1; }
done
echo "ok: state labels + ownerReferences"

# every GPU node carries gpu.present + per-operand deploy state labels
kget "api/v1/nodes" > "${WORK_DIR}/nodes.json"
n_present="$(jsonq 'sum(1 for n in obj["items"]
    if n["metadata"].get("labels", {}).get("tpu.ai/gpu.present") == "true")' < "${WORK_DIR}/nodes.json")"
[ "${n_present}" = "4" ] || { echo "expected 4 gpu.present nodes, got ${n_present}" >&2; exit 1; }
n_deploy="$(jsonq 'sum(1 for n in obj["items"]
    if n["metadata"].get("labels", {}).get("tpu.ai/gpu.deploy.device-plugin") == "true")' < "${WORK_DIR}/nodes.json")"
[ "${n_deploy}" = "4" ] || { echo "expected 4 deploy-labeled nodes, got ${n_deploy}" >&2; exit 1; }
echo "ok: node discovery labels"
