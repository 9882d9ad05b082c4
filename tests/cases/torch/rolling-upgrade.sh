# Case: a rolling driver upgrade evicts GPU-holding user pods, including
# ones carrying the standard app.kubernetes.io/component label, while
# DaemonSet-owned pods are exempt (kubectl drain's semantics; the
# counterpart of tests/cases/rolling-upgrade.sh).

set -eu

# a user workload namespace with two pods on gpu-node-0:
#  - "web-train": component=web and a GPU limit -> must be evicted
#  - "user-ds-pod": DaemonSet-owned and a GPU limit -> must survive
kpost "api/v1/namespaces/ml-team/pods" '{
  "apiVersion": "v1", "kind": "Pod",
  "metadata": {"name": "web-train", "namespace": "ml-team",
               "labels": {"app.kubernetes.io/component": "web"}},
  "spec": {"nodeName": "gpu-node-0",
           "containers": [{"name": "train", "image": "user:1",
                           "resources": {"limits": {"nvidia.com/gpu": "4"}}}]},
  "status": {"phase": "Running"}
}' >/dev/null
kpost "api/v1/namespaces/ml-team/pods" '{
  "apiVersion": "v1", "kind": "Pod",
  "metadata": {"name": "user-ds-pod", "namespace": "ml-team",
               "ownerReferences": [{"kind": "DaemonSet", "name": "user-ds",
                                     "controller": true, "uid": "u-1"}]},
  "spec": {"nodeName": "gpu-node-0",
           "containers": [{"name": "c", "image": "user:1",
                           "resources": {"limits": {"nvidia.com/gpu": "4"}}}]},
  "status": {"phase": "Running"}
}' >/dev/null

# turn on auto-upgrade with an aggressive but safe policy, then roll the
# driver version to start the per-node state machine
kpatch "${CP_PATH}" '{"spec": {"driver": {
  "version": "0.3.0",
  "upgradePolicy": {"autoUpgrade": true, "maxParallelUpgrades": 4,
                    "maxUnavailable": "100%",
                    "drain": {"enable": true, "force": true,
                              "timeoutSeconds": 60},
                    "podDeletion": {"force": true, "timeoutSeconds": 60}}
}}}' >/dev/null

pod_gone() { ! kget "api/v1/namespaces/ml-team/pods/web-train"; }
pod_present() { kget "api/v1/namespaces/ml-team/pods/user-ds-pod"; }
nodes_settled() {
    kget "api/v1/nodes" | jsonq '"ok" if all(
        "tpu.ai/tpu-driver-upgrade-state" not in (n["metadata"].get("labels") or {})
        and not (n.get("spec") or {}).get("unschedulable")
        for n in obj["items"]) else sys.exit(1)'
}

# generous margins: this runs inside the full pytest suite
wait_for "GPU-holding user pod evicted (component label no shield)" 240 pod_gone
ds_rolled() { ds_image gpu-driver | grep -q "0.3.0"; }
wait_for "driver DS rolled to 0.3.0" 240 ds_rolled
wait_for "all nodes uncordoned, upgrade labels cleared" 240 nodes_settled
wait_for "ClusterPolicy ready after upgrade" 120 cp_state_is ready
pod_present >/dev/null || { echo "FAIL: DaemonSet-owned pod was evicted" >&2; exit 1; }
echo "ok: DaemonSet-owned user pod survived the drain"

# revert for later cases
kpatch "${CP_PATH}" '{"spec": {"driver": {
  "version": "0.1.0",
  "upgradePolicy": {"autoUpgrade": false}}}}' >/dev/null
kdel "api/v1/namespaces/ml-team/pods/user-ds-pod" >/dev/null 2>&1 || true
wait_for "ClusterPolicy ready after revert" 120 cp_state_is ready
wait_for "nodes settled after revert" 120 nodes_settled
