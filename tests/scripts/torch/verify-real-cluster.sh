#!/usr/bin/env bash
# kubectl-based verification of gpu-operator on a real cluster (the
# counterpart of tests/scripts/verify-real-cluster.sh, run by
# tests/ci-run-e2e-gpu.sh): the six operand DaemonSets roll out, the
# ClusterPolicy is ready, every GPU node advertises the resource within the
# join budget, and every validator pod holds its status files.

set -euo pipefail

NS="${OPERATOR_NAMESPACE:-tpu-operator}"
BUDGET="${NODE_JOIN_BUDGET_S:-120}"
# the operator's extended resource under test (ci-run-e2e-gpu.sh passes a
# name apart from GKE's own nvidia.com/gpu)
RESOURCE="${GPU_RESOURCE_NAME:-nvidia.com/gpu}"
RESOURCE_JSONPATH="${RESOURCE//./\\.}"
# GKE labels its GPU nodes with the accelerator
GPU_NODES="${GPU_NODE_SELECTOR:-cloud.google.com/gke-accelerator}"

wait_rollout() { # wait_rollout <daemonset> <timeout>
    kubectl -n "${NS}" rollout status "daemonset/$1" --timeout "$2" \
        && echo "ok: $1"
}

for ds in gpu-driver gpu-operator-validator gpu-device-plugin \
          gpu-feature-discovery gpu-telemetry-exporter gpu-node-status-exporter; do
    wait_rollout "${ds}" 300s
done

echo "--- ClusterPolicy ready ---"
kubectl wait clusterpolicies.tpu.ai/cluster-policy \
    --for jsonpath='{.status.state}'=ready --timeout 120s

echo "--- ${RESOURCE} on every GPU node (<${BUDGET}s) ---"
deadline=$(( $(date +%s) + BUDGET ))
while true; do
    total=$(kubectl get nodes -l "${GPU_NODES}" -o name | wc -l)
    ready=$(kubectl get nodes -l "${GPU_NODES}" \
        -o jsonpath="{range .items[*]}{.status.capacity.${RESOURCE_JSONPATH}}{\"\n\"}{end}" \
        | grep -c -v '^$' || true)
    [ "${total}" -gt 0 ] && [ "${ready}" = "${total}" ] && break
    [ "$(date +%s)" -ge "${deadline}" ] && {
        echo "TIMEOUT: ${ready}/${total} GPU nodes schedulable" >&2; exit 1; }
    sleep 2
done
echo "ok: ${ready}/${total} nodes schedulable"

echo "--- per-node validation status files ---"
pods=$(kubectl -n "${NS}" get pods -l app=gpu-operator-validator -o name)
[ -n "${pods}" ] || { echo "FAIL: no validator pods found" >&2; exit 1; }
for pod in ${pods}; do
    for barrier in driver-ready plugin-ready workload-ready; do
        if ! kubectl -n "${NS}" exec "${pod#pod/}" -- \
            test -s "/run/tpu/validations/${barrier}"; then
            echo "FAIL: ${pod} has no ${barrier} status file" >&2
            exit 1
        fi
    done
    echo "ok: ${pod}"
done
