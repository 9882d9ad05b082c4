#!/usr/bin/env bash
# The port's real-hardware e2e runner (the counterpart of tests/ci-run-e2e.sh):
# provision the GKE environment tests/gpu-ci.yaml declares (one H100 node
# pool), install gpu-operator from its chart, verify the stack on the real
# GPU node, tear down.
#
# Usage: GPU_CI_PROJECT=... OPERATOR_IMAGE=... OPERATOR_VERSION=... \
#            tests/ci-run-e2e-gpu.sh [--keep]
#
# Needs gcloud, kubectl and helm with credentials for $GPU_CI_PROJECT; it is
# the CI entry point for real GPU hardware and cannot run in a hermetic
# sandbox, where tests/scripts/torch/end-to-end.sh covers the control plane.

set -euo pipefail

TEST_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
REPO_ROOT="$(cd "${TEST_DIR}/.." && pwd)"

: "${GPU_CI_PROJECT:?set GPU_CI_PROJECT to the GCP project for CI}"
: "${OPERATOR_IMAGE:?set OPERATOR_IMAGE (e.g. gcr.io/$GPU_CI_PROJECT/gpu-operator)}"
: "${OPERATOR_VERSION:?set OPERATOR_VERSION}"
VALIDATOR_IMAGE="${VALIDATOR_IMAGE:-${OPERATOR_IMAGE%/*}/gpu-validator}"
VALIDATOR_VERSION="${VALIDATOR_VERSION:-${OPERATOR_VERSION}}"
KEEP="${1:-}"

CLUSTER=gpu-operator-e2e
ZONE=us-central1-a

cleanup() {
    if [ "${KEEP}" != "--keep" ]; then
        echo "=== teardown ==="
        gcloud container clusters delete "${CLUSTER}" --zone "${ZONE}" \
            --project "${GPU_CI_PROJECT}" --quiet || true
    fi
}
trap cleanup EXIT

echo "=== provision (tests/gpu-ci.yaml) ==="
gcloud container clusters create "${CLUSTER}" \
    --project "${GPU_CI_PROJECT}" --zone "${ZONE}" \
    --release-channel rapid --num-nodes 1 --machine-type e2-standard-4
# one a3-highgpu-1g VM: one H100 80GB, GKE's driver installed
gcloud container node-pools create h100 \
    --project "${GPU_CI_PROJECT}" --zone "${ZONE}" --cluster "${CLUSTER}" \
    --machine-type a3-highgpu-1g \
    --accelerator type=nvidia-h100-80gb,count=1,gpu-driver-version=default \
    --num-nodes 1 --spot
gcloud container clusters get-credentials "${CLUSTER}" \
    --zone "${ZONE}" --project "${GPU_CI_PROJECT}"

echo "=== install gpu-operator (deployments/gpu-operator) ==="
# GKE's own device plugin already advertises nvidia.com/gpu; the operator's
# plugin under test serves a distinct resource so the two never contend and
# the check below proves the operator's stack
OPERATOR_RESOURCE="${OPERATOR_RESOURCE:-tpu.ai/gpu}"
HELM_SETS=(
    --set "operator.image=${OPERATOR_IMAGE}"
    --set "operator.version=${OPERATOR_VERSION}"
    --set "devicePlugin.resourceName=${OPERATOR_RESOURCE}"
)
for component in driver devicePlugin validator featureDiscovery telemetry nodeStatusExporter; do
    HELM_SETS+=(
        --set "${component}.repository=${VALIDATOR_IMAGE%/*}"
        --set "${component}.image=${VALIDATOR_IMAGE##*/}"
        --set "${component}.version=${VALIDATOR_VERSION}"
    )
done
helm install gpu-operator "${REPO_ROOT}/deployments/gpu-operator" \
    --namespace tpu-operator --create-namespace \
    "${HELM_SETS[@]}" --wait --timeout 5m

echo "=== verify (a node's join to schedulable inside 120 s) ==="
GPU_RESOURCE_NAME="${OPERATOR_RESOURCE}" "${TEST_DIR}/scripts/torch/verify-real-cluster.sh"

echo "=== e2e PASS ==="
