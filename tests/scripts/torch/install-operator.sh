#!/usr/bin/env bash
# Install step (the counterpart of tests/scripts/install-operator.sh): apply
# the port's sample ClusterPolicy, which is JSON, to the cluster. The
# operator itself is launched by the orchestrator (no real kubelet runs the
# chart's Deployment here).

set -eu
REPO_ROOT="$(cd "$(dirname "$0")/../../.." && pwd)"
. "$(dirname "$0")/common.sh"

SAMPLE="${REPO_ROOT}/tpu_operator_torch/manifests/samples/v1_clusterpolicy.json"
kpost "apis/tpu.ai/v1/clusterpolicies" "$(cat "${SAMPLE}")" >/dev/null
echo "applied tpu_operator_torch/manifests/samples/v1_clusterpolicy.json"
