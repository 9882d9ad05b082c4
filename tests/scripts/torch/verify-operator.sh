#!/usr/bin/env bash
# Verify step (the counterpart of tests/scripts/verify-operator.sh): every
# enabled operand DaemonSet ready, the ClusterPolicy ready, all nodes
# advertising nvidia.com/gpu, the operator's metrics live.

set -eu
. "$(dirname "$0")/common.sh"

for ds in gpu-driver gpu-operator-validator gpu-device-plugin \
          gpu-feature-discovery gpu-telemetry-exporter gpu-node-status-exporter; do
    wait_for "daemonset ${ds} ready" 60 ds_ready "${ds}"
done
wait_for "ClusterPolicy state=ready" 60 cp_state_is ready
wait_for "4 nodes schedulable (nvidia.com/gpu capacity)" 60 nodes_schedulable 4
wait_for "operator reconciliation metric" 30 \
    operator_metric_nonzero tpu_operator_reconciliation_total
curl -sf "http://127.0.0.1:${HEALTH_PORT}/healthz" >/dev/null && echo "ok: healthz"
