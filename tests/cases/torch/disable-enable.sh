# Case: disabling an operand deletes its DaemonSet; re-enabling restores it
# (the counterpart of tests/cases/disable-enable.sh).

set -eu

kpatch "${CP_PATH}" '{"spec": {"telemetry": {"enabled": false}}}' >/dev/null
wait_for "telemetry DS deleted when disabled" 30 ds_absent gpu-telemetry-exporter
wait_for "ClusterPolicy ready with operand disabled" 60 cp_state_is ready

kpatch "${CP_PATH}" '{"spec": {"telemetry": {"enabled": true}}}' >/dev/null
wait_for "telemetry DS restored" 30 ds_ready gpu-telemetry-exporter
wait_for "ClusterPolicy ready again" 60 cp_state_is ready
