# Case: an operator restart resumes from the cluster's state (the
# counterpart of tests/cases/restart-operator.sh): all durable state lives
# in the apiserver, so a restart must reconcile what changed while it was
# down.

set -eu

stop_operator

# mutate the cluster behind the operator's back: delete an operand DS
kdel "apis/apps/v1/namespaces/${NS}/daemonsets/gpu-feature-discovery" >/dev/null
ds_absent gpu-feature-discovery || { echo "DS still present after delete" >&2; exit 1; }

start_operator
wait_for "feature-discovery DS recreated after restart" 60 ds_ready gpu-feature-discovery
wait_for "ClusterPolicy ready after restart" 60 cp_state_is ready
