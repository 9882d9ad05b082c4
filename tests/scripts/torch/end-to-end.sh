#!/usr/bin/env bash
# The port's shell e2e orchestrator (the counterpart of
# tests/scripts/end-to-end.sh): launch the port's cluster harness, launch
# `gpu-operator` as a process, install the sample ClusterPolicy, run every
# case under tests/cases/torch/, uninstall.
#
# Usage: tests/scripts/torch/end-to-end.sh [case ...]   (default: all cases)
#
# Each case prints its seconds on its PASS line.

set -eu

REPO_ROOT="$(cd "$(dirname "$0")/../../.." && pwd)"
SCRIPTS_DIR="${REPO_ROOT}/tests/scripts/torch"
CASES_DIR="${REPO_ROOT}/tests/cases/torch"
WORK_DIR="$(mktemp -d)"
export PYTHONPATH="${REPO_ROOT}${PYTHONPATH:+:${PYTHONPATH}}"

# Operand default images (what the chart's Deployment sets).
IMAGE="registry.example.com/gpu-operator/gpu-validator:0.1.0"
export DRIVER_IMAGE="${DRIVER_IMAGE:-${IMAGE}}"
export VALIDATOR_IMAGE="${VALIDATOR_IMAGE:-${IMAGE}}"
export DEVICE_PLUGIN_IMAGE="${DEVICE_PLUGIN_IMAGE:-${IMAGE}}"
export FEATURE_DISCOVERY_IMAGE="${FEATURE_DISCOVERY_IMAGE:-${IMAGE}}"
export TELEMETRY_EXPORTER_IMAGE="${TELEMETRY_EXPORTER_IMAGE:-${IMAGE}}"
export SLICE_PARTITIONER_IMAGE="${SLICE_PARTITIONER_IMAGE:-${IMAGE}}"
# free ephemeral ports so concurrent runs (or stray processes) never collide
pick_port() { python3 -c 'import socket; s = socket.socket(); s.bind(("127.0.0.1", 0)); print(s.getsockname()[1]); s.close()'; }
export METRICS_PORT="${METRICS_PORT:-$(pick_port)}"
export HEALTH_PORT="${HEALTH_PORT:-$(pick_port)}"

export WORK_DIR
CLUSTER_PID=""

cleanup() {
    [ -f "${WORK_DIR}/operator.pid" ] && kill "$(cat "${WORK_DIR}/operator.pid")" 2>/dev/null || true
    [ -n "${CLUSTER_PID}" ] && kill "${CLUSTER_PID}" 2>/dev/null || true
    wait 2>/dev/null || true
    rm -rf "${WORK_DIR}"
}
trap cleanup EXIT

echo "=== launch cluster harness (4 GPU nodes) ==="
# the port's harness always makes the DaemonSets' pods
python3 -m tpu_operator_torch.testing.cluster \
    --url-file "${WORK_DIR}/cluster.url" --nodes 4 \
    >"${WORK_DIR}/cluster.log" 2>&1 &
CLUSTER_PID=$!
for _ in $(seq 1 100); do
    [ -s "${WORK_DIR}/cluster.url" ] && break
    sleep 0.1
done
[ -s "${WORK_DIR}/cluster.url" ] || { echo "cluster harness failed to start" >&2; exit 1; }
export BASE="$(cat "${WORK_DIR}/cluster.url")"
echo "cluster at ${BASE}"

. "${SCRIPTS_DIR}/common.sh"

# pidfile-based so cases (run in their own processes) can restart the operator
start_operator() {
    # --leader-elect as the chart runs it; SIGTERM in stop_operator
    # exercises the clean lease release and the fast re-acquire
    python3 -m tpu_operator_torch.cmd.operator \
        --api-server "${BASE}" --namespace "${NS}" \
        --metrics-port "${METRICS_PORT}" --health-port "${HEALTH_PORT}" \
        --leader-elect \
        --log-level info >>"${WORK_DIR}/operator.log" 2>&1 &
    echo $! > "${WORK_DIR}/operator.pid"
}
stop_operator() {
    if [ -f "${WORK_DIR}/operator.pid" ]; then
        kill "$(cat "${WORK_DIR}/operator.pid")" 2>/dev/null || true
        while kill -0 "$(cat "${WORK_DIR}/operator.pid")" 2>/dev/null; do sleep 0.1; done
        rm -f "${WORK_DIR}/operator.pid"
    fi
}
export -f start_operator stop_operator

echo "=== install operator ==="
"${SCRIPTS_DIR}/install-operator.sh"
start_operator

echo "=== verify install ==="
"${SCRIPTS_DIR}/verify-operator.sh"

STATUS=0
CASES="${*:-$(cd "${CASES_DIR}" && ls *.sh)}"
export BASE SCRIPTS_DIR REPO_ROOT
for case_sh in ${CASES}; do
    echo "=== case: ${case_sh} ==="
    t0="$(date +%s.%N)"
    # a fresh bash process, not a sourced subshell: POSIX suppresses
    # `set -e` inside an if-condition subshell, so a sourced case's
    # mid-case wait_for timeout would not fail it
    if bash -eu -c '. "$1"; . "$2"' case-runner \
            "${SCRIPTS_DIR}/common.sh" "${CASES_DIR}/${case_sh}"; then
        echo "=== PASS: ${case_sh} ($(python3 -c "import sys; print(f'{float(sys.argv[2]) - float(sys.argv[1]):.3f}')" "${t0}" "$(date +%s.%N)") s) ==="
    else
        echo "=== FAIL: ${case_sh} ===" >&2
        STATUS=1
        break
    fi
done

echo "=== uninstall ==="
kdel "${CP_PATH}" >/dev/null || true
stop_operator

if [ "${STATUS}" -ne 0 ]; then
    echo "--- operator log tail ---" >&2
    tail -50 "${WORK_DIR}/operator.log" >&2 || true
fi
exit "${STATUS}"
