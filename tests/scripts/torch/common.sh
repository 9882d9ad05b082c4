# Shared helpers for the port's shell e2e layer (the counterpart of
# tests/scripts/common.sh). Requires: $BASE (API server base URL). Uses curl
# and python3 only, no jq; the port's samples are JSON.

set -u

NS="${OPERATOR_NAMESPACE:-tpu-operator}"
CP_PATH="apis/tpu.ai/v1/clusterpolicies/cluster-policy"

kget() { # kget <path>
    curl -sf "${BASE}/$1"
}

kpost() { # kpost <path> <json>
    curl -sf -X POST -H 'Content-Type: application/json' -d "$2" "${BASE}/$1"
}

kpatch() { # kpatch <path> <merge-patch-json>
    curl -sf -X PATCH -H 'Content-Type: application/merge-patch+json' -d "$2" "${BASE}/$1"
}

kdel() { # kdel <path>
    curl -sf -X DELETE "${BASE}/$1"
}

jsonq() { # jsonq '<python expr over obj>'   (reads JSON on stdin)
    python3 -c "import sys, json; obj = json.load(sys.stdin); print($1)"
}

# wait_for <description> <timeout_s> <command...>  — poll until command exits 0
wait_for() {
    local desc="$1" timeout="$2"; shift 2
    local deadline=$(( $(date +%s) + timeout ))
    while true; do
        if "$@" >/dev/null 2>&1; then
            echo "ok: ${desc}"
            return 0
        fi
        if [ "$(date +%s)" -ge "${deadline}" ]; then
            echo "TIMEOUT waiting for: ${desc}" >&2
            return 1
        fi
        sleep 0.2
    done
}

cp_state_is() { # cp_state_is <state>
    [ "$(kget "${CP_PATH}" | jsonq 'obj.get("status", {}).get("state")')" = "$1" ]
}

ds_ready() { # ds_ready <name> — desired==available==updated and desired>0
    kget "apis/apps/v1/namespaces/${NS}/daemonsets/$1" | jsonq '
(lambda s: "ready" if s.get("desiredNumberScheduled", 0) > 0
 and s.get("desiredNumberScheduled") == s.get("numberAvailable")
 == s.get("updatedNumberScheduled") else sys.exit(1))(obj.get("status", {}))'
}

ds_absent() { # ds_absent <name>
    ! kget "apis/apps/v1/namespaces/${NS}/daemonsets/$1"
}

ds_image() { # ds_image <name> — first container image
    kget "apis/apps/v1/namespaces/${NS}/daemonsets/$1" \
        | jsonq 'obj["spec"]["template"]["spec"]["containers"][0]["image"]'
}

nodes_schedulable() { # nodes_schedulable <n> — n nodes advertise nvidia.com/gpu
    [ "$(kget "api/v1/nodes" | jsonq 'sum(1 for n in obj["items"]
        if n.get("status", {}).get("capacity", {}).get("nvidia.com/gpu"))')" = "$1" ]
}

operator_metric_nonzero() { # operator_metric_nonzero <metric-name>
    curl -sf "http://127.0.0.1:${METRICS_PORT}/metrics" \
        | grep "^$1" | grep -qv ' 0\.0$'
}
