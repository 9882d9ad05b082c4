#!/usr/bin/env bash
# The port's support-bundle collector (the twin of hack/must-gather.sh;
# NVIDIA's hack/must-gather.sh, shipped as /usr/bin/gather in the operator
# image). Two modes:
#
#   BASE=<url> ./gpu-must-gather.sh   harness or in-cluster mode: runs the
#                                     Python collector (gpu-must-gather),
#                                     which speaks the operator's own REST
#                                     client (the cluster harness too)
#   ./gpu-must-gather.sh              kubectl mode for real clusters: the
#                                     same section layout plus what only
#                                     kubectl reaches (pod logs, barrier
#                                     files read through the exporter pod)
#
# Sections: cluster/ crs/ operands/ nodes/ validation/ telemetry/ events/
# operator/ provenance/ plus manifest.json. See
# tpu_operator_torch/cmd/must_gather.py for the layout.
set -uo pipefail

ARTIFACT_DIR="${ARTIFACT_DIR:-${TMPDIR:-/tmp}/gpu-operator-must-gather-$(date +%s)}"
NS="${OPERATOR_NAMESPACE:-tpu-operator}"
K="${KUBECTL:-kubectl}"
STATUS_DIR="${VALIDATION_STATUS_DIR:-/run/tpu/validations}"

# the Python collector: an explicit BASE (the harness), or no kubectl on
# PATH (the operator image has none; the collector then takes the
# in-cluster config). K may be a wrapper with arguments.
if [ -n "${BASE:-}" ] || ! command -v "${K%% *}" >/dev/null 2>&1; then
  exec python3 -m tpu_operator_torch.cmd.must_gather \
    ${BASE:+--base-url "$BASE"} \
    --namespace "$NS" --out "$ARTIFACT_DIR" \
    ${TELEMETRY_URL:+--telemetry-url "$TELEMETRY_URL"} \
    ${STATUS_DIR_OVERRIDE:+--status-dir "$STATUS_DIR_OVERRIDE"}
fi

mkdir -p "$ARTIFACT_DIR"/{cluster,crs,operands/pods,nodes,validation/barriers,telemetry,events,operator,provenance}
echo "gathering into $ARTIFACT_DIR"
manifest_entries=()
error_entries=()

collect() { # collect <section/relpath> <command...>
  local rel="$1"; shift
  mkdir -p "$(dirname "$ARTIFACT_DIR/$rel")"
  if "$@" > "$ARTIFACT_DIR/$rel" 2>&1; then
    manifest_entries+=("$rel")
  else
    # a failure stays out of its section and lands in errors, as in the
    # Python collector's manifest: a partial bundle must not read as whole
    echo "  warning: $rel failed" >&2
    error_entries+=("$rel")
  fi
}

GPU_LABELS=tpu.ai/gpu.present,tpu.ai/tpu.chip-type,tpu.ai/tpu.chip-count,tpu.ai/tpu-driver-upgrade-state,tpu.ai/tpu.driver.stack,tpu.ai/tpu.device-plugin.stack

# cluster/
collect cluster/version.txt        $K version -o yaml
collect cluster/nodes.yaml         $K get nodes -o yaml
collect cluster/node-summary.txt   $K get nodes -L "$GPU_LABELS" \
  -o custom-columns='NODE:.metadata.name,GPUS:.status.capacity.nvidia\.com/gpu,UNSCHEDULABLE:.spec.unschedulable'

# crs/ (the whole objects: spec, status, conditions)
collect crs/clusterpolicies.yaml   $K get clusterpolicies.tpu.ai -o yaml
collect crs/gpudrivers.yaml        $K get gpudrivers.tpu.ai -o yaml

# operands/
collect operands/daemonsets.yaml   $K -n "$NS" get ds -o yaml
collect operands/deployments.yaml  $K -n "$NS" get deploy -o yaml
collect operands/services.yaml     $K -n "$NS" get svc -o yaml
collect operands/configmaps.yaml   $K -n "$NS" get cm -o yaml
for pod in $($K -n "$NS" get pods -o name 2>/dev/null); do
  name="${pod#pod/}"
  collect "operands/pods/$name.yaml"         $K -n "$NS" get "$pod" -o yaml
  collect "operands/pods/$name.describe.txt" $K -n "$NS" describe "$pod"
  collect "operands/pods/$name.log"          $K -n "$NS" logs "$pod" --all-containers --tail=2000
done

# nodes/ and validation/: each GPU node, and its barrier files through the
# node-status exporter pod (it mounts the validation status dir)
collect validation/upgrade-states.txt $K get nodes \
  -L tpu.ai/tpu-driver-upgrade-state -l tpu.ai/gpu.present=true
for node in $($K get nodes -l tpu.ai/gpu.present=true -o name 2>/dev/null); do
  n="${node#node/}"
  collect "nodes/$n.describe.txt" $K describe "$node"
  exporter=$($K -n "$NS" get pods -l app=gpu-node-status-exporter \
    --field-selector "spec.nodeName=$n" -o name 2>/dev/null | head -1)
  if [ -n "$exporter" ]; then
    collect "validation/barriers/$n.txt" \
      $K -n "$NS" exec "${exporter#pod/}" -- \
      sh -c "for f in $STATUS_DIR/*; do echo \"== \$f\"; cat \"\$f\"; done"
  fi
done

# telemetry/: each telemetry pod's metrics port through the API proxy (the
# port is spec.telemetry.metricsPort, 9400 by default)
TPORT=$($K get clusterpolicies.tpu.ai \
  -o jsonpath='{.items[0].spec.telemetry.metricsPort}' 2>/dev/null)
TPORT="${TPORT:-9400}"
for pod in $($K -n "$NS" get pods -l app=gpu-telemetry-exporter -o name 2>/dev/null); do
  name="${pod#pod/}"
  collect "telemetry/$name.prom" \
    $K -n "$NS" get --raw "/api/v1/namespaces/$NS/pods/$name:$TPORT/proxy/metrics"
done

# operator/: each operator pod's metrics and /debug routes through the API
# proxy, the routes from the health server's own table when python3 can
# read it
ROUTES=$(python3 -c 'from tpu_operator_torch.controllers.manager import DEBUG_ROUTES; print(" ".join(DEBUG_ROUTES))' 2>/dev/null \
  || echo /debug/informers /debug/traces /debug/join-traces /debug/queue /debug/state /debug/threads /debug/timeline /debug/capacity)
for pod in $($K -n "$NS" get pods -l app=gpu-operator -o name 2>/dev/null); do
  name="${pod#pod/}"
  collect "operator/$name/metrics.prom" \
    $K -n "$NS" get --raw "/api/v1/namespaces/$NS/pods/$name:8080/proxy/metrics"
  for route in $ROUTES; do
    stem="${route##*/}"
    ext=json; [ "$stem" = threads ] && ext=txt
    collect "operator/$name/$stem.$ext" \
      $K -n "$NS" get --raw "/api/v1/namespaces/$NS/pods/$name:8081/proxy$route"
  done
done

# provenance/: the decision journal's mirror ConfigMaps
collect provenance/decision-records.yaml $K -n "$NS" get cm -l tpu.ai/provenance -o yaml

# events/
collect events/events.txt $K -n "$NS" get events --sort-by=.lastTimestamp

python3 - "$ARTIFACT_DIR" "${#manifest_entries[@]}" \
    "${manifest_entries[@]}" "${error_entries[@]:-}" <<'PY'
import json, sys, collections, time
out, n_ok = sys.argv[1], int(sys.argv[2])
entries, errors = sys.argv[3:3 + n_ok], [e for e in sys.argv[3 + n_ok:] if e]
sections = collections.defaultdict(list)
for entry in entries:
    section, _, rel = entry.partition("/")
    sections[section].append(rel)
with open(f"{out}/manifest.json", "w") as f:
    json.dump({"sections": dict(sections),
               "errors": [f"collection failed: {e}" for e in errors],
               "gathered_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())},
              f, indent=1, sort_keys=True)
PY

tar -C "$(dirname "$ARTIFACT_DIR")" -czf "$ARTIFACT_DIR.tar.gz" "$(basename "$ARTIFACT_DIR")"
echo "wrote $ARTIFACT_DIR.tar.gz"
