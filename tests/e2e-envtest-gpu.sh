#!/usr/bin/env bash
# The port's envtest lane (the counterpart of tests/e2e-envtest.sh): five
# control-plane steps (CRD install, server-side schema 422, structural
# pruning, gpu-operator reconciling to ready, ownerRef GC) against real
# `kube-apiserver` and `etcd` binaries booted without containers, driven by
# tests/torch_envtest_driver.py through the port's RestClient.
#
# Binary discovery follows envtest's conventions: $KUBEBUILDER_ASSETS, the
# TEST_ASSET_* variables, /usr/local/kubebuilder/bin, then $PATH. Without
# the binaries the script exits 77 (skip) and writes a skip record naming
# every location probed, to $ENVTEST_SKIP_RECORD, else
# tests/e2e-envtest-gpu-SKIPPED.json (not committed). The driver itself
# still runs everywhere: tests/test_torch_envtest_driver.py drives it
# against the port's in-process MiniApiServer.
set -euo pipefail

REPO="$(cd "$(dirname "$0")/.." && pwd)"
cd "$REPO"
export PYTHONPATH="${REPO}${PYTHONPATH:+:${PYTHONPATH}}"
TMP="${TMPDIR:-/tmp}"

PROBE_LOG="$(mktemp "$TMP/envtest-gpu-probe.XXXXXX")"
find_bin() {  # find_bin <name> <TEST_ASSET_VAR>   (runs in $(...) subshells:
  local name="$1" asset_var="$2" candidate  # probes are recorded in a file)
  for candidate in \
      "${!asset_var:-}" \
      "${KUBEBUILDER_ASSETS:-/nonexistent}/$name" \
      "/usr/local/kubebuilder/bin/$name"; do
    [ -n "$candidate" ] || continue
    echo "$candidate" >> "$PROBE_LOG"
    [ -x "$candidate" ] && { echo "$candidate"; return 0; }
  done
  if command -v "$name" >/dev/null 2>&1; then
    command -v "$name"; return 0
  fi
  echo "PATH:$name" >> "$PROBE_LOG"
  return 1
}

APISERVER="$(find_bin kube-apiserver TEST_ASSET_KUBE_APISERVER || true)"
ETCD="$(find_bin etcd TEST_ASSET_ETCD || true)"
# the controller-manager is optional: without it a bare apiserver runs no
# garbage collector, so the driver checks ownerReferences instead
KCM="$(find_bin kube-controller-manager TEST_ASSET_KUBE_CONTROLLER_MANAGER || true)"

if [ -z "$APISERVER" ] || [ -z "$ETCD" ]; then
  SKIP_RECORD="${ENVTEST_SKIP_RECORD:-$REPO/tests/e2e-envtest-gpu-SKIPPED.json}"
  mkdir -p "$(dirname "$SKIP_RECORD")"
  python3 - "$SKIP_RECORD" "$PROBE_LOG" <<'PYEOF'
import json, sys, time
path = sys.argv[1]
probed = [l.strip() for l in open(sys.argv[2]) if l.strip()]
json.dump({
    "skipped": True,
    "exit": 77,
    "reason": "kube-apiserver and/or etcd binaries not found in this environment",
    "probed_locations": probed,
    "probed_env": ["KUBEBUILDER_ASSETS", "TEST_ASSET_KUBE_APISERVER",
                   "TEST_ASSET_ETCD", "PATH"],
    "assertion_suite_still_executed_via":
        "tests/test_torch_envtest_driver.py (same driver, in-process MiniApiServer)",
    "last_attempt_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
}, open(path, "w"), indent=1)
PYEOF
  rm -f "$PROBE_LOG"
  echo "SKIP: kube-apiserver/etcd not available; record at $SKIP_RECORD"
  exit 77
fi
rm -f "$PROBE_LOG"

echo "=== envtest e2e (gpu-operator): apiserver=$APISERVER etcd=$ETCD kcm=${KCM:-<none>} ==="

EVIDENCE="${E2E_EVIDENCE_DIR:-$TMP/envtest-gpu-evidence}"
mkdir -p "$EVIDENCE"
: > "$EVIDENCE/results.jsonl"
WORK="$(mktemp -d "$TMP/envtest-gpu.XXXXXX")"
ETCD_PORT="${ENVTEST_ETCD_PORT:-23790}"
API_PORT="${ENVTEST_APISERVER_PORT:-26443}"
PIDS=()

cleanup() {
  local rc=$?
  for pid in "${PIDS[@]:-}"; do kill "$pid" >/dev/null 2>&1 || true; done
  cp "$WORK"/*.log "$EVIDENCE"/ 2>/dev/null || true
  rm -rf "$WORK"
  exit $rc
}
trap cleanup EXIT

# -- the control plane (the envtest recipe) -----------------------------------
"$ETCD" --data-dir "$WORK/etcd" \
  --listen-client-urls "http://127.0.0.1:$ETCD_PORT" \
  --advertise-client-urls "http://127.0.0.1:$ETCD_PORT" \
  --listen-peer-urls http://127.0.0.1:0 \
  > "$WORK/etcd.log" 2>&1 &
PIDS+=($!)

openssl genrsa -out "$WORK/sa.key" 2048 >/dev/null 2>&1
TOKEN="envtest-$(head -c8 /dev/urandom | od -An -tx1 | tr -d ' \n')"
echo "$TOKEN,envtest-admin,1,\"system:masters\"" > "$WORK/tokens.csv"

"$APISERVER" \
  --etcd-servers="http://127.0.0.1:$ETCD_PORT" \
  --secure-port="$API_PORT" \
  --bind-address=127.0.0.1 \
  --cert-dir="$WORK/certs" \
  --service-account-key-file="$WORK/sa.key" \
  --service-account-signing-key-file="$WORK/sa.key" \
  --service-account-issuer=https://envtest.local \
  --token-auth-file="$WORK/tokens.csv" \
  --authorization-mode=AlwaysAllow \
  --disable-admission-plugins=ServiceAccount \
  --allow-privileged=true \
  > "$WORK/kube-apiserver.log" 2>&1 &
PIDS+=($!)

echo "waiting for apiserver readyz..."
for _ in $(seq 1 60); do
  if curl -sk -H "Authorization: Bearer $TOKEN" \
      "https://127.0.0.1:$API_PORT/readyz" | grep -q ok; then
    READY=1; break
  fi
  sleep 1
done
[ "${READY:-0}" = 1 ] || { echo "FAIL: apiserver never became ready"; exit 1; }

EXPECT_GC=no
if [ -n "$KCM" ]; then
  cat > "$WORK/kubeconfig" <<KCFG
apiVersion: v1
kind: Config
clusters:
- name: envtest
  cluster:
    server: "https://127.0.0.1:$API_PORT"
    insecure-skip-tls-verify: true
users:
- name: envtest
  user:
    token: "$TOKEN"
contexts:
- name: envtest
  context:
    cluster: envtest
    user: envtest
current-context: envtest
KCFG
  "$KCM" --kubeconfig "$WORK/kubeconfig" \
    --controllers=garbagecollector,namespace \
    --use-service-account-credentials=false \
    --service-account-private-key-file="$WORK/sa.key" \
    > "$WORK/kube-controller-manager.log" 2>&1 &
  PIDS+=($!)
  EXPECT_GC=yes
fi

# -- the shared steps over the wire -------------------------------------------
if python3 tests/torch_envtest_driver.py \
    --base-url "https://127.0.0.1:$API_PORT" \
    --token "$TOKEN" --insecure \
    --evidence-dir "$EVIDENCE" \
    --expect-gc "$EXPECT_GC"; then
  RC=0
else
  RC=$?  # captured by if/else: a bare failing command would trip set -e
fi

echo "=== envtest e2e (gpu-operator): exit $RC (evidence: $EVIDENCE) ==="
exit $RC
