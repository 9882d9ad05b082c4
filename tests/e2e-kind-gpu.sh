#!/usr/bin/env bash
# The port's real-apiserver e2e on kind (the counterpart of tests/e2e-kind.sh):
# gpu-operator against a real kube-apiserver, kubelet and DaemonSet
# controller in an ephemeral kind cluster, in five steps:
#
#   1. CRDs and the operator installed from deploy/gpu-operator.yaml alone
#   2. a typo'd ClusterPolicy field is refused by the apiserver (422)
#   3. reconcile to ready on a stub GPU node: a node-prep DaemonSet plants
#      fake libcuda.so.1/libnvidia-ml.so.1 (ELF magic only) where
#      GPU_HOST_DRIVER_PATHS looks and fake /dev/nvidia* device files; the
#      host driver is adopted (driver disabled), and so is the host's
#      device plugin: a kind node has no NVML, so the script advertises
#      nvidia.com/gpu through the node's status as a platform plugin would,
#      before the operator first labels the node. The components that read
#      NVML or run CUDA (feature discovery, telemetry, the validator's
#      sweep) are off; the node status exporter counts the fake devices
#      through spec.hostPaths.devGlobs
#   4. disabling and enabling an operand flips its DaemonSet
#   5. deleting the ClusterPolicy garbage-collects its objects (the real
#      apiserver's ownerRef GC)
#
# with `gpuop-cfg status` and /debug/informers captured between 3 and 4.
set -euo pipefail

# Needs kind, docker and kubectl (CI); exits 77 (skip) without them, with a
# record of the missing tool where $KIND_SKIP_RECORD points, if it is set.
for tool in kind docker kubectl; do
  command -v "$tool" >/dev/null 2>&1 || {
    if [ -n "${KIND_SKIP_RECORD:-}" ]; then
      printf '{"skipped": true, "exit": 77, "missing": "%s", "needs": ["kind", "docker", "kubectl"]}\n' \
        "$tool" > "$KIND_SKIP_RECORD"
    fi
    echo "SKIP: $tool not available (the kind e2e needs kind, docker and kubectl)"
    exit 77
  }
done

REPO="$(cd "$(dirname "$0")/.." && pwd)"
CLUSTER="${KIND_CLUSTER_NAME:-gpu-operator-e2e}"
NS=tpu-operator
cd "$REPO"
export PYTHONPATH="${REPO}${PYTHONPATH:+:${PYTHONPATH}}"

# -- evidence: every step appends to results.jsonl; the EXIT trap writes
# junit XML and keeps the operator's and the cluster's logs -------------------
EVIDENCE="${E2E_EVIDENCE_DIR:-${TMPDIR:-/tmp}/kind-gpu-e2e-evidence}"
mkdir -p "$EVIDENCE"
: > "$EVIDENCE/results.jsonl"
STEP_T0=$(date +%s)

record() {  # record <pass|fail|skip> <step-name> [detail]
  local status="$1" step="$2" detail="${3:-}"
  printf '{"step":"%s","status":"%s","t_offset_s":%s,"detail":"%s"}\n' \
    "$step" "$status" "$(( $(date +%s) - STEP_T0 ))" "$detail" \
    >> "$EVIDENCE/results.jsonl"
}

finalize() {
  local rc=$?
  [ $rc -eq 0 ] && record pass overall || record fail overall "exit=$rc"
  kubectl version -o json > "$EVIDENCE/apiserver-version.json" 2>/dev/null || true
  kubectl -n "$NS" logs deploy/gpu-operator --tail=2000 \
    > "$EVIDENCE/operator.log" 2>/dev/null || true
  kubectl get clusterpolicies.tpu.ai -o json \
    > "$EVIDENCE/clusterpolicies.json" 2>/dev/null || true
  kubectl -n "$NS" get all -o wide > "$EVIDENCE/workloads.txt" 2>/dev/null || true
  kind export logs "$EVIDENCE/kind-logs" --name "$CLUSTER" >/dev/null 2>&1 || true
  python3 - "$EVIDENCE" <<'PYEOF' || true
import json, sys, xml.sax.saxutils as x
d = sys.argv[1]
cases = [json.loads(l) for l in open(f"{d}/results.jsonl") if l.strip()]
failures = sum(1 for c in cases if c["status"] not in ("pass", "skip"))
skipped = sum(1 for c in cases if c["status"] == "skip")
with open(f"{d}/junit.xml", "w") as f:
    f.write(f'<testsuite name="kind-gpu-e2e" tests="{len(cases)}" '
            f'failures="{failures}" skipped="{skipped}">')
    for c in cases:
        f.write(f'<testcase name={x.quoteattr(c["step"])} time="{c["t_offset_s"]}">')
        if c["status"] == "skip":
            f.write(f'<skipped message={x.quoteattr(c.get("detail", ""))}/>')
        elif c["status"] != "pass":
            f.write(f'<failure message={x.quoteattr(c.get("detail", ""))}/>')
        f.write('</testcase>')
    f.write('</testsuite>')
PYEOF
  kind delete cluster --name "$CLUSTER" >/dev/null 2>&1 || true
  exit $rc
}

echo "=== build images ==="
docker build -q -t gpu-operator:e2e -f docker/gpu-operator.Dockerfile .
docker build -q -t gpu-validator:e2e -f docker/gpu-validator.Dockerfile .

echo "=== create cluster ==="
kind create cluster --name "$CLUSTER" --wait 180s
trap finalize EXIT
record pass create-cluster
kind load docker-image gpu-operator:e2e gpu-validator:e2e --name "$CLUSTER"

echo "=== 1. install: the static install (CRDs, RBAC, Deployment) ==="
kubectl apply -f deploy/gpu-operator.yaml
kubectl -n "$NS" set image deployment/gpu-operator gpu-operator=gpu-operator:e2e
kubectl -n "$NS" set env deployment/gpu-operator \
  DRIVER_IMAGE=gpu-validator:e2e VALIDATOR_IMAGE=gpu-validator:e2e \
  DEVICE_PLUGIN_IMAGE=gpu-validator:e2e FEATURE_DISCOVERY_IMAGE=gpu-validator:e2e \
  TELEMETRY_EXPORTER_IMAGE=gpu-validator:e2e SLICE_PARTITIONER_IMAGE=gpu-validator:e2e
kubectl -n "$NS" rollout status deployment/gpu-operator --timeout 180s
record pass static-install

echo "=== 2. the apiserver refuses a typo'd field (the generated schema) ==="
if kubectl apply -f - <<'EOF' 2>"$EVIDENCE/typo-err.txt"
apiVersion: tpu.ai/v1
kind: ClusterPolicy
metadata:
  name: typo-policy
spec:
  driver:
    driverVerion: "580.95.05"
EOF
then
  echo "FAIL: the apiserver accepted a typo'd field"; record fail schema-422; exit 1
fi
# the refusal must be identified, not merely happen
if grep -qi "driverVerion\|unknown field\|ValidationError" "$EVIDENCE/typo-err.txt"; then
  echo "ok: typo refused server-side"; record pass schema-422
else
  echo "FAIL: refused, but the message is not the schema's:"
  cat "$EVIDENCE/typo-err.txt"; record fail schema-422 "unrecognized refusal"; exit 1
fi

echo "=== 3a. node prep: a stub GPU node ==="
NODE=$(kubectl get nodes -o name | head -1); NODE="${NODE#node/}"
kubectl label node "$NODE" \
  feature.node.kubernetes.io/pci-10de.present=true \
  cloud.google.com/gke-accelerator=nvidia-h100-80gb --overwrite
# fake host driver libraries (ELF magic) and device files, by a privileged one-shot
kubectl apply -f - <<'EOF'
apiVersion: apps/v1
kind: DaemonSet
metadata:
  name: node-prep
  namespace: kube-system
spec:
  selector:
    matchLabels:
      app: node-prep
  template:
    metadata:
      labels:
        app: node-prep
    spec:
      tolerations:
        - operator: Exists
      containers:
        - name: prep
          image: busybox
          command: [sh, -c]
          args:
            - mkdir -p /host/home/kubernetes/bin/nvidia/lib64 && printf '\177ELF-fake-libcuda' > /host/home/kubernetes/bin/nvidia/lib64/libcuda.so.1 && printf '\177ELF-fake-libnvidia-ml' > /host/home/kubernetes/bin/nvidia/lib64/libnvidia-ml.so.1 && touch /host/dev/nvidia0 /host/dev/nvidia1 /host/dev/nvidiactl && sleep 1000000
          securityContext:
            privileged: true
          volumeMounts:
            - name: host
              mountPath: /host
      volumes:
        - name: host
          hostPath:
            path: /
EOF
kubectl -n kube-system rollout status daemonset/node-prep --timeout 120s
# the platform's device plugin, stood in for: a kind node has no NVML
kubectl patch node "$NODE" --subresource=status --type=json \
  -p '[{"op":"add","path":"/status/capacity/nvidia.com~1gpu","value":"2"}]'
record pass node-prep

echo "=== 3b. ClusterPolicy: host driver and host plugin adopted ==="
kubectl apply -f - <<'EOF'
apiVersion: tpu.ai/v1
kind: ClusterPolicy
metadata:
  name: cluster-policy
spec:
  driver:
    enabled: false
  featureDiscovery:
    enabled: false
  telemetry:
    enabled: false
  validator:
    enabled: false
  slicePartitioner:
    enabled: false
  nodeStatusExporter:
    enabled: true
  hostPaths:
    devGlobs:
      - "/dev/nvidia[0-9]*"
EOF

echo "=== 3c. reconcile to ready ==="
kubectl wait clusterpolicies.tpu.ai/cluster-policy \
  --for jsonpath='{.status.state}'=ready --timeout 600s || {
    echo "--- debug dump ---"
    kubectl get clusterpolicies.tpu.ai -o json
    kubectl -n "$NS" get all -o wide
    kubectl -n "$NS" logs deploy/gpu-operator --tail=100
    for p in $(kubectl -n "$NS" get pods -o name); do
      echo "--- $p"; kubectl -n "$NS" describe "$p" | tail -30
      kubectl -n "$NS" logs "$p" --all-containers --tail=30 || true
    done
    record fail reconcile-to-ready
    exit 1
  }
echo "ok: ClusterPolicy ready against a real apiserver"
record pass reconcile-to-ready
kubectl get clusterpolicies.tpu.ai/cluster-policy \
  -o jsonpath='{.status.conditions[?(@.type=="Ready")].status}' | grep -q True
STACKS=$(kubectl get node "$NODE" \
  -o jsonpath='{.metadata.labels.tpu\.ai/tpu\.driver\.stack}/{.metadata.labels.tpu\.ai/tpu\.device-plugin\.stack}')
[ "$STACKS" = "host/host" ] || {
  echo "FAIL: driver/plugin stacks $STACKS, not host/host"; record fail host-adoption "$STACKS"; exit 1; }
CAP=$(kubectl get node "$NODE" -o jsonpath='{.status.capacity.nvidia\.com/gpu}')
[ -n "$CAP" ] && [ "$CAP" != "0" ] || {
  echo "FAIL: nvidia.com/gpu no longer advertised"; record fail gpu-capacity; exit 1; }
echo "ok: host driver and plugin adopted, nvidia.com/gpu=$CAP"
record pass host-adoption "$CAP"

echo "=== live triage surfaces ==="
# gpuop-cfg status against the real apiserver through kubectl proxy (the
# port's CLI needs only the standard library), and the operator's debug
# routes into the evidence bundle
kubectl proxy --port=8001 > "$EVIDENCE/kubectl-proxy.log" 2>&1 &
PROXY_PID=$!
timeout 30 bash -c \
  'until curl -sf http://127.0.0.1:8001/version >/dev/null; do sleep 1; done' \
  || { echo "FAIL: kubectl proxy never came up"; cat "$EVIDENCE/kubectl-proxy.log";
       record fail cfg-status "proxy unreachable"; kill $PROXY_PID 2>/dev/null; exit 1; }
if python3 -m tpu_operator_torch.cmd.cfg status --base-url http://127.0.0.1:8001 \
    > "$EVIDENCE/gpuop-cfg-status.txt" 2>&1; then
  echo "ok: gpuop-cfg status reports ready"; record pass cfg-status
else
  echo "FAIL: gpuop-cfg status"; cat "$EVIDENCE/gpuop-cfg-status.txt"
  record fail cfg-status; kill $PROXY_PID; exit 1
fi
kill $PROXY_PID 2>/dev/null || true
OPPOD=$(kubectl -n "$NS" get pods -l app=gpu-operator -o jsonpath='{.items[0].metadata.name}')
if kubectl get --raw "/api/v1/namespaces/$NS/pods/$OPPOD:8081/proxy/debug/informers" \
    > "$EVIDENCE/debug-informers.json" 2>/dev/null; then
  echo "ok: /debug/informers captured"; record pass debug-informers
else
  echo "warn: /debug/informers not captured"; record skip debug-informers "endpoint unreachable"
fi

echo "=== 4. disabling and enabling an operand flips its DaemonSet ==="
kubectl patch clusterpolicies.tpu.ai/cluster-policy --type merge \
  -p '{"spec":{"nodeStatusExporter":{"enabled":false}}}'
timeout 120 bash -c \
  'until ! kubectl -n '"$NS"' get ds gpu-node-status-exporter >/dev/null 2>&1; do sleep 2; done'
echo "ok: node status exporter DS removed"
kubectl patch clusterpolicies.tpu.ai/cluster-policy --type merge \
  -p '{"spec":{"nodeStatusExporter":{"enabled":true}}}'
timeout 120 bash -c \
  'until kubectl -n '"$NS"' get ds gpu-node-status-exporter >/dev/null 2>&1; do sleep 2; done'
echo "ok: node status exporter DS recreated"
record pass operand-disable-enable

echo "=== 5. deleting the ClusterPolicy garbage-collects its objects ==="
kubectl delete clusterpolicies.tpu.ai/cluster-policy --wait
timeout 180 bash -c \
  'until [ "$(kubectl -n '"$NS"' get ds -o name | wc -l)" = 0 ]; do sleep 2; done'
echo "ok: owned DaemonSets garbage-collected by the real apiserver"
record pass ownerref-gc

echo "=== PASS: kind e2e (gpu-operator) ==="
