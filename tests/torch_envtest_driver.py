"""The port's real-apiserver assertion driver (the counterpart of
tests/envtest_driver.py), shared by two transports.

Runs five control-plane steps (CRD install, server-side schema 422,
structural pruning, the port's operator reconciling to ready, ownerRef GC)
through the port's own ``RestClient`` against any wire-compatible
apiserver:

* ``tests/e2e-envtest-gpu.sh`` points it at a real ``kube-apiserver`` and
  ``etcd`` booted without containers (the controller-runtime envtest model);
* ``tests/test_torch_envtest_driver.py`` runs it against the port's
  in-process ``MiniApiServer`` in the default suite, so the driver itself is
  executed where no real apiserver binaries exist.

It takes its CRDs from the chart (``deployments/gpu-operator/crds/``:
ClusterPolicy and GPUDriver) and reads them with the port's YAML subset.
Every step appends to ``<evidence>/results.jsonl``; the exit code is nonzero
when any step fails.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

NS = "tpu-operator"
NODE = "envtest-node-0"
IMAGE = "registry.example.com/gpu-operator/gpu-validator:0.1.0"


def load_crds():
    from tpu_operator_torch import yamlsubset

    docs = []
    for path in sorted(glob.glob(
            os.path.join(REPO, "deployments", "gpu-operator", "crds", "*.yaml"))):
        with open(path) as f:
            docs.extend(d for d in yamlsubset.parse_all(f.read()) if d)
    return docs


class Driver:
    def __init__(self, client, evidence_dir: str, expect_gc: str = "no",
                 timeout: float = 120.0):
        self.client = client
        self.evidence_dir = evidence_dir
        self.expect_gc = expect_gc
        self.timeout = timeout
        self.results = []
        self._t0 = time.monotonic()
        os.makedirs(evidence_dir, exist_ok=True)

    def record(self, step: str, status: str, detail: str = "") -> None:
        entry = {"step": step, "status": status,
                 "t_offset_s": round(time.monotonic() - self._t0, 1),
                 "detail": detail[:300]}
        self.results.append(entry)
        with open(os.path.join(self.evidence_dir, "results.jsonl"), "a") as f:
            f.write(json.dumps(entry) + "\n")
        print(f"[{status}] {step} {detail[:120]}", flush=True)

    def _wait(self, cond, timeout: float = None) -> bool:
        from tpu_operator_torch.client.errors import ApiError

        deadline = time.monotonic() + (timeout or self.timeout)
        while time.monotonic() < deadline:
            try:
                if cond():
                    return True
            except (ApiError, ConnectionError, KeyError):
                pass
            time.sleep(0.5)
        return False

    # -- steps ----------------------------------------------------------------
    def install_crds(self) -> bool:
        from tpu_operator_torch.client.errors import AlreadyExistsError
        from tpu_operator_torch.utils import deep_get

        crds = load_crds()
        for crd in crds:
            try:
                self.client.create(crd)
            except AlreadyExistsError:
                pass

        def established(name):
            live = self.client.get("apiextensions.k8s.io/v1",
                                   "CustomResourceDefinition", name)
            conds = deep_get(live, "status", "conditions", default=[]) or []
            if any(c.get("type") == "Established" and c.get("status") == "True"
                   for c in conds):
                return True
            # a server that publishes no Established condition (the
            # in-process one) counts once the CR endpoint serves a list
            group = deep_get(live, "spec", "group")
            versions = deep_get(live, "spec", "versions", default=[]) or [{}]
            kind = deep_get(live, "spec", "names", "kind")
            self.client.list(f"{group}/{versions[0].get('name', 'v1')}", kind)
            return True

        for crd in crds:
            name = crd["metadata"]["name"]
            if not self._wait(lambda: established(name), timeout=30):
                self.record("crd-install", "fail", f"{name} never established")
                return False
        kinds = sorted(c["spec"]["names"]["kind"] for c in crds)
        self.record("crd-install", "pass", f"{len(crds)} CRDs established: {', '.join(kinds)}")
        return True

    def schema_422(self) -> bool:
        from tpu_operator_torch.client.errors import InvalidError

        bad = {"apiVersion": "tpu.ai/v1", "kind": "ClusterPolicy",
               "metadata": {"name": "bad-policy"},
               "spec": {"driver": {"version": {"oops": "a-map-not-a-string"}}}}
        try:
            self.client.create(bad)
        except InvalidError as e:
            self.record("schema-422", "pass", f"server rejected: {e}")
            return True
        self.client.delete("tpu.ai/v1", "ClusterPolicy", "bad-policy")
        self.record("schema-422", "fail", "typo'd ClusterPolicy was admitted")
        return False

    def structural_pruning(self) -> bool:
        """An unknown spec field must never persist: a real apiserver prunes
        it (structural schema), the in-process one refuses it; either keeps
        it out of storage."""
        from tpu_operator_torch.api.clusterpolicy import new_cluster_policy
        from tpu_operator_torch.client.errors import InvalidError
        from tpu_operator_torch.utils import deep_get

        policy = new_cluster_policy()
        policy["metadata"]["name"] = "prune-probe"
        policy["spec"]["definitelyNotAField"] = {"x": 1}
        try:
            created = self.client.create(policy)
        except InvalidError:
            self.record("structural-pruning", "pass",
                        "unknown spec field rejected at admission")
            return True
        pruned = deep_get(created, "spec", "definitelyNotAField") is None
        live = self.client.get("tpu.ai/v1", "ClusterPolicy", "prune-probe")
        pruned = pruned and deep_get(live, "spec", "definitelyNotAField") is None
        self.client.delete("tpu.ai/v1", "ClusterPolicy", "prune-probe")
        self.record("structural-pruning", "pass" if pruned else "fail",
                    "unknown spec field pruned server-side" if pruned
                    else "unknown field persisted")
        return pruned

    def reconcile_to_ready(self) -> bool:
        """The port's operator and the kubelet simulator against the live
        apiserver: a GPU node joins, advertises ``nvidia.com/gpu``, and the
        ClusterPolicy reaches ready."""
        from tpu_operator_torch import consts
        from tpu_operator_torch.api.clusterpolicy import new_cluster_policy
        from tpu_operator_torch.client.errors import AlreadyExistsError
        from tpu_operator_torch.controllers.manager import OperatorApp
        from tpu_operator_torch.testing.kubelet import KubeletSimulator
        from tpu_operator_torch.utils import deep_get

        defaults = {name: IMAGE for name in (
            "DRIVER_IMAGE", "VALIDATOR_IMAGE", "DEVICE_PLUGIN_IMAGE", "FEATURE_DISCOVERY_IMAGE",
            "TELEMETRY_EXPORTER_IMAGE", "SLICE_PARTITIONER_IMAGE")}
        defaults[consts.NAMESPACE_ENV] = NS
        # restored afterwards: embedded in a pytest process, leaked defaults
        # would make later missing-image tests order-dependent
        saved = {k: os.environ.get(k) for k in defaults}
        for key, value in defaults.items():
            os.environ.setdefault(key, value)
        for obj in ({"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}},
                    new_cluster_policy(),
                    {"apiVersion": "v1", "kind": "Node",
                     "metadata": {"name": NODE, "labels": {
                         consts.NFD_NVIDIA_PCI_LABEL: "true",
                         consts.GKE_ACCELERATOR_LABEL: "nvidia-h100-80gb"}},
                     "status": {}}):
            try:
                self.client.create(obj)
            except AlreadyExistsError:
                pass

        app = OperatorApp(self.client)
        kubelet = KubeletSimulator(self.client, interval=0.2)
        app.start()
        kubelet.start()
        try:
            def converged():
                node = self.client.get("v1", "Node", NODE)
                policy = self.client.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
                return (deep_get(node, "status", "capacity",
                                 consts.GPU_RESOURCE_NAME) is not None
                        and deep_get(policy, "status", "state") == "ready")

            ok = self._wait(converged)
        finally:
            app.stop()
            kubelet.stop()
            for key, value in saved.items():
                if value is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = value
        self.record("reconcile-to-ready", "pass" if ok else "fail",
                    "node schedulable (nvidia.com/gpu) + ClusterPolicy ready" if ok
                    else "never converged")
        return ok

    def ownerref_gc(self) -> bool:
        """Deleting the ClusterPolicy cascades to its DaemonSets, but the
        cascade is the controller-manager's garbage collector, which a bare
        apiserver does not run. ``expect_gc`` 'yes' asserts the deletion;
        'no' asserts well-formed ownerReferences and records a skip for the
        cascade itself."""
        from tpu_operator_torch.utils import deep_get

        owned = self.client.list("apps/v1", "DaemonSet", NS)
        if not owned:
            self.record("ownerref-gc", "fail", "no owned DaemonSets to GC")
            return False
        policy = self.client.get("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
        uid = policy["metadata"].get("uid")
        bad_refs = [ds["metadata"]["name"] for ds in owned
                    if not any(r.get("uid") == uid and r.get("controller")
                               for r in deep_get(ds, "metadata", "ownerReferences",
                                                 default=[]) or [])]
        if bad_refs:
            self.record("ownerref-gc", "fail", f"missing/odd ownerReferences: {bad_refs}")
            return False
        if self.expect_gc == "no":
            self.record("ownerref-gc", "skip",
                        "ownerReferences verified; cascade needs "
                        "kube-controller-manager (not booted)")
            return True
        self.client.delete("tpu.ai/v1", "ClusterPolicy", "cluster-policy")
        ok = self._wait(lambda: not self.client.list("apps/v1", "DaemonSet", NS))
        self.record("ownerref-gc", "pass" if ok else "fail",
                    "owned DaemonSets garbage-collected" if ok
                    else "owned DaemonSets survived CR deletion")
        return ok

    def run(self) -> int:
        ok = self.install_crds()
        ok = self.schema_422() and ok
        ok = self.structural_pruning() and ok
        ok = self.reconcile_to_ready() and ok
        ok = self.ownerref_gc() and ok
        self.record("overall", "pass" if ok else "fail")
        return 0 if ok else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="torch_envtest_driver")
    p.add_argument("--base-url", help="the apiserver's URL")
    p.add_argument("--token", default=None)
    p.add_argument("--insecure", action="store_true",
                   help="skip TLS verification (self-signed envtest certs)")
    p.add_argument("--evidence-dir", default=os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "envtest-gpu-evidence"))
    p.add_argument("--expect-gc", choices=["yes", "no"], default="no")
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument("--mini-apiserver", action="store_true",
                   help="boot the port's in-process MiniApiServer and run against it "
                        "(its fake garbage-collects, so --expect-gc yes applies)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from tpu_operator_torch.client.rest import RestClient

    srv = None
    base = args.base_url
    if args.mini_apiserver:
        from tpu_operator_torch.testing.apiserver import MiniApiServer

        srv = MiniApiServer()
        base = srv.start()
    if not base:
        build_parser().error("--base-url or --mini-apiserver is required")
    try:
        client = RestClient(base_url=base, token=args.token,
                            verify=False if args.insecure else None)
        return Driver(client, args.evidence_dir, expect_gc=args.expect_gc,
                      timeout=args.timeout).run()
    finally:
        if srv is not None:
            srv.stop()


if __name__ == "__main__":
    sys.exit(main())
