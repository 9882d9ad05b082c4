"""``gpu-must-gather``: the support-bundle collector (counterpart of
tpu_operator/cmd/must_gather.py; NVIDIA's hack/must-gather.sh, shipped as
/usr/bin/gather in the operator image).

Gathers the sections a support case needs:

  cluster/     server version, clusterinfo (Kubernetes version, container
               runtime), nodes (full YAML and a table of the GPU labels, the
               upgrade state and ``nvidia.com/gpu`` capacity)
  crs/         ClusterPolicy and GPUDriver objects with status and conditions
  operands/    DaemonSets, Deployments, Services, ConfigMaps,
               ServiceAccounts and each pod of the operator's namespace
  nodes/       each GPU node's labels, annotations, capacity and taints
  validation/  the nodes' upgrade states and the validation barrier files
               (on a node, or pointed at a status dir)
  telemetry/   a live scrape of each exporter's /metrics
  events/      the namespace's Events
  operator/    each operator pod's /metrics and every /debug route
  provenance/  the decision journal (its mirror ConfigMaps, the JSONL)

plus a manifest.json index that tests (and humans) check for completeness.
It speaks the operator's own REST client, so the same collector runs
against a real apiserver, the cluster harness, or in-cluster; an endpoint it
cannot reach becomes a recorded error, never a crash. YAML is written with
:func:`~tpu_operator_torch.yamlsubset.dump` (no PyYAML), and nothing here
imports torch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tarfile
import tempfile
import time
import urllib.request
from typing import Dict, List, Optional

from .. import consts, yamlsubset
from ..client.errors import ApiError
from ..client.rest import RestClient
from ..nodeinfo.node_info import is_gpu_node
from ..utils import deep_get

SECTIONS = ("cluster", "crs", "operands", "nodes", "validation",
            "telemetry", "events", "operator", "provenance")

#: the operator pods' app label (the chart's Deployment)
OPERATOR_APP = consts.OPERATOR_NAME


def debug_endpoint_files():
    """(route, bundle filename) for every /debug route the operator's health
    server answers, from the server's own table
    (``controllers.manager.DEBUG_ROUTES``): a route added there is collected
    here without a second edit."""
    from ..controllers.manager import DEBUG_ROUTES

    out = []
    for route in DEBUG_ROUTES:
        stem = route.rsplit("/", 1)[-1]
        out.append((route, f"{stem}.txt" if stem == "threads" else f"{stem}.json"))
    return out


#: node label columns of the summary table: presence, the GPU model and
#: count feature discovery labels, the upgrade state and the stacks
NODE_LABEL_COLUMNS = (
    consts.GPU_PRESENT_LABEL,
    consts.TPU_CHIP_TYPE_LABEL,
    consts.TPU_CHIP_COUNT_LABEL,
    consts.UPGRADE_STATE_LABEL,
    consts.DRIVER_STACK_LABEL,
    consts.PLUGIN_STACK_LABEL,
)


def _yaml(content) -> str:
    """``content`` as YAML in the subset; as JSON (which YAML reads too)
    where the subset cannot hold a string in it."""
    try:
        return yamlsubset.dump(content) + "\n"
    except yamlsubset.SubsetError:
        return json.dumps(content, indent=1) + "\n"


class MustGather:
    def __init__(self, client, namespace: str, out_dir: str,
                 status_dir: Optional[str] = None,
                 telemetry_urls: Optional[List[str]] = None,
                 operator_metrics_port: int = 8080,
                 operator_health_port: int = 8081,
                 journal_path: Optional[str] = None):
        self.client = client
        self.namespace = namespace
        self.out_dir = out_dir
        self.journal_path = journal_path or os.environ.get(consts.JOURNAL_PATH_ENV) or None
        self.status_dir = status_dir or (
            consts.VALIDATION_STATUS_DIR
            if os.path.isdir(consts.VALIDATION_STATUS_DIR) else None)
        self.telemetry_urls = telemetry_urls or []
        self.operator_metrics_port = operator_metrics_port
        self.operator_health_port = operator_health_port
        self.manifest: Dict[str, List[str]] = {s: [] for s in SECTIONS}
        self.errors: List[str] = []
        self._nodes: Optional[List[dict]] = None

    def _list_nodes(self) -> List[dict]:
        """One LIST for the whole run: three sections read nodes, and one
        snapshot keeps them consistent (and a large fleet's apiserver
        unhammered)."""
        if self._nodes is None:
            self._nodes = self._try("nodes", self.client.list, "v1", "Node") or []
        return self._nodes

    # -- plumbing ------------------------------------------------------------
    def _write(self, section: str, name: str, content) -> None:
        path = os.path.join(self.out_dir, section, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if isinstance(content, (dict, list)):
            content = _yaml(content)
        with open(path, "w") as f:
            f.write(content if isinstance(content, str) else str(content))
        self.manifest[section].append(name)

    def _try(self, what, fn, *args, **kw):
        try:
            return fn(*args, **kw)
        except (ApiError, OSError) as e:
            self.errors.append(f"{what}: {e}")
            return None

    # -- sections ------------------------------------------------------------
    def gather_cluster(self) -> None:
        from ..clusterinfo import ClusterInfo

        version = self._try("server version", self.client.server_version)
        self._write("cluster", "version.txt", str(version))
        info = ClusterInfo(self.client, one_shot=True)
        runtime = self._try("container runtime", info.container_runtime)
        self._write("cluster", "clusterinfo.txt",
                    f"kubernetes: {self._try('kubernetes version', info.kubernetes_version)}"
                    f"  runtime: {runtime}  nodes: {len(self._list_nodes())}\n")
        nodes = self._list_nodes()
        self._write("cluster", "nodes.yaml", nodes)
        rows = [["NODE", *NODE_LABEL_COLUMNS, "CAPACITY", "UNSCHEDULABLE"]]
        for n in nodes:
            labels = deep_get(n, "metadata", "labels", default={}) or {}
            rows.append([
                n["metadata"]["name"],
                *[labels.get(c, "-") for c in NODE_LABEL_COLUMNS],
                str(deep_get(n, "status", "capacity", consts.GPU_RESOURCE_NAME, default="-")),
                str(deep_get(n, "spec", "unschedulable", default=False)),
            ])
        widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
        table = "\n".join("  ".join(c.ljust(w) for c, w in zip(r, widths)) for r in rows)
        self._write("cluster", "node-summary.txt", table + "\n")

    def gather_crs(self) -> None:
        for api_version, kind, fname in (
                ("tpu.ai/v1", "ClusterPolicy", "clusterpolicies.yaml"),
                ("tpu.ai/v1alpha1", "GPUDriver", "gpudrivers.yaml")):
            objs = self._try(kind, self.client.list, api_version, kind) or []
            self._write("crs", fname, objs)
            conditions = {o["metadata"]["name"]: deep_get(o, "status", "conditions", default=[])
                          for o in objs}
            self._write("crs", fname.replace(".yaml", ".conditions.yaml"), conditions)

    def gather_operands(self) -> None:
        for api_version, kind in (("apps/v1", "DaemonSet"),
                                  ("apps/v1", "Deployment"),
                                  ("v1", "Service"),
                                  ("v1", "ConfigMap"),
                                  ("v1", "ServiceAccount")):
            objs = self._try(kind, self.client.list, api_version, kind, self.namespace) or []
            if objs:
                self._write("operands", f"{kind.lower()}s.yaml", objs)
        pods = self._try("pods", self.client.list, "v1", "Pod", self.namespace) or []
        for pod in pods:
            self._write("operands", f"pods/{pod['metadata']['name']}.yaml", pod)

    def gather_nodes(self) -> None:
        for n in self._list_nodes():
            if not is_gpu_node(n):
                continue
            self._write("nodes", f"{n['metadata']['name']}.yaml", {
                "labels": deep_get(n, "metadata", "labels", default={}) or {},
                "annotations": deep_get(n, "metadata", "annotations", default={}) or {},
                "capacity": deep_get(n, "status", "capacity", default={}) or {},
                "allocatable": deep_get(n, "status", "allocatable", default={}) or {},
                "unschedulable": deep_get(n, "spec", "unschedulable", default=False),
                "taints": deep_get(n, "spec", "taints", default=[]) or [],
            })

    def gather_validation(self) -> None:
        # each node's upgrade state as the control plane sees it
        states = {
            n["metadata"]["name"]: {
                "upgrade_state": deep_get(n, "metadata", "labels",
                                          consts.UPGRADE_STATE_LABEL, default=""),
                "state_since": deep_get(n, "metadata", "annotations",
                                        consts.UPGRADE_STATE_SINCE_ANNOTATION, default=""),
            } for n in self._list_nodes()}
        self._write("validation", "upgrade-states.yaml", states)
        # the barrier files, where a status dir is reachable (on a node, or
        # the harness's)
        if self.status_dir and os.path.isdir(self.status_dir):
            for entry in sorted(os.listdir(self.status_dir)):
                path = os.path.join(self.status_dir, entry)
                if os.path.isfile(path):
                    with open(path, errors="replace") as f:
                        self._write("validation", f"barriers/{entry}", f.read())
        else:
            self._write("validation", "barriers/README.txt",
                        "no validation status dir reachable from this process "
                        "(run on a node or pass --status-dir)\n")

    def gather_telemetry(self) -> None:
        urls = list(self.telemetry_urls)
        if not urls:
            # the exporters' Services, where the operator made them
            for svc in (self._try("services", self.client.list, "v1", "Service",
                                  self.namespace) or []):
                ip = deep_get(svc, "spec", "clusterIP")
                for port in deep_get(svc, "spec", "ports", default=[]) or []:
                    if "metrics" in str(port.get("name", "")) and ip:
                        urls.append(f"http://{ip}:{port['port']}/metrics")
        if not urls:
            self._write("telemetry", "README.txt", "no telemetry endpoints found or provided\n")
            return
        for i, url in enumerate(urls):
            body, error = self._scrape(url)
            if error is not None:
                self._write("telemetry", f"scrape-{i}.error.txt", error)
            else:
                self._write("telemetry", f"scrape-{i}.prom", f"# source: {url}\n{body}")

    def _scrape(self, url: str):
        """(body, None) or (None, the error): a malformed or refused answer
        degrades its one file, never the bundle."""
        import http.client

        try:
            with urllib.request.urlopen(url, timeout=3) as resp:
                return resp.read().decode("utf-8", "replace"), None
        except (OSError, http.client.HTTPException) as e:
            return None, f"{url}: {e}\n"

    def gather_operator(self) -> None:
        """The operator's self-diagnostics: its metrics (work queues,
        reconcile errors, apiserver traffic) and every /debug route (the
        thread dump, the informer caches, the flight recorder, the join
        traces, the decision timeline, the capacity table)."""
        pods = self._try("operator pods", self.client.list, "v1", "Pod", self.namespace,
                         {"app": OPERATOR_APP}) or []
        targets = [(p["metadata"]["name"], deep_get(p, "status", "podIP"))
                   for p in pods if deep_get(p, "status", "podIP")]
        if not targets:
            self._write("operator", "README.txt", "no running operator pods with an IP found\n")
            return
        endpoints = ((self.operator_metrics_port, "/metrics", "metrics.prom"),
                     *((self.operator_health_port, route, fname)
                       for route, fname in debug_endpoint_files()))
        for name, ip in targets:
            sources = []
            for port, path, fname in endpoints:
                url = f"http://{ip}:{port}{path}"
                body, error = self._scrape(url)
                if error is not None:
                    self._write("operator", f"{name}/{fname}.error.txt", error)
                    continue
                # .json files stay parseable: their source goes in sources.txt
                if not fname.endswith(".json"):
                    body = f"# source: {url}\n{body}"
                self._write("operator", f"{name}/{fname}", body)
                sources.append(f"{fname}: {url}")
            if sources:
                self._write("operator", f"{name}/sources.txt", "\n".join(sources) + "\n")

    def gather_provenance(self) -> None:
        """The fleet's black box: the decision journal's mirror ConfigMaps
        (one per decision record) and, where reachable, the JSONL on disk.
        The live /debug/timeline rides the operator section."""
        cms = self._try("provenance mirrors", self.client.list, "v1", "ConfigMap",
                        self.namespace) or []
        records = []
        for cm in cms:
            labels = deep_get(cm, "metadata", "labels", default={}) or {}
            if consts.PROVENANCE_LABEL not in labels:
                continue
            raw = deep_get(cm, "data", "record")
            if not raw:
                continue
            try:
                records.append(json.loads(raw))
            except ValueError:
                records.append({"unparseable": cm["metadata"]["name"]})
        records.sort(key=lambda r: (r.get("episode", ""), r.get("seq", 0)))
        self._write("provenance", "decision-records.yaml", records)
        path = self.journal_path
        if path and os.path.isfile(path):
            with open(path) as f:
                self._write("provenance", "journal.jsonl", f.read())
        else:
            self._write("provenance", "journal.README.txt",
                        "no on-disk journal reachable from this process "
                        "(run in the operator pod or pass --journal-path)\n")

    def gather_events(self) -> None:
        events = self._try("events", self.client.list, "v1", "Event", self.namespace) or []
        # events.k8s.io Events carry lastTimestamp: null
        events.sort(key=lambda e: e.get("lastTimestamp") or "")
        self._write("events", "events.yaml", events)

    # -- driver --------------------------------------------------------------
    def run(self) -> Dict[str, List[str]]:
        for section in SECTIONS:
            getattr(self, f"gather_{section}")()
        index = {"sections": self.manifest, "errors": self.errors,
                 "namespace": self.namespace,
                 "gathered_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
        with open(os.path.join(self.out_dir, "manifest.json"), "w") as f:
            json.dump(index, f, indent=1, sort_keys=True)
        return index


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpu-must-gather",
                                description="Collect a gpu-operator support bundle.")
    p.add_argument("--base-url", default=os.environ.get("BASE"),
                   help="API server base URL (default: $BASE, else $KUBE_API_URL, else "
                        "in-cluster config)")
    p.add_argument("--namespace",
                   default=os.environ.get(consts.NAMESPACE_ENV, consts.DEFAULT_NAMESPACE))
    p.add_argument("--out", default=None,
                   help="output dir (default: timestamped under the temp dir)")
    p.add_argument("--status-dir", default=None, help="validation barrier dir to include")
    p.add_argument("--telemetry-url", action="append", default=[],
                   help="exporter /metrics URL (repeatable)")
    p.add_argument("--operator-metrics-port", type=int, default=8080)
    p.add_argument("--operator-health-port", type=int, default=8081)
    p.add_argument("--journal-path", default=None,
                   help=f"on-disk decision journal to include (default: "
                        f"${consts.JOURNAL_PATH_ENV})")
    p.add_argument("--no-tar", action="store_true")
    args = p.parse_args(argv)

    out = args.out or os.path.join(tempfile.gettempdir(),
                                   f"gpu-operator-must-gather-{int(time.time())}")
    os.makedirs(out, exist_ok=True)
    client = RestClient(base_url=args.base_url) if args.base_url else RestClient.from_env()
    gather = MustGather(client, args.namespace, out,
                        status_dir=args.status_dir,
                        telemetry_urls=args.telemetry_url,
                        operator_metrics_port=args.operator_metrics_port,
                        operator_health_port=args.operator_health_port,
                        journal_path=args.journal_path)
    index = gather.run()
    print(f"gathered {sum(len(v) for v in index['sections'].values())} files into {out}")
    for err in index["errors"]:
        print(f"  warning: {err}", file=sys.stderr)
    if not args.no_tar:
        tar_path = out.rstrip("/") + ".tar.gz"
        with tarfile.open(tar_path, "w:gz") as tar:
            tar.add(out, arcname=os.path.basename(out))
        print(f"wrote {tar_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
