"""``gpuop-cfg``: configuration validation and triage CLI (counterpart of
tpu_operator/cfgtool/main.py; NVIDIA's cmd/gpuop-cfg validates ClusterPolicy
samples in CI).

Subcommands:
  validate <file.yaml>...   schema- and spec-validate ClusterPolicy and
                            GPUDriver documents
  validate-partitions <table.yaml> [--link CLASS --gpus N]
                            validate a partition table offline on an N-GPU
                            node whose every pair of GPUs has one link class
  sample [clusterpolicy|gpudriver]   print a complete sample CR
  status [--base-url URL]   live-cluster triage summary (exit 0 iff ready)
  explain node <X> | episode <id> [--base-url URL]
                            render a node's (or an episode's) decision
                            chains from the provenance journal

Files are JSON or YAML, read and written with
:mod:`~tpu_operator_torch.yamlsubset`, not PyYAML. The reference's
``validate-csv`` (the OLM bundle) waits for the port's bundle.
"""

from __future__ import annotations

import argparse
import sys

from .. import yamlsubset
from ..api.clusterpolicy import CLUSTER_POLICY_KIND, ClusterPolicy
from ..api.common import SpecValidationError
from ..api.gpudriver import GPU_DRIVER_KIND, GPUDriver

SAMPLE_CLUSTER_POLICY = {
    "apiVersion": "tpu.ai/v1",
    "kind": "ClusterPolicy",
    "metadata": {"name": "cluster-policy"},
    "spec": {
        "operator": {},
        "daemonsets": {"updateStrategy": "RollingUpdate",
                       "priorityClassName": "system-node-critical"},
        "driver": {"enabled": True, "repository": "gcr.io/my-project",
                   "image": "gpu-validator", "version": "0.1.0",
                   "driverVersion": "580.95.05",
                   "upgradePolicy": {"autoUpgrade": False, "maxParallelUpgrades": 1}},
        "devicePlugin": {"enabled": True, "repository": "gcr.io/my-project",
                         "image": "gpu-device-plugin", "version": "0.1.0",
                         "resourceName": "nvidia.com/gpu"},
        "featureDiscovery": {"enabled": True, "repository": "gcr.io/my-project",
                             "image": "gpu-validator", "version": "0.1.0"},
        "telemetry": {"enabled": True, "repository": "gcr.io/my-project",
                      "image": "gpu-validator", "version": "0.1.0",
                      "metricsPort": 9400},
        "nodeStatusExporter": {"enabled": True, "repository": "gcr.io/my-project",
                               "image": "gpu-validator", "version": "0.1.0"},
        "validator": {"enabled": True, "repository": "gcr.io/my-project",
                      "image": "gpu-validator", "version": "0.1.0"},
        "slicePartitioner": {"enabled": False},
        "serving": {"enabled": False},
        "cdi": {"enabled": False},
    },
}

SAMPLE_GPU_DRIVER = {
    "apiVersion": "tpu.ai/v1alpha1",
    "kind": "GPUDriver",
    "metadata": {"name": "h100-pool"},
    "spec": {
        "driverType": "standard",
        "repository": "gcr.io/my-project",
        "image": "gpu-validator",
        "version": "0.1.0",
        "driverVersion": "580.95.05",
        "nodeSelector": {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"},
    },
}

#: the link class every pair of GPUs has on the node ``validate-partitions``
#: checks a table against (nvml.LINK_CLASSES), and its GPU count
DEFAULT_LINK = "nvlink"
DEFAULT_GPUS = 8


def validate_doc(doc: dict) -> list:
    """Schema and semantic (``spec.validate``) validation of one CR.

    The schema pass runs the generated openAPIV3Schema a real apiserver
    enforces, so typo'd field names and enum or bound violations are caught
    before anything touches a cluster. Schema errors short-circuit: a
    type-mangled document cannot be loaded into the spec dataclasses."""
    from ..api import schema_gen, schema_validate

    kind = doc.get("kind")
    if kind == CLUSTER_POLICY_KIND:
        typed, crd = ClusterPolicy, schema_gen.clusterpolicy_crd()
    elif kind == GPU_DRIVER_KIND:
        typed, crd = GPUDriver, schema_gen.gpudriver_crd()
    else:
        return [f"unsupported kind {kind!r} (expected ClusterPolicy or GPUDriver)"]
    errors = schema_validate.validate_cr(doc, crd)
    if errors:
        return errors
    return typed.from_obj(doc).spec.validate()


def validate_partitions(path: str, link: str, gpus: int) -> int:
    """Validate a partition table offline with the node partitioner's own
    tiler, on an ``gpus``-GPU node whose every pair of GPUs is linked by
    ``link``, so an impossible split is caught at review time instead of
    as a failed partition on live nodes."""
    from ..nvml import LINK_CLASSES
    from ..partitioner.partitioner import PartitionError, compute_partition, load_config

    if link not in LINK_CLASSES:
        print(f"--link {link!r} is not one of {list(LINK_CLASSES)}")
        return 1
    try:
        table = load_config(path)
    except (OSError, PartitionError) as e:
        print(f"{path}: unreadable: {e}")
        return 1
    links = [[None if i == j else link for j in range(gpus)] for i in range(gpus)]
    failed = False
    for name in sorted(table):
        try:
            groups = compute_partition(table[name], links)
        except PartitionError as e:
            print(f"{path}: partition {name!r} on {gpus} GPUs ({link}): INVALID: {e}")
            failed = True
            continue
        rendered = ", ".join(
            f"{g['topology']}{g['chips']}" for g in groups) or "(empty)"
        print(f"{path}: partition {name!r} on {gpus} GPUs ({link}): OK: {rendered}")
    return 1 if failed else 0


def status(base_url=None, namespace="tpu-operator", out=None,
           token=None) -> int:
    """One-command cluster triage: the ClusterPolicy's verdict and
    conditions, the GPUDrivers' pools, a table of GPU nodes and the operand
    DaemonSets' readiness. Exit 0 only when the policy reports ready, 1
    when it does not, 2 when the cluster cannot be read."""
    import http.client

    from ..client.errors import ApiError
    from ..client.rest import RestClient

    out = out or sys.stdout  # resolved at call time (tests capture stdout)
    # one readable line, not a traceback, exactly when the cluster is sick;
    # an apiserver that answered (403, 404) is not a connectivity problem
    try:
        # the plain REST client: a triage tool reads once and exits, and
        # the cluster's own answer beats a retry layer masking it
        if base_url:
            client = RestClient(base_url=base_url, token=token)
        else:
            client = RestClient.from_env()
        return _status(client, namespace, out)
    except ApiError as e:
        hint = (" — check RBAC and that the tpu.ai CRDs are installed"
                if e.code in (401, 403, 404) else "")
        print(f"status: apiserver returned {e.code}: {e}{hint}",
              file=sys.stderr)
        return 2
    except (OSError, http.client.HTTPException, RuntimeError) as e:
        print(f"status: cannot reach the cluster: {e}", file=sys.stderr)
        return 2


def explain(kind, name, base_url=None, token=None, namespace="tpu-operator",
            journal_path=None, out=None) -> int:
    """``gpuop-cfg explain node <X>`` / ``explain episode <id>``: the causal
    chain each decision episode followed (trigger, inputs, decision,
    rejected alternatives, actuations with trace ids and leader epoch,
    outcome), from the on-disk journal where one is reachable, else from
    the cluster's ``prov-*`` mirror ConfigMaps. Exit 0 with records, 1
    without, 2 when the cluster cannot be read."""
    import http.client
    import json
    import os

    from .. import consts
    from ..provenance import DecisionJournal, render_explain

    out = out or sys.stdout
    journal_path = journal_path or os.environ.get(consts.JOURNAL_PATH_ENV)
    records = []
    if journal_path and os.path.isfile(journal_path):
        records = DecisionJournal(path=journal_path).timeline()
    else:
        from ..client.errors import ApiError
        from ..client.rest import RestClient

        try:
            client = (RestClient(base_url=base_url, token=token) if base_url
                      else RestClient.from_env())
            for cm in client.list("v1", "ConfigMap", namespace):
                if consts.PROVENANCE_LABEL not in (cm.get("metadata", {}).get("labels") or {}):
                    continue
                raw = (cm.get("data") or {}).get("record")
                if not raw:
                    continue
                try:
                    records.append(json.loads(raw))
                except ValueError:
                    continue
        except ApiError as e:
            print(f"explain: apiserver returned {e.code}: {e}", file=sys.stderr)
            return 2
        except (OSError, http.client.HTTPException, RuntimeError) as e:
            print(f"explain: cannot reach the cluster: {e}", file=sys.stderr)
            return 2
    rendered = render_explain(records, node=name if kind == "node" else None,
                              episode=name if kind == "episode" else None)
    if not rendered:
        print(f"no decision records for {kind} {name!r}", file=out)
        return 1
    print(rendered, file=out)
    return 0


def _serving_cell(labels: dict, annotations: dict) -> str:
    """SERVING column: the verdict of the ``tpu.ai/serving-slo`` label with
    the measured decode p99 (or the skip reason) from its annotation."""
    from .. import consts
    from ..validator.serving import parse_serving_detail

    verdict = labels.get(consts.SERVING_SLO_LABEL)
    if not verdict:
        return "-"
    detail = parse_serving_detail(
        annotations.get(consts.SERVING_SLO_ANNOTATION, ""))
    if "skipped" in detail:
        return f"{verdict} ({detail['skipped']})"
    if "p99_ms" in detail:
        return f"{verdict} p99={detail['p99_ms']:g}ms"
    return verdict


def _capacity_cell(annotations: dict) -> str:
    """CAPACITY column: the best point of the node's measured serving
    frontier (``tpu.ai/serving-frontier``), flagged ``reprobe`` while a
    re-probe request is pending; ``-`` until the node reports a curve."""
    from .. import consts
    from ..serving import frontier as frontier_schema

    fr = frontier_schema.decode_annotation(
        annotations.get(consts.SERVING_FRONTIER_ANNOTATION))
    if fr is None or not fr.points:
        return "-"
    best = max(fr.points, key=lambda p: p.tokens_per_s)
    cell = f"{best.tokens_per_s:g}t/s@b{best.batch}"
    if annotations.get(consts.SERVING_REPROBE_ANNOTATION):
        cell += " reprobe"
    return cell


#: the autoscaler's built-in per-pool bounds, for pools its spec leaves out
AUTOSCALE_DEFAULT_MIN = 1
AUTOSCALE_DEFAULT_MAX = 32


def _pool_bound(bounds, pool: str, default: int) -> int:
    bounds = bounds if isinstance(bounds, dict) else {}
    return int(bounds.get(pool, bounds.get("default", default)))


def _autoscale_cells(policy_obj, gpu_nodes, now=None) -> dict:
    """AUTOSCALE column, by node name: the node's pool posture (current and
    target size against the spec's bounds, an in-flight resize, the
    cooldown left) from the autoscaler's durable state
    (``tpu.ai/autoscale-state``). ``spec.autoscale`` is a free-form object
    until the autoscaler is ported; its ``enabled``, ``minNodes`` and
    ``maxNodes`` are read as the reference's spec reads them."""
    import json
    import time

    from .. import consts
    from ..state.nodepool import get_node_pools
    from ..utils import deep_get

    if not policy_obj:
        return {}
    spec = deep_get(policy_obj, "spec", "autoscale")
    if not isinstance(spec, dict) or not spec.get("enabled"):
        return {}
    try:
        states = json.loads(deep_get(
            policy_obj, "metadata", "annotations",
            consts.AUTOSCALE_STATE_ANNOTATION) or "{}")
    except ValueError:
        states = {}
    if not isinstance(states, dict):
        states = {}
    now = time.time() if now is None else now
    cells = {}
    for pool in get_node_pools(gpu_nodes):
        st = states.get(pool.name) or {}
        cell = (f"{pool.size}/{st.get('target', pool.size)}"
                f"[{_pool_bound(spec.get('minNodes'), pool.name, AUTOSCALE_DEFAULT_MIN)}"
                f"-{_pool_bound(spec.get('maxNodes'), pool.name, AUTOSCALE_DEFAULT_MAX)}]")
        resize = st.get("resize") or {}
        if resize.get("direction"):
            cell += f" resizing:{resize['direction']}"
        cooldown = float(st.get("cooldown_until") or 0.0) - now
        if cooldown > 0:
            cell += f" cd={cooldown:.0f}s"
        for name in pool.node_names:
            cells[name] = cell
    return cells


def _migration_cell(annotations: dict) -> str:
    """MIGRATION column: a migration episode's phase, source and
    destination, steps at risk and sequence number, from its durable
    record (``tpu.ai/migration-state``)."""
    import json

    from .. import consts

    raw = annotations.get(consts.MIGRATION_STATE_ANNOTATION)
    if not raw:
        return "-"
    try:
        state = json.loads(raw)
    except ValueError:
        state = None
    if not isinstance(state, dict):
        return "corrupt"
    cell = (f"{state.get('phase', '?')} "
            f"{state.get('src', '?')}->{state.get('dst', '?')}")
    at_risk = state.get("at_risk")
    if at_risk:
        cell += f" risk={at_risk}"
    if state.get("seq") is not None:
        cell += f" seq={state['seq']}"
    return cell


def _status(client, namespace, out) -> int:
    from .. import consts
    from ..utils import deep_get

    ready = False

    policies = client.list("tpu.ai/v1", "ClusterPolicy")
    if not policies:
        print("ClusterPolicy: none found", file=out)
    # the controllers' singleton rule: the first by sorted name
    autoscale_policy = min(
        policies, key=lambda p: p["metadata"]["name"]) if policies else None
    for policy in policies:
        state = deep_get(policy, "status", "state") or "unknown"
        ready = ready or state == "ready"
        print(f"ClusterPolicy/{policy['metadata']['name']}: {state}", file=out)
        for cond in deep_get(policy, "status", "conditions", default=[]) or []:
            print(f"  {cond.get('type')}={cond.get('status')} "
                  f"reason={cond.get('reason', '')} {cond.get('message', '')}",
                  file=out)

    for driver in client.list("tpu.ai/v1alpha1", "GPUDriver"):
        state = deep_get(driver, "status", "state") or "unknown"
        pools = deep_get(driver, "status", "pools", default={}) or {}
        print(f"GPUDriver/{driver['metadata']['name']}: {state} "
              f"pools={pools}", file=out)

    # GPU nodes only: presence is the row filter, so no column for it
    gpu_nodes = [n for n in client.list("v1", "Node")
                 if (n.get("metadata", {}).get("labels", {}) or {})
                 .get(consts.GPU_PRESENT_LABEL) == "true"]
    autoscale_cells = _autoscale_cells(autoscale_policy, gpu_nodes)
    print("\nNODE            GPUS      HEALTHY  HEALTH-STATE     "
          "UPGRADE-STATE    SLICE-PARTITION   SERVING             "
          "CAPACITY            AUTOSCALE            MIGRATION", file=out)
    for node in gpu_nodes:
        labels = node.get("metadata", {}).get("labels", {}) or {}
        name = node["metadata"]["name"]
        capacity = deep_get(node, "status", "capacity",
                            consts.GPU_RESOURCE_NAME) or "0"
        # the kubelet takes the plugin's Unhealthy units out of allocatable:
        # allocatable < capacity is the cluster-visible per-GPU health
        allocatable = deep_get(node, "status", "allocatable",
                               consts.GPU_RESOURCE_NAME)
        if allocatable is None or str(allocatable) == str(capacity):
            healthy = str(capacity)
        else:
            healthy = f"{allocatable}!"  # units withdrawn by the health gate
        health_state = labels.get(consts.HEALTH_STATE_LABEL, "-")
        attempts = deep_get(node, "metadata", "annotations",
                            consts.HEALTH_ATTEMPTS_ANNOTATION)
        if attempts and health_state == "remediating":
            health_state = f"remediating#{attempts}"
        upgrade = labels.get(consts.UPGRADE_STATE_LABEL, "-")
        slice_cfg = labels.get(consts.TPU_SLICE_CONFIG_LABEL)
        slice_state = labels.get(consts.TPU_SLICE_STATE_LABEL)
        # either label: a stale failed state with the config label removed
        # still shows
        if slice_cfg or slice_state:
            partition = f"{slice_cfg or '<none>'}={slice_state or '?'}"
        else:
            partition = "-"
        annotations = (node.get("metadata", {})
                       .get("annotations", {}) or {})
        serving = _serving_cell(labels, annotations)
        frontier_capacity = _capacity_cell(annotations)
        autoscale = autoscale_cells.get(name, "-")
        migration = _migration_cell(annotations)
        print(f"{name:<15} {capacity:<9} {healthy:<8} {health_state:<16} "
              f"{upgrade:<16} {partition:<17} {serving:<19} "
              f"{frontier_capacity:<19} {autoscale:<20} {migration}",
              file=out)

    print("\nDAEMONSET                 DESIRED  AVAILABLE  UPDATED", file=out)
    for ds in client.list("apps/v1", "DaemonSet", namespace):
        st = ds.get("status", {})
        print(f"{ds['metadata']['name']:<25} "
              f"{st.get('desiredNumberScheduled', 0):<8} "
              f"{st.get('numberAvailable', 0):<10} "
              f"{st.get('updatedNumberScheduled', 0)}", file=out)
    return 0 if ready else 1


def _documents(text: str) -> list:
    """The documents of a file: one JSON document (the port's samples), else
    the ``---`` documents of YAML in the subset."""
    import json

    try:
        return [json.loads(text)]
    except ValueError:
        return yamlsubset.parse_all(text)


def run(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpuop-cfg")
    sub = p.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("validate")
    v.add_argument("files", nargs="+")
    vp = sub.add_parser("validate-partitions",
                        help="validate a partition table on an N-GPU node "
                             "of one link class")
    vp.add_argument("table", help="partition-table YAML or JSON (the ConfigMap "
                                  "payload: a 'partitions' mapping)")
    vp.add_argument("--link", default=DEFAULT_LINK,
                    help="the link class of every pair of GPUs "
                         "(nvlink, pcie-switch, host-bridge, numa, system)")
    vp.add_argument("--gpus", type=int, default=DEFAULT_GPUS)
    s = sub.add_parser("sample")
    s.add_argument("kind", nargs="?", default="clusterpolicy",
                   choices=["clusterpolicy", "gpudriver"])
    st = sub.add_parser("status", help="live-cluster triage summary")
    st.add_argument("--base-url", default=None,
                    help="API server URL (default: $KUBE_API_URL, else in-cluster config)")
    st.add_argument("--token", default=None,
                    help="bearer token for --base-url (off-cluster use)")
    st.add_argument("--namespace", default="tpu-operator")
    ex = sub.add_parser("explain",
                        help="render a node's (or episode's) decision-"
                             "provenance chain from the journal")
    ex.add_argument("kind", choices=["node", "episode"])
    ex.add_argument("name", help="node name or episode id")
    ex.add_argument("--base-url", default=None,
                    help="API server URL (default: $KUBE_API_URL, else in-cluster config)")
    ex.add_argument("--token", default=None)
    ex.add_argument("--namespace", default="tpu-operator")
    ex.add_argument("--journal-path", default=None,
                    help="on-disk journal JSONL (default: "
                         "$GPU_OPERATOR_JOURNAL_PATH, else the cluster's "
                         "mirror ConfigMaps)")
    args = p.parse_args(argv)

    if args.cmd == "status":
        return status(base_url=args.base_url, namespace=args.namespace,
                      token=args.token)

    if args.cmd == "explain":
        return explain(args.kind, args.name, base_url=args.base_url,
                       token=args.token, namespace=args.namespace,
                       journal_path=args.journal_path)

    if args.cmd == "validate-partitions":
        return validate_partitions(args.table, args.link, args.gpus)

    if args.cmd == "sample":
        sample = SAMPLE_CLUSTER_POLICY if args.kind == "clusterpolicy" else SAMPLE_GPU_DRIVER
        print(yamlsubset.dump(sample))
        return 0

    failed = False
    for path in args.files:
        try:
            with open(path) as f:
                docs = [d for d in _documents(f.read()) if d]
        except (OSError, yamlsubset.SubsetError) as e:
            print(f"{path}: unreadable: {e}")
            failed = True
            continue
        for doc in docs:
            name = doc.get("metadata", {}).get("name", "?")
            try:
                errors = validate_doc(doc)
            except SpecValidationError as e:
                errors = [str(e)]
            if errors:
                failed = True
                for err in errors:
                    print(f"{path}: {doc.get('kind')}/{name}: {err}")
            else:
                print(f"{path}: {doc.get('kind')}/{name}: OK")
    return 1 if failed else 0
