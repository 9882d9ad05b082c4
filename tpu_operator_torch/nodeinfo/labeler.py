"""GPU node labelling: presence marker + per-operand deploy labels
(counterpart of tpu_operator/nodeinfo/labeler.py).

NVIDIA's labelGPUNodes + gpuStateLabels (controllers/state_manager.go:86-111,
363-421,481-581): every GPU node gets ``tpu.ai/gpu.present=true`` plus one
``tpu.ai/gpu.deploy.<operand>`` label per enabled operand. Pre-existing
``...deploy.*=false`` values are honored as per-node kill switches
(state_manager.go:377-383). Labels are removed when a node stops being a
GPU node (hardware removed / relabeled).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional

from .. import consts, events
from ..api.clusterpolicy import ClusterPolicy
from ..client.batch import coalesced_patch
from ..client.interface import Client
from ..utils import deep_get
from .node_info import is_gpu_node

log = logging.getLogger(__name__)


@dataclasses.dataclass
class LabelResult:
    gpu_nodes: int = 0
    labeled: int = 0
    cleaned: int = 0
    #: post-labeling node snapshot, reusable by the same reconcile sweep
    nodes: List[dict] = dataclasses.field(default_factory=list)


def operand_enabled(policy: ClusterPolicy, operand: str) -> bool:
    spec = policy.spec
    return {
        "driver": spec.driver.is_enabled(),
        "device-plugin": spec.device_plugin.is_enabled(),
        "feature-discovery": spec.feature_discovery.is_enabled(),
        "telemetry": spec.telemetry.is_enabled(),
        "node-status-exporter": spec.node_status_exporter.is_enabled(),
        "operator-validator": spec.validator.is_enabled(),
        "slice-partitioner": spec.slice_partitioner.is_enabled(),
        # the reference's table leaves serving out, so its labeller never
        # sets the serving deploy label its DaemonSet selects on, and
        # strips one an admin set: the port labels it when enabled
        "serving": spec.serving.is_enabled(),
    }.get(operand, False)


def desired_state_labels(policy: ClusterPolicy) -> Dict[str, str]:
    labels = {consts.GPU_PRESENT_LABEL: "true"}
    for operand in consts.OPERANDS:
        if operand_enabled(policy, operand):
            labels[consts.deploy_label(operand)] = "true"
    return labels


def adoption_labels(policy: ClusterPolicy, node: dict,
                    our_plugin_nodes: frozenset = frozenset()
                    ) -> Dict[str, Optional[str]]:
    """Host-stack adoption (validateHostDriver analog).

    GKE GPU nodes can arrive with the driver preinstalled and GKE's device
    plugin already advertising ``nvidia.com/gpu``; deploying a second stack
    on top would fight it. Two adoption paths:

    - driver: ``spec.driver.enabled=false`` is the operator-wide statement
      that the platform owns the driver (NVIDIA's driver.enabled=false ->
      validateHostDriver); every node records ``driver.stack=host``.
      Re-enabling the driver removes the label again.
    - device plugin: with ``spec.devicePlugin.enabled`` UNSET (auto), a
      node already advertising the GPU resource before we ever labeled it
      has a working host plugin — adopt it: deploy gate forced "false"
      (our DS skips the node) + ``device-plugin.stack=host``. An explicit
      ``enabled: true`` always deploys ours, including un-adopting nodes
      adopted earlier.

    Returned entries OVERRIDE the desired-state labels and bypass the
    per-node kill-switch filter (the adoption machinery owns these keys;
    a value of None removes the label)."""
    labels = deep_get(node, "metadata", "labels", default={}) or {}
    out: Dict[str, Optional[str]] = {}

    if not policy.spec.driver.is_enabled():
        out[consts.DRIVER_STACK_LABEL] = "host"
    elif consts.DRIVER_STACK_LABEL in labels:
        out[consts.DRIVER_STACK_LABEL] = None  # driver re-enabled: un-adopt

    plugin_gate = consts.deploy_label("device-plugin")
    plugin_auto = policy.spec.device_plugin.enabled is None
    already_adopted = labels.get(consts.PLUGIN_STACK_LABEL) == "host"
    preloaded = (
        plugin_auto
        and plugin_gate not in labels
        and deep_get(node, "status", "capacity",
                     consts.GPU_RESOURCE_NAME) is not None
        # the advertised capacity must not come from OUR plugin: if deploy
        # labels were wiped (operator reinstall, node re-registration)
        # while our plugin pod still runs, adopting would gate our own
        # plugin off as a phantom "host stack"
        and node["metadata"]["name"] not in our_plugin_nodes)
    if plugin_auto and (preloaded or already_adopted):
        out[plugin_gate] = "false"
        out[consts.PLUGIN_STACK_LABEL] = "host"
    elif already_adopted:
        # explicit enabled: true/false supersedes the auto-adoption; the
        # adoption-set gate is removed (not left as "false", which would
        # read as a manual kill switch and block a later enabled: true)
        out[consts.PLUGIN_STACK_LABEL] = None
        out[plugin_gate] = ("true" if policy.spec.device_plugin.is_enabled()
                            else None)
    return out


def _apply_label_patch(node: dict, patch: Dict[str, Optional[str]]) -> None:
    labels = node.setdefault("metadata", {}).setdefault("labels", {})
    for key, value in patch.items():
        if value is None:
            labels.pop(key, None)
        else:
            labels[key] = value


def label_gpu_nodes(client: Client, policy: ClusterPolicy,
                    namespace: Optional[str] = None) -> LabelResult:
    result = LabelResult(nodes=client.list("v1", "Node"))
    # OUR plugin pods only: scoped to the operator namespace and Running
    # phase — a third-party/host plugin chart in kube-system can carry the
    # same recommended component label, and a leftover Succeeded pod of
    # ours no longer advertises anything
    our_plugin_nodes = frozenset(
        deep_get(p, "spec", "nodeName")
        for p in client.list(
            "v1", "Pod", namespace or consts.DEFAULT_NAMESPACE,
            label_selector={"app.kubernetes.io/component": "gpu-device-plugin"})
        if deep_get(p, "spec", "nodeName")
        and deep_get(p, "status", "phase", default="Running") == "Running")
    for node in result.nodes:
        name = node["metadata"]["name"]
        labels = deep_get(node, "metadata", "labels", default={}) or {}
        if is_gpu_node(node):
            result.gpu_nodes += 1
            patch: Dict[str, Optional[str]] = {}
            adopt = adoption_labels(policy, node, our_plugin_nodes)
            for key, value in desired_state_labels(policy).items():
                if key in adopt:
                    continue  # adoption owns this key (applied below)
                if labels.get(key) == "false" and key != consts.GPU_PRESENT_LABEL:
                    continue  # per-node kill switch wins
                if labels.get(key) != value:
                    patch[key] = value
            for key, value in adopt.items():
                if value is None:
                    if key in labels:
                        patch[key] = None
                elif labels.get(key) != value:
                    patch[key] = value
            # disabled operands lose their deploy label (unless kill-switched)
            for operand in consts.OPERANDS:
                key = consts.deploy_label(operand)
                if key in labels and labels[key] != "false" and not operand_enabled(policy, operand):
                    patch[key] = None
            # image pre-pull stamp, once per node on first sight: kubelets
            # start pulling operand images the moment this lands, so the
            # pulls overlap the driver install + validation chain instead
            # of serializing behind DaemonSet scheduling. Rides the same
            # coalesced patch as the deploy labels: no second write per node.
            annotations = deep_get(node, "metadata", "annotations",
                                   default={}) or {}
            ann_patch: Dict[str, str] = {}
            if consts.IMAGE_PREPULL_ANNOTATION not in annotations:
                ann_patch[consts.IMAGE_PREPULL_ANNOTATION] = f"{time.time():.3f}"
            if patch or ann_patch:
                log.info("labeling GPU node %s: %s", name, patch)
                body: Dict[str, dict] = {"metadata": {}}
                if patch:
                    body["metadata"]["labels"] = patch
                if ann_patch:
                    body["metadata"]["annotations"] = ann_patch
                coalesced_patch(client, "v1", "Node", name, body)
                _apply_label_patch(node, patch)  # keep the snapshot current
                if ann_patch:
                    node.setdefault("metadata", {}).setdefault(
                        "annotations", {}).update(ann_patch)
                result.labeled += 1
                if patch.get(consts.PLUGIN_STACK_LABEL) == "host":
                    # adoption is a real decision an admin should see in
                    # `kubectl describe node`. After the successful patch:
                    # a failed patch must retry WITHOUT minting a second
                    # Event for the same transition.
                    events.record(
                        client, "", node, events.NORMAL,
                        "HostPluginAdopted",
                        f"node {name} already advertises the GPU resource; "
                        f"adopting its device plugin instead of deploying "
                        f"ours")
        else:
            stale = [k for k in labels
                     if k == consts.GPU_PRESENT_LABEL
                     or k.startswith(consts.DEPLOY_LABEL_PREFIX)
                     or k in (consts.DRIVER_STACK_LABEL,
                              consts.PLUGIN_STACK_LABEL)]
            if stale:
                log.info("cleaning GPU labels from node %s", name)
                coalesced_patch(client, "v1", "Node", name,
                                {"metadata": {"labels": {k: None for k in stale}}})
                _apply_label_patch(node, {k: None for k in stale})
                result.cleaned += 1
    return result

