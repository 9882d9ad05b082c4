"""OpenAPI schemas for embedded Kubernetes core types (copy of
tpu_operator/api/k8s_schemas.py).

controller-gen inlines these into the reference CRDs from the vendored
k8s.io/api Go types (e.g. every resources/tolerations field in
config/crd/bases/nvidia.com_clusterpolicies.yaml carries the full
ResourceRequirements / Toleration schema).  Spec dataclasses attach them via
``spec_field(schema=...)``; constants-only module so both the spec types and
the schema generator can import it without a cycle.
"""

from __future__ import annotations

# Kubernetes resource.Quantity pattern, as emitted by controller-gen for
# every int-or-string quantity field in the reference CRDs.
QUANTITY_PATTERN = (
    r"^(\+|-)?(([0-9]+(\.[0-9]*)?)|(\.[0-9]+))"
    r"(([KMGTPE]i)|[numkMGTPE]|([eE](\+|-)?[0-9]+))?$"
)

INT_OR_STRING = {
    "anyOf": [{"type": "integer"}, {"type": "string"}],
    "x-kubernetes-int-or-string": True,
}

QUANTITY = {
    "anyOf": [{"type": "integer"}, {"type": "string"}],
    "pattern": QUANTITY_PATTERN,
    "x-kubernetes-int-or-string": True,
}

RESOURCE_REQUIREMENTS = {
    "type": "object",
    "description": "Compute resources for the operand containers "
                   "(k8s core/v1 ResourceRequirements).",
    "properties": {
        "limits": {"type": "object", "additionalProperties": QUANTITY},
        "requests": {"type": "object", "additionalProperties": QUANTITY},
    },
}

TOLERATION = {
    "type": "object",
    "description": "k8s core/v1 Toleration",
    "properties": {
        "key": {"type": "string"},
        "operator": {"type": "string", "enum": ["Exists", "Equal"]},
        "value": {"type": "string"},
        "effect": {"type": "string",
                   "enum": ["NoSchedule", "PreferNoSchedule", "NoExecute"]},
        "tolerationSeconds": {"type": "integer", "format": "int64"},
    },
}

TOLERATIONS = {"type": "array", "items": TOLERATION}

CONFIGMAP_REF = {
    "type": "object",
    "description": "Reference to a ConfigMap holding operand configuration: "
                   "name of the ConfigMap and the default key to use.",
    "properties": {
        "name": {"type": "string"},
        "default": {"type": "string"},
    },
}

ROLLING_UPDATE = {
    "type": "object",
    "description": "DaemonSet RollingUpdate tuning.",
    "properties": {"maxUnavailable": dict(INT_OR_STRING)},
}

SERVICE_MONITOR = {
    "type": "object",
    "description": "prometheus-operator ServiceMonitor knobs for the "
                   "telemetry exporter Service.",
    "properties": {
        "enabled": {"type": "boolean"},
        "interval": {"type": "string",
                     "pattern": r"^([0-9]+(ms|s|m|h))+$"},
        "honorLabels": {"type": "boolean"},
        "additionalLabels": {"type": "object",
                             "additionalProperties": {"type": "string"}},
        "relabelings": {"type": "array",
                        "items": {"type": "object",
                                  "x-kubernetes-preserve-unknown-fields": True}},
    },
}

INIT_CONTAINER = {
    "type": "object",
    "description": "Operator-managed init container image "
                   "(reference InitContainerSpec).",
    "properties": {
        "repository": {"type": "string"},
        "image": {"type": "string"},
        "version": {"type": "string"},
        "imagePullPolicy": {"type": "string",
                            "enum": ["Always", "IfNotPresent", "Never"]},
    },
}

NODE_AFFINITY = {
    "type": "object",
    "description": "k8s core/v1 NodeAffinity applied to the driver pods.",
    "x-kubernetes-preserve-unknown-fields": True,
}

METAV1_CONDITION = {
    "type": "object",
    "description": "metav1.Condition",
    "required": ["type", "status"],
    "properties": {
        "type": {"type": "string"},
        "status": {"type": "string", "enum": ["True", "False", "Unknown"]},
        "reason": {"type": "string"},
        "message": {"type": "string"},
        "observedGeneration": {"type": "integer", "format": "int64"},
        "lastTransitionTime": {"type": "string", "format": "date-time"},
    },
}

ENV_VALUE_FROM = {
    "type": "object",
    "description": "k8s core/v1 EnvVarSource",
    "x-kubernetes-preserve-unknown-fields": True,
}
