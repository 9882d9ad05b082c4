"""Shared sub-spec types of the CRDs (copy of tpu_operator/api/common.py).

Mirrors the reference's per-operand spec pattern (api/nvidia/v1/
clusterpolicy_types.go:41-97): every operand gets enabled/repository/image/
version/imagePullPolicy/imagePullSecrets/env/resources/args, and image
resolution follows CR-field > env-var > error (internal/image/image.go:25-53)
so OLM-style digest pinning via operator-pod env keeps working.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, List, Optional

from .k8s_schemas import (
    ENV_VALUE_FROM,
    RESOURCE_REQUIREMENTS,
    ROLLING_UPDATE,
    TOLERATIONS,
)
from .specbase import SpecBase, spec_field


class SpecValidationError(ValueError):
    pass


_IMAGE_RE = re.compile(r"^[a-z0-9]+([._/:@-][a-zA-Z0-9._-]+)*$")

#: image name / repository / version validation patterns for the CRD schema
#: (reference kubebuilder markers on Repository/Image/Version fields,
#: api/nvidia/v1/clusterpolicy_types.go)
IMAGE_PATTERN = r"^[a-z0-9]+([._/:@-][a-zA-Z0-9._-]+)*$"
VERSION_PATTERN = r"^[a-zA-Z0-9._@:+-]+$"
REPOSITORY_PATTERN = r"^[a-zA-Z0-9._:/-]+$"


@dataclasses.dataclass
class EnvVar(SpecBase):
    """Environment variable injected into the operand container."""

    name: str = spec_field("", doc="Variable name.", required=True,
                           pattern=r"^[-._a-zA-Z][-._a-zA-Z0-9]*$")
    value: Optional[str] = spec_field(None, doc="Literal value.")
    value_from: Optional[Dict[str, Any]] = spec_field(
        None, doc="Source for the value (k8s core/v1 EnvVarSource).",
        schema=ENV_VALUE_FROM)
    extra: Dict[str, Any] = spec_field(dict)

    def to_k8s(self) -> Dict[str, Any]:
        """Render as a k8s container env entry, preserving valueFrom."""
        if self.value_from is not None:
            return {"name": self.name, "valueFrom": self.value_from}
        return {"name": self.name, "value": self.value or ""}


@dataclasses.dataclass
class ComponentSpec(SpecBase):
    """Common operand knobs: enable switch, image coordinates, env, args,
    resources (reference per-operand spec pattern,
    api/nvidia/v1/clusterpolicy_types.go:41-97)."""

    enabled: Optional[bool] = spec_field(
        None, doc="Deploy this operand. Unset means the operand default "
                  "(on for core operands, off for opt-in ones).")
    repository: Optional[str] = spec_field(
        None, doc="Image registry/repository prefix.",
        pattern=REPOSITORY_PATTERN)
    image: Optional[str] = spec_field(
        None, doc="Image name (without repository or tag).",
        pattern=IMAGE_PATTERN)
    version: Optional[str] = spec_field(
        None, doc="Image tag or sha256: digest.", pattern=VERSION_PATTERN)
    image_pull_policy: str = spec_field(
        "IfNotPresent", doc="Image pull policy for the operand pods.",
        enum=("Always", "IfNotPresent", "Never"))
    image_pull_secrets: List[str] = spec_field(
        list, doc="Names of image pull Secrets in the operator namespace.")
    env: List[EnvVar] = spec_field(
        list, doc="Extra environment variables for the operand container.")
    args: List[str] = spec_field(
        list, doc="Extra command-line arguments for the operand container.")
    resources: Optional[Dict[str, Any]] = spec_field(
        None, schema=RESOURCE_REQUIREMENTS)
    extra: Dict[str, Any] = spec_field(dict)

    #: env var consulted when the CR does not pin an image (subclass override)
    DEFAULT_IMAGE_ENV: str = dataclasses.field(default="", repr=False)

    def is_enabled(self, default: bool = True) -> bool:
        return default if self.enabled is None else bool(self.enabled)

    def image_path(self) -> str:
        """Resolve the operand image: CR fields > $<DEFAULT_IMAGE_ENV> > error."""
        if self.image:
            image = self.image
            if self.repository:
                image = f"{self.repository}/{image}"
            if self.version:
                sep = "@" if self.version.startswith("sha256:") else ":"
                image = f"{image}{sep}{self.version}"
            return image
        env_name = self.DEFAULT_IMAGE_ENV
        if env_name and os.environ.get(env_name):
            return os.environ[env_name]
        raise SpecValidationError(
            f"no image for {type(self).__name__}: set spec fields or ${env_name or '<unset>'}")

    def env_map(self) -> Dict[str, str]:
        return {e.name: (e.value or "") for e in self.env}

    def validate(self, path: str = "") -> List[str]:
        errors = []
        if self.image_pull_policy not in ("Always", "IfNotPresent", "Never"):
            errors.append(f"{path}.imagePullPolicy: invalid value {self.image_pull_policy!r}")
        if self.image is not None and not _IMAGE_RE.match(self.image or ""):
            errors.append(f"{path}.image: malformed image name {self.image!r}")
        for e in self.env:
            if not e.name:
                errors.append(f"{path}.env: entry with empty name")
        return errors


@dataclasses.dataclass
class DaemonsetsSpec(SpecBase):
    """Cluster-wide DaemonSet defaults (reference DaemonsetsSpec)."""

    update_strategy: str = spec_field(
        "RollingUpdate", doc="DaemonSet update strategy for all operands.",
        enum=("RollingUpdate", "OnDelete"))
    rolling_update: Optional[Dict[str, Any]] = spec_field(
        None, schema=ROLLING_UPDATE)
    priority_class_name: str = spec_field(
        "system-node-critical",
        doc="PriorityClass assigned to every operand pod.")
    tolerations: List[Dict[str, Any]] = spec_field(
        list, doc="Tolerations applied to every operand pod.",
        schema=TOLERATIONS)
    labels: Dict[str, str] = spec_field(
        dict, doc="Extra labels stamped on every operand pod.")
    annotations: Dict[str, str] = spec_field(
        dict, doc="Extra annotations stamped on every operand pod.")
    extra: Dict[str, Any] = spec_field(dict)

    def validate(self, path: str = "spec.daemonsets") -> List[str]:
        if self.update_strategy not in ("RollingUpdate", "OnDelete"):
            return [f"{path}.updateStrategy: must be RollingUpdate or OnDelete"]
        return []


@dataclasses.dataclass
class DrainSpec(SpecBase):
    """Node-drain behavior during driver upgrade (reference DrainSpec)."""

    enable: bool = spec_field(
        False, doc="Evict workload pods from the node before upgrading.")
    force: bool = spec_field(
        False, doc="After timeoutSeconds, delete pods that refused "
                   "eviction (bypasses PodDisruptionBudgets).")
    pod_selector: str = spec_field(
        "", doc="Only drain pods matching this label selector "
                "(empty = all GPU workload pods).")
    timeout_seconds: int = spec_field(
        300, doc="Eviction budget before giving up or forcing.",
        minimum=0)
    delete_empty_dir: bool = spec_field(
        False, doc="Drain even pods using emptyDir volumes "
                   "(their local data is lost).")
    extra: Dict[str, Any] = spec_field(dict)


@dataclasses.dataclass
class PodDeletionSpec(SpecBase):
    """Deletion behavior for pods consuming the GPU resource
    (reference PodDeletionSpec)."""

    force: bool = spec_field(
        False, doc="After timeoutSeconds, delete pods that refused "
                   "eviction (bypasses PodDisruptionBudgets).")
    timeout_seconds: int = spec_field(
        300, doc="Eviction budget before giving up or forcing.",
        minimum=0)
    delete_empty_dir: bool = spec_field(
        False, doc="Delete even pods using emptyDir volumes.")
    extra: Dict[str, Any] = spec_field(dict)


@dataclasses.dataclass
class WaitForCompletionSpec(SpecBase):
    """Wait for selected workload jobs to finish before upgrading a node
    (reference WaitForCompletionSpec)."""

    pod_selector: str = spec_field(
        "", doc="Label selector for jobs/pods that must complete before "
                "the node upgrade proceeds.")
    timeout_seconds: int = spec_field(
        0, doc="Seconds to wait for completion before escalating; "
               "0 waits forever.", minimum=0)
    extra: Dict[str, Any] = spec_field(dict)


@dataclasses.dataclass
class UpgradePolicySpec(SpecBase):
    """Rolling-upgrade knobs (reference DriverUpgradePolicySpec via
    k8s-operator-libs; consumed by our upgrade state machine)."""

    auto_upgrade: bool = spec_field(
        False, doc="Enable automatic rolling upgrade when the driver "
                   "spec changes.")
    max_parallel_upgrades: int = spec_field(
        1, doc="Nodes upgraded simultaneously; 0 = unlimited.", minimum=0)
    max_unavailable: Optional[str] = spec_field(
        "25%", doc="Ceiling on simultaneously-unavailable nodes, absolute "
                   "or percentage.",
        pattern=r"^([0-9]+|[0-9]+%)$")
    wait_for_completion: WaitForCompletionSpec = spec_field(WaitForCompletionSpec)
    pod_deletion: PodDeletionSpec = spec_field(PodDeletionSpec)
    drain: DrainSpec = spec_field(DrainSpec)
    extra: Dict[str, Any] = spec_field(dict)

    def validate(self, path: str = "") -> List[str]:
        errors = []
        if self.max_parallel_upgrades < 0:
            errors.append(f"{path}.maxParallelUpgrades: must be >= 0")
        return errors
