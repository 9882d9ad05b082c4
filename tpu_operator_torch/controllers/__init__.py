from .runtime import ControllerManager, Reconciler, Request, Result
from .clusterpolicy_controller import ClusterPolicyReconciler
from .gpudriver_controller import GPUDriverReconciler

__all__ = [
    "ControllerManager",
    "Reconciler",
    "Request",
    "Result",
    "ClusterPolicyReconciler",
    "GPUDriverReconciler",
]
