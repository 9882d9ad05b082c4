from .runtime import ControllerManager, Reconciler, Request, Result
from .clusterpolicy_controller import ClusterPolicyReconciler

__all__ = [
    "ControllerManager",
    "Reconciler",
    "Request",
    "Result",
    "ClusterPolicyReconciler",
]
