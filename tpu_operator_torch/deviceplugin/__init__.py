"""The kubelet device plugin for ``nvidia.com/gpu`` (imports without
grpc: only its wire layer needs it)."""

from .plugin import GPUDevicePlugin

__all__ = ["GPUDevicePlugin"]
