"""Constants of the GPU validation path (counterpart of tpu_operator/consts.py).

The port's own copy: only what its modules use, with the accelerator names
swapped for NVIDIA's.
"""

# -- operator identity -------------------------------------------------------
NAMESPACE_ENV = "OPERATOR_NAMESPACE"
DEFAULT_NAMESPACE = "tpu-operator"

# -- node-local paths ---------------------------------------------------------
#: status-file barrier dir (same layout as the TPU operator's, so one set
#: of barrier readers serves both)
VALIDATION_STATUS_DIR = "/run/tpu/validations"
#: where the NVIDIA driver's user-space library lives on a GPU node
DEFAULT_DRIVER_LIB_DIR = "/usr/lib/x86_64-linux-gnu"
#: the CUDA driver library whose presence marks the driver as installed
DRIVER_LIB = "libcuda.so.1"
#: per-GPU device nodes; ``/dev/nvidiactl`` and ``/dev/nvidia-uvm``, the
#: control and unified-memory nodes every CUDA process also opens, are not
#: per-GPU and so never counted
GPU_DEV_GLOBS = ("/dev/nvidia[0-9]*",)
#: env override for GPU_DEV_GLOBS (comma-separated)
GPU_DEV_GLOBS_ENV = "GPU_DEV_GLOBS"

#: schedulable extended resource
GPU_RESOURCE_NAME = "nvidia.com/gpu"
