"""PyTorch/CUDA port of the tpu-operator's node validation path.

Mirrors ``tpu_operator/`` path for path (``tpu_operator_torch/validator/perf.py``
ports ``tpu_operator/validator/perf.py``) for ``nvidia.com/gpu`` nodes on an
NVIDIA H100. It imports ``torch``, never ``jax``, and nothing of
``tpu_operator``: what it needs from there it keeps as its own copy.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a CUDA device it raises (``device.resolve_device``).
"""

__version__ = "0.1.0"
