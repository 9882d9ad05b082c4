from .node_info import NodeAttributes, gpu_capacity, is_gpu_node
from .labeler import LabelResult, label_gpu_nodes

__all__ = [
    "NodeAttributes",
    "gpu_capacity",
    "is_gpu_node",
    "LabelResult",
    "label_gpu_nodes",
]
