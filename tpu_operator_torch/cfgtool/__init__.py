"""``gpuop-cfg``: the operator's configuration CLI (counterpart of
tpu_operator/cfgtool/)."""
