"""Node-agent side of the operator's health protocols
(counterpart of tpu_operator/health/)."""
