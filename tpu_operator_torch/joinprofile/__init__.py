"""Node-side join-trace records (counterpart of tpu_operator/joinprofile/);
the operator-side profiler waits for the control plane."""
