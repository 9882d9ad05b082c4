"""device.idle_share: the share of the traced window, first pass start to
last pass end, in which no kernel, copy or fill ran on the validator's GPU
(cuda:0), in % (device trace). Spawned ranks' work is not in this
process's trace, so it is read only where there are none (one GPU)."""


def read(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s(0) / run.trace.window_s)
