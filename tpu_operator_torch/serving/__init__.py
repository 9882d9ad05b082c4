"""Serving validation (counterpart of tpu_operator/serving/): the SLO probe,
a continuous-batching decode step run as one CUDA graph, and the frontier
schema it publishes through the validation barrier.

The reference's ``traffic`` module, a host-side traffic simulator, is not
ported yet.
"""



def __getattr__(name):
    # the probe imports torch: load it only when asked for, so the frontier
    # schema stays importable by torch-free processes (gpuop-cfg, feature
    # discovery)
    if name in ("ServingReport", "run_probe"):
        from . import probe

        return getattr(probe, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
