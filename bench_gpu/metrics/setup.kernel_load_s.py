"""setup.kernel_load_s: K1's build (the checkout's first run calls nvcc) or
cache load (``kernels/_build.py:library``) in set-up (host clock)."""


def read(run):
    return run.setup_parts.get("kernel_load_s")
