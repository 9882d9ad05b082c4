"""setup_s: process start to the first pass (host clock): imports, the
CUDA context, K1's build or load, one warm GEMM, HBM probe and K1 launch."""


def read(run):
    return run.setup_s
