"""certify_s: the window, from the first pass's start to the last pass's
end, over the passes in it (host clock): the node time one certification
takes from serving."""

from bench_gpu import traffic


def read(run):
    return traffic.window_s(run.passes) / len(run.passes)
