"""The benchmark of ``tpu_operator_torch``: node certification
(``gpu-validator -c perf``) on NVIDIA H100 cards. ``python -m bench_gpu.run``
runs one cell of ``BENCHMARK.json``; README-style notes are in PERF.md."""
