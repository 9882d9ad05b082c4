"""The benchmark's own tests: the harness on the CPU, the control and the
faults on the card (marked ``gpu``).

    python -m pytest bench_gpu/tests -q            # here: the card tests skip
    python -m pytest bench_gpu/tests -q -m gpu -s  # on the card
"""
