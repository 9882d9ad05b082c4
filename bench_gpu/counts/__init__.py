"""Operations and bytes of the kernels whose roofline share the benchmark
reports, computed from the shapes the configuration runs."""
