"""Test doubles for code paths that need hardware or a cluster this package
cannot assume: fake NVML and CUDA driver libraries for the device plumbing,
and an in-process apiserver (:mod:`~.apiserver`) for the operator."""
