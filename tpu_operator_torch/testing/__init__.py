"""Test doubles for code paths that need hardware this package cannot
assume: fake NVML and CUDA driver libraries for the device plumbing."""
