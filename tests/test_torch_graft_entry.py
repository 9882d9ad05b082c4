"""Graft entry points of the PyTorch port (tpu_operator_torch/graft_entry.py)
held against __graft_entry__.py on the CPU."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
from tpu_operator_torch import graft_entry


def test_entry_matches_reference():
    fn, args = graft_entry.entry(device="cpu")
    c, checks = fn(*args)
    ref_fn, ref_args = ref_entry.entry()
    ref_c, ref_checks = jax.jit(ref_fn)(*ref_args)
    assert c.dtype == torch.float32 and tuple(c.shape) == tuple(ref_c.shape) == (512, 512)
    np.testing.assert_array_equal(c.numpy(), np.asarray(ref_c))
    assert checks.tolist() == np.asarray(ref_checks).tolist() == [True, True]


def test_entry_catches_a_wrong_product():
    fn, (a, b) = graft_entry.entry(device="cpu")
    a = a.clone()
    a[7, 11] = 0
    _, checks = fn(a, b)
    assert checks.tolist() == [False, True]


@pytest.mark.parametrize("n", range(1, 17))
def test_mesh_factors_match_reference(n):
    assert graft_entry._mesh_factors(n) == ref_entry._mesh_factors(n)


@pytest.mark.parametrize("n", [1, 4])
def test_dryrun_multichip(n):
    graft_entry.dryrun_multichip(n, device="cpu")
    ref_entry.dryrun_multichip(n)


def test_dryrun_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.dryrun_multichip(1)
