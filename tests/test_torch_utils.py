"""The twin of tests/test_utils.py: the reference's six cases on the port's
``tpu_operator_torch.utils`` (its own copy of ``deep_get``,
``deep_merge``, ``fnv32a``, ``object_hash`` and ``parse_quantity``), and
both packages' helpers on the same seeded inputs (numpy), which must give
the same hashes, merges and quantities.
"""

import copy
import json

import numpy as np
import pytest

from tpu_operator import utils as ref
from tpu_operator_torch.utils import deep_get, deep_merge, fnv32a, object_hash, parse_quantity


def test_fnv32a_known_vectors():
    # the published FNV-1a 32-bit vectors
    assert fnv32a(b"") == 0x811C9DC5
    assert fnv32a(b"a") == 0xE40C292C
    assert fnv32a(b"foobar") == 0xBF9CF968


def test_object_hash_is_key_order_insensitive():
    assert object_hash({"a": 1, "b": [1, 2]}) == object_hash({"b": [1, 2], "a": 1})


def test_object_hash_detects_changes():
    assert object_hash({"spec": {"image": "gpu-driver:1"}}) != \
        object_hash({"spec": {"image": "gpu-driver:2"}})


def test_deep_get():
    obj = {"metadata": {"labels": {"x": "y"}}}
    assert deep_get(obj, "metadata", "labels", "x") == "y"
    assert deep_get(obj, "metadata", "missing", "x") is None
    assert deep_get(obj, "metadata", "missing", default=3) == 3


def test_deep_merge_replaces_lists_merges_maps():
    base = {"a": {"b": 1, "c": 2}, "l": [1, 2]}
    deep_merge(base, {"a": {"c": 3}, "l": [9]})
    assert base == {"a": {"b": 1, "c": 3}, "l": [9]}


def test_parse_quantity():
    assert parse_quantity("500m") == 0.5
    assert parse_quantity("1Gi") == 2**30
    assert parse_quantity(4) == 4.0


def _random_object(rng, depth=0):
    """A nested JSON object of strings, numbers, lists and maps."""
    out = {}
    for _ in range(int(rng.integers(1, 5))):
        key = "k" + str(int(rng.integers(0, 50)))
        roll = rng.random()
        if roll < 0.3 and depth < 3:
            out[key] = _random_object(rng, depth + 1)
        elif roll < 0.5:
            out[key] = [int(x) for x in rng.integers(0, 100, size=int(rng.integers(0, 4)))]
        elif roll < 0.8:
            out[key] = "v" + str(int(rng.integers(0, 1000)))
        else:
            out[key] = float(rng.normal())
    return out


@pytest.mark.parametrize("seed", range(5))
def test_both_packages_hash_and_merge_alike(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        obj, patch = _random_object(rng), _random_object(rng)
        assert object_hash(obj) == ref.object_hash(obj)
        text = json.dumps(obj, sort_keys=True).encode()
        assert fnv32a(text) == ref.fnv32a(text)
        mine, theirs = copy.deepcopy(obj), copy.deepcopy(obj)
        deep_merge(mine, copy.deepcopy(patch))
        ref.deep_merge(theirs, copy.deepcopy(patch))
        assert mine == theirs


@pytest.mark.parametrize("text", ["0", "1", "250m", "1.5", "2k", "3M", "4G", "1Ki", "8Mi",
                                  "16Gi", "1Ti", "100Mi", "7", 12, 0.25])
def test_both_packages_read_a_quantity_alike(text):
    assert parse_quantity(text) == ref.parse_quantity(text)
