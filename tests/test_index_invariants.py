"""Property tests of the rotation index via the exhaustive invariant
checker (the checkSuffixTree analog, gencycsuffixtrees.c:655-713) on
random, periodic, and degenerate inputs — both engine backends.
"""

import numpy as np
import pytest

from csa_jax.index import cyclic, engine, verify


def _check(encoded):
    index = cyclic.build_rotation_index(encoded)
    verify.verify_index(index, encoded)
    blocks = cyclic.collect_blocks(index)
    verify.verify_blocks(index, blocks, encoded)
    return index, blocks


def test_random_circular_families():
    rng = np.random.default_rng(42)
    for trial in range(5):
        k = int(rng.integers(2, 5))
        n = int(rng.integers(12, 60))
        base = rng.integers(0, 4, size=n, dtype=np.int64)
        encoded = []
        for _ in range(k):
            row = np.roll(base, int(rng.integers(0, n))).copy()
            for _ in range(2):
                row[int(rng.integers(0, n))] = int(rng.integers(0, 4))
            encoded.append(row)
        _check(encoded)


def test_homopolymers_and_periodic():
    # duplicate rotations galore: AAAA…, ABAB…, ABCABC…
    _check([np.zeros(16, dtype=np.int64), np.zeros(24, dtype=np.int64)])
    _check(
        [
            np.tile([0, 1], 10).astype(np.int64),
            np.tile([0, 1, 2], 8).astype(np.int64),
        ]
    )


def test_mixed_lengths_and_short():
    _check(
        [
            np.array([0, 1, 2, 3], dtype=np.int64),
            np.array([0, 1, 2, 3, 0, 1], dtype=np.int64),
            np.array([2, 3, 0, 1, 3], dtype=np.int64),
        ]
    )


def test_jax_engine_satisfies_invariants():
    rng = np.random.default_rng(7)
    n = 48
    base = rng.integers(0, 4, size=n, dtype=np.int64)
    encoded = []
    for _ in range(3):
        row = np.roll(base, int(rng.integers(0, n))).copy()
        row[int(rng.integers(0, n))] = int(rng.integers(0, 4))
        encoded.append(row)
    index, blocks = engine.collect_blocks_jax(encoded)
    verify.verify_index(index, encoded)
    verify.verify_blocks(index, blocks, encoded)


def test_checker_catches_corruption():
    encoded = [
        np.array([0, 1, 2, 3, 1], dtype=np.int64),
        np.array([1, 2, 3, 1, 0], dtype=np.int64),
    ]
    index = cyclic.build_rotation_index(encoded)
    bad = np.array(index.lcp)
    if len(bad) > 3:
        bad[3] = bad[3] + 1
    index.lcp = bad
    with pytest.raises(verify.IndexInvariantError):
        verify.verify_index(index, encoded)
