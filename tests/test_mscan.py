"""Multi-channel prefix scans (index/mscan.py) and the collect front.

The ``lax`` wrappers must equal per-channel numpy accumulations for
every option combination, and the collect front built on them must
match the numpy engine's cascade.
"""

import numpy as np
import pytest

from csa_jax.index import mscan


@pytest.mark.parametrize("M,N", [(1, 100), (3, 2048), (12, 5000),
                                 (16, 2047), (26, 4097)])
def test_multi_cummax_matches_lax(M, N):
    rng = np.random.default_rng(M * 1000 + N)
    x = rng.integers(-(2**30), 2**30, size=(M, N)).astype(np.int32)
    want = np.maximum.accumulate(x, axis=1)
    got = np.asarray(mscan.multi_cummax(x))
    np.testing.assert_array_equal(got, want)


def test_multi_cummax_reverse():
    rng = np.random.default_rng(7)
    x = rng.integers(-(2**30), 2**30, size=(5, 3000)).astype(np.int32)
    want = np.maximum.accumulate(x[:, ::-1], axis=1)[:, ::-1]
    got = np.asarray(mscan.multi_cummax(x, reverse=True))
    np.testing.assert_array_equal(got, want)


def test_multi_cummax_min_over_channels():
    rng = np.random.default_rng(11)
    x = rng.integers(-(2**30), 2**30, size=(13, 2500)).astype(np.int32)
    want = np.maximum.accumulate(x, axis=1).min(axis=0)
    got = np.asarray(mscan.multi_cummax(x, min_over_channels=True))
    np.testing.assert_array_equal(got, want)


def test_multi_cummin_reverse_max_over():
    rng = np.random.default_rng(13)
    x = rng.integers(-(2**30), 2**30, size=(9, 2100)).astype(np.int32)
    want = np.minimum.accumulate(x[:, ::-1], axis=1)[:, ::-1].max(axis=0)
    got = np.asarray(
        mscan.multi_cummin(x, reverse=True, max_over_channels=True)
    )
    np.testing.assert_array_equal(got, want)


def test_collect_front_through_interpreted_kernel():
    """The collect front's PSV/NSV + coverage scans (index/mscan.py),
    run through the device engine, match the numpy cascade."""
    rng = np.random.default_rng(3)
    from csa_jax.index import cyclic, engine

    n = 400
    base = rng.integers(0, 4, size=n)
    encoded = []
    for _ in range(4):
        row = np.roll(base, int(rng.integers(0, n))).copy()
        idx = rng.integers(0, n, size=6)
        row[idx] = rng.integers(0, 4, size=6)
        encoded.append(row.astype(np.int64))
    index, got = engine.collect_blocks_jax(encoded)
    want_index = cyclic.build_rotation_index(encoded)
    want = cyclic.collect_blocks(want_index)
    np.testing.assert_array_equal(np.sort(got.start), np.sort(want.start))
    np.testing.assert_array_equal(np.sort(got.depth), np.sort(want.depth))
