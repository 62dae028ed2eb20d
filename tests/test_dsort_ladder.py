"""Shard-local prefix-doubling ladder: bit-parity with the single-device
index build at every mesh size (the production sharded backend path)."""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from csa_jax.index import engine
from csa_jax.parallel import dsort_ladder


def _circular_set(k, n, seed, noise=200):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=n, dtype=np.int64)
    enc = []
    for _ in range(k):
        row = np.roll(base, int(rng.integers(0, n))).copy()
        idx = rng.integers(0, n, size=max(1, n // noise))
        row[idx] = rng.integers(0, 4, size=len(idx))
        enc.append(row)
    return enc


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_ladder_matches_single_device_build(n_dev):
    enc = _circular_set(8, 3000, seed=3)
    want_arrays, want_aux = engine._device_build(enc)
    mesh = Mesh(
        np.asarray(jax.devices()[:n_dev]).reshape(n_dev, 1), ("seq", "pos")
    )
    got_arrays, got_aux = dsort_ladder.device_build_dsort(enc, mesh)
    assert got_aux == want_aux
    np.testing.assert_array_equal(
        np.asarray(got_arrays[0]), np.asarray(want_arrays[0])
    )
    np.testing.assert_array_equal(
        np.asarray(got_arrays[1]), np.asarray(want_arrays[1])
    )


def test_ladder_ragged_lengths():
    # unequal sequence lengths exercise the padded-slot sentinels
    rng = np.random.default_rng(9)
    enc = [
        rng.integers(0, 4, size=int(rng.integers(500, 2500))).astype(np.int64)
        for _ in range(6)
    ]
    want_arrays, want_aux = engine._device_build(enc)
    mesh = Mesh(np.asarray(jax.devices()).reshape(-1, 1), ("seq", "pos"))
    got_arrays, got_aux = dsort_ladder.device_build_dsort(enc, mesh)
    assert got_aux == want_aux
    np.testing.assert_array_equal(
        np.asarray(got_arrays[0]), np.asarray(want_arrays[0])
    )
    np.testing.assert_array_equal(
        np.asarray(got_arrays[1]), np.asarray(want_arrays[1])
    )


def test_ladder_duplicate_rotation_fallback():
    # identical rotations of one sequence within the set -> dup fallback
    rng = np.random.default_rng(4)
    base = rng.integers(0, 4, size=64).astype(np.int64)
    period = np.tile(base[:8], 8)  # period-8 sequence: duplicate rotations
    enc = [period, np.roll(period, 3)]
    mesh = Mesh(np.asarray(jax.devices()).reshape(-1, 1), ("seq", "pos"))
    arrays, aux = dsort_ladder.device_build_dsort(enc, mesh)
    w_arrays, w_aux = engine._device_build(enc)
    assert (arrays is None) == (w_arrays is None)
