"""Shard-local collect front: bit-parity with the replicated cascade."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from csa_jax.index import engine
from csa_jax.parallel import collect_sharded, dsort_ladder


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


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_front_matches_replicated(n_dev):
    enc = _circular_set(8, 2500, seed=5)
    arrays, aux = engine._device_build(enc)
    order, lcp, js = arrays
    k, n_max, mg0 = aux
    tdeep = engine._tdeep_for(mg0, k, n_max)
    want = engine._collect_front(
        jnp.asarray(order), jnp.asarray(lcp), js, k=k, n_max=n_max,
        tdeep=tdeep,
    )
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]).reshape(-1), ("x",))
    with jax.enable_x64():
        prog = collect_sharded.collect_front_program(
            mesh, k=k, n_max=n_max, tdeep=tdeep
        )
        got = prog(jnp.asarray(order), jnp.asarray(lcp), js)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_rotation_final_sharded_collect_end_to_end():
    """Full sharded rotation_final (ladder build + sharded collect
    front) equals the single-device result."""
    enc = _circular_set(8, 4000, seed=8)
    single = engine.rotation_final_jax(enc)
    mesh = dsort_ladder._flat_mesh(
        Mesh(np.asarray(jax.devices()).reshape(-1, 1), ("seq", "pos"))
    )
    mesh2 = Mesh(np.asarray(jax.devices()).reshape(-1, 1), ("seq", "pos"))
    sharded_res = engine.rotation_final_jax(enc, mesh=mesh2)
    assert single is not None and sharded_res is not None
    np.testing.assert_array_equal(
        sharded_res.final_start, single.final_start
    )
    np.testing.assert_array_equal(
        sharded_res.final_depth, single.final_depth
    )
    np.testing.assert_array_equal(
        sharded_res.final_positions, single.final_positions
    )
    assert sharded_res.num_collected == single.num_collected
    assert sharded_res.num_after_suffix == single.num_after_suffix
