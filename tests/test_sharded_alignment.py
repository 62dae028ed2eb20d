"""Mesh-sharded alignment gap-DP parity.

The batched inter-anchor gap merges are embarrassingly independent
(alignment.c:179-208); ``dp_paths_device_sharded`` distributes the gap
axis over a 1D device mesh via shard_map.  These tests pin bit-parity of
the sharded launch against the single-device batched launch and the host
path on the virtual 8-device CPU mesh.
"""

import numpy as np
import pytest

import jax

from csa_jax.align import progressive


def _random_gaps(rng, n_gaps, k, lo=20, hi=200):
    return [
        [
            rng.integers(0, 4, size=int(rng.integers(lo, hi))).astype(np.int8)
            for _ in range(k)
        ]
        for _ in range(n_gaps)
    ]


@pytest.fixture
def mesh():
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), ("gap",))


def test_sharded_batch_matches_single_device(mesh):
    from csa_jax.dp import wavefront

    rng = np.random.default_rng(5)
    items = []
    for _ in range(11):  # odd count: exercises mesh-multiple padding
        R = int(rng.integers(5, 120))
        C = int(rng.integers(5, 150))
        i = int(rng.integers(1, 6))
        codes = rng.integers(0, 4, size=R).astype(np.int8)
        sv = rng.integers(0, 3, size=(C, 5)).astype(np.int64)
        top = progressive.default_top_row(sv, i)
        items.append((codes, sv, i, top, -i))
    single = wavefront.dp_paths_device_batched(items)
    sharded = wavefront.dp_paths_device_sharded(items, mesh=mesh)
    assert len(single) == len(sharded)
    for a, b in zip(single, sharded):
        np.testing.assert_array_equal(a, b)


def test_sharded_progressive_matches_host(mesh):
    rng = np.random.default_rng(9)
    gaps = _random_gaps(rng, n_gaps=6, k=5)
    host = [
        progressive.progressive_dp([g.copy() for g in gap])
        for gap in gaps
    ]
    sharded = progressive.progressive_dp_batched(
        [[g.copy() for g in gap] for gap in gaps], mesh=mesh
    )
    for h, s in zip(host, sharded):
        for a, b in zip(h, s):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_sharded_pallas_body_matches_rowscan(n_dev):
    """The gap-axis shard_map with the GPU path's body (channels, packed
    layout and packed backtrack; the kernel's plain-JAX twin as fill) is
    bit-identical to the single-device row-scan batch at every mesh
    size on the virtual CPU mesh."""
    from jax.sharding import Mesh

    from csa_jax.dp import wavefront

    devs = np.asarray(jax.devices()[:n_dev])
    if len(devs) < n_dev:
        pytest.skip("not enough virtual devices")
    mesh = Mesh(devs, ("gap",))
    rng = np.random.default_rng(17)
    items = []
    for _ in range(9):  # odd count: exercises mesh-multiple padding
        R = int(rng.integers(5, 100))
        C = int(rng.integers(5, 120))
        i = int(rng.integers(1, 6))
        codes = rng.integers(0, 4, size=R).astype(np.int8)
        sv = rng.integers(0, 3, size=(C, 5)).astype(np.int64)
        top = progressive.default_top_row(sv, i)
        items.append((codes, sv, i, top, -i))
    single = wavefront.dp_paths_rowscan_batched(items)
    sharded = wavefront.dp_paths_device_sharded(
        items, mesh, impl="reference"
    )
    assert len(single) == len(sharded)
    for a, b in zip(single, sharded):
        np.testing.assert_array_equal(a, b)


def test_runner_sharded_backend_matches_numpy():
    """End-to-end run_alignment under the sharded backend equals numpy."""
    from csa_jax.align import runner

    rng = np.random.default_rng(3)
    core = rng.integers(0, 4, size=120)
    rotated = []
    for _ in range(4):
        pre = rng.integers(0, 4, size=int(rng.integers(60, 140)))
        post = rng.integers(0, 4, size=int(rng.integers(60, 140)))
        rotated.append(
            np.concatenate([pre, core, post]).astype(np.int8)
        )
    import io

    res_np = runner.run_alignment(
        [r.copy() for r in rotated], log=io.StringIO(), dp_backend="numpy"
    )
    out_np = runner.render_alignment(res_np, [r.copy() for r in rotated])
    res_sh = runner.run_alignment(
        [r.copy() for r in rotated], log=io.StringIO(), dp_backend="sharded"
    )
    out_sh = runner.render_alignment(res_sh, [r.copy() for r in rotated])
    for a, b in zip(out_np, out_sh):
        np.testing.assert_array_equal(a, b)
