"""Round-3 fast rotation path: slim entry, caps retries, GSPMD meshes,
auto-backend policy.
"""

import numpy as np
import pytest

import jax

from csa_jax.index import cyclic, engine
from csa_jax.rotation import pipeline as rot


def _shared_core_set(rng, k=5, core_len=120):
    core = rng.integers(0, 4, size=core_len)
    enc = []
    for _ in range(k):
        pre = rng.integers(0, 4, size=int(rng.integers(80, 400)))
        post = rng.integers(0, 4, size=int(rng.integers(80, 400)))
        enc.append(np.concatenate([pre, core, post]))
    return enc


def _numpy_final(enc):
    index = cyclic.build_rotation_index(enc)
    blocks = cyclic.collect_blocks(index)
    keep = cyclic.remove_suffix_blocks(blocks)
    unique, positions = blocks.positions_if_unique()
    final = keep & unique
    start = blocks.start[final]
    depth = blocks.depth[final]
    pos = positions[final]
    o = np.lexsort((-depth, start))
    return (
        len(blocks),
        int(keep.sum()),
        start[o],
        depth[o],
        pos[o],
    )


@pytest.mark.parametrize("seed", [1, 23])
def test_rotation_final_matches_numpy(seed):
    rng = np.random.default_rng(seed)
    enc = _shared_core_set(rng)
    nb, nsuf, start, depth, pos = _numpy_final(enc)
    rf = engine.rotation_final_jax(enc)
    assert rf.num_collected == nb
    assert rf.num_after_suffix == nsuf
    np.testing.assert_array_equal(rf.final_start, start)
    np.testing.assert_array_equal(rf.final_depth, depth)
    np.testing.assert_array_equal(rf.final_positions, pos)


def test_rotation_final_cap_retry():
    """Tiny initial caps force every retry branch; result unchanged."""
    rng = np.random.default_rng(3)
    enc = _shared_core_set(rng, k=4)
    ref = engine.rotation_final_jax(enc)
    engine._CAPS_CACHE.clear()
    got = engine.rotation_final_jax(enc, cap=4)
    np.testing.assert_array_equal(got.final_start, ref.final_start)
    assert got.num_collected == ref.num_collected


def test_rotation_final_gspmd_mesh_parity():
    from csa_jax.parallel import sharded

    rng = np.random.default_rng(9)
    enc = _shared_core_set(rng, k=8)
    ref = engine.rotation_final_jax(enc)
    for shape in [(8, 1), (2, 4)]:
        mesh = sharded.make_mesh(8, shape)
        got = engine.rotation_final_jax(enc, mesh=mesh)
        assert got.num_collected == ref.num_collected
        np.testing.assert_array_equal(got.final_start, ref.final_start)
        np.testing.assert_array_equal(
            got.final_positions, ref.final_positions
        )


def test_rotation_final_duplicate_fallback():
    """Same-sequence duplicate rotations return None (numpy fallback)."""
    enc = [np.array([0, 1, 2, 3] * 6), np.array([1, 2, 3, 0] * 6)]
    assert engine.rotation_final_jax(enc) is None


def test_auto_backend_size_policy(monkeypatch):
    monkeypatch.delenv("CSA_AUTO_DEVICE_MIN", raising=False)
    from csa_jax import native

    if native.available():
        assert rot.resolve_auto_backend(100_000) == "native"
    # above the threshold with only CPU devices, auto must NOT pick the
    # device path (virtual CPU mesh is not an accelerator)
    big = rot.resolve_auto_backend(10_000_000)
    have_accel = any(d.platform != "cpu" for d in jax.devices())
    if not have_accel:
        assert big in ("native", "jax")
        if native.available():
            assert big == "native"
