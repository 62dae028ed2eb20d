"""Sequence-parallel wavefront fill parity (SURVEY §5 halo exchange).

The column-sharded fill with ppermute halo exchange must produce the
bit-identical direction matrix of the single-device row scan / numpy
fill, for every mesh size, including non-default scoring.
"""

import numpy as np
import pytest

import jax

from csa_jax import config
from csa_jax.align import progressive
from csa_jax.dp import seqpar


def _mesh(n):
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:n]), ("col",))


def _numpy_dirs(row_codes, sv, i):
    from csa_jax import native

    lib, tried = native._lib, native._tried
    try:
        native._lib = None
        native._tried = True
        _, dirs = progressive.dp_fill(row_codes, sv, i)
    finally:
        native._lib, native._tried = lib, tried
    return dirs


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_seqpar_matches_numpy(n_dev):
    rng = np.random.default_rng(n_dev)
    R = int(rng.integers(30, 300))
    C = int(rng.integers(50, 500))
    i = int(rng.integers(1, 7))
    codes = rng.integers(0, 4, size=R).astype(np.int8)
    sv = rng.integers(0, 3, size=(C, 5)).astype(np.int64)
    dirs_ref = _numpy_dirs(codes, sv, i)
    dirs_sp = seqpar.dp_fill_seqpar(codes, sv, i, mesh=_mesh(n_dev),
                                    band_rows=16)
    np.testing.assert_array_equal(dirs_sp, dirs_ref)


def test_seqpar_non_default_scoring():
    rng = np.random.default_rng(42)
    codes = rng.integers(0, 4, size=120).astype(np.int8)
    sv = rng.integers(0, 3, size=(200, 5)).astype(np.int64)
    i = 4
    config.set_scoring(config.Scoring(match=2, mismatch=-3, indel=-2,
                                      doublegap=-1))
    try:
        dirs_ref = _numpy_dirs(codes, sv, i)
        dirs_sp = seqpar.dp_fill_seqpar(codes, sv, i, mesh=_mesh(8),
                                        band_rows=8)
        np.testing.assert_array_equal(dirs_sp, dirs_ref)
    finally:
        config.set_scoring(config.DEFAULT_SCORING)


def test_seqpar_giant_shape_smoke():
    """A Set3-shaped (tall x wide) fill stays exact across the mesh."""
    rng = np.random.default_rng(7)
    R, C, i = 700, 1900, 9
    codes = rng.integers(0, 4, size=R).astype(np.int8)
    sv = rng.integers(0, 4, size=(C, 5)).astype(np.int64)
    dirs_ref = _numpy_dirs(codes, sv, i)
    dirs_sp = seqpar.dp_fill_seqpar(codes, sv, i, mesh=_mesh(8),
                                    band_rows=64)
    np.testing.assert_array_equal(dirs_sp, dirs_ref)


def test_seqpar_path_matches_numpy_backtrack():
    """Fill + ON-DEVICE backtrack: the path-only variant (only O(R+C)
    codes reach the host) reproduces the numpy walk exactly."""
    for n_dev, seed in [(2, 1), (8, 2)]:
        rng = np.random.default_rng(seed)
        R = int(rng.integers(40, 250))
        C = int(rng.integers(60, 400))
        i = int(rng.integers(1, 9))
        codes = rng.integers(0, 4, size=R).astype(np.int8)
        sv = rng.integers(0, 3, size=(C, 5)).astype(np.int64)
        dirs_ref = _numpy_dirs(codes, sv, i)
        want = progressive._dirs_to_maps(dirs_ref, R, C)
        path = seqpar.dp_path_seqpar(codes, sv, i, mesh=_mesh(n_dev),
                                     band_rows=16)
        got = progressive._path_to_maps(path)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_batched_giants_route_to_seqpar(monkeypatch):
    """progressive_dp_batched with a mesh sends oversized merges through
    the column-sharded seqpar path; output identical to the pure-numpy
    progressive DP."""
    rng = np.random.default_rng(11)
    gaps = [
        [rng.integers(0, 4, size=int(rng.integers(150, 260)))
         for _ in range(4)]
        for _ in range(3)
    ]
    want = [progressive.progressive_dp([g.copy() for g in gs],
                                       dp_backend="numpy")
            for gs in gaps]
    # a tiny dirs cap forces every non-trivial merge off the padded
    # batch and onto the giant path
    monkeypatch.setattr(progressive, "BATCH_DIRS_CAP", 1)
    calls = {"n": 0}
    from csa_jax.dp import seqpar as seqpar_mod

    real = seqpar_mod.dp_path_seqpar

    def spy(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(seqpar_mod, "dp_path_seqpar", spy)
    from jax.sharding import Mesh

    mesh = Mesh(np.asarray(jax.devices()), ("gap",))
    got = progressive.progressive_dp_batched(
        [[g.copy() for g in gs] for gs in gaps], mesh=mesh
    )
    assert calls["n"] > 0
    for gs_want, gs_got in zip(want, got):
        for a, b in zip(gs_want, gs_got):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_band_pallas_path_matches_numpy(n_dev):
    """The seqpar path (fill + device backtrack) at band_rows=32
    reproduces the numpy walk bit-exactly at every mesh size."""
    rng = np.random.default_rng(100 + n_dev)
    R = int(rng.integers(40, 200))
    C = int(rng.integers(60, 300))
    i = int(rng.integers(1, 9))
    codes = rng.integers(0, 4, size=R).astype(np.int8)
    sv = rng.integers(0, 3, size=(C, 5)).astype(np.int64)
    dirs_ref = _numpy_dirs(codes, sv, i)
    want = progressive._dirs_to_maps(dirs_ref, R, C)
    path = seqpar.dp_path_seqpar(codes, sv, i, mesh=_mesh(n_dev),
                                 band_rows=32)
    got = progressive._path_to_maps(path)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_band_pallas_non_default_scoring():
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=90).astype(np.int8)
    sv = rng.integers(0, 3, size=(140, 5)).astype(np.int64)
    i = 5
    config.set_scoring(config.Scoring(match=2, mismatch=-3, indel=-2,
                                      doublegap=-1))
    try:
        dirs_ref = _numpy_dirs(codes, sv, i)
        want = progressive._dirs_to_maps(dirs_ref, 90, 140)
        path = seqpar.dp_path_seqpar(codes, sv, i, mesh=_mesh(4),
                                     band_rows=32)
        got = progressive._path_to_maps(path)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    finally:
        config.set_scoring(config.Scoring())


def test_band_pallas_stale_boundaries():
    """Arbitrary (stale) top_row / edge_rowgap boundaries — the
    reference reuses dp edges between same-shape merges
    (dynamicprogramming.c:957-987) — flow through the seqpar halo
    path exactly."""
    from csa_jax.dp import wavefront

    rng = np.random.default_rng(23)
    R, C, i = 70, 180, 6
    codes = rng.integers(0, 4, size=R).astype(np.int8)
    sv = rng.integers(0, 3, size=(C, 5)).astype(np.int64)
    top = rng.integers(-500, 500, size=C + 1).astype(np.int64)
    erg = -11
    want = wavefront.dp_path_rowscan(codes, sv, i, top_row=top,
                                     edge_rowgap=erg)
    path = seqpar.dp_path_seqpar(
        codes, sv, i, mesh=_mesh(8), band_rows=32, top_row=top,
        edge_rowgap=erg,
    )
    np.testing.assert_array_equal(path, want)
