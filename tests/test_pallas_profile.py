"""Device profile-DP paths that run on the CPU: exactness vs numpy.

Each case runs once per implementation: ``rowscan`` (the XLA row scan of
``dp/wavefront.py``, the device DP off the GPU) and ``packed`` (the GPU
path of ``dp/profile_cuda.py`` — channels, 2-bit packed layout, packed
backtrack — with the kernel's plain-JAX twin as the fill; the CUDA kernel
itself only runs on a card, tests/test_chip.py).

Golden = the numpy ``dp_fill`` (itself pinned bit-identical to the
native C++ kernel and the reference semantics by
tests/test_dp_wavefront.py / test_alignment_parity.py).
"""

import numpy as np
import pytest

from csa_jax import config
from csa_jax.align import progressive
from csa_jax.dp import profile_cuda, wavefront


def _path(impl, item):
    if impl == "rowscan":
        return wavefront.dp_path_rowscan(*item)
    return profile_cuda.profile_path(*item, impl="reference")


def _paths(impl, items):
    if impl == "rowscan":
        return wavefront.dp_paths_rowscan_batched(items)
    return profile_cuda.profile_paths(items, impl="reference")


impls = pytest.mark.parametrize("impl", ["rowscan", "packed"])


def _golden_maps(item):
    codes, sv, i, top, erg = item
    _, dirs = progressive.dp_fill(codes, sv, i, top_row=top, edge_rowgap=erg)
    return progressive._dirs_to_maps(dirs, len(codes), len(sv))


def _rand_item(rng, rmax=120, cmax=160):
    R = int(rng.integers(1, rmax))
    C = int(rng.integers(1, cmax))
    i = int(rng.integers(1, 17))
    codes = rng.integers(0, 4, size=R).astype(np.int64)
    sv = rng.integers(0, 4, size=(C, 5)).astype(np.int64)
    # stale-allocation boundaries: arbitrary top row / edge scale
    top = rng.integers(-60, 10, size=C + 1).astype(np.int64)
    top[0] = 0
    erg = int(rng.integers(-20, 0))
    return codes, sv, i, top, erg


@impls
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_single_gap_exact(impl, seed):
    rng = np.random.default_rng(seed)
    item = _rand_item(rng)
    path = _path(impl, item)
    got = progressive._path_to_maps(path)
    want = _golden_maps(item)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


@impls
def test_batched_ragged_exact(impl):
    rng = np.random.default_rng(7)
    items = [_rand_item(rng) for _ in range(6)]
    paths = _paths(impl, items)
    for p, it in zip(paths, items):
        got = progressive._path_to_maps(p)
        want = _golden_maps(it)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


@impls
def test_fresh_default_boundaries_exact(impl):
    rng = np.random.default_rng(11)
    R, C, i = 64, 200, 9
    codes = rng.integers(0, 4, size=R).astype(np.int64)
    sv = rng.integers(0, 5, size=(C, 5)).astype(np.int64)
    top = progressive.default_top_row(sv, i)
    item = (codes, sv, i, top, -i)
    path = _path(impl, item)
    got = progressive._path_to_maps(path)
    want = _golden_maps(item)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


@impls
def test_non_default_scoring_exact(impl):
    rng = np.random.default_rng(3)
    item = _rand_item(rng)
    config.set_scoring(
        config.Scoring(match=3, mismatch=-2, indel=-4, doublegap=-1)
    )
    try:
        path = _path(impl, item)
        got = progressive._path_to_maps(path)
        want = _golden_maps(item)
    finally:
        config.set_scoring(config.DEFAULT_SCORING)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


@impls
def test_degenerate_single_row_and_col(impl):
    # R=1 / C=1 shapes exercise the injection-only diagonals
    for R, C in [(1, 40), (40, 1), (1, 1)]:
        rng = np.random.default_rng(R * 100 + C)
        i = 3
        codes = rng.integers(0, 4, size=R).astype(np.int64)
        sv = rng.integers(0, 3, size=(C, 5)).astype(np.int64)
        top = progressive.default_top_row(sv, i)
        item = (codes, sv, i, top, -i)
        path = _path(impl, item)
        got = progressive._path_to_maps(path)
        want = _golden_maps(item)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


@impls
def test_max_profile_counts_i64(impl):
    """i = 64 (the reference's MAXNUMBEROFSEQS bound) saturates the
    count-based scores and the 7-bit count fields; int32 stays exact."""
    rng = np.random.default_rng(64)
    R, C, i = 90, 140, 64
    codes = rng.integers(0, 4, size=R).astype(np.int64)
    sv = rng.integers(0, 65, size=(C, 5)).astype(np.int64)
    top = progressive.default_top_row(sv, i)
    item = (codes, sv, i, top, -i)
    path = _path(impl, item)
    got = progressive._path_to_maps(path)
    want = _golden_maps(item)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


@impls
def test_bucket_edge_shapes(impl):
    """R/C exactly at and one past the 512 bucket edge exercise the
    padded regions (and the 256-column strip edges)."""
    rng = np.random.default_rng(512)
    for R, C in [(512, 512), (513, 511), (511, 513)]:
        i = 5
        codes = rng.integers(0, 4, size=R).astype(np.int64)
        sv = rng.integers(0, 3, size=(C, 5)).astype(np.int64)
        top = progressive.default_top_row(sv, i)
        item = (codes, sv, i, top, -i)
        path = _path(impl, item)
        got = progressive._path_to_maps(path)
        want = _golden_maps(item)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
