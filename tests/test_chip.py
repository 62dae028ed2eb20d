"""Exactness of the device paths on a GPU (``chip`` marker).

Skipped on the CPU; run on a card with
``JAX_PLATFORMS=cuda python -m pytest -m chip tests/test_chip.py``.
``chip_smoke.py`` runs the same checks at full size.

* fused rotation program -> bit-identical Primates rotations;
* batched pairwise NW -> full-batch equality with the C++ host kernel;
* CUDA profile-DP fill + on-device backtrack -> the row scan's paths,
  the numpy and native fills under non-default scoring, and identical
  alignments to the host engine on real gap data.
"""

import io

import numpy as np
import pytest

pytestmark = pytest.mark.chip


def test_device_backend_is_gpu():
    import jax

    assert jax.devices()[0].platform == "gpu"


def test_rotation_bit_identical_on_chip(fixtures_dir):
    from csa_jax.io import fasta as fio
    from csa_jax.rotation import pipeline as rot

    seqs = fio.load_fasta(str(fixtures_dir / "Primates.txt"), log=io.StringIO())
    a = rot.analyze(seqs, log=io.StringIO(), backend="numpy")
    b = rot.analyze(seqs, log=io.StringIO(), backend="jax")
    assert list(a.rotations) == list(b.rotations)
    assert (a.num_collected, int(a.num_after_suffix), a.num_after_unique,
            a.num_chains) == (b.num_collected, int(b.num_after_suffix),
                              b.num_after_unique, b.num_chains)


def test_nw_full_batch_exact_on_chip():
    from csa_jax.dp import nw

    rng = np.random.default_rng(11)
    B, L = 64, 1024
    a = rng.integers(0, 4, size=(B, L))
    b = rng.integers(0, 4, size=(B, L))
    assert (nw.pairwise_nw_scores(a, b) == nw.nw_scores_host(a, b)).all()


def test_cuda_fill_matches_rowscan_on_chip():
    """Stale boundaries, i up to 64, 1-row/1-column shapes."""
    from csa_jax.dp import profile_cuda, wavefront

    rng = np.random.default_rng(3)
    items = []
    for R, C in [(1, 40), (40, 1), (700, 1300), (1500, 300), (64, 2500)]:
        i = int(rng.integers(1, 65))
        codes = rng.integers(0, 4, size=R).astype(np.int8)
        sv = rng.integers(0, i + 1, size=(C, 5)).astype(np.int64)
        top = rng.integers(-500, 10, size=C + 1).astype(np.int64)
        items.append((codes, sv, i, top, int(rng.integers(-20, 0))))
    got = profile_cuda.profile_paths(items, impl="cuda")
    want = wavefront.dp_paths_rowscan_batched(items)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_cuda_non_default_scoring_on_chip():
    """Non-default scoring and stale boundaries: the CUDA path equals
    the numpy fill's maps and the native fill + walk's path."""
    from csa_jax import config, native
    from csa_jax.align import progressive
    from csa_jax.dp import profile_cuda

    rng = np.random.default_rng(9)
    R, C, i = 300, 700, 6
    codes = rng.integers(0, 4, size=R).astype(np.int8)
    sv = rng.integers(0, i + 1, size=(C, 5)).astype(np.int64)
    top = rng.integers(-400, 10, size=C + 1).astype(np.int64)
    config.set_scoring(
        config.Scoring(match=3, mismatch=-2, indel=-4, doublegap=-1)
    )
    try:
        path = profile_cuda.profile_path(codes, sv, i, top, -7)
        _, dirs = progressive.dp_fill(codes, sv, i, top_row=top,
                                      edge_rowgap=-7)
        host = native.dp_fill_path(codes, sv, i, top, -7)
    finally:
        config.set_scoring(config.DEFAULT_SCORING)
    got = progressive._path_to_maps(path)
    want = progressive._dirs_to_maps(dirs, R, C)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if host is not None:
        np.testing.assert_array_equal(path, host[1])


def test_progressive_dp_device_path_on_chip(monkeypatch):
    """Force every merge through the device fill (single and batched
    launches) and pin the alignments against numpy."""
    from csa_jax.align import progressive

    monkeypatch.setenv("CSA_DEVICE_MIN_CELLS", "1")
    monkeypatch.setenv("CSA_BATCH_MIN_CELLS", "1")
    rng = np.random.default_rng(17)
    gaps = [
        rng.integers(0, 4, size=rng.integers(200, 700)).astype(np.int8)
        for _ in range(5)
    ]
    host = progressive.progressive_dp([g.copy() for g in gaps],
                                      dp_backend="numpy")
    dev = progressive.progressive_dp([g.copy() for g in gaps],
                                     dp_backend="jax")
    for a, b in zip(host, dev):
        np.testing.assert_array_equal(a, b)

    many = [
        [rng.integers(0, 4, size=rng.integers(100, 400)) for _ in range(4)]
        for _ in range(3)
    ]
    hostb = [
        progressive.progressive_dp([g.copy() for g in gs],
                                   dp_backend="numpy")
        for gs in many
    ]
    devb = progressive.progressive_dp_batched(
        [[g.copy() for g in gs] for gs in many]
    )
    for hs, ds in zip(hostb, devb):
        for a, b in zip(hs, ds):
            np.testing.assert_array_equal(a, b)
