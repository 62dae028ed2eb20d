"""Device wavefront vs host DP fill: bit-exact direction matrices."""

import numpy as np
import pytest

from csa_jax import native
from csa_jax.align import progressive
from csa_jax.dp import wavefront


def _random_profile(rng, C, i):
    sv = np.zeros((C, 5), dtype=np.int64)
    for c in range(C):
        left = i
        for t in rng.permutation(5)[:4]:
            v = int(rng.integers(0, left + 1))
            sv[c, t] = v
            left -= v
        sv[c, 4] += left
    return sv


@pytest.mark.parametrize("trial", range(4))
def test_device_wavefront_matches_host(trial):
    rng = np.random.default_rng(trial)
    R = int(rng.integers(1, 80))
    C = int(rng.integers(1, 80))
    i = int(rng.integers(1, 16))
    codes = rng.integers(0, 4, size=R).astype(np.int64)
    sv = _random_profile(rng, C, i)
    # include a stale-edge case: random top_row / edge_rowgap
    top = np.cumsum(rng.integers(-i, 1, size=C + 1)).astype(np.int64)
    top[0] = 0
    erg = int(rng.integers(-i - 3, 0))
    _, host_dirs = progressive.dp_fill(codes, sv, i, top_row=top, edge_rowgap=erg)
    dev_dirs = wavefront.dp_fill_device(codes, sv, i, top_row=top, edge_rowgap=erg)
    assert np.array_equal(host_dirs, dev_dirs)


def test_native_matches_numpy_fallback():
    if not native.available():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(7)
    R, C, i = 50, 60, 9
    codes = rng.integers(0, 4, size=R).astype(np.int64)
    sv = _random_profile(rng, C, i)
    top = progressive.default_top_row(sv, i)
    s_nat, d_nat = native.dp_fill_dirs(codes, sv, i, top, progressive.INDEL * i)
    saved = native.dp_fill_dirs
    try:
        native.dp_fill_dirs = lambda *a: None
        s_np, d_np = progressive.dp_fill(codes, sv, i)
    finally:
        native.dp_fill_dirs = saved
    assert s_nat == s_np
    assert np.array_equal(d_nat, d_np)


@pytest.mark.parametrize("trial", range(3))
def test_device_path_matches_host_walk(trial):
    """Fused fill+backtrack on device == host dirs walk (maps identical)."""
    rng = np.random.default_rng(100 + trial)
    R = int(rng.integers(1, 90))
    C = int(rng.integers(1, 90))
    i = int(rng.integers(1, 12))
    codes = rng.integers(0, 4, size=R).astype(np.int64)
    sv = _random_profile(rng, C, i)
    top = progressive.default_top_row(sv, i)
    erg = progressive.INDEL * i
    _, dirs = progressive.dp_fill(codes, sv, i, top_row=top, edge_rowgap=erg)
    oc_h, r_h = progressive._dirs_to_maps(dirs, R, C)
    path = wavefront.dp_path_device(codes, sv, i, top_row=top, edge_rowgap=erg)
    oc_d, r_d = progressive._path_to_maps(path)
    assert np.array_equal(oc_h, oc_d)
    assert np.array_equal(r_h, r_d)


def test_progressive_dp_backend_jax_identical():
    """progressive_dp with device merges == numpy path, end to end."""
    rng = np.random.default_rng(42)
    gaps = [
        rng.integers(0, 4, size=int(rng.integers(10, 120))).astype(np.int8)
        for _ in range(5)
    ]
    a = progressive.progressive_dp([g.copy() for g in gaps], dp_backend="numpy")
    import os

    os.environ["CSA_DEVICE_MIN_CELLS"] = "1"  # force merges on device
    try:
        b = progressive.progressive_dp([g.copy() for g in gaps], dp_backend="jax")
    finally:
        del os.environ["CSA_DEVICE_MIN_CELLS"]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_progressive_dp_batched_identical():
    """progressive_dp_batched (one padded device launch per merge step
    across gaps) == per-gap progressive_dp, including degenerate gaps."""
    rng = np.random.default_rng(17)
    gap_sets = []
    for g in range(6):
        k = int(rng.integers(2, 6))
        gaps = [
            rng.integers(0, 4, size=int(rng.integers(0, 150))).astype(np.int8)
            for _ in range(k)
        ]
        gap_sets.append(gaps)
    gap_sets.append([np.zeros(0, dtype=np.int8), np.zeros(0, dtype=np.int8)])
    singles = [
        progressive.progressive_dp([g.copy() for g in gaps])
        for gaps in gap_sets
    ]
    batched = progressive.progressive_dp_batched(
        [[g.copy() for g in gaps] for gaps in gap_sets]
    )
    for a, b in zip(singles, batched):
        assert len(a) == len(b)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_run_alignment_deferred_batch_byte_identical(fixtures_dir):
    """Full alignment with dp_backend=jax (deferred, batched gap DP) must
    byte-match the host path on a real set."""
    import io

    from csa_jax.align import runner
    from csa_jax.io import fasta as fio
    from csa_jax.rotation import pipeline as rot

    seqs = fio.load_fasta(str(fixtures_dir / "Primates.txt"), log=io.StringIO())
    res = rot.analyze(seqs, log=io.StringIO(), backend="numpy")
    rotated = [
        np.roll(e, -int(r)) for e, r in zip(seqs.encoded_all(), res.rotations)
    ]
    host = runner.run_alignment(
        [r.copy() for r in rotated], log=io.StringIO(), dp_backend="numpy"
    )
    dev = runner.run_alignment(
        [r.copy() for r in rotated], log=io.StringIO(), dp_backend="jax"
    )
    import tempfile, pathlib
    with tempfile.TemporaryDirectory() as td:
        fa = pathlib.Path(td, "a.fasta")
        fb = pathlib.Path(td, "b.fasta")
        runner.save_alignment(str(fa), host, rotated, seqs.names,
                              res.rotations, log=io.StringIO())
        runner.save_alignment(str(fb), dev, rotated, seqs.names,
                              res.rotations, log=io.StringIO())
        assert fa.read_bytes() == fb.read_bytes()
