"""Device linear suffix index vs the exact numpy twin.

The alignment phase's anchor discovery (border nodes; reference
morenodeslinkedlists.c:303-326) must produce identical results whether
the suffix sort runs on the host (numpy lexsort loop) or on the device
engine (jax.lax.sort prefix doubling, engine.linear_suffix_order).
"""

import io

import numpy as np

from csa_jax.align import anchors
from csa_jax.io import fasta as fio
from csa_jax.rotation import pipeline as rot


def _random_rotated(k=5, n=180, seed=13):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=n, dtype=np.int64)
    out = []
    for _ in range(k):
        row = np.roll(base, int(rng.integers(0, n))).copy()
        for _ in range(5):
            row[int(rng.integers(0, n))] = int(rng.integers(0, 4))
        out.append(row)
    return out


def _assert_index_equal(a, b):
    np.testing.assert_array_equal(a.seq_of, b.seq_of)
    np.testing.assert_array_equal(a.pos_of, b.pos_of)
    np.testing.assert_array_equal(a.cap, b.cap)
    np.testing.assert_array_equal(a.lcp, b.lcp)


def test_linear_index_backends_agree_synthetic():
    rotated = _random_rotated()
    _assert_index_equal(
        anchors.build_linear_index(rotated, backend="numpy"),
        anchors.build_linear_index(rotated, backend="jax"),
    )


def test_linear_index_backends_agree_degenerate():
    # homopolymers + exact repeats stress tie-breaking and LCP caps
    rotated = [
        np.zeros(40, dtype=np.int64),
        np.zeros(40, dtype=np.int64),
        np.tile([0, 1], 20).astype(np.int64),
    ]
    _assert_index_equal(
        anchors.build_linear_index(rotated, backend="numpy"),
        anchors.build_linear_index(rotated, backend="jax"),
    )


def test_border_nodes_backends_agree_primates(fixtures_dir):
    seqs = fio.load_fasta(str(fixtures_dir / "Primates.txt"), log=io.StringIO())
    res = rot.analyze(seqs, log=io.StringIO(), backend="numpy")
    enc = seqs.encoded_all()
    rotated = [np.roll(e, -int(r)) for e, r in zip(enc, res.rotations)]
    nodes_np = anchors.compute_border_nodes(rotated, backend="numpy")
    nodes_jax = anchors.compute_border_nodes(rotated, backend="jax")
    assert len(nodes_np) == len(nodes_jax)
    for a, b in zip(nodes_np, nodes_jax):
        assert a.size == b.size
        assert len(a.positions) == len(b.positions)
        for pa, pb in zip(a.positions, b.positions):
            np.testing.assert_array_equal(pa, pb)


def test_border_nodes_native_backend_agrees(fixtures_dir):
    """Native anchor_attach (C++ mstat sweeps + monotonic-stack nearest
    queries) must reproduce the numpy twin exactly, including on random
    degenerate inputs."""
    seqs = fio.load_fasta(str(fixtures_dir / "Primates.txt"), log=io.StringIO())
    res = rot.analyze(seqs, log=io.StringIO(), backend="numpy")
    enc = seqs.encoded_all()
    rotated = [np.roll(e, -int(r)) for e, r in zip(enc, res.rotations)]
    sets = [rotated]
    rng = np.random.default_rng(21)
    for _ in range(6):
        k = int(rng.integers(2, 6))
        sets.append(
            [rng.integers(0, 4, size=int(rng.integers(40, 300)))
             for _ in range(k)]
        )
    # homopolymers + duplicates: stress tie handling
    sets.append([np.zeros(60, dtype=np.int64), np.zeros(60, dtype=np.int64) ])
    for enc_set in sets:
        nodes_np = anchors.compute_border_nodes(enc_set, backend="numpy")
        nodes_nat = anchors.compute_border_nodes(enc_set, backend="native")
        assert len(nodes_np) == len(nodes_nat)
        for a, b in zip(nodes_np, nodes_nat):
            assert a.size == b.size
            for pa, pb in zip(a.positions, b.positions):
                np.testing.assert_array_equal(pa, pb)
