"""Parity of the mesh-sharded rotation path against the exact numpy engine.

Runs on the virtual 8-device CPU mesh (tests/conftest.py).  The sharded
backend = GSPMD-partitioned fused block stage + explicit shard_map chain
merge (psum uniqueness vote + all_gather positions); its RotationResult
must match the numpy engine exactly.
"""

import io

import numpy as np
import pytest

import jax

from csa_jax.io import fasta as fio
from csa_jax.parallel import sharded
from csa_jax.rotation import pipeline as rot


def _synthetic_circular_set(k=6, n=220, seed=7):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=n, dtype=np.int32)
    encoded = []
    for _ in range(k):
        row = np.roll(base, int(rng.integers(0, n))).copy()
        for _ in range(4):
            row[int(rng.integers(0, n))] = int(rng.integers(0, 4))
        encoded.append(row)
    return encoded


class _FakeSeqs:
    """Minimal SequenceSet stand-in for pipeline.analyze."""

    def __init__(self, encoded):
        self._encoded = [np.asarray(e) for e in encoded]
        self.sizes = np.array([len(e) for e in encoded], dtype=np.int64)
        self.names = [f"seq{i}" for i in range(len(encoded))]

    def encoded_all(self):
        return self._encoded


def _result_tuple(res):
    return (
        list(map(int, res.rotations)),
        res.num_collected,
        res.num_after_suffix,
        res.num_after_unique,
        res.num_chains,
    )


def test_sharded_blocks_match_jax_on_synthetic():
    encoded = _synthetic_circular_set()
    from csa_jax.index import engine

    ref = engine.rotation_blocks_jax(encoded)
    shr = sharded.rotation_blocks_sharded(encoded)
    assert shr is not None and ref is not None
    assert shr.num_collected == ref.num_collected
    np.testing.assert_array_equal(shr.start, ref.start)
    np.testing.assert_array_equal(shr.end, ref.end)
    np.testing.assert_array_equal(shr.depth, ref.depth)
    np.testing.assert_array_equal(shr.keep_suffix, ref.keep_suffix)
    np.testing.assert_array_equal(shr.unique, ref.unique)
    # positions compared only where consumed downstream (unique & kept)
    final = shr.keep_suffix & shr.unique
    np.testing.assert_array_equal(shr.positions[final], ref.positions[final])


def test_sharded_analyze_matches_numpy_on_synthetic():
    encoded = _synthetic_circular_set(k=8, n=300, seed=11)
    seqs = _FakeSeqs(encoded)
    sink = io.StringIO()
    res_np = rot.analyze(seqs, log=sink, backend="numpy")
    res_sh = rot.analyze(seqs, log=sink, backend="sharded")
    assert _result_tuple(res_sh) == _result_tuple(res_np)


def test_sharded_analyze_primates_parity(fixtures_dir):
    seqs = fio.load_fasta(str(fixtures_dir / "Primates.txt"), log=io.StringIO())
    sink = io.StringIO()
    res_np = rot.analyze(seqs, log=sink, backend="numpy")
    res_sh = rot.analyze(seqs, log=sink, backend="sharded")
    assert _result_tuple(res_sh) == _result_tuple(res_np)
    # ground truth from the compiled reference (BASELINE.md)
    assert res_sh.num_collected == 3004
    assert res_sh.num_after_suffix == 2209
    assert res_sh.num_after_unique == 58
    assert res_sh.num_chains == 19


def test_sharded_mesh_refactors_when_seq_axis_mismatched():
    # k=6 does not divide the default (4, 2) factorization of 8 devices;
    # rotation_blocks_sharded must pick a compatible mesh on its own
    encoded = _synthetic_circular_set(k=6, n=160, seed=3)
    from csa_jax.index import engine

    ref = engine.rotation_blocks_jax(encoded)
    mesh = sharded.make_mesh(8, (4, 2))
    shr = sharded.rotation_blocks_sharded(encoded, mesh=mesh)
    assert shr is not None
    np.testing.assert_array_equal(shr.unique, ref.unique)


def test_sharded_uses_all_eight_devices():
    assert len(jax.devices()) == 8
    mesh = sharded.make_mesh()
    assert mesh.size == 8


def test_explicit_mesh_shape_through_analyze():
    """--mesh plumbing: pipeline.analyze(mesh_shape=) builds the requested
    (seq, pos) mesh and still matches the numpy engine exactly."""
    encoded = _synthetic_circular_set(k=4, n=180, seed=11)
    seqs = _FakeSeqs(encoded)
    ref = rot.analyze(seqs, log=io.StringIO(), backend="numpy")
    shr = rot.analyze(
        seqs, log=io.StringIO(), backend="sharded", mesh_shape=(2, 4)
    )
    assert _result_tuple(ref) == _result_tuple(shr)
