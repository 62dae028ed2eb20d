"""Native C++ rotation engine vs the numpy exactness twin.

The native engine (csa_host.cpp::csa_rotation_analyze) must reproduce the
numpy cyclic suffix-array engine (csa_jax/index/cyclic.py) bit for bit:
collected block intervals, suffix filter, uniqueness, and first-occurrence
positions — including degenerate periodic inputs (duplicate rotations,
homopolymers) that the reference tree handles via leaf sharing
(gencycsuffixtrees.c:484-496).
"""

import io

import numpy as np
import pytest

from csa_jax import native
from csa_jax.index import cyclic
from csa_jax.io import fasta as fio

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native lib unavailable"
)


def _numpy_reference(encoded):
    index = cyclic.build_rotation_index(encoded)
    blocks = cyclic.collect_blocks(index)
    keep = cyclic.remove_suffix_blocks(blocks)
    kept = cyclic.BlockSet(
        blocks.index, blocks.start[keep], blocks.end[keep], blocks.depth[keep]
    )
    unique, positions = kept.positions_if_unique()
    return blocks, keep, unique, positions


def _check(encoded):
    nat = native.rotation_analyze(encoded)
    blocks, keep, unique, positions = _numpy_reference(encoded)
    assert np.array_equal(nat.start, blocks.start)
    assert np.array_equal(nat.end, blocks.end)
    assert np.array_equal(nat.depth, blocks.depth)
    assert np.array_equal(nat.keep_suffix, keep)
    assert np.array_equal(nat.unique[nat.keep_suffix], unique)
    assert np.array_equal(
        nat.positions[nat.keep_suffix][unique], positions[unique]
    )


@pytest.mark.parametrize("seed", range(6))
def test_random_sets_match_numpy(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, 7))
    base = rng.integers(0, 4, size=int(rng.integers(40, 400)), dtype=np.int8)
    encoded = []
    for _ in range(k):
        rot = int(rng.integers(0, len(base)))
        row = np.roll(base, rot).copy()
        for _ in range(int(rng.integers(0, 8))):
            row[int(rng.integers(0, len(row)))] = int(rng.integers(0, 4))
        encoded.append(row)
    _check(encoded)


def test_degenerate_periodic_and_homopolymer():
    # duplicate rotations within one sequence (period 2), homopolymers,
    # mixed lengths, and the 5th code (normalized '-')
    encoded = [
        np.array([0, 1] * 12, dtype=np.int8),
        np.array([0] * 20, dtype=np.int8),
        np.array([0, 1, 0, 1, 2, 0, 1], dtype=np.int8),
        np.array([4, 0, 1, 0, 1, 4, 2], dtype=np.int8),
    ]
    _check(encoded)


def test_tiny_inputs():
    _check([np.array([0, 1], dtype=np.int8), np.array([1, 0], dtype=np.int8)])
    _check([np.array([2], dtype=np.int8), np.array([2, 2], dtype=np.int8)])


def test_primates_pipeline_rotations_native(fixtures_dir):
    """Full analyze(backend='native') bit-identical rotations on Primates."""
    from csa_jax.rotation import pipeline as rot

    seqs = fio.load_fasta(str(fixtures_dir / "Primates.txt"), log=io.StringIO())
    res_nat = rot.analyze(seqs, log=io.StringIO(), backend="native")
    res_np = rot.analyze(seqs, log=io.StringIO(), backend="numpy")
    assert np.array_equal(res_nat.rotations, res_np.rotations)
    assert res_nat.num_collected == res_np.num_collected
    assert res_nat.num_after_suffix == res_np.num_after_suffix
    assert res_nat.num_after_unique == res_np.num_after_unique
    assert res_nat.num_chains == res_np.num_chains
