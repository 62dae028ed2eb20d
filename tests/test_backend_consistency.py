"""numpy vs jax rotation-backend consistency.

The fused device program (csa_jax/index/engine.py full_rotation_program)
must produce the same block cascade and the same final rotations as the
exact numpy engine on any input.  Runs on the virtual CPU device mesh
(tests/conftest.py); bench.py exercises the same path on the real chip.
"""

import io
import os

import numpy as np
import pytest

from csa_jax.io.fasta import SequenceSet
from csa_jax.rotation.pipeline import analyze

ALPH = "ACGT"


def _synthetic_set(seed, k, n, mut_frac=0.01):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=n)
    texts = []
    for _ in range(k):
        row = np.roll(base, int(rng.integers(0, n))).copy()
        mut = rng.integers(0, n, size=max(1, int(n * mut_frac)))
        row[mut] = rng.integers(0, 4, size=len(mut))
        texts.append("".join(ALPH[c] for c in row))
    return SequenceSet(
        names=[f"seq_{i:02d}" for i in range(len(texts))], texts=texts
    )


def _run_both(seqs):
    a = analyze(seqs, log=io.StringIO(), backend="numpy")
    b = analyze(seqs, log=io.StringIO(), backend="jax")
    return a, b


@pytest.mark.parametrize("seed,k,n", [(0, 4, 300), (1, 6, 1000), (2, 3, 700)])
def test_backends_agree_small(seed, k, n):
    seqs = _synthetic_set(seed, k, n, mut_frac=0.02)
    a, b = _run_both(seqs)
    assert list(a.rotations) == list(b.rotations)
    assert (a.num_collected, a.num_after_suffix, a.num_after_unique,
            a.num_chains) == (b.num_collected, b.num_after_suffix,
                              b.num_after_unique, b.num_chains)


@pytest.mark.skipif(
    not os.environ.get("CSA_SLOW_TESTS"),
    reason="set CSA_SLOW_TESTS=1 for the plasmid-scale consistency run",
)
def test_backends_agree_plasmid_scale():
    seqs = _synthetic_set(42, 6, 20_000, mut_frac=0.01)
    a, b = _run_both(seqs)
    assert list(a.rotations) == list(b.rotations)


@pytest.mark.skipif(
    not os.environ.get("CSA_SLOW_TESTS"),
    reason="set CSA_SLOW_TESTS=1 for the 8x100kbp sharded parity run",
)
def test_sharded_agrees_at_100kbp_scale():
    """Numpy vs sharded parity on a synthetic
    8 x 100 kbp circular set over the 8-device CPU mesh."""
    seqs = _synthetic_set(17, 8, 100_000, mut_frac=0.005)
    a = analyze(seqs, log=io.StringIO(), backend="numpy")
    c = analyze(seqs, log=io.StringIO(), backend="sharded")
    assert list(a.rotations) == list(c.rotations)
    assert (a.num_collected, a.num_after_suffix, a.num_after_unique,
            a.num_chains) == (c.num_collected, c.num_after_suffix,
                              c.num_after_unique, c.num_chains)


def test_backends_agree_on_real_set(fixtures_dir):
    from csa_jax.io.fasta import load_fasta

    seqs = load_fasta(fixtures_dir / "Primates.txt", log=io.StringIO())
    a, b = _run_both(seqs)
    assert list(a.rotations) == list(b.rotations)
