"""Seeded synthetic circular sequence sets for benchmarks and smoke runs.

:func:`mbp_set` is the BASELINE.md 8 x 1 Mbp configuration: one random
base genome, ``k`` randomly rotated copies, each with ``n // 200`` point
mutations.  It quacks like :class:`csa_jax.io.fasta.SequenceSet` as far
as ``rotation.pipeline.analyze`` needs.
"""

from __future__ import annotations

import numpy as np


class _EncodedSet:
    def __init__(self, encoded, names):
        self._encoded = encoded
        self.names = names
        self.sizes = np.array([len(e) for e in encoded], dtype=np.int64)

    def encoded_all(self):
        return self._encoded


def mbp_set(n: int = 1_000_000, k: int = 8, seed: int = 7):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=n, dtype=np.int64)
    enc = []
    for _ in range(k):
        row = np.roll(base, int(rng.integers(0, n))).copy()
        idxs = rng.integers(0, n, size=n // 200)
        row[idxs] = rng.integers(0, 4, size=n // 200)
        enc.append(row)
    return _EncodedSet(enc, [f"s{i}" for i in range(k)])
