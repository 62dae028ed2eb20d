"""Native DeleteGappedColumns (csa_host.cpp::csa_dgc) vs the numpy twin.

The numpy implementation in csa_jax/align/progressive.py is the verified
exactness reference (byte-identical alignments vs the compiled reference
CSA on Primates/Mammals/Set3); the native kernel must match it bit for
bit on arbitrary gapped profiles.
"""

import numpy as np
import pytest

from csa_jax import native
from csa_jax.align import progressive


def _random_profile(rng, numseqs, consize, gap_frac):
    """Random aligned strings + consistent scorevector."""
    strings = []
    for _ in range(numseqs):
        s = rng.integers(0, 4, size=consize).astype(np.int8)
        gaps = rng.random(consize) < gap_frac
        s[gaps] = progressive.GAP
        strings.append(s)
    sv = np.zeros((consize, 5), dtype=np.int64)
    for s in strings:
        np.add.at(sv, (np.arange(consize), s.astype(np.int64)), 1)
    return strings, sv


@pytest.mark.skipif(not native.available(), reason="native lib not built")
@pytest.mark.parametrize("seed", range(8))
def test_dgc_native_matches_numpy(seed):
    rng = np.random.default_rng(seed)
    numseqs = int(rng.integers(2, 9))
    consize = int(rng.integers(4, 120))
    gap_frac = float(rng.uniform(0.15, 0.6))
    strings, sv = _random_profile(rng, numseqs, consize, gap_frac)
    usable = list(rng.permutation(numseqs))
    maxnongaps = int(rng.integers(1, numseqs + 1))

    s_np = [s.copy() for s in strings]
    sv_np = sv.copy()
    # arm the trace hook to force the numpy path
    progressive.SHIFT_TRACE = []
    try:
        n_np = progressive.delete_gapped_columns(
            usable, s_np, numseqs, sv_np, consize, maxnongaps
        )
    finally:
        progressive.SHIFT_TRACE = None

    s_nat = [s.copy() for s in strings]
    sv_nat = sv.copy()
    n_nat = native.dgc(usable, s_nat, numseqs, sv_nat, consize, maxnongaps)

    assert n_nat == n_np
    assert (sv_nat[:n_np] == sv_np[:n_np]).all()
    for a, b in zip(s_nat, s_np):
        assert (a[:n_np] == b[:n_np]).all()
