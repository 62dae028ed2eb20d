"""Two-thread native DP fill vs the single-thread path.

csa_host.cpp::FillWorker runs the high half of every DP row on a second
host thread in lockstep with the caller; the only cross-thread value is
the per-row prefix-max carry.  Scores and the full walk-order path must
be bit-identical to the single-thread fill (which is itself verified
byte-identical to the reference through the alignment parity suite).
The csa_set_mt_threshold knob forces each path regardless of shape.
"""

import numpy as np
import pytest

from csa_jax import native
from csa_jax.align.progressive import default_top_row

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native lib not built"
)


def _random_fill(rng, R, C, i):
    codes = rng.integers(0, 4, size=R).astype(np.int8)
    raw = rng.integers(0, 5, size=(i, C))
    sv = np.zeros((C, 5), dtype=np.int64)
    for a in range(5):
        sv[:, a] = (raw == a).sum(axis=0)
    top = default_top_row(sv, i)
    return codes, sv, top


@pytest.mark.parametrize(
    "seed,R,C,i",
    [
        (0, 700, 4100, 3),    # just past the C >= 4096 gate
        (1, 900, 5003, 2),    # odd C: exercises the split-point rounding
        (2, 4097, 4096, 9),   # R > C
        (3, 64, 8192, 5),     # short R: per-row sync dominated
    ],
)
def test_mt_fill_matches_single_thread(seed, R, C, i):
    rng = np.random.default_rng(seed)
    codes, sv, top = _random_fill(rng, R, C, i)
    try:
        assert native.set_mt_threshold(1 << 60)  # force single-thread
        s_st, p_st = native.dp_fill_path(codes, sv, i, top, -i)
        assert native.set_mt_threshold(1)  # force two-thread
        s_mt, p_mt = native.dp_fill_path(codes, sv, i, top, -i)
        # run twice: a lockstep race would be schedule-dependent
        s_mt2, p_mt2 = native.dp_fill_path(codes, sv, i, top, -i)
    finally:
        native.set_mt_threshold(0)  # restore default
    assert s_st == s_mt == s_mt2
    assert np.array_equal(p_st, p_mt)
    assert np.array_equal(p_st, p_mt2)


def test_mt_fill_dirs_match_single_thread():
    """The dirs-matrix entry point dispatches through the same core."""
    rng = np.random.default_rng(7)
    codes, sv, top = _random_fill(rng, 1100, 4200, 4)
    try:
        assert native.set_mt_threshold(1 << 60)
        s_st, d_st = native.dp_fill_dirs(codes, sv, 4, top, -4)
        assert native.set_mt_threshold(1)
        s_mt, d_mt = native.dp_fill_dirs(codes, sv, 4, top, -4)
    finally:
        native.set_mt_threshold(0)
    assert s_st == s_mt
    assert np.array_equal(d_st, d_mt)
