"""Batched pairwise NW (dp/nw.py): exact scores vs the native host kernel."""

import numpy as np
import pytest

from csa_jax.dp import nw


@pytest.mark.parametrize("shape", [(3, 40, 55), (2, 100, 100), (2, 131, 62)])
def test_kernel_scores_exact(shape):
    B, la, lb = shape
    rng = np.random.default_rng(la * lb)
    a = rng.integers(0, 4, size=(B, la))
    b = rng.integers(0, 4, size=(B, lb))
    got = nw.pairwise_nw_scores(a, b)
    want = nw.nw_scores_host(a, b)
    assert np.array_equal(got, want)
