"""Distributed block-bitonic sort: exact stable-argsort parity.

The merge-split network must reproduce XLA's stable sort bit for bit at
every mesh size, including the adversarial distributions a suffix-array
engine produces (heavy ties from repetitive DNA, pre-sorted runs).
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from csa_jax.parallel import dsort


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("x",))


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize(
    "dist",
    ["uniform", "ties", "presorted", "negative", "reverse"],
)
def test_sharded_argsort_exact(n_dev, dist):
    rng = np.random.default_rng(hash((n_dev, dist)) % 2**31)
    n = 8 * 4096
    if dist == "uniform":
        v = rng.integers(0, 1 << 28, size=n, dtype=np.int32)
    elif dist == "ties":
        v = rng.integers(0, 7, size=n, dtype=np.int32)
    elif dist == "presorted":
        v = np.sort(rng.integers(0, 500, size=n, dtype=np.int32))
    elif dist == "negative":
        v = rng.integers(-(2**31), 2**31 - 1, size=n, dtype=np.int32)
    else:
        v = np.sort(rng.integers(0, 500, size=n, dtype=np.int32))[::-1].copy()
    vals, order = dsort.sharded_argsort(v, _mesh(n_dev))
    want = np.argsort(v, kind="stable")
    np.testing.assert_array_equal(np.asarray(order), want)
    np.testing.assert_array_equal(np.asarray(vals), v[want])


def test_non_power_of_two_rejected():
    import jax.numpy as jnp  # noqa: F401

    if len(jax.devices()) < 3:
        pytest.skip("needs >= 3 devices")
    with pytest.raises(ValueError):
        dsort.sharded_sort_program(
            Mesh(np.asarray(jax.devices()[:3]), ("x",)), "x"
        )
