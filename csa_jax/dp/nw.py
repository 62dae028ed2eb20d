"""Batched pairwise Needleman-Wunsch scores in plain JAX.

The reference's pairwise DP scoring (``dynamicprogramming.c`` Score()
semantics: match +1, mismatch/indel -1) for a batch of sequence pairs,
used by the rotation-verification oracle.  The DP matrix is never
materialized: a ``lax.scan`` walks the rows of ``a`` carrying one
(B, lb+1) row.  The in-row left-gap chain ``cur[j] = max(m1[j],
cur[j-1] - 1)`` has the closed form

    cur[j] = max_{k<=j} (t[k]) - j,   t[0] = cur[0],  t[k] = m1[k] + k

so each row is a few elementwise ops plus one ``lax.cummax``.  Exact
integer arithmetic: scores equal the native host kernel's
(tests/test_pallas_nw.py).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

ROW_UNROLL = 8  # rows per scan step (amortizes loop-step overhead)


@jax.jit
def _nw_program(a, b):
    """a (B, la), b (B, lb) int32 codes -> (B,) dp[la][lb] scores."""
    B, la = a.shape
    lb = b.shape[1]
    jv = jnp.arange(lb + 1, dtype=jnp.int32)
    prev0 = jnp.broadcast_to(-jv, (B, lb + 1))          # dp[0][j] = -j

    def row(prev, xs):
        ai, i = xs                                      # (B,), dp row index
        sub = jnp.where(b == ai[:, None], 1, -1)
        m1 = jnp.maximum(prev[:, :-1] + sub, prev[:, 1:] - 1)
        t = jnp.concatenate(
            [jnp.broadcast_to(-i, (B, 1)), m1 + jv[None, 1:]], axis=1
        )
        return jax.lax.cummax(t, axis=1) - jv[None, :], None

    rows = jnp.arange(1, la + 1, dtype=jnp.int32)
    last, _ = jax.lax.scan(row, prev0, (a.T, rows), unroll=ROW_UNROLL)
    return last[:, lb]


def pairwise_nw_scores(a_batch: np.ndarray, b_batch: np.ndarray) -> np.ndarray:
    """Global NW score (+1 match / -1 mismatch / -1 gap) per batch pair.

    a_batch: (B, la), b_batch: (B, lb) int codes; codes that differ never
    match, so distinct pad codes on the two sides only ever mismatch.
    """
    a = jnp.asarray(np.asarray(a_batch), jnp.int32)
    b = jnp.asarray(np.asarray(b_batch), jnp.int32)
    return np.asarray(_nw_program(a, b))


def nw_scores_host(a_batch, b_batch):
    """Host reference scores via the native pairwise kernel."""
    from .. import native

    outs = []
    for a, b in zip(a_batch, b_batch):
        outs.append(native.pairwise_nw(np.asarray(a), np.asarray(b)))
    return np.asarray(outs)
