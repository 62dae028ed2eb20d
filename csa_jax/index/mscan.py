"""Multi-channel prefix scans for the collect front.

The collect cascade (``index/engine.py``) runs ~45 independent prefix
max/min scans per rotation (PSV/NSV thresholds, per-sequence coverage).
These helpers scan all channels of an (M, N) array in one
``jax.lax.cummax`` along axis 1, with the two options the consumers
need: ``reverse`` (suffix scans) and a fused reduction over channels.
Exact integer arithmetic (tests/test_mscan.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def multi_cummax(chans, *, reverse: bool = False,
                 min_over_channels: bool = False):
    """Per-channel inclusive prefix max of ``chans`` (M, N) int32 along
    axis 1.  ``reverse`` scans right-to-left (suffix max);
    ``min_over_channels`` returns the (N,) elementwise minimum over the
    M scanned channels instead of the full (M, N) result."""
    chans = jnp.asarray(chans, jnp.int32)
    out = jax.lax.cummax(chans, axis=1, reverse=reverse)
    if min_over_channels:
        out = jnp.min(out, axis=0)
    return out


def multi_cummin(chans, *, reverse: bool = False,
                 max_over_channels: bool = False):
    """Per-channel inclusive prefix min; ``max_over_channels`` fuses the
    (N,) elementwise maximum over channels."""
    chans = jnp.asarray(chans, jnp.int32)
    out = jax.lax.cummin(chans, axis=1, reverse=reverse)
    if max_over_channels:
        out = jnp.max(out, axis=0)
    return out
