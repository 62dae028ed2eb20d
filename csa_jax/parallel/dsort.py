"""Shard-local distributed sort (block-bitonic merge-split).

Why this exists: XLA's SPMD partitioner handles
``lax.sort`` along a SHARDED dimension by replicating — every device
all-gathers the full operand and sorts all of it, so per-device sort
work does not shrink with the mesh and the virtual-mesh walls of the
sharded rotation backend GROW ~linearly in device count (measured:
1-D argsort of 800k int32, 265 ms at 1 device -> 1091 ms at 8 timeshared
virtual devices; the same growth dominates the 3.35 s -> 15.0 s
``sharded_scaling`` curve of BENCH_r03).  The scalable alternative is a
shard-LOCAL sort plus a collective merge, which this module provides:

* each shard sorts its local block once (one ``S log S`` ``lax.sort``);
* the D sorted blocks are merged by a **bitonic merge-split network**:
  ``O(log^2 D)`` stages, each exchanging whole blocks between a static
  device pairing (``ppermute``) and keeping the lower/upper half of the
  pairwise merge.  Merge-split on pre-sorted blocks driven by any
  sorting network yields a globally sorted sequence (0-1 principle
  lifted to blocks), so the result is EXACT — no sampling, no load
  imbalance, fixed message sizes;
* each pairwise merge is a true O(S) interleave (two vectorized
  ``searchsorted`` rank computations + scatters), NOT a 2S re-sort —
  keys are unique, so ranks are collision-free.

Per-device cost: ``S log S`` once + ``log D (log D+1)/2`` linear merge
stages + ``S``-element neighbor traffic per stage, vs the partitioner's
replicated ``N log N`` on EVERY device — the per-device compute shrinks
``~D/log^2 D``-fold at scale, and the whole-block exchanges ride
the device interconnect.

Keys are single int64 values that the caller makes UNIQUE (pack the
original index into the low bits — ``sharded_argsort`` does this), which
makes the result bit-identical to XLA's stable sort
(tests/test_dsort.py: unique, heavy-tie and pre-sorted distributions at
every mesh size).  D must be a power of two (mesh sizes here and on
pods are); callers fall back to the XLA sort otherwise.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from jax import shard_map as _shard_map

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_PROGRAMS: dict = {}


def _merge_split_net(num_dev: int):
    """Bitonic network stages for ``num_dev`` (power of two) blocks.

    Yields (partner_permutation, keep_low_per_device) per stage.
    """
    m = num_dev.bit_length() - 1
    stages = []
    for kk in range(1, m + 1):
        for j in reversed(range(kk)):
            bit = 1 << j
            perm = [(s, s ^ bit) for s in range(num_dev)]
            keep_low = []
            for s in range(num_dev):
                partner = s ^ bit
                ascending = ((s >> kk) & 1) == 0
                keep_low.append((s < partner) == ascending)
            stages.append((perm, np.asarray(keep_low)))
    return stages


def _merge_halves(a, b, keep_low):
    """Lower or upper half of the merge of two sorted UNIQUE arrays.

    Ranks via searchsorted (collision-free for unique keys): element
    a[i] lands at i + |{b < a[i]}| in the merged order.  O(S log S)
    comparisons, fully vectorized — no 2S re-sort.
    """
    S = a.shape[0]
    ra = jnp.arange(S, dtype=jnp.int32) + jnp.searchsorted(
        b, a, side="left"
    ).astype(jnp.int32)
    rb = jnp.arange(S, dtype=jnp.int32) + jnp.searchsorted(
        a, b, side="right"
    ).astype(jnp.int32)
    sentinel = jnp.int64(np.iinfo(np.int64).max)
    lo = jnp.where(keep_low, 0, S)
    # out-of-half ranks are remapped to index S: positively out of
    # bounds, so mode="drop" discards them (negative indices would WRAP
    # under JAX's numpy indexing and clobber the other half)
    ia = ra - lo
    ia = jnp.where((ia >= 0) & (ia < S), ia, S)
    ib = rb - lo
    ib = jnp.where((ib >= 0) & (ib < S), ib, S)
    ha = jnp.full(S, sentinel).at[ia].set(a, mode="drop")
    hb = jnp.full(S, sentinel).at[ib].set(b, mode="drop")
    return jnp.minimum(ha, hb)


def _merge_halves_pair(ka, pa, kb, pb, keep_low, a_first):
    """Merge-split of two sorted (key, payload) blocks; keys MAY tie.

    Both exchange partners compute this merge independently (one keeps
    the low half, the other the high half), so the tie ORDER must be
    decided identically on both sides — NOT "my block first": ``a_first``
    says whether the local block precedes the partner's on ties (lower
    device index wins).  With that, the merge ranks (first block's equal
    elements before the second's) form a bijection onto 0..2S-1 even
    with duplicate keys, and the payloads ride the same indices.
    """
    S = ka.shape[0]
    lo_a = jnp.searchsorted(kb, ka, side="left").astype(jnp.int32)
    hi_a = jnp.searchsorted(kb, ka, side="right").astype(jnp.int32)
    lo_b = jnp.searchsorted(ka, kb, side="left").astype(jnp.int32)
    hi_b = jnp.searchsorted(ka, kb, side="right").astype(jnp.int32)
    ra = jnp.arange(S, dtype=jnp.int32) + jnp.where(a_first, lo_a, hi_a)
    rb = jnp.arange(S, dtype=jnp.int32) + jnp.where(a_first, hi_b, lo_b)
    lo = jnp.where(keep_low, 0, S)
    ia = ra - lo
    ia = jnp.where((ia >= 0) & (ia < S), ia, S)
    ib = rb - lo
    ib = jnp.where((ib >= 0) & (ib < S), ib, S)
    ksent = jnp.int64(np.iinfo(np.int64).max)
    hk = jnp.full(S, ksent).at[ia].set(ka, mode="drop")
    hk = jnp.minimum(hk, jnp.full(S, ksent).at[ib].set(kb, mode="drop"))
    hp = jnp.zeros(S, pa.dtype).at[ia].set(pa, mode="drop")
    hp = hp.at[ib].set(pb, mode="drop")
    return hk, hp


def net_sort_pairs(u, p, axis: str, num_dev: int):
    """Distributed (key int64, payload) sort, callable INSIDE a
    ``shard_map`` body whose mesh axis ``axis`` has ``num_dev`` (a power
    of two) devices.  ``u``/``p`` are the local shards; returns the
    local shards of the globally key-sorted pairs.  Keys may tie (the
    pairwise merges are stable); tie ORDER across blocks is
    deterministic but not the global stable order — callers that need
    exact stability must make keys unique.
    """
    u, p = jax.lax.sort((u, p), num_keys=1, is_stable=True)
    if num_dev == 1:
        return u, p
    me = jax.lax.axis_index(axis)
    m = num_dev.bit_length() - 1
    stages = _merge_split_net(num_dev)
    bits = []
    for kk in range(1, m + 1):
        for j in reversed(range(kk)):
            bits.append(1 << j)
    for (perm, keep_low_np), bit in zip(stages, bits):
        tu = jax.lax.ppermute(u, axis, perm)
        tp = jax.lax.ppermute(p, axis, perm)
        keep_low = jnp.asarray(keep_low_np)[me]
        a_first = (me & bit) == 0  # lower-indexed partner's ties first
        u, p = _merge_halves_pair(u, p, tu, tp, keep_low, a_first)
    return u, p


def sharded_sort_program(mesh: Mesh, axis: str):
    """Build (and cache) the distributed sort of unique int64 keys over
    ``mesh[axis]``; input/output sharded ``P(axis)``."""
    D = int(np.prod(mesh.devices.shape))
    key = (id(mesh), axis)
    prog = _PROGRAMS.get(key)
    if prog is not None:
        return prog
    if D & (D - 1):
        raise ValueError("device count must be a power of two")
    stages = _merge_split_net(D)

    def body(u):
        cur = jax.lax.sort(u)
        if D == 1:
            return cur
        me = jax.lax.axis_index(axis)
        for perm, keep_low_np in stages:
            theirs = jax.lax.ppermute(cur, axis, perm)
            keep_low = jnp.asarray(keep_low_np)[me]
            cur = _merge_halves(cur, theirs, keep_low)
        return cur

    prog = jax.jit(
        _shard_map(
            body, mesh=mesh, in_specs=P(axis), out_specs=P(axis),
        )
    )
    _PROGRAMS[key] = prog
    return prog


def sharded_argsort(values: np.ndarray, mesh: Mesh, axis: str = "x"):
    """Distributed stable argsort: returns (sorted_values, order).

    Equivalent to ``lax.sort((values, iota), num_keys=1, is_stable=True)``
    — the idiom the index engine's sort sites use — but with shard-local
    sorts and the bitonic block merge instead of the partitioner's
    replicated sort.  int32 values are packed with their index into one
    unique int64 key (value in the high 32 bits), so lexicographic
    (value, index) order == the stable sort order.
    """
    n = values.shape[0]
    g = np.arange(n, dtype=np.int64)
    # signed packing: u = v * 2^32 + g (low 32 bits of v<<32 are zero, g
    # < 2^32), so int64 ordering == (value, index) lexicographic for the
    # full signed int32 range
    u = (np.asarray(values, np.int64) << 32) | g
    sh = NamedSharding(mesh, P(axis))
    # int64 keys need the x64 context (the library default stays 32-bit)
    with jax.enable_x64():
        us = jax.device_put(jnp.asarray(u), sh)
        su = np.asarray(sharded_sort_program(mesh, axis)(us))
    order = (su & 0xFFFFFFFF).astype(np.int32)
    vals = (su >> 32).astype(np.int32)
    return vals, order
