"""JAX (device) backend of the cyclic suffix-array engine.

Device-side replacement for :mod:`csa_jax.index.cyclic`'s heavy stages,
re-expressed as static-shaped XLA programs:

* prefix-doubling rank sort over all rotations (jnp.argsort + gathers);
* capped adjacent LCPs by vectorized binary descent over the rank levels;
* PSV/NSV + canonical-representative selection via range-min/argmin sparse
  tables (static log-depth loops);
* per-sequence coverage tests via cumulative sums;
* "deepest all-sequences node" selection via scatter-OR of all-seq child
  marks into canonical interval representatives.

The (tiny) collected block set is handed back to the host where the exact
numpy filters (:func:`csa_jax.index.cyclic.remove_suffix_blocks`,
uniqueness, chaining) finish the pipeline.

Padding layout: sequences are padded to a common ``n_max`` (bucketed to
limit recompiles); padded rotation slots get unique sentinel ranks larger
than any real rank, so they sort last, never tie, and never join an
lcp-interval.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from . import cyclic


def _bucket(n: int, quantum: int = 1024) -> int:
    return ((n + quantum - 1) // quantum) * quantum


# Cyclic prefix-doubling starts from a PACKED window: the level-0 rank is
# the base-5 encoding of the first PACK_W cyclic chars (5**PACK_W must
# fit int32, so PACK_W <= 13), resolving PACK_W chars with ZERO sorts;
# level t covers PACK_W << t chars.  Sub-PACK_W granularity (LCP tail,
# short fingerprints) reads the code array directly.  Configurable via
# config.RunConfig.pack_w (the CLI's --pack-w flag installs the config
# before this module is first imported) or the CSA_PACK_W env
# override; frozen at import because it shapes every compiled program.
import os as _os

from ..config import run_config as _run_config

PACK_W = max(
    2,
    min(13, int(_os.environ.get("CSA_PACK_W", 0)
                or _run_config().pack_w)),
)
_ALPHA = 5  # alphabet (ACGT-)
_SENT0 = _ALPHA ** PACK_W  # level-0 pad sentinel base (above all keys)


def _num_levels(n_max: int) -> int:
    """Number of packed cyclic rank levels (PACK_W << (levels-1) >= n_max)."""
    t = 1
    while (PACK_W << (t - 1)) < n_max:
        t += 1
    return t


def _linear_levels(total: int) -> int:
    """Level count for the LINEAR suffix program (plain 1 << t windows)."""
    t = 1
    while (1 << (t - 1)) < total:
        t += 1
    return t


def device_index_program(codes, lengths, *, k: int, n_max: int, levels: int):
    """Core device program.

    codes: (k, n_max) int32 (padding values arbitrary);
    lengths: (k,) int32.
    Returns (rank_levels (levels, N), sa (N,), lcp (N,), dup_flag ()).
    """
    n_total = k * n_max
    g = jnp.arange(n_total, dtype=jnp.int32)
    seq_of = g // n_max
    pos_of = g % n_max
    n_of = jnp.maximum(lengths[seq_of], 1)
    valid = pos_of < n_of
    base = seq_of * n_max

    def adv(gg, off):
        s = gg // n_max
        p = gg % n_max
        nn = jnp.maximum(lengths[s], 1)
        return s * n_max + (p + off) % nn

    big = jnp.int32(n_total)
    cflat = codes.reshape(-1).astype(jnp.int32)
    # level-0 rank: packed base-5 key of the first PACK_W cyclic chars
    # (order-isomorphic to the lexicographic 12-prefix order, equal iff
    # equal) — no sort needed; pad slots get unique sentinels above every
    # real key
    acc = jnp.zeros(n_total, jnp.int32)
    for t in range(PACK_W):
        acc = acc * _ALPHA + cflat[adv(g, jnp.int32(t))]
    rank = jnp.where(valid, acc, jnp.int32(_SENT0) + g)
    rank_levels = [rank]
    order = None
    for t in range(levels - 1):
        rank2 = rank[adv(g, jnp.int32(PACK_W << t))]
        # ONE stable multi-key sort per level (lexicographic on the rank
        # pair); pure int32 — JAX default has x64 disabled, so a combined
        # 64-bit key would truncate
        r1s, r2s, order = jax.lax.sort((rank, rank2, g), num_keys=2, is_stable=True)
        newgrp = jnp.concatenate(
            [
                jnp.zeros(1, jnp.int32),
                ((r1s[1:] != r1s[:-1]) | (r2s[1:] != r2s[:-1])).astype(jnp.int32),
            ]
        )
        dense = jnp.cumsum(newgrp)
        rank = jnp.zeros(n_total, jnp.int32).at[order].set(dense.astype(jnp.int32))
        # keep padding ranks unique and above all real ranks
        rank = jnp.where(valid, rank, big + g)
        rank_levels.append(rank)
    rank_stack = jnp.stack(rank_levels)  # (levels, N)

    final = rank_levels[-1]
    if order is None:  # degenerate levels == 1
        sa = jnp.argsort(final).astype(jnp.int32)
    else:
        # the last level's sort order IS the final rank order (the dense
        # final rank was assigned in that order; ties keep g ascending,
        # exactly like a stable argsort of `final`)
        sa = order.astype(jnp.int32)

    # duplicate-rotation detection (same sequence, identical periodic string)
    fr = final[sa]
    sq = seq_of[sa]
    vd = valid[sa]
    dup_flag = jnp.any((fr[1:] == fr[:-1]) & (sq[1:] == sq[:-1]) & vd[1:])

    # capped LCP of adjacent entries by binary descent over rank levels
    a = sa[:-1]
    b = sa[1:]
    off = jnp.zeros(n_total - 1, dtype=jnp.int32)
    for t in range(levels - 1, -1, -1):
        ga = adv(a, off)
        gb = adv(b, off)
        eq = rank_stack[t][ga] == rank_stack[t][gb]
        off = jnp.where(eq, off + jnp.int32(PACK_W << t), off)
    # sub-PACK_W tail: after the window-12 check, <12 chars remain
    # undetermined; compare chars sequentially with a stop flag (a +1
    # step past a mismatch could otherwise re-match by accident)
    still = jnp.ones(n_total - 1, dtype=bool)
    for _ in range(PACK_W - 1):
        eqc = cflat[adv(a, off)] == cflat[adv(b, off)]
        still = still & eqc
        off = jnp.where(still, off + 1, off)
    cap = jnp.minimum(n_of[a], n_of[b])
    raw = jnp.concatenate([jnp.zeros(1, jnp.int32), off.astype(jnp.int32)])
    lcp = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.minimum(off, cap).astype(jnp.int32)]
    )
    return rank_stack, sa, lcp, raw, dup_flag


_build_device_index = functools.partial(
    jax.jit, static_argnames=("k", "n_max", "levels")
)(device_index_program)


def collect_program(sa, lcp, lengths, *, k: int, n_max: int, levels: int):
    """Enumerate collected (deepest all-seq) nodes on device.

    Returns (collected mask over boundaries, start, end) arrays of length N.
    """
    n_total = k * n_max
    seq_sorted = (sa // n_max).astype(jnp.int32)
    pos_sorted = (sa % n_max).astype(jnp.int32)

    # ---- sparse table: range-min VALUES only.  The leftmost-argmin
    # table of the round-1 design doubled the biggest allocation
    # (2 x tlevels x N int32 was the device-memory high-water mark at
    # Mbp scale); argmins are instead derived from the value
    # table by a threshold binary descent (see range_argmin below) ----
    tlevels = max(1, int(np.ceil(np.log2(max(n_total, 2)))) + 1)
    INF = jnp.int32(np.iinfo(np.int32).max)
    minv = [lcp]
    for t in range(tlevels - 1):
        half = 1 << t
        prev_v = minv[-1]
        shifted_v = jnp.concatenate([prev_v[half:], jnp.full(half, INF, jnp.int32)])
        minv.append(jnp.minimum(prev_v, shifted_v))
    minv_st = jnp.stack(minv)
    minv_flat = minv_st.reshape(-1)  # flattened: 1D gathers beat generic 2D

    idx = jnp.arange(n_total, dtype=jnp.int32)

    # PSV: largest j < i with lcp[j] < lcp[i]; lcp[0] = 0 is the sentinel.
    ln = jnp.zeros(n_total, jnp.int32)
    for t in range(tlevels - 1, -1, -1):
        j = idx - ln - jnp.int32(1 << t)
        ok = j >= 0
        mv = minv_st[t][jnp.maximum(j, 0)]
        grow = ok & (mv >= lcp)
        ln = jnp.where(grow, ln + jnp.int32(1 << t), ln)
    psv = idx - ln - 1  # may be -1

    # NSV: smallest j > i with lcp[j] < lcp[i]
    rn = jnp.zeros(n_total, jnp.int32)
    for t in range(tlevels - 1, -1, -1):
        j = idx + rn + 1
        ok = (j + jnp.int32(1 << t) - 1) <= jnp.int32(n_total - 1)
        mv = minv_st[t][jnp.minimum(j, n_total - 1)]
        grow = ok & (mv >= lcp)
        rn = jnp.where(grow, rn + jnp.int32(1 << t), rn)
    nsv = idx + rn + 1  # may be n_total

    start = jnp.maximum(psv, 0)  # interval start member
    end = nsv - 1  # interval end member (inclusive)

    def range_argmin(lo, hi):
        """leftmost argmin of lcp over [lo, hi], elementwise; lo <= hi.

        Two-phase, value-table only: (1) range min m via the classic
        two-window lookup; (2) leftmost j in [lo, hi] with lcp[j] <= m by
        binary descent — advance pos past every power-of-two window whose
        min stays > m.  Since m IS the range min, the landing position is
        exactly the leftmost argmin.
        """
        span = jnp.maximum(hi - lo + 1, 1)
        # exact floor(log2(span)) via integer comparisons; the two windows
        # [lo, lo+2^tt) and [hi-2^tt+1, hi] cover since 2^(tt+1) > span
        tt = jnp.zeros(span.shape, jnp.int32)
        for t in range(1, tlevels):
            tt = jnp.where(span >= jnp.int32(1 << t), jnp.int32(t), tt)
        pow_tt = jnp.left_shift(jnp.int32(1), tt)
        base = tt * jnp.int32(n_total)
        lv = minv_flat[base + lo]
        rstart = hi - pow_tt + 1
        rv = minv_flat[base + rstart]
        m = jnp.minimum(lv, rv)
        pos = lo
        for t in range(tlevels - 1, -1, -1):
            j_end = pos + jnp.int32((1 << t) - 1)
            ok = j_end <= hi
            wv = minv_st[t][jnp.minimum(pos, n_total - 1)]
            adv = ok & (wv > m)
            pos = jnp.where(adv, pos + jnp.int32(1 << t), pos)
        return pos

    # canonical boundary of the interval of boundary i: leftmost minimum in
    # [start+1, end] (non-empty whenever lcp[i] >= 1: i itself is inside)
    has_node = lcp >= 1
    canon = jnp.where(
        has_node, range_argmin(jnp.minimum(start + 1, n_total - 1), jnp.maximum(end, 0)), idx
    )
    is_canon = has_node & (canon == idx)

    # ---- all-sequences coverage of each boundary's interval ----
    # one fused (N+1, k) prefix-count instead of k separate cumsum passes
    one_hot = (
        seq_sorted[:, None] == jnp.arange(k, dtype=jnp.int32)[None, :]
    ).astype(jnp.int32)
    pref = jnp.concatenate(
        [jnp.zeros((1, k), jnp.int32), jnp.cumsum(one_hot, axis=0)]
    )
    cnt = pref[end + 1] - pref[start]  # (N, k) via two row-gathers
    allseq = jnp.all(cnt >= 1, axis=1) & has_node

    # ---- mark parents that have an all-seq child ----
    lcp_ext = jnp.concatenate([lcp, jnp.zeros(1, jnp.int32)])
    left_d = lcp_ext[start]
    right_d = lcp_ext[jnp.minimum(end + 1, n_total)]
    parent_bound = jnp.where(left_d >= right_d, start, end + 1)
    parent_d = jnp.maximum(left_d, right_d)
    has_parent = is_canon & allseq & (parent_d >= 1)
    pb = jnp.where(has_parent, parent_bound, 0)
    # canonical boundary of the parent's interval
    p_start = jnp.maximum(psv[pb], 0)
    p_end = nsv[pb] - 1
    p_canon = range_argmin(
        jnp.minimum(p_start + 1, n_total - 1), jnp.maximum(p_end, 0)
    )
    haschild = jnp.zeros(n_total, dtype=bool).at[
        jnp.where(has_parent, p_canon, n_total - 1)
    ].max(has_parent)
    # note: scatter target n_total-1 for inactive lanes writes False (no-op)

    collected = is_canon & allseq & ~haschild
    return collected, start, end, pos_sorted, seq_sorted


_collect_device = functools.partial(
    jax.jit, static_argnames=("k", "n_max", "levels")
)(collect_program)


def linear_index_program(s, valid_n, *, total: int, levels: int):
    """Prefix-doubling suffix sort of ONE linear string (device twin of
    :func:`csa_jax.align.anchors.build_linear_index`'s host loop).

    ``s``: (total,) int32, real values in ``[0, valid_n)`` (smaller values
    sort first — the caller encodes separators below character codes);
    pad slots get unique sentinel ranks above every real rank.  Returns
    ``(sa, lcp)`` where ``sa`` is the full sorted order (pads last) and
    ``lcp[i]`` is the LCP of sorted entries ``i-1``/``i`` (``lcp[0]=0``).

    Shifted ranks follow the linear convention ``rank2 = -1`` past the end
    of the string (matching numpy's host twin), NOT the cyclic wrap of
    :func:`device_index_program`.
    """
    g = jnp.arange(total, dtype=jnp.int32)
    big = jnp.int32(total)
    real = g < valid_n
    rank = jnp.where(real, s.astype(jnp.int32), big + g)
    rank_levels = [rank]
    order = None
    for t in range(levels - 1):
        pos2 = g + jnp.int32(1 << t)
        rank2 = jnp.where(
            real & (pos2 < valid_n),
            rank[jnp.minimum(pos2, total - 1)],
            jnp.int32(-1),
        )
        r1s, r2s, order = jax.lax.sort((rank, rank2, g), num_keys=2, is_stable=True)
        newgrp = jnp.concatenate(
            [
                jnp.zeros(1, jnp.int32),
                ((r1s[1:] != r1s[:-1]) | (r2s[1:] != r2s[:-1])).astype(jnp.int32),
            ]
        )
        dense = jnp.cumsum(newgrp)
        rank = jnp.zeros(total, jnp.int32).at[order].set(dense.astype(jnp.int32))
        rank = jnp.where(real, rank, big + g)
        rank_levels.append(rank)
    stack = jnp.stack(rank_levels)
    if order is None:
        sa = jnp.argsort(rank).astype(jnp.int32)
    else:
        sa = order.astype(jnp.int32)

    a = sa[:-1]
    b = sa[1:]
    off = jnp.zeros(total - 1, dtype=jnp.int32)
    for t in range(levels - 1, -1, -1):
        ga = a + off
        gb = b + off
        ok = (ga < valid_n) & (gb < valid_n)
        eq = ok & (
            stack[t][jnp.minimum(ga, total - 1)]
            == stack[t][jnp.minimum(gb, total - 1)]
        )
        off = jnp.where(eq, off + jnp.int32(1 << t), off)
    lcp = jnp.concatenate([jnp.zeros(1, jnp.int32), off])
    return sa, lcp


_linear_index_device = functools.partial(
    jax.jit, static_argnames=("total", "levels")
)(linear_index_program)


@functools.partial(jax.jit, static_argnames=("total", "levels"))
def _linear_index_device_et(s, valid_n, *, total: int, levels: int):
    """Early-terminating twin of :func:`linear_index_program`: the
    doubling levels run under an on-device ``while_loop`` that stops
    when every group is a singleton (real inputs resolve in ~6-8 levels
    where the static program burns ~18), rank snapshots go into a
    (levels, total) stack whose unused rows hold the final all-unique
    rank — their LCP-descent steps are exact no-ops (``rank[a+off] ==
    rank[b+off]`` needs ``a == b`` under unique ranks).  Used for the
    small-input regime (the alignment anchors at mtDNA scale), where the
    unrolled program's dead levels dominate the wall."""
    g = jnp.arange(total, dtype=jnp.int32)
    big = jnp.int32(total)
    real = g < valid_n
    rank0 = jnp.where(real, s.astype(jnp.int32), big + g)
    stack0 = jnp.zeros((levels, total), jnp.int32).at[0].set(rank0)

    def cond(state):
        _r, _o, t, tied, _st = state
        return tied & (t < levels - 1)

    def body(state):
        rank, _o, t, _tied, stack = state
        pos2 = g + (jnp.int32(1) << t)
        rank2 = jnp.where(
            real & (pos2 < valid_n),
            rank[jnp.minimum(pos2, total - 1)],
            jnp.int32(-1),
        )
        r1s, r2s, order = jax.lax.sort(
            (rank, rank2, g), num_keys=2, is_stable=True
        )
        samegrp = (r1s[1:] == r1s[:-1]) & (r2s[1:] == r2s[:-1])
        tied = jnp.any(samegrp)
        newgrp = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), (~samegrp).astype(jnp.int32)]
        )
        dense = jnp.cumsum(newgrp)
        rank = (
            jnp.zeros(total, jnp.int32)
            .at[order]
            .set(dense.astype(jnp.int32))
        )
        rank = jnp.where(real, rank, big + g)
        stack = jax.lax.dynamic_update_slice_in_dim(
            stack, rank[None, :], t + 1, axis=0
        )
        return (rank, order, t + 1, tied, stack)

    order0 = jax.lax.sort((rank0, g), num_keys=1, is_stable=True)[1]
    rank, order, L, _tied, stack = jax.lax.while_loop(
        cond, body, (rank0, order0, jnp.int32(0), jnp.bool_(True), stack0)
    )
    rows = jnp.arange(levels, dtype=jnp.int32)[:, None]
    stack = jnp.where(rows > L, rank[None, :], stack)
    sa = order.astype(jnp.int32)

    a = sa[:-1]
    b = sa[1:]
    off = jnp.zeros(total - 1, dtype=jnp.int32)
    for t in range(levels - 1, -1, -1):
        ga = a + off
        gb = b + off
        ok = (ga < valid_n) & (gb < valid_n)
        eq = ok & (
            stack[t][jnp.minimum(ga, total - 1)]
            == stack[t][jnp.minimum(gb, total - 1)]
        )
        off = jnp.where(eq, off + jnp.int32(1 << t), off)
    lcp = jnp.concatenate([jnp.zeros(1, jnp.int32), off])
    return sa, lcp


def linear_suffix_order(s_real: np.ndarray):
    """Host wrapper: pad, run the device linear sort, return (sa, lcp)
    over the real entries only (sorted order, pads stripped)."""
    n = len(s_real)
    total = _bucket(max(n, 8))
    levels = _linear_levels(total)
    s = np.zeros(total, dtype=np.int32)
    s[:n] = s_real
    # small inputs: the early-terminating while_loop variant skips the
    # ~2/3 dead doubling levels (0.28 s -> ~0.1 s at mtDNA scale); big
    # inputs keep the unrolled program (no (levels, total) stack)
    impl = (
        _linear_index_device_et if total <= FUSED_MAX_CHARS
        else _linear_index_device
    )
    sa, lcp = impl(
        jnp.asarray(s), jnp.int32(n), total=total, levels=levels
    )
    sa = np.asarray(sa).astype(np.int64)
    lcp = np.asarray(lcp).astype(np.int64)
    return sa[:n], lcp[:n]


def build_index_jax(encoded: Sequence[np.ndarray]) -> cyclic.RotationIndex:
    """Build a :class:`cyclic.RotationIndex` using the device engine.

    Falls back to the numpy engine when duplicate rotations are present
    (degenerate periodic inputs; see docs/PARITY.md).
    """
    k = len(encoded)
    sizes = np.array([len(e) for e in encoded], dtype=np.int32)
    n_max = _bucket(int(sizes.max()))
    levels = _num_levels(n_max)
    codes = np.zeros((k, n_max), dtype=np.int32)
    for i, e in enumerate(encoded):
        codes[i, : len(e)] = e
    rank_stack, sa, lcp, raw, dup = _build_device_index(
        jnp.asarray(codes), jnp.asarray(sizes), k=k, n_max=n_max, levels=levels
    )
    if bool(dup):
        return cyclic.build_rotation_index(encoded)
    return _index_from_device(rank_stack, sa, lcp, raw, sizes, k, n_max,
                              codes=jnp.asarray(codes))


def collect_blocks_jax(
    encoded: Sequence[np.ndarray],
) -> Tuple[cyclic.RotationIndex, cyclic.BlockSet]:
    """Device-accelerated index build + block collection."""
    k = len(encoded)
    sizes = np.array([len(e) for e in encoded], dtype=np.int32)
    n_max = _bucket(int(sizes.max()))
    levels = _num_levels(n_max)
    codes = np.zeros((k, n_max), dtype=np.int32)
    for i, e in enumerate(encoded):
        codes[i, : len(e)] = e
    jsizes = jnp.asarray(sizes)
    rank_stack, sa, lcp, raw, dup = _build_device_index(
        jnp.asarray(codes), jsizes, k=k, n_max=n_max, levels=levels
    )
    if bool(dup):
        index = cyclic.build_rotation_index(encoded)
        return index, cyclic.collect_blocks(index)
    collected, start, end, _, _ = _collect_device(
        sa, lcp, jsizes, k=k, n_max=n_max, levels=levels
    )

    index = _index_from_device(rank_stack, sa, lcp, raw, sizes, k, n_max,
                               codes=jnp.asarray(codes))
    mask = np.asarray(collected)
    cstart = np.asarray(start)[mask].astype(np.int64)
    cend = np.asarray(end)[mask].astype(np.int64)
    cdepth = np.asarray(lcp)[mask].astype(np.int64)
    blocks = cyclic.BlockSet(index, cstart, cend, cdepth)
    return index, blocks


MAX_DEPTH_SLOTS = 512  # static bound on distinct block depths (escalated)


def compact_blocks_program(collected, start, end, lcp, *, cap: int):
    """Compact the collected-block mask to a static ``cap``-sized table."""
    nb = jnp.sum(collected).astype(jnp.int32)
    (bidx,) = jnp.nonzero(collected, size=cap, fill_value=0)
    bidx = bidx.astype(jnp.int32)
    valid = jnp.arange(cap, dtype=jnp.int32) < nb
    bstart = jnp.where(valid, start[bidx], 0)
    bend = jnp.where(valid, end[bidx], 0)
    bdepth = jnp.where(valid, lcp[bidx], 1)  # >=1 keeps log2 well-defined
    return nb, valid, bstart, bend, bdepth


def member_tables_program(sa, lengths, *, k: int, n_max: int):
    """Per-sequence member tables for occurrence queries.

    ``M[s]`` holds, in ascending order, the sorted-order indices of
    sequence ``s``'s real rotation entries (padded with ``n_total``);
    ``Mpos[s]`` holds the rotation start position of each such entry
    (pad slots hold 0).  Both tables are row-shardable over the "seq"
    mesh axis: a shard can answer occurrence-count / first-position
    queries for its own sequences locally (the sharded chain merge
    in :mod:`csa_jax.parallel.sharded` relies on this).
    """
    n_total = k * n_max
    seq_sorted = (sa // n_max).astype(jnp.int32)
    pos_sorted = (sa % n_max).astype(jnp.int32)
    member_valid = pos_sorted < lengths[seq_sorted]
    seq_key = jnp.where(member_valid, seq_sorted, jnp.int32(k))
    ord2 = jnp.argsort(seq_key, stable=True).astype(jnp.int32)
    sorted_seq = seq_key[ord2]
    first_of_seq = jnp.searchsorted(
        sorted_seq, jnp.arange(k, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    col = jnp.arange(n_total, dtype=jnp.int32) - first_of_seq[
        jnp.minimum(sorted_seq, k - 1)
    ]
    flat = jnp.where(
        sorted_seq < k,
        sorted_seq * n_max + col,
        n_total,  # dump slot for pad members
    )
    M = (
        jnp.full(n_total + 1, jnp.int32(n_total), jnp.int32)
        .at[flat]
        .set(ord2)[:n_total]
        .reshape(k, n_max)
    )
    pos_ext = jnp.concatenate([pos_sorted, jnp.zeros(1, jnp.int32)])
    Mpos = pos_ext[M]
    return M, Mpos


def uniqueness_counts(M, Mpos, bstart, bend):
    """Occurrence counts + first positions per (sequence-row, block).

    ``M``/``Mpos`` may be a row shard of the full member tables; returns
    ``cnts (rows, cap)`` and ``first_pos (rows, cap)``.
    """
    rows, n_max = M.shape
    cap = bstart.shape[0]
    q_lo = jnp.broadcast_to(bstart, (rows, cap))
    q_hi = jnp.broadcast_to(bend + 1, (rows, cap))
    lo = jax.vmap(lambda row, q: jnp.searchsorted(row, q, side="left"))(M, q_lo)
    hi = jax.vmap(lambda row, q: jnp.searchsorted(row, q, side="left"))(M, q_hi)
    cnts = hi - lo  # (rows, cap)
    first_pos = Mpos[jnp.arange(rows)[:, None], jnp.minimum(lo, n_max - 1)]
    return cnts, first_pos


def suffix_filter_program(
    sa, lcp, lengths, valid, bstart, bend, bdepth, *, k: int, n_max: int, cap: int, slots: int
):
    """Suffix-containment filter (removeSuffixNodes semantics).

    Drop block i iff some strictly deeper block j has block i's string as
    its length-depth[i] suffix.  Exact via the suffix array itself: the
    length-d suffix of block j starts at rotation q = adv(rep_j, d_j - d);
    block i (depth d) contains that string iff q's sorted position lies in
    i's lcp-interval [bstart_i, bend_i].  Blocks of equal depth have
    disjoint intervals, so a (depth-slot, sorted-position) join decides
    membership with one search per block instead of a cap^2 matrix.

    Returns (keep_suffix (cap,) bool, num_distinct ()).
    """
    n_total = k * n_max

    def adv(gg, off):
        s = gg // n_max
        p = gg % n_max
        nn = jnp.maximum(lengths[s], 1)
        return s * n_max + (p + off) % nn

    BIG = jnp.int32(1 << 30)
    nslots = cap if cap < slots else slots
    uniqd = jnp.unique(
        jnp.where(valid, bdepth, BIG), size=nslots, fill_value=BIG
    )
    num_distinct = jnp.sum(uniqd < BIG).astype(jnp.int32)
    slot_of_block = jnp.searchsorted(uniqd, bdepth).astype(jnp.int32)

    inv_sa = (
        jnp.zeros(n_total, jnp.int32)
        .at[sa]
        .set(jnp.arange(n_total, dtype=jnp.int32))
    )
    rep = sa[bstart]
    dq = uniqd[None, :]  # (1, nslots)
    djm = bdepth[:, None]  # (cap, 1)
    qvalid = valid[:, None] & (dq < BIG) & (djm > dq)
    q_g = adv(rep[:, None], jnp.where(qvalid, djm - dq, 0))
    q_r = inv_sa[q_g]  # (cap, nslots) sorted position of each suffix start
    slot_mat = jnp.broadcast_to(
        jnp.arange(nslots, dtype=jnp.int32)[None, :], (cap, nslots)
    )
    key_slot = jnp.where(qvalid, slot_mat, jnp.int32(nslots)).reshape(-1)
    key_r = jnp.where(qvalid, q_r, jnp.int32(n_total)).reshape(-1)
    ks, rs = jax.lax.sort((key_slot, key_r), num_keys=2)
    seg = jnp.searchsorted(
        ks, jnp.arange(nslots + 1, dtype=jnp.int32)
    ).astype(jnp.int32)

    nq = cap * nslots
    lo0 = seg[slot_of_block]
    hi0 = seg[jnp.minimum(slot_of_block + 1, nslots)]

    def seg_lower_bound(target):
        lo, hi = lo0, hi0
        for _ in range(int(np.ceil(np.log2(nq + 1))) + 1):
            cond = lo < hi
            mid = (lo + hi) >> 1
            v = rs[jnp.clip(mid, 0, nq - 1)]
            less = v < target
            lo = jnp.where(cond & less, mid + 1, lo)
            hi = jnp.where(cond & ~less, mid, hi)
        return lo

    cnt_in = seg_lower_bound(bend + 1) - seg_lower_bound(bstart)
    keep_suffix = valid & (cnt_in == 0)
    return keep_suffix, num_distinct


# ---------------------------------------------------------------------------
# Fast single-device rotation path.
#
# Host-driven pipeline of SMALL jitted stages with per-level scalar syncs
# instead of one fused program.  The design (a) keeps everything on
# device with one small packed transfer, (b) builds the stages from
# sorts, scans and scatters rather than N-sized gathers, and (c)
# terminates the prefix-doubling refinement as soon as every group is a
# singleton (host reads one scalar per level), which for non-repetitive
# genomes ends after 2-3 levels instead of ~18.
#
# Key algorithmic moves vs round 2 (all exact, parity-tested vs numpy):
#
# * packed 12-mer level-0 keys built with STATIC rolls (+ a tiny scatter
#   fixing the <= 11 cyclic-wrap slots per sequence) — no N-sized gathers;
# * group-start ranks (Larsson-Sadakane convention) so a level is one
#   2-key sort + one scatter + one gather;
# * PSV/NSV: boundaries with lcp <= PACK_W via 12 threshold cummax/cummin
#   passes (no gathers); deeper boundaries via a binary descent BOUNDED by
#   the level-0 max group size (their interval cannot outgrow their
#   12-mer group), typically 4-8 levels instead of log2(N) ~ 23;
# * all-sequences coverage via L[e] = min over sequences of the last
#   occurrence at or before e (k cummax passes), so allseq([s,e]) = L[e]>=s;
# * suffix-containment filter via occurrence-END rotations: block i (depth
#   d_i) is a suffix of a deeper block j iff adv(rep_j, d_j - d_i) lies in
#   i's interval, and advancing both sides by d_i turns that into
#   end_rot(j) IN {adv(member, d_i)} — one scatter-max table over rotation
#   ids + one gather, O(total occurrences) instead of the round-2
#   (blocks x depth-slots) join that melted down at 529k blocks;
#   reference semantics: csamsa.c:85-109;
# * uniqueness: collected intervals are all-seq and pairwise disjoint, so
#   "exactly once per sequence" is simply interval width == k;
# * positions via a scatter-min over (block, seq) slots of the expanded
#   interval members (collectPositions, csamsa.c:114-123).
# ---------------------------------------------------------------------------


def _n_of_flat(lengths, k: int, n_max: int):
    """(N,) per-rotation sequence length, built without gathers."""
    return jnp.broadcast_to(
        jnp.maximum(lengths, 1)[:, None], (k, n_max)
    ).reshape(-1)


@functools.partial(jax.jit, static_argnames=("k", "n_max"))
def _pack_keys_program(codes, lengths, *, k: int, n_max: int):
    """Base-5 packed key of the PACK_W-char cyclic window at every
    position: static rolls for the bulk, a tiny gather+scatter for the
    <= PACK_W-1 wrap slots per sequence (and whole short sequences)."""
    c = codes.astype(jnp.int32)
    acc = jnp.zeros((k, n_max), jnp.int32)
    cur = c
    for t in range(PACK_W):
        if t:
            cur = jnp.roll(c, -t, axis=1)
        acc = acc * _ALPHA + cur
    packed = acc.reshape(-1)

    # wrap fix: positions p with p + PACK_W - 1 >= n_s read pad/next-row
    # garbage above; recompute them exactly (k x (PACK_W-1) slots)
    n_s = jnp.maximum(lengths, 1)[:, None]                     # (k, 1)
    j = jnp.arange(PACK_W - 1, dtype=jnp.int32)[None, :]       # (1, 11)
    p = (n_s - (PACK_W - 1) + j) % n_s                         # (k, 11)
    srow = jnp.arange(k, dtype=jnp.int32)[:, None] * n_max
    key = jnp.zeros_like(p)
    cflat = c.reshape(-1)
    for t in range(PACK_W):
        key = key * _ALPHA + cflat[srow + (p + t) % n_s]
    packed = packed.at[(srow + p).reshape(-1)].set(key.reshape(-1))
    return packed


def _group_stats(newgrp, g):
    """start index, size, tied count and max size of boundary-marked
    groups over the sorted axis (all elementwise/scan ops)."""
    n = newgrp.shape[0]
    start_idx = jax.lax.cummax(jnp.where(newgrp, g, 0))
    a = jnp.where(newgrp, g, jnp.int32(n))
    nxt = jnp.concatenate(
        [jax.lax.cummin(a, reverse=True)[1:], jnp.full(1, n, jnp.int32)]
    )
    size = nxt - start_idx
    num_tied = jnp.sum((size > 1).astype(jnp.int32))
    max_group = jnp.max(size)
    return start_idx, num_tied, max_group


@functools.partial(jax.jit, static_argnames=("k", "n_max"))
def _level0_program(packed, lengths, *, k: int, n_max: int):
    """Initial sort by packed key; group-start ranks; tie stats."""
    n_total = k * n_max
    g = jnp.arange(n_total, dtype=jnp.int32)
    pos = g % jnp.int32(n_max)
    n_of = _n_of_flat(lengths, k, n_max)
    valid = pos < n_of
    key = jnp.where(valid, packed, jnp.int32(_SENT0) + g)
    ks, order = jax.lax.sort((key, g), num_keys=1, is_stable=True)
    newgrp = jnp.concatenate(
        [jnp.ones(1, bool), ks[1:] != ks[:-1]]
    )
    start_idx, num_tied, max_group = _group_stats(newgrp, g)
    rank = jnp.zeros(n_total, jnp.int32).at[order].set(start_idx)
    return order, rank, num_tied, max_group


@functools.partial(jax.jit, static_argnames=("k", "n_max"))
def _refine_program(rank, lengths, h, *, k: int, n_max: int):
    """One prefix-doubling level: rank2 gather + 2-key sort + group-start
    rank rebuild.  ``h`` is traced, so every level reuses one executable."""
    n_total = k * n_max
    g = jnp.arange(n_total, dtype=jnp.int32)
    base = (g // jnp.int32(n_max)) * jnp.int32(n_max)
    pos = g - base
    n_of = _n_of_flat(lengths, k, n_max)
    r2 = rank[base + (pos + h) % n_of]
    r1s, r2s, order = jax.lax.sort((rank, r2, g), num_keys=2, is_stable=True)
    newgrp = jnp.concatenate(
        [
            jnp.ones(1, bool),
            (r1s[1:] != r1s[:-1]) | (r2s[1:] != r2s[:-1]),
        ]
    )
    start_idx, num_tied, max_group = _group_stats(newgrp, g)
    rank_new = jnp.zeros(n_total, jnp.int32).at[order].set(start_idx)
    return order, rank_new, num_tied, max_group


@functools.partial(jax.jit, static_argnames=("k", "n_max"))
def _dup_check_program(order, rank, lengths, *, k: int, n_max: int):
    """Same-sequence identical periodic rotations (fallback trigger)."""
    rs = rank[order]
    seq_s = order // jnp.int32(n_max)
    n_of = _n_of_flat(lengths, k, n_max)
    valid_s = (order % jnp.int32(n_max)) < n_of[order]
    return jnp.any(
        (rs[1:] == rs[:-1]) & (seq_s[1:] == seq_s[:-1]) & valid_s[1:]
    )


@functools.partial(jax.jit, static_argnames=("k", "n_max"))
def _lcp_step_program(off, rank_t, a, b, n_a, n_b, h, *, k: int, n_max: int):
    """One binary-descent level of the adjacent-pair LCP (2 gathers)."""
    base_a = (a // jnp.int32(n_max)) * jnp.int32(n_max)
    base_b = (b // jnp.int32(n_max)) * jnp.int32(n_max)
    ga = base_a + (a - base_a + off) % n_a
    gb = base_b + (b - base_b + off) % n_b
    eq = rank_t[ga] == rank_t[gb]
    return jnp.where(eq, off + h, off)


@functools.partial(jax.jit, static_argnames=("k", "n_max"))
def _lcp_tail_program(off, packed, order, lengths, *, k: int, n_max: int):
    """Sub-PACK_W tail: compare the two differing packed 12-mer windows
    digit by digit (arithmetic, no per-char gathers).  Returns the full
    (N,) raw and capped lcp arrays (index i = boundary sa[i-1]/sa[i])."""
    n_of = _n_of_flat(lengths, k, n_max)
    n_sorted = n_of[order]
    valid_s = (order % jnp.int32(n_max)) < n_sorted
    a = order[:-1]
    b = order[1:]
    n_a = n_sorted[:-1]
    n_b = n_sorted[1:]
    base_a = (a // jnp.int32(n_max)) * jnp.int32(n_max)
    base_b = (b // jnp.int32(n_max)) * jnp.int32(n_max)
    ka = packed[base_a + (a - base_a + off) % n_a]
    kb = packed[base_b + (b - base_b + off) % n_b]
    still = jnp.ones(off.shape, bool)
    run = jnp.zeros(off.shape, jnp.int32)
    for i in range(PACK_W):
        sh = jnp.int32(_ALPHA ** (PACK_W - 1 - i))
        still = still & ((ka // sh) % _ALPHA == (kb // sh) % _ALPHA)
        run = run + still.astype(jnp.int32)
    raw_pair = jnp.where(valid_s[:-1] & valid_s[1:], off + run, 0)
    cap_pair = jnp.minimum(n_a, n_b)
    zero = jnp.zeros(1, jnp.int32)
    raw = jnp.concatenate([zero, raw_pair])
    lcp = jnp.concatenate([zero, jnp.minimum(raw_pair, cap_pair)])
    return raw, lcp


def _collect_pack_program(
    order, lcp, lengths, *, k: int, n_max: int, tdeep: int, cap: int,
    ecap: int, fcap: int = 0
):
    """Collect + suffix filter + uniqueness + positions, one program.

    Exact twin of the numpy cascade (cyclic.collect_blocks +
    remove_suffix_blocks + positions_if_unique; reference csamsa.c:69-257)
    built from scans, sorts and scatters — see the module-section comment
    for the per-stage algorithms.  ``tdeep`` must satisfy
    ``2**tdeep >= max level-0 group size`` (deep intervals cannot outgrow
    their 12-mer group).  Returns one packed int32 vector:
    [nb, total_e, bstart(cap), bend(cap), bdepth(cap), keep_suffix(cap),
    unique(cap), positions(cap*k)] — or, with ``fcap > 0``, the SLIM
    layout [nb, total_e, n_suffix, n_final, fstart(fcap), fdepth(fcap),
    fpositions(fcap*k)] carrying only the suffix-free unique blocks the
    pipeline consumes (the full per-block tables stay on device; only
    the blocks the host needs are transferred).
    """
    front = _collect_front(order, lcp, lengths, k=k, n_max=n_max,
                           tdeep=tdeep)
    return _collect_tail(order, lcp, lengths, *front, k=k, n_max=n_max,
                         cap=cap, ecap=ecap, fcap=fcap)


def _collect_front(order, lcp, lengths, *, k: int, n_max: int, tdeep: int):
    """The N-sized front of the collect cascade: PSV/NSV intervals,
    all-sequence coverage, canonical representatives, deepest-node
    marking.  Returns (collected, start, end) — everything the cap-sized
    tail consumes.  Split out so the sharded path can run a shard-local
    twin (parallel/collect_sharded.py) and feed the same tail."""
    n_total = k * n_max
    idx = jnp.arange(n_total, dtype=jnp.int32)
    n_of = _n_of_flat(lengths, k, n_max)
    pos_sorted = order % jnp.int32(n_max)
    seq_sorted = order // jnp.int32(n_max)
    valid_s = pos_sorted < n_of[order]
    BIGN = jnp.int32(n_total)
    # the PACK_W forward + PACK_W backward threshold scans run as one
    # multi-channel scan per direction (index/mscan.py)
    from . import mscan

    vv = jnp.arange(1, PACK_W + 1, dtype=jnp.int32)[:, None]
    below = lcp[None, :] < vv                               # (PACK_W, N)
    rs_all = mscan.multi_cummax(jnp.where(below, idx[None, :], -1))
    ns_all = mscan.multi_cummin(
        jnp.where(below, idx[None, :], BIGN), reverse=True
    )
    psv = jnp.full(n_total, -1, jnp.int32)
    nsv = jnp.full(n_total, n_total, jnp.int32)
    for v in range(1, PACK_W + 1):
        sel = lcp == v
        psv = jnp.where(sel, rs_all[v - 1], psv)
        nsv = jnp.where(sel, ns_all[v - 1], nsv)
    # (both scans include self, but self has lcp == v, not < v, so it is
    # never marked "below" — the inclusive scans are exactly psv/nsv)

    deep = lcp > PACK_W
    if tdeep > 0:
        minv = [lcp]
        for t in range(tdeep - 1):
            half = 1 << t
            prev = minv[-1]
            shifted = jnp.concatenate(
                [prev[half:], jnp.full(half, jnp.int32(2**30), jnp.int32)]
            )
            minv.append(jnp.minimum(prev, shifted))
        ln = jnp.zeros(n_total, jnp.int32)
        for t in range(tdeep - 1, -1, -1):
            j = idx - ln - jnp.int32(1 << t)
            ok = j >= 0
            mv = minv[t][jnp.maximum(j, 0)]
            grow = ok & (mv >= lcp) & deep
            ln = jnp.where(grow, ln + jnp.int32(1 << t), ln)
        psv_deep = idx - ln - 1
        rn = jnp.zeros(n_total, jnp.int32)
        for t in range(tdeep - 1, -1, -1):
            j = idx + rn + 1
            ok = (j + jnp.int32(1 << t) - 1) <= jnp.int32(n_total - 1)
            mv = minv[t][jnp.minimum(j, n_total - 1)]
            grow = ok & (mv >= lcp) & deep
            rn = jnp.where(grow, rn + jnp.int32(1 << t), rn)
        nsv_deep = idx + rn + 1
        psv = jnp.where(deep, psv_deep, psv)
        nsv = jnp.where(deep, nsv_deep, nsv)

    start = jnp.maximum(psv, 0)
    end = nsv - 1
    has_node = lcp >= 1

    # ---- all-sequences coverage: L[e] = min_s lastocc_s(e) ----
    # k per-sequence last-occurrence scans + cross-channel min
    sv_ch = jnp.arange(k, dtype=jnp.int32)[:, None]
    occ = jnp.where(
        (seq_sorted[None, :] == sv_ch) & valid_s[None, :],
        idx[None, :], -1,
    )                                                       # (k, N)
    L = mscan.multi_cummax(occ, min_over_channels=True)
    allseq = has_node & (L[end] >= start)

    # ---- canonical representative per (start, end) group ----
    s_key = jnp.where(has_node, start, BIGN)
    e_key = jnp.where(has_node, end, BIGN)
    sk, ek, bidx = jax.lax.sort((s_key, e_key, idx), num_keys=2,
                                is_stable=True)
    head = jnp.concatenate(
        [jnp.ones(1, bool), (sk[1:] != sk[:-1]) | (ek[1:] != ek[:-1])]
    )
    seg_id = jnp.cumsum(head.astype(jnp.int32)) - 1
    canon_of_seg = (
        jnp.zeros(n_total, jnp.int32)
        .at[jnp.where(head, seg_id, n_total - 1)]
        .set(jnp.where(head, bidx, 0))
    )
    canon_arr = (
        jnp.zeros(n_total, jnp.int32).at[bidx].set(canon_of_seg[seg_id])
    )
    is_canon = has_node & (canon_arr == idx)

    # ---- deepest: mark parents of all-seq canonical nodes ----
    lcp_ext = jnp.concatenate([lcp, jnp.zeros(1, jnp.int32)])
    left_d = lcp_ext[start]
    right_d = lcp_ext[jnp.minimum(end + 1, n_total)]
    parent_bound = jnp.where(left_d >= right_d, start, end + 1)
    parent_d = jnp.maximum(left_d, right_d)
    has_parent = is_canon & allseq & (parent_d >= 1)
    pb = jnp.where(has_parent, jnp.minimum(parent_bound, n_total - 1), 0)
    parent_canon = canon_arr[pb]
    haschild = (
        jnp.zeros(n_total, bool)
        .at[jnp.where(has_parent, parent_canon, n_total - 1)]
        .max(has_parent)
    )
    collected = is_canon & allseq & ~haschild
    return collected, start, end


def _collect_tail(order, lcp, lengths, collected, start, end, *, k: int,
                  n_max: int, cap: int, ecap: int, fcap: int = 0):
    """The cap/ecap-sized back half of the collect cascade (compaction,
    interval expansion, suffix join, uniqueness, packing); consumes the
    front's (collected, start, end) regardless of which twin computed
    them."""
    n_total = k * n_max
    n_of = _n_of_flat(lengths, k, n_max)
    pos_sorted = order % jnp.int32(n_max)

    # ---- compact to cap blocks ----
    nb = jnp.sum(collected).astype(jnp.int32)
    (bsel,) = jnp.nonzero(collected, size=cap, fill_value=0)
    bsel = bsel.astype(jnp.int32)
    validb = jnp.arange(cap, dtype=jnp.int32) < nb
    bstart = jnp.where(validb, start[bsel], 0)
    bend = jnp.where(validb, end[bsel], -1)
    bdepth = jnp.where(validb, lcp[bsel], 0)
    width = jnp.where(validb, bend - bstart + 1, 0)
    offs = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(width, dtype=jnp.int32)]
    )
    total_e = offs[cap]

    # ---- expand the (disjoint) collected intervals ----
    e_idx = jnp.arange(ecap, dtype=jnp.int32)
    blk = jax.lax.cummax(
        jnp.zeros(ecap, jnp.int32)
        .at[jnp.where(validb & (width > 0), jnp.minimum(offs[:cap], ecap - 1), ecap - 1)]
        .max(jnp.where(validb & (width > 0), jnp.arange(cap, dtype=jnp.int32), 0))
    )
    active = e_idx < jnp.minimum(total_e, jnp.int32(ecap))
    r = jnp.where(active, bstart[blk] + (e_idx - offs[blk]), 0)
    gmem = order[r]
    mseq = gmem // jnp.int32(n_max)
    mpos = gmem % jnp.int32(n_max)
    mn = n_of[gmem]
    d_b = bdepth[blk]
    end_rot = mseq * jnp.int32(n_max) + (mpos + d_b) % mn

    # ---- suffix filter: occurrence-end join ----
    repg = order[jnp.minimum(bstart, n_total - 1)]
    rbase = (repg // jnp.int32(n_max)) * jnp.int32(n_max)
    rep_end = rbase + (repg - rbase + bdepth) % n_of[repg]
    maxd = (
        jnp.full(n_total + 1, -1, jnp.int32)
        .at[jnp.where(validb, rep_end, n_total)]
        .max(jnp.where(validb, bdepth, -1))
    )
    hit = active & (maxd[jnp.minimum(end_rot, n_total - 1)] > d_b)
    removed = (
        jnp.zeros(cap, bool)
        .at[jnp.where(active, blk, cap - 1)]
        .max(hit)
    )
    keep_suffix = validb & ~removed

    # ---- uniqueness + positions ----
    unique = validb & (width == jnp.int32(k))
    slot = jnp.where(active, blk * jnp.int32(k) + mseq, 0)
    BIG = jnp.int32(2**30)
    minr = (
        jnp.full(cap * k, BIG, jnp.int32)
        .at[slot]
        .min(jnp.where(active, r, BIG))
    )
    pos_at = pos_sorted[jnp.minimum(minr, n_total - 1)]
    positions = jnp.where(minr < BIG, pos_at, 0)

    if fcap:
        n_suffix = jnp.sum(keep_suffix).astype(jnp.int32)
        final = keep_suffix & unique
        n_final = jnp.sum(final).astype(jnp.int32)
        (fsel,) = jnp.nonzero(final, size=fcap, fill_value=0)
        fsel = fsel.astype(jnp.int32)
        fvalid = jnp.arange(fcap, dtype=jnp.int32) < n_final
        fstart = jnp.where(fvalid, bstart[fsel], 0)
        fdepth = jnp.where(fvalid, bdepth[fsel], 0)
        fpos = jnp.where(
            fvalid[:, None],
            positions.reshape(cap, k)[fsel],
            0,
        )
        return jnp.concatenate(
            [
                jnp.stack([nb, total_e, n_suffix, n_final]),
                fstart,
                fdepth,
                fpos.reshape(-1),
            ]
        )
    packed_out = jnp.concatenate(
        [
            jnp.stack([nb, total_e]),
            bstart,
            bend,
            bdepth,
            keep_suffix.astype(jnp.int32),
            unique.astype(jnp.int32),
            positions,
        ]
    )
    return packed_out


_collect_pack = functools.partial(
    jax.jit, static_argnames=("k", "n_max", "tdeep", "cap", "ecap", "fcap")
)(_collect_pack_program)

_collect_tail_jit = functools.partial(
    jax.jit, static_argnames=("k", "n_max", "cap", "ecap", "fcap")
)(_collect_tail)


def _pow2_at_least(x: int, floor: int = 1) -> int:
    v = max(int(x), floor)
    return 1 << (v - 1).bit_length()


class RotationBlocks:
    """Host view of the fused rotation block stage (one transfer)."""

    __slots__ = (
        "start", "end", "depth", "keep_suffix", "unique", "positions",
        "num_collected",
    )

    def __init__(self, arr: np.ndarray, cap: int, k: int, nb: int,
                 header: int = 3):
        f = arr[header:]
        self.num_collected = nb
        sl = lambda i: f[i * cap : (i + 1) * cap][:nb]
        self.start = sl(0).astype(np.int64)
        self.end = sl(1).astype(np.int64)
        self.depth = sl(2).astype(np.int64)
        self.keep_suffix = sl(3).astype(bool)
        self.unique = sl(4).astype(bool)
        self.positions = (
            f[5 * cap : (5 + k) * cap].reshape(cap, k)[:nb].astype(np.int64)
        )

    @classmethod
    def from_fields(
        cls, *, num_collected, start, end, depth, keep_suffix, unique, positions
    ) -> "RotationBlocks":
        self = object.__new__(cls)
        self.num_collected = int(num_collected)
        self.start = np.asarray(start).astype(np.int64)
        self.end = np.asarray(end).astype(np.int64)
        self.depth = np.asarray(depth).astype(np.int64)
        self.keep_suffix = np.asarray(keep_suffix).astype(bool)
        self.unique = np.asarray(unique).astype(bool)
        self.positions = np.asarray(positions).astype(np.int64)
        return self


def rotation_blocks_jax(encoded: Sequence[np.ndarray], cap: int = 4096):
    """Run the fast host-driven rotation block stage; returns
    ``RotationBlocks`` or ``None`` when duplicate within-sequence
    rotations demand the exact numpy fallback (degenerate periodic
    inputs, docs/PARITY.md)."""
    arrays, aux = _device_build(encoded)
    if arrays is None:
        return None
    order, lcp, js = arrays
    k, n_max, mg0 = aux
    # deep-descent level count: 2**tdeep >= max level-0 group size,
    # bucketed to powers of two to bound recompiles
    tdeep = _tdeep_for(mg0, k, n_max)
    cap, ecap, _ = _CAPS_CACHE.get((k, n_max), (cap, 0, 0))
    ecap = max(ecap, _pow2_at_least(cap * (k + 2), 1 << 14))
    while True:
        packed = _collect_pack(
            order, lcp, js, k=k, n_max=n_max, tdeep=tdeep, cap=cap,
            ecap=ecap,
        )
        arr = np.asarray(packed)  # the single bulk device->host transfer
        nb, total_e = int(arr[0]), int(arr[1])
        if nb > cap:
            cap = _pow2_at_least(nb + 1, 4096)
            ecap = _pow2_at_least(max(ecap, cap * (k + 2)))
            continue
        if total_e + 1 > ecap:
            ecap = _pow2_at_least(total_e + 1)
            continue
        _CAPS_CACHE[(k, n_max)] = (cap, ecap, 0)
        break
    blocks = RotationBlocks(arr, cap, k, nb, header=2)
    # normalize to the numpy engine's (start, end) block order
    o = np.lexsort((blocks.end, blocks.start))
    blocks.start = blocks.start[o]
    blocks.end = blocks.end[o]
    blocks.depth = blocks.depth[o]
    blocks.keep_suffix = blocks.keep_suffix[o]
    blocks.unique = blocks.unique[o]
    blocks.positions = blocks.positions[o]
    return blocks


_CAPS_CACHE: dict = {}  # (k, n_max) -> (cap, ecap, fcap) last known good


def _tdeep_for(mg0: int, k: int, n_max: int) -> int:
    """Deep-descent level count: 2**tdeep >= max level-0 group size,
    bucketed to powers of two to bound recompiles."""
    return min(
        _pow2_at_least(mg0, 16).bit_length() - 1,
        int(np.ceil(np.log2(max(k * n_max, 2)))) + 1,
    )


class RotationFinal:
    """Slim pipeline view: only the suffix-free unique blocks, plus the
    cascade counts (the full per-block tables never leave the device)."""

    __slots__ = (
        "num_collected", "num_after_suffix", "final_start", "final_depth",
        "final_positions",
    )


@functools.partial(
    jax.jit,
    static_argnames=("k", "n_max", "Lmax", "tdeep", "cap", "ecap", "fcap"),
)
def _fused_small_program(codes, lengths, *, k: int, n_max: int, Lmax: int,
                         tdeep: int, cap: int, ecap: int, fcap: int):
    """The ENTIRE rotation block stage as ONE dispatch (small inputs).

    The host-driven staged pipeline costs ~13 dispatch round trips,
    each with a host sync.  Here the per-level host sync is
    replaced by an on-device ``lax.while_loop`` over the refinement
    levels (compiled ONCE per level, not unrolled — the round-2 fused
    program's compile-time failure mode), rank snapshots go into a
    (Lmax+1, N) stack, rows above the realized level count are filled
    with the final all-unique rank so their LCP-descent steps are exact
    no-ops, and the collect/filter cascade runs with a conservative
    static ``tdeep``.  Returns (packed slim result, duplicate flag).

    Memory is (Lmax+1) x N x 4 B for the stack — ~14 MB at Primates
    scale, which is why this path is gated to small inputs; big inputs
    keep the early-terminating staged pipeline whose per-dispatch cost
    is amortized.
    """
    n_total = k * n_max
    packed = _pack_keys_program(codes, lengths, k=k, n_max=n_max)
    order, rank, num_tied, _mg = _level0_program(
        packed, lengths, k=k, n_max=n_max
    )
    stack0 = jnp.zeros((Lmax + 1, n_total), jnp.int32).at[0].set(rank)

    def cond(state):
        _o, _r, nt, t, _s = state
        return (nt > 0) & ((jnp.int32(PACK_W) << t) < jnp.int32(n_max))

    def body(state):
        _o, r, _nt, t, stack = state
        o2, r2, nt2, _ = _refine_program(
            r, lengths, jnp.int32(PACK_W) << t, k=k, n_max=n_max
        )
        stack = jax.lax.dynamic_update_slice_in_dim(
            stack, r2[None, :], t + 1, axis=0
        )
        return (o2, r2, nt2, t + 1, stack)

    order, rank, nt, L, stack = jax.lax.while_loop(
        cond, body, (order, rank, num_tied, jnp.int32(0), stack0)
    )
    dup = (nt > 0) & _dup_check_program(
        order, rank, lengths, k=k, n_max=n_max
    )
    rows = jnp.arange(Lmax + 1, dtype=jnp.int32)[:, None]
    stack = jnp.where(rows > L, rank[None, :], stack)

    a = order[:-1]
    b = order[1:]
    n_of = _n_of_flat(lengths, k, n_max)
    n_a = n_of[a]
    n_b = n_of[b]
    off = jnp.zeros(n_total - 1, jnp.int32)
    for tt in range(Lmax, -1, -1):
        off = _lcp_step_program(
            off, stack[tt], a, b, n_a, n_b, jnp.int32(PACK_W << tt),
            k=k, n_max=n_max,
        )
    raw, lcp = _lcp_tail_program(off, packed, order, lengths, k=k,
                                 n_max=n_max)
    out = _collect_pack(
        order, lcp, lengths, k=k, n_max=n_max, tdeep=tdeep, cap=cap,
        ecap=ecap, fcap=fcap,
    )
    # one transfer carries everything the host must branch on: the
    # duplicate-rotation flag and the realized max level-0 group size
    # (the host validates its cached static tdeep against it and retries
    # bigger when 2**tdeep < mg0 — correctness gate of the deep descent)
    head = jnp.stack([dup.astype(jnp.int32), _mg.astype(jnp.int32)])
    return jnp.concatenate([head, out])


# fused-path size gate: above this many total characters the staged
# pipeline's early termination + slim memory win; below it the single
# dispatch wins (the regime is exactly the auto-backend native zone,
# but `--backend jax` should still be fast there)
FUSED_MAX_CHARS = int(_os.environ.get("CSA_FUSED_MAX_CHARS", 4_000_000))


def _parse_slim(arr: np.ndarray, k: int, fcap: int):
    """RotationFinal from the packed slim layout (shared by both paths)."""
    nb, total_e, n_suffix, n_final = (int(x) for x in arr[:4])
    out = RotationFinal()
    out.num_collected = nb
    out.num_after_suffix = n_suffix
    f = arr[4:]
    start = f[:fcap][:n_final].astype(np.int64)
    depth = f[fcap : 2 * fcap][:n_final].astype(np.int64)
    pos = f[2 * fcap :].reshape(fcap, k)[:n_final].astype(np.int64)
    # normalize to the numpy engine's (start, end) block order so the
    # pipeline's depth-sort sees identical input order on ties
    o = np.lexsort((-depth, start))
    out.final_start = start[o]
    out.final_depth = depth[o]
    out.final_positions = pos[o]
    return out


_TDEEP_CACHE: dict = {}


def _rotation_final_fused(encoded: Sequence[np.ndarray], cap: int):
    """Single-dispatch small-input path; None on duplicate rotations.

    ``tdeep`` is a cached static guess validated IN-PROGRAM against the
    realized max level-0 group size (the descent is only exact when
    2**tdeep >= mg0); a wrong guess costs one retry dispatch, the common
    case costs zero extra syncs.
    """
    k = len(encoded)
    sizes = np.array([len(e) for e in encoded], dtype=np.int32)
    n_max = _bucket(int(sizes.max()))
    codes = np.zeros((k, n_max), dtype=np.int8)
    for i, e in enumerate(encoded):
        codes[i, : len(e)] = e
    jc = jnp.asarray(codes)
    js = jnp.asarray(sizes)
    Lmax = _num_levels(n_max)
    tdeep = _TDEEP_CACHE.get((k, n_max), 7)
    ccap, ecap, fcap = _CAPS_CACHE.get((k, n_max), (cap, 0, 0))
    cap = max(cap, ccap)
    ecap = max(ecap, _pow2_at_least(cap * (k + 2), 1 << 14))
    # the slim transfer is fcap*(k+2) ints; the small-input regime
    # rarely has >1k final blocks, so start low and
    # let the overflow retry grow it
    fcap = max(fcap, 1024)
    while True:
        packed = _fused_small_program(
            jc, js, k=k, n_max=n_max, Lmax=Lmax, tdeep=tdeep, cap=cap,
            ecap=ecap, fcap=fcap,
        )
        arr = np.asarray(packed)
        dup, mg0 = int(arr[0]), int(arr[1])
        if dup:
            return None
        if (1 << tdeep) < mg0:
            tdeep = _tdeep_for(mg0, k, n_max)
            _TDEEP_CACHE[(k, n_max)] = tdeep
            continue
        _TDEEP_CACHE[(k, n_max)] = tdeep
        arr = arr[2:]
        nb, total_e, n_suffix, n_final = (int(x) for x in arr[:4])
        if nb > cap:
            cap = _pow2_at_least(nb + 1, 4096)
            ecap = _pow2_at_least(max(ecap, cap * (k + 2)))
            continue
        if total_e + 1 > ecap:
            ecap = _pow2_at_least(total_e + 1)
            continue
        if n_final > fcap:
            fcap = _pow2_at_least(n_final + 1, 1024)
            continue
        _CAPS_CACHE[(k, n_max)] = (cap, ecap, fcap)
        break
    return _parse_slim(arr, k, fcap)


def rotation_final_jax(encoded: Sequence[np.ndarray], cap: int = 4096,
                       mesh=None):
    """Fast pipeline entry: like :func:`rotation_blocks_jax` but transfers
    only the filtered final blocks (slim packed layout).  Returns a
    :class:`RotationFinal` or ``None`` on the duplicate-rotation fallback.

    Small inputs (<= FUSED_MAX_CHARS total characters, no mesh) run the
    whole stage as ONE dispatch (:func:`_fused_small_program`); larger
    inputs keep the host-driven staged pipeline with per-level early
    termination.

    With ``mesh`` (a ``(seq, pos)`` device mesh) the input code matrix is
    placed sharded and every stage program runs under GSPMD — XLA
    partitions the sorts/scans and inserts the collectives.  The explicit
    hand-written collective merge lives in
    :func:`csa_jax.parallel.sharded.rotation_blocks_sharded`; this path
    is the same round-3 algorithm as single-device, just sharded."""
    # gate on the PADDED working-set size k * bucket(max len) — that is
    # the actual rank-stack row width of _fused_small_program — not the
    # raw character total: a skewed set (one long sequence + many short
    # ones) pads every row to the longest and can blow device memory on
    # a path meant for small inputs.
    padded = len(encoded) * _bucket(max((len(e) for e in encoded), default=8))
    if mesh is None and padded <= FUSED_MAX_CHARS:
        return _rotation_final_fused(encoded, cap)
    arrays, aux = _device_build(encoded, mesh=mesh)
    if arrays is None:
        return None
    order, lcp, js = arrays
    k, n_max, mg0 = aux
    tdeep = _tdeep_for(mg0, k, n_max)
    ccap, ecap, fcap = _CAPS_CACHE.get((k, n_max), (cap, 0, 0))
    cap = max(cap, ccap)
    ecap = max(ecap, _pow2_at_least(cap * (k + 2), 1 << 14))
    fcap = max(fcap, 4096)
    # under a power-of-two mesh the collect cascade's N-sized front runs
    # shard-local (parallel/collect_sharded.py); the cap-sized tail —
    # whose caps may retry — stays replicated and reuses the front
    front = None
    n_dev = 1 if mesh is None else int(
        np.prod(np.asarray(mesh.devices).shape)
    )
    from ..utils.profiling import PROFILER

    if (
        mesh is not None
        and n_dev & (n_dev - 1) == 0
        and _os.environ.get("CSA_SHARDED_COLLECT", "dsort") == "dsort"
    ):
        from ..parallel import collect_sharded, dsort_ladder

        with PROFILER.phase("idx.collect_front"):
            fmesh = dsort_ladder._flat_mesh(mesh)
            rep = dsort_ladder._replicate_program(fmesh)
            with jax.enable_x64():
                prog = collect_sharded.collect_front_program(
                    fmesh, k=k, n_max=n_max, tdeep=tdeep
                )
                col, st, en = prog(order, lcp, js)
            front = (rep(col), rep(st), rep(en))
            if PROFILER.enabled:
                jax.block_until_ready(front)
    while True:
        with PROFILER.phase("idx.collect_tail"):
            if front is not None:
                packed = _collect_tail_jit(
                    order, lcp, js, *front, k=k, n_max=n_max, cap=cap,
                    ecap=ecap, fcap=fcap,
                )
            else:
                packed = _collect_pack(
                    order, lcp, js, k=k, n_max=n_max, tdeep=tdeep, cap=cap,
                    ecap=ecap, fcap=fcap,
                )
            arr = np.asarray(packed)  # slim device->host transfer
        nb, total_e, n_suffix, n_final = (int(x) for x in arr[:4])
        if nb > cap:
            cap = _pow2_at_least(nb + 1, 4096)
            ecap = _pow2_at_least(max(ecap, cap * (k + 2)))
            continue
        if total_e + 1 > ecap:
            ecap = _pow2_at_least(total_e + 1)
            continue
        if n_final > fcap:
            fcap = _pow2_at_least(n_final + 1, 4096)
            continue
        _CAPS_CACHE[(k, n_max)] = (cap, ecap, fcap)
        break
    return _parse_slim(arr, k, fcap)


def _device_build(encoded: Sequence[np.ndarray], mesh=None):
    """Shared host-driven build: pack + level-0 sort + early-terminated
    refinement + LCP.  Returns ((order, lcp, lengths_dev), (k, n_max,
    max_group0)), or (None, None) when duplicate rotations are present.

    The per-level scalar syncs (num_tied, max_group) cost one ~0.2 ms
    round trip each and buy early termination: non-repetitive inputs
    resolve every tie after 2-3 levels and skip the remaining ~15.
    """
    k = len(encoded)
    sizes = np.array([len(e) for e in encoded], dtype=np.int32)
    n_max = _bucket(int(sizes.max()))
    if mesh is not None:
        # shard-local ladder (parallel/dsort_ladder.py): per-device sort
        # work genuinely divides, vs the GSPMD partitioner which
        # REPLICATES sorts along a sharded dim.  Power-of-two meshes
        # only (the bitonic merge-split network); escape hatch:
        # CSA_SHARDED_SORT=xla
        n_dev = int(np.prod(np.asarray(mesh.devices).shape))
        if (
            n_dev & (n_dev - 1) == 0
            and _os.environ.get("CSA_SHARDED_SORT", "dsort") == "dsort"
        ):
            from ..parallel import dsort_ladder

            return dsort_ladder.device_build_dsort(encoded, mesh)
        pos_axis = int(mesh.shape.get("pos", 1))
        n_max = -(-n_max // pos_axis) * pos_axis
    codes = np.zeros((k, n_max), dtype=np.int8)  # int8 upload: 4x
    for i, e in enumerate(encoded):              # smaller than int32
        codes[i, : len(e)] = e
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        jc = jax.device_put(
            jnp.asarray(codes), NamedSharding(mesh, P("seq", "pos"))
        )
        js = jax.device_put(
            jnp.asarray(sizes), NamedSharding(mesh, P("seq"))
        )
    else:
        jc = jnp.asarray(codes)
        js = jnp.asarray(sizes)
    from ..utils.profiling import PROFILER

    with PROFILER.phase("idx.pack"):
        packed = _pack_keys_program(jc, js, k=k, n_max=n_max)
        if PROFILER.enabled:
            jax.block_until_ready(packed)
    with PROFILER.phase("idx.l0_sort"):
        order, rank, num_tied, max_group = _level0_program(
            packed, js, k=k, n_max=n_max
        )
        ranks = [rank]
        mg0 = int(max_group)
        nt = int(num_tied)
    t = 0
    with PROFILER.phase("idx.refine"):
        while nt > 0 and (PACK_W << t) < n_max:
            order, rank, num_tied, max_group = _refine_program(
                rank, js, jnp.int32(PACK_W << t), k=k, n_max=n_max
            )
            ranks.append(rank)
            nt = int(num_tied)
            t += 1
    if nt > 0 and bool(
        _dup_check_program(order, rank, js, k=k, n_max=n_max)
    ):
        return None, None

    # adjacent-pair LCP: binary descent over the stored levels + tail
    with PROFILER.phase("idx.lcp"):
        n_total = k * n_max
        a = order[:-1]
        b = order[1:]
        n_of = _n_of_flat(js, k, n_max)
        n_a = n_of[a]
        n_b = n_of[b]
        off = jnp.zeros(n_total - 1, jnp.int32)
        for tt in range(len(ranks) - 1, -1, -1):
            off = _lcp_step_program(
                off, ranks[tt], a, b, n_a, n_b, jnp.int32(PACK_W << tt),
                k=k, n_max=n_max,
            )
        raw, lcp = _lcp_tail_program(off, packed, order, js, k=k,
                                     n_max=n_max)
        if PROFILER.enabled:
            jax.block_until_ready(lcp)
    return (order, lcp, js), (k, n_max, mg0)



def _index_from_device(rank_stack, sa, lcp, raw, sizes, k, n_max,
                       codes=None):
    """Host RotationIndex view; the rank stack (and code matrix, for
    sub-PACK_W fingerprints) stays on the device and is consulted via
    :func:`device_fingerprint` (transfers of the full stack dominate wall
    time otherwise)."""
    sa_np = np.asarray(sa)
    lcp_np = np.asarray(lcp).astype(np.int64)
    raw_np = np.asarray(raw).astype(np.int64)
    seq_pad = sa_np // n_max
    pos_pad = sa_np % n_max
    real = pos_pad < sizes[seq_pad]
    sa_real = sa_np[real]
    m = len(sa_real)
    offsets = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(sizes.astype(np.int64), out=offsets[1:])
    total = int(offsets[-1])
    seq_of = np.repeat(np.arange(k, dtype=np.int64), sizes)
    pos_of = np.arange(total, dtype=np.int64) - offsets[seq_of]
    n_of = sizes.astype(np.int64)[seq_of]
    sa_compact = offsets[sa_real // n_max] + (sa_real % n_max)
    return cyclic.RotationIndex(
        seq_of=seq_of,
        pos_of=pos_of,
        n_of=n_of,
        offsets=offsets,
        levels=[],
        sa=sa_compact,
        lcp=lcp_np[:m],
        num_seqs=k,
        raw_lcp=raw_np[:m],
        device_ranks=(rank_stack, codes),
        device_layout=(k, n_max),
    )


@functools.partial(jax.jit, static_argnames=("n_max",))
def _fingerprint_mixed_device(rank_stack, codes, lengths, g_pad, t_arr,
                              off_arr, d_arr, *, n_max: int):
    """Mixed-depth fingerprints in ONE dispatch.

    Per element: for ``d >= PACK_W`` the classic two-overlapping-windows
    rank pair (level ``t_arr``, second window at offset ``off_arr``);
    for ``d < PACK_W`` the exact base-5 packed key of the first ``d``
    chars (read from the code matrix) with r2 = -1 — same-d comparisons
    only, so the two encodings never cross.
    """
    s = g_pad // n_max
    p = g_pad % n_max
    nn = jnp.maximum(lengths[s], 1)
    g2 = s * n_max + (p + off_arr) % nn
    r1 = rank_stack[t_arr, g_pad]
    r2 = rank_stack[t_arr, g2]
    cflat = codes.reshape(-1).astype(jnp.int32)
    acc = jnp.zeros_like(g_pad)
    for i in range(PACK_W - 1):
        gi = s * n_max + (p + jnp.int32(i)) % nn
        take = jnp.int32(i) < d_arr
        acc = jnp.where(take, acc * _ALPHA + cflat[gi], acc)
    short = d_arr < jnp.int32(PACK_W)
    r1 = jnp.where(short, acc, r1)
    r2 = jnp.where(short, jnp.int32(-1), r2)
    return r1, r2


def _fingerprint_params(d: np.ndarray):
    """Per-element packed level + second-window offset for d >= PACK_W
    (zeros for shorter depths, which take the char-packed path)."""
    d = np.asarray(d, dtype=np.int64)
    q = np.maximum(d // PACK_W, 1)
    t = np.zeros(len(d), dtype=np.int64)
    qq = q.copy()
    while np.any(qq > 1):
        grow = qq > 1
        t[grow] += 1
        qq[grow] >>= 1
    off = d - (np.int64(PACK_W) << t)
    shortm = d < PACK_W
    return (
        np.where(shortm, 0, t).astype(np.int32),
        np.where(shortm, 0, off).astype(np.int32),
    )


def device_fingerprint_mixed(index: cyclic.RotationIndex, g: np.ndarray, d: np.ndarray):
    """Fingerprints for per-element prefix lengths ``d`` (one dispatch)."""
    k, n_max = index.device_layout
    g = np.asarray(g, dtype=np.int64)
    d = np.asarray(d, dtype=np.int64)
    seq = index.seq_of[g]
    g_pad = (seq * n_max + index.pos_of[g]).astype(np.int32)
    t, off = _fingerprint_params(d)
    lengths = index.n_of[index.offsets[:-1]].astype(np.int32)
    rank_stack, codes = index.device_ranks
    r1, r2 = _fingerprint_mixed_device(
        rank_stack,
        codes,
        jnp.asarray(lengths),
        jnp.asarray(g_pad),
        jnp.asarray(t),
        jnp.asarray(off),
        jnp.asarray(d.astype(np.int32)),
        n_max=n_max,
    )
    r1 = np.asarray(r1).astype(np.int64)
    r2 = np.asarray(r2).astype(np.int64)
    return r1 * np.int64(k * n_max + 1) + r2


def device_fingerprint(index: cyclic.RotationIndex, g: np.ndarray, d: int):
    """Fingerprint length-``d`` prefixes via on-device rank gathers."""
    g = np.asarray(g, dtype=np.int64)
    return device_fingerprint_mixed(
        index, g, np.full(len(g), int(d), dtype=np.int64)
    )
