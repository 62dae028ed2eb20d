"""Shard-local twin of the collect cascade's N-sized front.

``engine._collect_front`` (PSV/NSV intervals, all-sequence coverage,
canonical representatives, deepest-node marking) runs replicated under a
mesh — the last N-sized replicated stage after the round-4 ladder.  This
module re-plumbs it shard-local:

* the threshold PSV/NSV and coverage scans -> local scans with
  cross-shard carries;
* the deep-interval descent -> one transient ``all_gather`` of the lcp
  array + fully local sparse-table queries on the own slice;
* the canonical 2-key sort -> the block-bitonic pair sort
  (:func:`dsort.net_sort_pairs`, key = start*(N+1)+end packed int64);
* the "first sorted member of each (start, end) group" representative —
  which the replicated program gets from sort STABILITY — is recovered
  under the unstable-tie distributed sort as the SEGMENTED MIN of the
  original indices (identical value: stability makes the head the min
  index), via a reset-min scan with cross-shard carries;
* the representative / has-child scatters -> transient gathers + masked
  own-slice scatters.

Exactness: every reformulation is value-identical, so the front's
(collected, start, end) — and therefore the final block set — is
bit-identical to the replicated program (tests/test_collect_sharded.py).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from jax import shard_map as _shard_map

from jax.sharding import Mesh, PartitionSpec as P

from ..index import engine
from . import dsort

_PROGRAMS: dict = {}


def _gcummax(x, D, me):
    loc = jax.lax.cummax(x)
    if D == 1:
        return loc
    lasts = jax.lax.all_gather(loc[-1], "x")
    lo = jnp.min(jnp.array(np.iinfo(np.int32).min, x.dtype))
    carry = jnp.max(
        jnp.where(jnp.arange(D, dtype=jnp.int32) < me, lasts, lo)
    )
    return jnp.maximum(loc, carry)


def _gcummin_rev(x, D, me):
    loc = jax.lax.cummin(x, reverse=True)
    if D == 1:
        return loc
    firsts = jax.lax.all_gather(loc[0], "x")
    hi = jnp.max(jnp.array(np.iinfo(np.int32).max, x.dtype))
    carry = jnp.min(
        jnp.where(jnp.arange(D, dtype=jnp.int32) > me, firsts, hi)
    )
    return jnp.minimum(loc, carry)


def _seg_reset_min(head, val, D, me):
    """Forward segmented min: out[i] = min(val[j] for j in
    [segment_head(i), i]), segments delimited by ``head`` flags, across
    shard boundaries."""

    def comb(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb, vb, jnp.minimum(va, vb))

    f, v = jax.lax.associative_scan(comb, (head, val))
    if D == 1:
        return v
    summaries = (
        jax.lax.all_gather(f[-1], "x"),
        jax.lax.all_gather(v[-1], "x"),
    )
    BIG = jnp.int32(np.iinfo(np.int32).max)
    cf, cv = jnp.bool_(False), BIG
    # fold the shard summaries strictly before me (D is small/static)
    for j in range(D - 1):
        take = jnp.int32(j) < me
        sf = summaries[0][j]
        sv = summaries[1][j]
        nf, nv = comb((cf, cv), (sf, sv))
        cf = jnp.where(take, nf, cf)
        cv = jnp.where(take, nv, cv)
    return jnp.where(f, v, jnp.minimum(cv, v))


def _scatter_own_slice_set(dest_full, val_full, S, me, init):
    d = dest_full - me * S
    d = jnp.where((d >= 0) & (d < S), d, S)
    return jnp.full(S, init, val_full.dtype).at[d].set(
        val_full, mode="drop"
    )


def collect_front_program(mesh: Mesh, *, k: int, n_max: int, tdeep: int):
    """Build (and cache) the shard_map front for (k, n_max, tdeep)."""
    key = (id(mesh), k, n_max, tdeep)
    prog = _PROGRAMS.get(key)
    if prog is not None:
        return prog
    D = int(np.prod(mesh.devices.shape))
    N = k * n_max
    S = N // D
    N2 = jnp.int64(N + 1)
    PACK_W = engine.PACK_W

    def body(order_l, lcp_l, lengths):
        me = jax.lax.axis_index("x")
        gidx = (me * S + jnp.arange(S)).astype(jnp.int32)
        BIGN = jnp.int32(N)
        n_of_of = jnp.maximum(lengths, 1)
        seq_sorted = order_l // jnp.int32(n_max)
        pos_sorted = order_l % jnp.int32(n_max)
        valid_s = pos_sorted < n_of_of[seq_sorted]

        # ---- PSV/NSV threshold passes (carried scans) ----
        psv = jnp.full(S, -1, jnp.int32)
        nsv = jnp.full(S, N, jnp.int32)
        for v in range(1, PACK_W + 1):
            below = lcp_l < v
            rs = _gcummax(jnp.where(below, gidx, -1), D, me)
            ns = _gcummin_rev(jnp.where(below, gidx, BIGN), D, me)
            sel = lcp_l == v
            psv = jnp.where(sel, rs, psv)
            nsv = jnp.where(sel, ns, nsv)

        # ---- deep intervals: transient lcp gather + local sparse table
        lcp_full = (
            jax.lax.all_gather(lcp_l, "x", tiled=True) if D > 1 else lcp_l
        )
        deep = lcp_l > PACK_W
        if tdeep > 0:
            minv = [lcp_full]
            for t in range(tdeep - 1):
                half = 1 << t
                prev = minv[-1]
                shifted = jnp.concatenate(
                    [prev[half:],
                     jnp.full(half, jnp.int32(2**30), jnp.int32)]
                )
                minv.append(jnp.minimum(prev, shifted))
            ln = jnp.zeros(S, jnp.int32)
            for t in range(tdeep - 1, -1, -1):
                j = gidx - ln - jnp.int32(1 << t)
                ok = j >= 0
                mv = minv[t][jnp.maximum(j, 0)]
                grow = ok & (mv >= lcp_l) & deep
                ln = jnp.where(grow, ln + jnp.int32(1 << t), ln)
            psv_deep = gidx - ln - 1
            rn = jnp.zeros(S, jnp.int32)
            for t in range(tdeep - 1, -1, -1):
                j = gidx + rn + 1
                ok = (j + jnp.int32(1 << t) - 1) <= jnp.int32(N - 1)
                mv = minv[t][jnp.minimum(j, N - 1)]
                grow = ok & (mv >= lcp_l) & deep
                rn = jnp.where(grow, rn + jnp.int32(1 << t), rn)
            nsv_deep = gidx + rn + 1
            psv = jnp.where(deep, psv_deep, psv)
            nsv = jnp.where(deep, nsv_deep, nsv)

        start = jnp.maximum(psv, 0)
        end = nsv - 1
        has_node = lcp_l >= 1

        # ---- all-sequences coverage (k carried scans) ----
        L = None
        for s in range(k):
            occ = jnp.where((seq_sorted == s) & valid_s, gidx, -1)
            last = _gcummax(occ, D, me)
            L = last if L is None else jnp.minimum(L, last)
        L_full = jax.lax.all_gather(L, "x", tiled=True) if D > 1 else L
        allseq = has_node & (L_full[end] >= start)

        # ---- canonical representative per (start, end) group ----
        s_key = jnp.where(has_node, start, BIGN)
        e_key = jnp.where(has_node, end, BIGN)
        key64 = s_key.astype(jnp.int64) * N2 + e_key.astype(jnp.int64)
        su, sb = dsort.net_sort_pairs(key64, gidx, "x", D)
        if D > 1:
            left_last = jax.lax.ppermute(
                su[-1:], "x", [(i, i + 1) for i in range(D - 1)]
            )
        else:
            left_last = su[-1:] * 0 - 1
        prev = jnp.concatenate([left_last, su[:-1]])
        head = su != prev
        head = jnp.where(gidx == 0, True, head)
        # stable-sort head == min original index of the group: recover
        # it under the unstable-tie distributed sort as a segmented min
        ffwd = _seg_reset_min(head, sb, D, me)
        a = jnp.where(head, gidx, BIGN)
        locr = _gcummin_rev(a, D, me)
        if D > 1:
            right_first = jax.lax.ppermute(
                locr[:1], "x", [(i + 1, i) for i in range(D - 1)]
            )
            right_first = jnp.where(me == D - 1, BIGN, right_first)
        else:
            right_first = jnp.full(1, N, jnp.int32)
        nxt = jnp.concatenate([locr[1:], right_first])
        ffwd_full = (
            jax.lax.all_gather(ffwd, "x", tiled=True) if D > 1 else ffwd
        )
        canon_sorted = ffwd_full[jnp.clip(nxt - 1, 0, N - 1)]
        sb_full = jax.lax.all_gather(sb, "x", tiled=True) if D > 1 else sb
        cs_full = (
            jax.lax.all_gather(canon_sorted, "x", tiled=True)
            if D > 1 else canon_sorted
        )
        canon_l = _scatter_own_slice_set(sb_full, cs_full, S, me, 0)
        is_canon = has_node & (canon_l == gidx)

        # ---- deepest: mark parents of all-seq canonical nodes ----
        lcp_ext = jnp.concatenate([lcp_full, jnp.zeros(1, jnp.int32)])
        left_d = lcp_ext[start]
        right_d = lcp_ext[jnp.minimum(end + 1, N)]
        parent_bound = jnp.where(left_d >= right_d, start, end + 1)
        parent_d = jnp.maximum(left_d, right_d)
        has_parent = is_canon & allseq & (parent_d >= 1)
        canon_full = (
            jax.lax.all_gather(canon_l, "x", tiled=True)
            if D > 1 else canon_l
        )
        pb = jnp.where(has_parent, jnp.minimum(parent_bound, N - 1), 0)
        parent_canon = canon_full[pb]
        hp_full = (
            jax.lax.all_gather(has_parent, "x", tiled=True)
            if D > 1 else has_parent
        )
        pc_full = (
            jax.lax.all_gather(parent_canon, "x", tiled=True)
            if D > 1 else parent_canon
        )
        dests = jnp.where(hp_full, pc_full, -1) - me * S
        dests = jnp.where((dests >= 0) & (dests < S), dests, S)
        haschild = (
            jnp.zeros(S, jnp.int32)
            .at[dests]
            .max(hp_full.astype(jnp.int32), mode="drop")
            .astype(bool)
        )
        collected = is_canon & allseq & ~haschild
        return collected, start, end

    sp = P("x")
    prog = jax.jit(
        _shard_map(
            body, mesh=mesh, in_specs=(sp, sp, P()),
            out_specs=(sp, sp, sp),
        )
    )
    _PROGRAMS[key] = prog
    return prog
