"""Shard-local prefix-doubling ladder (the scalable sharded index build).

``engine._device_build`` under a mesh leaves the sorts to the GSPMD
partitioner, which REPLICATES them (measured attribution in
``parallel/dsort.py``), so per-device work never shrinks.  This module
re-plumbs the build's hot stages onto the block-bitonic distributed
sort:

* level-0 / refine sorts -> :func:`dsort.net_sort_pairs` inside a
  ``shard_map`` (local ``S log S`` sort + log^2 D merge-split stages of
  whole-block ``ppermute`` exchanges);
* group statistics (Larsson-Sadakane rank starts, tie counts, max group
  size) -> local scans with cross-shard carries (one ``all_gather`` of
  D scalars per scan) + ``psum``/``pmax`` reductions;
* the rank scatter ``rank[order] = start`` -> ONE MORE distributed pair
  sort keyed by the (unique) permutation values — sorting (order, start)
  by order IS the scatter, redistributed to natural sharding;
* the per-level doubling gather ``rank[(pos+h) % n]`` -> transient
  ``all_gather`` of the rank array (O(N) neighbor traffic per level —
  device-to-device on real meshes) + purely local gathers on the own slice;
* the LCP binary descent / packed-key tail -> the same
  transient-gather + local-compute shape, one program per stored level.

Exactness: intermediate sort keys may tie, but ranks are built from
group STARTS, which are tie-order independent; the final level's keys
are unique (the loop exits when every group is a singleton), so the
final suffix order — the only order consumed downstream — is
bit-identical to the single-device engine (tests/test_dsort_ladder.py,
plus the sharded cascade parity run in parallel/scaling.py).

The collect/filter cascade (``engine._collect_pack``) still runs
replicated — it is ~15% of the single-device wall; re-plumbing it is
tracked as the remaining sharding step.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from jax import shard_map as _shard_map

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..index import engine
from . import dsort

_PROGRAMS: dict = {}


def _flat_mesh(mesh) -> Mesh:
    return Mesh(np.asarray(mesh.devices).reshape(-1), ("x",))


_REP_PROGRAMS: dict = {}


def _replicate_program(mesh: Mesh):
    """jit that reshards a mesh array to fully replicated (an in-program
    all_gather — works across processes, unlike host-side np.asarray of
    a non-addressable sharded array)."""
    prog = _REP_PROGRAMS.get(id(mesh))
    if prog is None:
        rep = NamedSharding(mesh, P())
        prog = jax.jit(lambda x: jax.lax.with_sharding_constraint(x, rep))
        _REP_PROGRAMS[id(mesh)] = prog
    return prog


def _stats_and_rank(su, sg, *, D: int, S: int, N: int):
    """Group stats of the sorted keys + the rank rebuild, shard-local.

    su/sg: local (S,) shards of the globally sorted (key, g) pairs.
    Returns (rank shard in natural g order, order shard, num_tied,
    max_group) — the exact ``engine._group_stats`` semantics.
    """
    me = jax.lax.axis_index("x")
    gidx = (me * S + jnp.arange(S)).astype(jnp.int32)
    if D > 1:
        left_last = jax.lax.ppermute(
            su[-1:], "x", [(i, i + 1) for i in range(D - 1)]
        )
    else:
        left_last = su[-1:] * 0
    prev = jnp.concatenate([left_last, su[:-1]])
    newgrp = su != prev
    newgrp = jnp.where(gidx == 0, True, newgrp)

    x = jnp.where(newgrp, gidx, 0)
    loc = jax.lax.cummax(x)
    if D > 1:
        lasts = jax.lax.all_gather(loc[-1], "x")                  # (D,)
        carry = jnp.max(
            jnp.where(jnp.arange(D, dtype=jnp.int32) < me, lasts, 0)
        )
        start_idx = jnp.maximum(loc, carry)
    else:
        start_idx = loc

    a = jnp.where(newgrp, gidx, jnp.int32(N))
    locr = jax.lax.cummin(a, reverse=True)
    if D > 1:
        firsts = jax.lax.all_gather(locr[0], "x")
        carry_r = jnp.min(
            jnp.where(
                jnp.arange(D, dtype=jnp.int32) > me, firsts, jnp.int32(N)
            )
        )
        cmr = jnp.minimum(locr, carry_r)
        right_first = jax.lax.ppermute(
            cmr[:1], "x", [(i + 1, i) for i in range(D - 1)]
        )
        right_first = jnp.where(me == D - 1, jnp.int32(N), right_first)
    else:
        cmr = locr
        right_first = jnp.full(1, N, jnp.int32)
    nxt = jnp.concatenate([cmr[1:], right_first])
    size = nxt - start_idx
    num_tied = jax.lax.psum(jnp.sum((size > 1).astype(jnp.int32)), "x")
    max_group = jax.lax.pmax(jnp.max(size), "x")

    # rank[g] = start_idx at g's sorted position.  Instead of a second
    # distributed sort keyed by g, gather both arrays (O(N) neighbor
    # traffic, device-to-device) and let each shard scatter ONLY the entries
    # that land in its own slice — out-of-slice destinations are pushed
    # positively out of bounds and dropped.
    if D > 1:
        sg_full = jax.lax.all_gather(sg, "x", tiled=True)
        start_full = jax.lax.all_gather(start_idx, "x", tiled=True)
    else:
        sg_full = sg
        start_full = start_idx
    dest = sg_full - me * S
    dest = jnp.where((dest >= 0) & (dest < S), dest, S)
    rank_l = jnp.zeros(S, jnp.int32).at[dest].set(
        start_full, mode="drop"
    )
    return rank_l, sg, num_tied, max_group


def _seq_geometry(gidx, lengths, n_max: int):
    seq = gidx // jnp.int32(n_max)
    base = seq * jnp.int32(n_max)
    pos = gidx - base
    n_of = jnp.maximum(lengths, 1)[seq]
    return base, pos, n_of


def _ladder_programs(mesh: Mesh, k: int, n_max: int):
    """Build (and cache) the shard_map level programs for (k, n_max)."""
    key = (id(mesh), k, n_max)
    progs = _PROGRAMS.get(key)
    if progs is not None:
        return progs
    D = int(np.prod(mesh.devices.shape))
    N = k * n_max
    S = N // D
    N2 = jnp.int64(1 << (max(N, 2) - 1).bit_length())

    def level0(packed_l, lengths):
        me = jax.lax.axis_index("x")
        gidx = (me * S + jnp.arange(S)).astype(jnp.int32)
        _, pos, n_of = _seq_geometry(gidx, lengths, n_max)
        valid = pos < n_of
        keyv = jnp.where(
            valid,
            packed_l.astype(jnp.int64),
            jnp.int64(engine._SENT0) + gidx.astype(jnp.int64),
        )
        su, sg = dsort.net_sort_pairs(keyv, gidx, "x", D)
        return _stats_and_rank(su, sg, D=D, S=S, N=N)

    def refine(rank_l, lengths, h):
        me = jax.lax.axis_index("x")
        gidx = (me * S + jnp.arange(S)).astype(jnp.int32)
        base, pos, n_of = _seq_geometry(gidx, lengths, n_max)
        rank_full = jax.lax.all_gather(rank_l, "x", tiled=True)
        r2 = rank_full[base + (pos + h) % n_of]
        keyv = rank_l.astype(jnp.int64) * N2 + r2.astype(jnp.int64)
        su, sg = dsort.net_sort_pairs(keyv, gidx, "x", D)
        return _stats_and_rank(su, sg, D=D, S=S, N=N)

    def lcp_prep(order_l, lengths):
        """Adjacent sorted pairs (a, b) + their sequence lengths; the
        final global position's pair is a masked dummy."""
        me = jax.lax.axis_index("x")
        gidx = (me * S + jnp.arange(S)).astype(jnp.int32)
        if D > 1:
            right_first = jax.lax.ppermute(
                order_l[:1], "x", [(i + 1, i) for i in range(D - 1)]
            )
        else:
            right_first = order_l[:1]
        b = jnp.concatenate([order_l[1:], right_first])
        a = order_l
        _, _, n_a = _seq_geometry(a, lengths, n_max)
        _, _, n_b = _seq_geometry(b, lengths, n_max)
        is_pair = gidx < jnp.int32(N - 1)
        return a, b, n_a, n_b, is_pair

    def lcp_step(off_l, rank_l, a, b, n_a, n_b, is_pair, h):
        rank_full = jax.lax.all_gather(rank_l, "x", tiled=True)
        base_a = (a // jnp.int32(n_max)) * jnp.int32(n_max)
        base_b = (b // jnp.int32(n_max)) * jnp.int32(n_max)
        ga = base_a + (a - base_a + off_l) % n_a
        gb = base_b + (b - base_b + off_l) % n_b
        eq = (rank_full[ga] == rank_full[gb]) & is_pair
        return jnp.where(eq, off_l + h, off_l)

    def lcp_tail(off_l, packed_full, a, b, n_a, n_b, is_pair, lengths):
        """Digit-compare tail + assembly of the final (N,) lcp shard:
        lcp[i] = min(raw_pair(i-1), cap(i-1)); the pair values shift one
        position right across the shard boundary (left halo)."""
        base_a = (a // jnp.int32(n_max)) * jnp.int32(n_max)
        base_b = (b // jnp.int32(n_max)) * jnp.int32(n_max)
        ka = packed_full[base_a + (a - base_a + off_l) % n_a]
        kb = packed_full[base_b + (b - base_b + off_l) % n_b]
        still = jnp.ones(off_l.shape, bool)
        run = jnp.zeros(off_l.shape, jnp.int32)
        for i in range(engine.PACK_W):
            sh = jnp.int32(engine._ALPHA ** (engine.PACK_W - 1 - i))
            still = still & (
                (ka // sh) % engine._ALPHA == (kb // sh) % engine._ALPHA
            )
            run = run + still.astype(jnp.int32)
        _, pos_a, n_of_a = _seq_geometry(a, lengths, n_max)
        _, pos_b, n_of_b = _seq_geometry(b, lengths, n_max)
        valid_pair = (pos_a < n_of_a) & (pos_b < n_of_b) & is_pair
        raw_pair = jnp.where(valid_pair, off_l + run, 0)
        lcp_pair = jnp.minimum(raw_pair, jnp.minimum(n_a, n_b))
        lcp_pair = jnp.where(is_pair, lcp_pair, 0)
        me = jax.lax.axis_index("x")
        if D > 1:
            left_last = jax.lax.ppermute(
                lcp_pair[-1:], "x", [(i, i + 1) for i in range(D - 1)]
            )
        else:
            left_last = lcp_pair[-1:] * 0
        lcp_l = jnp.concatenate([left_last, lcp_pair[:-1]])
        gidx = (me * S + jnp.arange(S)).astype(jnp.int32)
        lcp_l = jnp.where(gidx == 0, 0, lcp_l)
        return lcp_l

    sp = P("x")
    rep = P()

    def wrap(fn, in_specs, out_specs):
        return jax.jit(
            _shard_map(
                fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            )
        )

    progs = {
        "level0": wrap(level0, (sp, rep), (sp, sp, rep, rep)),
        "refine": wrap(refine, (sp, rep, rep), (sp, sp, rep, rep)),
        "lcp_prep": wrap(lcp_prep, (sp, rep), (sp,) * 5),
        "lcp_step": wrap(lcp_step, (sp, sp) + (sp,) * 5 + (rep,), sp),
        "lcp_tail": wrap(lcp_tail, (sp, rep) + (sp,) * 5 + (rep,), sp),
    }
    _PROGRAMS[key] = progs
    return progs


def _sync(x):
    """Drain the dispatch queue at a stage boundary — only while the
    profiler is on, so production keeps full async pipelining."""
    from ..utils.profiling import PROFILER

    if PROFILER.enabled:
        jax.block_until_ready(x)
    return x


def device_build_dsort(encoded, mesh):
    """Drop-in for ``engine._device_build(encoded, mesh=...)`` with the
    shard-local ladder; same return contract."""
    from ..utils.profiling import PROFILER

    fmesh = _flat_mesh(mesh)
    D = int(np.prod(fmesh.devices.shape))
    k = len(encoded)
    sizes = np.array([len(e) for e in encoded], dtype=np.int32)
    n_max = engine._bucket(int(sizes.max()))
    # N must split evenly over the flat axis
    n_max = -(-n_max // D) * D
    N = k * n_max
    codes = np.zeros((k, n_max), dtype=np.int8)
    for i, e in enumerate(encoded):
        codes[i, : len(e)] = e

    from . import sharded as _sharded

    rep_prog = _replicate_program(fmesh)
    with jax.enable_x64():
        progs = _ladder_programs(fmesh, k, n_max)
        sh = NamedSharding(fmesh, P("x"))
        rep = NamedSharding(fmesh, P())
        # put_global handles multi-process meshes (each process builds
        # only its addressable shards), so the ladder also serves the
        # N-host launch — a process-crossing distributed sort
        with PROFILER.phase("idx.pack"):
            jc = _sharded.put_global(codes, NamedSharding(fmesh, P(None)))
            js = _sharded.put_global(sizes, rep)
            packed = engine._pack_keys_program(jc, js, k=k, n_max=n_max)
            shard_x = _REP_PROGRAMS.setdefault(
                ("x", id(fmesh)),
                jax.jit(lambda x: jax.lax.with_sharding_constraint(x, sh)),
            )
            packed = _sync(shard_x(packed))

        with PROFILER.phase("idx.l0_sort"):
            rank, order, nt, mg = progs["level0"](packed, js)
            ranks = [rank]
            mg0 = int(mg)
            ntv = int(nt)
            _sync(rank)
        t = 0
        with PROFILER.phase("idx.refine"):
            while ntv > 0 and (engine.PACK_W << t) < n_max:
                rank, order, nt, _mg = progs["refine"](
                    rank, js, jnp.int32(engine.PACK_W << t)
                )
                ranks.append(rank)
                ntv = int(nt)
                t += 1
            _sync(rank)
        if ntv > 0:
            rfull = rep_prog(rank)
            ofull = rep_prog(order)
            if bool(
                engine._dup_check_program(ofull, rfull, js, k=k, n_max=n_max)
            ):
                return None, None

        with PROFILER.phase("idx.lcp"):
            a, b, n_a, n_b, is_pair = progs["lcp_prep"](order, js)
            off = _sharded.put_global(np.zeros(N, np.int32), sh)
            for tt in range(len(ranks) - 1, -1, -1):
                off = progs["lcp_step"](
                    off, ranks[tt], a, b, n_a, n_b, is_pair,
                    jnp.int32(engine.PACK_W << tt),
                )
            packed_rep = rep_prog(packed)
            lcp = progs["lcp_tail"](
                off, packed_rep, a, b, n_a, n_b, is_pair, js
            )
            _sync(lcp)

    # replicated views for the (still single-logical-device) collect
    # cascade — an in-jit resharding (all_gather), valid cross-process
    with PROFILER.phase("idx.replicate"):
        order_r = rep_prog(order)
        lcp_r = _sync(rep_prog(lcp))
    return (order_r, lcp_r, js), (k, n_max, mg0)
