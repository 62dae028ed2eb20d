"""Device row-scan for the progressive profile NW fill.

The reference's DP inner loop (``dynamicprogramming.c:990-1029``) is a
row-major O(rows x cols) scan whose only serial dependence inside a row is
the left-gap chain ``cur[c] = max(m1[c], cur[c-1] + cg[c])``.  That chain
is a max-plus prefix scan with the closed form

    cur[c] = S[c] + max(cur0, max_{1<=j<=c} (m1[j] - S[j])),   S = cumsum(cg)

so each row becomes a handful of full-width vector ops plus one
``lax.cummax`` — no anti-diagonal skew, no per-diagonal gathers.  Rows are
processed in unrolled chunks of :data:`ROW_UNROLL` under a single
``lax.scan`` to amortize loop-step overhead; the substitution counts are
one gather of the profile by row code.  Integer arithmetic matches the
host engine bit for bit, so the alignment output is backend-independent
(tests/test_dp_wavefront.py).

This row scan is the device DP on every platform but the GPU, where the
CUDA fill of :mod:`csa_jax.dp.profile_cuda` replaces it (the choice is
made from ``jax.default_backend()``).

Two consumers:

* :func:`dp_fill_device` — returns the full direction matrix (int8) for
  host backtracking; used by exactness tests.
* :func:`dp_path_device` — the production path (``--backend jax``): the
  direction matrix STAYS in device memory and a chunked ``while_loop``
  backtrack walks it on the device, so only the O(R+C) path codes reach
  the host (the direction matrix itself is O(R*C) — tens of MB for the
  large inter-anchor gaps).

Shapes are bucketed to multiples of :data:`PAD_QUANTUM` so a full
progressive alignment compiles a bounded handful of programs.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..align.progressive import D_DIAG, D_LEFT, D_UP, GAP
from ..config import Scoring, scoring as _current_scoring

ROW_UNROLL = 8       # rows computed per scan step (amortizes step overhead)
BT_UNROLL = 16       # backtrack steps per while_loop iteration
PAD_QUANTUM = 512    # R/C rounded up to multiples of this (bounds recompiles)


def _bucket_dim(x: int) -> int:
    """Size-dependent shape bucket: 512-quantum up to 8k, then 2048 —
    Set3-scale merges (R,C growing past 17k/28k as the consensus
    expands) would otherwise compile a fresh program per merge."""
    q = 512 if x <= 8192 else 2048
    return max(512, -(-x // q) * q)


def _on_gpu(mesh=None) -> bool:
    """True where the CUDA profile fill runs: the platform of the mesh's
    devices, or of the default backend."""
    if mesh is not None:
        return mesh.devices.flat[0].platform == "gpu"
    return jax.default_backend() == "gpu"


def _row_step(prev, sub_row, j, S, cg, rowgap, edge_rowgap):
    """One DP row: prev (C+1,) -> (cur (C+1,), dirs_row (C+1,) int8).

    Bit-exact twin of the host kernel's two inner loops
    (native/csa_host.cpp::csa_dp_fill): diag-vs-up with diag-preferred
    tie-break, then the left chain with left-wins-only-if-strictly-better
    (or equal when m1 came from up).
    """
    diag = prev[:-1] + sub_row                # c = 1..C
    up = prev[1:] + rowgap
    dwin = diag >= up
    m1 = jnp.where(dwin, diag, up)
    d1 = jnp.where(dwin, jnp.int8(D_DIAG), jnp.int8(D_UP))
    cur0 = (j * edge_rowgap).astype(jnp.int32)
    t = jnp.concatenate([cur0[None], m1 - S[1:]])
    cur = jax.lax.cummax(t) + S               # (C+1,)
    left = cur[:-1] + cg
    take_left = (left > m1) | ((left == m1) & (d1 == D_UP))
    dirs_row = jnp.concatenate(
        [jnp.full(1, D_UP, jnp.int8), jnp.where(take_left, jnp.int8(D_LEFT), d1)]
    )
    return cur, dirs_row


def _base_counts(codes, sv):
    """(R, C) count of each row's base in each profile column: a gather
    of the profile's four base rows by row code (codes >= 4 count 0)."""
    rows = jnp.concatenate(
        [sv[:, :4].T, jnp.zeros((1, sv.shape[0]), sv.dtype)]
    )
    return rows[jnp.clip(codes.astype(jnp.int32), 0, 4)]


def _rowscan_dirs(codes, sv, i, top_row, edge_rowgap, *, R: int, C: int,
                  sc: Scoring):
    """codes: (R,) int32; sv: (C, 5) int32; i: () int32;
    top_row: (C+1,) int32 dp[0][*] boundary; edge_rowgap: () int32 scale
    of dp[j][0] (possibly stale, see progressive.dp_fill).

    Returns dirs (R, C+1) int8 where device row j-1 holds dp row j.
    """
    sv = sv.astype(jnp.int32)  # arrives int8 (counts <= 64)
    cnt = _base_counts(codes, sv)                                 # (R, C)
    svg = sv[:, GAP]                                              # (C,)
    sub = (sc.match * cnt + sc.indel * svg[None, :]
           + sc.mismatch * (i - cnt - svg[None, :]))
    rowgap = sc.indel * i
    cg = sc.doublegap * svg + sc.indel * (i - svg)                # (C,)
    S = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(cg, dtype=jnp.int32)])

    nchunk = R // ROW_UNROLL
    sub_chunks = sub.reshape(nchunk, ROW_UNROLL, C)
    j0s = jnp.arange(nchunk, dtype=jnp.int32) * ROW_UNROLL

    def scan_body(prev, xs):
        sub_chunk, j0 = xs
        rows = []
        for u in range(ROW_UNROLL):
            prev, drow = _row_step(
                prev, sub_chunk[u], j0 + (u + 1), S, cg, rowgap, edge_rowgap
            )
            rows.append(drow)
        return prev, jnp.stack(rows)

    _, dirs = jax.lax.scan(scan_body, top_row.astype(jnp.int32), (sub_chunks, j0s))
    return dirs.reshape(R, C + 1)


@functools.partial(jax.jit, static_argnames=("R", "C", "sc"))
def _rowscan_program(codes, sv, i, top_row, edge_rowgap, *, R: int, C: int,
                     sc: Scoring):
    return _rowscan_dirs(codes, sv, i, top_row, edge_rowgap, R=R, C=C, sc=sc)


def _rowscan_path(
    codes, sv, i, top_row, edge_rowgap, r_real, c_real, *, R: int, C: int,
    sc: Scoring
):
    """Fused fill + device backtrack.

    Walks the reference backtrack (dynamicprogramming.c:1032-1138 order:
    main region by direction code, then the remaining j>0 / c>0 edge
    runs) over the device-resident direction matrix in chunks of
    BT_UNROLL data-dependent steps per loop iteration, returning the
    direction codes in walk order (from (R, C) back to (0, 0)) plus the
    step count.  Only this O(R+C) vector is transferred to the host.
    """
    dirs = _rowscan_dirs(codes, sv, i, top_row, edge_rowgap, R=R, C=C, sc=sc)

    L = R + C

    def cond(state):
        j, c, t, path = state
        return (j > 0) | (c > 0)

    def body(state):
        j, c, t, path = state
        for _ in range(BT_UNROLL):
            active = (j > 0) | (c > 0)
            inmain = (j > 0) & (c > 0)
            dcode_main = dirs[jnp.maximum(j - 1, 0), jnp.clip(c, 0, C)]
            dcode = jnp.where(
                inmain,
                dcode_main,
                jnp.where(j > 0, jnp.int8(D_UP), jnp.int8(D_LEFT)),
            )
            # inactive steps write junk at path[t] (t frozen); the host
            # slices path[:nsteps] so it is never observed
            path = path.at[jnp.clip(t, 0, L - 1)].set(dcode)
            j = jnp.where(active & (dcode != D_LEFT), j - 1, j)
            c = jnp.where(active & (dcode != D_UP), c - 1, c)
            t = jnp.where(active, t + 1, t)
        return (j, c, t, path)

    # seed the carry's constants FROM a varying input (t0 = 0, path0 =
    # zeros, but typed varying over the shard_map axis when one is
    # present) so the varying-axes checker passes without check_vma=False
    t0 = r_real * jnp.int32(0)
    path0 = jnp.zeros(L, jnp.int8) + t0.astype(jnp.int8)
    _, _, nsteps, path = jax.lax.while_loop(
        cond, body, (r_real, c_real, t0, path0)
    )
    return path, nsteps


_rowscan_path_program = functools.partial(
    jax.jit, static_argnames=("R", "C", "sc")
)(_rowscan_path)


def _pad_args(row_codes, scorevector, top_row):
    R = len(row_codes)
    C = len(scorevector)
    Rp = _bucket_dim(R)
    Cp = _bucket_dim(C)
    codes = np.zeros(Rp, dtype=np.int8)
    codes[:R] = row_codes
    sv = np.zeros((Cp, 5), dtype=np.int8)
    sv[:C] = scorevector
    top = np.zeros(Cp + 1, dtype=np.int32)
    top[: C + 1] = top_row[: C + 1]
    return codes, sv, top, R, C, Rp, Cp


def dp_fill_device(
    row_codes: np.ndarray,
    scorevector: np.ndarray,
    i: int,
    top_row=None,
    edge_rowgap=None,
):
    """Drop-in device replacement for progressive.dp_fill (dirs only).

    Pads R, C to PAD_QUANTUM buckets to bound recompiles; padded columns
    are to the right of / below every real cell, so they cannot influence
    real results (all DP dependencies point left/up).
    """
    from ..align.progressive import default_top_row

    if top_row is None:
        top_row = default_top_row(scorevector, i)
    sc = _current_scoring()
    if edge_rowgap is None:
        edge_rowgap = sc.indel * i
    codes, sv, top, R, C, Rp, Cp = _pad_args(row_codes, scorevector, top_row)
    dev = np.asarray(
        _rowscan_program(
            jnp.asarray(codes), jnp.asarray(sv), jnp.int32(i),
            jnp.asarray(top), jnp.int32(edge_rowgap), R=Rp, C=Cp, sc=sc
        )
    )
    dirs = np.zeros((R + 1, C + 1), dtype=np.int8)
    dirs[1:, :] = dev[:R, : C + 1]
    dirs[:, 0] = D_UP
    dirs[0, 1:] = D_LEFT
    dirs[0, 0] = D_DIAG
    return dirs


def dp_path_device(
    row_codes: np.ndarray,
    scorevector: np.ndarray,
    i: int,
    top_row=None,
    edge_rowgap=None,
) -> np.ndarray:
    """Device fill + device backtrack; returns the walk-order path codes.

    The direction matrix never leaves the device; the host receives only
    the (<= R+C) int8 path, which `progressive.merge_from_path` consumes.
    On a GPU the fill is the CUDA kernel
    (:func:`csa_jax.dp.profile_cuda.profile_path`); elsewhere the row
    scan below.
    """
    if _on_gpu():
        from .profile_cuda import profile_path

        return profile_path(
            row_codes, scorevector, i, top_row=top_row,
            edge_rowgap=edge_rowgap,
        )
    return dp_path_rowscan(row_codes, scorevector, i, top_row, edge_rowgap)


def dp_path_rowscan(row_codes, scorevector, i: int, top_row=None,
                    edge_rowgap=None) -> np.ndarray:
    """The row-scan fill + device backtrack on any platform (the plain
    reference of the GPU kernel); returns walk-order path codes."""
    from ..align.progressive import default_top_row

    if top_row is None:
        top_row = default_top_row(scorevector, i)
    sc = _current_scoring()
    if edge_rowgap is None:
        edge_rowgap = sc.indel * i
    codes, sv, top, R, C, Rp, Cp = _pad_args(row_codes, scorevector, top_row)
    path, nsteps = _rowscan_path_program(
        jnp.asarray(codes), jnp.asarray(sv), jnp.int32(i),
        jnp.asarray(top), jnp.int32(edge_rowgap),
        jnp.int32(R), jnp.int32(C), R=Rp, C=Cp, sc=sc,
    )
    n = int(nsteps)
    return np.asarray(path)[:n]


def _rowscan_batch(codes, sv, iv, top, erg, rr, cc, *, sc: Scoring):
    """vmap of the fused fill + backtrack over a leading gap axis.

    codes (G, R) int8; sv (G, C, 5); iv/erg/rr/cc (G,) int32;
    top (G, C+1) int32.  Returns (paths (G, R+C) int8, nsteps (G,)).
    """
    R, C = codes.shape[1], sv.shape[1]
    return jax.vmap(
        lambda c_, s_, i_, t_, e_, r_, cc_: _rowscan_path(
            c_, s_, i_, t_, e_, r_, cc_, R=R, C=C, sc=sc
        )
    )(codes, sv, iv, top, erg, rr, cc)


_batched_path_program = functools.partial(
    jax.jit, static_argnames=("sc",)
)(_rowscan_batch)


def _pad_batch(items, g_multiple: int = 1, min_g: int = 8):
    """Pad a list of prepared fills to one bucketed (Gp, Rp, Cp) batch.

    The batch axis is bucketed (powers of two, at least ``min_g``,
    padded with trivial 1x1 instances whose results are dropped) — G
    shrinks as gaps finish their merges, and every distinct G would
    otherwise be a fresh compile; ``g_multiple`` additionally rounds Gp
    up to a multiple of the mesh size for the sharded launch path.
    """
    G = len(items)
    Gp = max(min_g, 1 << (G - 1).bit_length())
    Gp = -(-Gp // g_multiple) * g_multiple
    Rmax = max(len(it[0]) for it in items)
    Cmax = max(len(it[1]) for it in items)
    Rp = _bucket_dim(Rmax)
    Cp = _bucket_dim(Cmax)
    codes = np.zeros((Gp, Rp), dtype=np.int8)
    sv = np.zeros((Gp, Cp, 5), dtype=np.int8)
    top = np.zeros((Gp, Cp + 1), dtype=np.int32)
    iv = np.ones(Gp, dtype=np.int32)
    erg = np.full(Gp, -1, dtype=np.int32)
    rr = np.ones(Gp, dtype=np.int32)
    cc = np.ones(Gp, dtype=np.int32)
    for gdx, (row_codes, svec, i, top_row, e) in enumerate(items):
        R = len(row_codes)
        C = len(svec)
        codes[gdx, :R] = row_codes
        sv[gdx, :C] = svec
        top[gdx, : C + 1] = top_row[: C + 1]
        iv[gdx] = i
        erg[gdx] = e
        rr[gdx] = R
        cc[gdx] = C
    return codes, sv, top, iv, erg, rr, cc, Rp, Cp, Gp


def dp_paths_device_batched(items):
    """Batched device fill + backtrack for MANY independent gap merges.

    ``items``: list of (row_codes, scorevector, i, top_row, edge_rowgap)
    tuples (the output of :meth:`GapProgressiveState.prepare`); pads all
    instances to one bucketed (R, C) and runs a single vmapped program —
    the i-th merges of every inter-anchor gap become ONE launch
    (alignment.c:179-208 independence).  Returns the per-item walk-order
    path codes.  On a GPU the fill is the CUDA kernel
    (:func:`csa_jax.dp.profile_cuda.profile_paths`).
    """
    if _on_gpu():
        from .profile_cuda import profile_paths

        return profile_paths(items)
    return dp_paths_rowscan_batched(items)


def dp_paths_rowscan_batched(items):
    """Batched row-scan fill + device backtrack on any platform."""
    codes, sv, top, iv, erg, rr, cc, *_ = _pad_batch(items)
    out = _batched_path_program(
        *(jnp.asarray(x) for x in (codes, sv, iv, top, erg, rr, cc)),
        sc=_current_scoring(),
    )
    return _split_paths(*out, len(items))


def _split_paths(paths, nsteps, n: int):
    """Host copies of the first ``n`` walk-order paths of a batch."""
    paths = np.asarray(paths)
    nsteps = np.asarray(nsteps)
    return [paths[g, : int(nsteps[g])] for g in range(n)]


_SHARDED_PROGRAMS: dict = {}


def dp_paths_device_sharded(items, mesh=None, *, impl: str | None = None):
    """Mesh-distributed variant of :func:`dp_paths_device_batched`.

    The gap axis is sharded over a 1D ``("gap",)`` device mesh via
    shard_map: each device runs the batched fill + backtrack on its
    local gap shard; there are no cross-shard data dependencies
    (alignment.c:179-208 gap independence), so no collectives are
    emitted.  Results are bit-identical to the single-device batched
    launch (tests/test_sharded_alignment.py).  The per-shard body is the
    CUDA fill on GPU meshes (``impl="cuda"``), the row scan elsewhere
    (``"rowscan"``); ``"reference"`` is the CUDA path's plain-JAX twin.
    """
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ..parallel.sharded import put_global

    if mesh is None:
        mesh = Mesh(np.asarray(jax.devices()), ("gap",))
    elif tuple(mesh.axis_names) != ("gap",):
        mesh = Mesh(mesh.devices.reshape(-1), ("gap",))
    if impl is None:
        impl = "cuda" if _on_gpu(mesh) else "rowscan"
    n_dev = int(np.prod(mesh.devices.shape))
    codes, sv, top, iv, erg, rr, cc, Rp, Cp, _ = _pad_batch(
        items, g_multiple=n_dev
    )
    sc = _current_scoring()
    key = (id(mesh), Rp, Cp, sc, impl)
    prog = _SHARDED_PROGRAMS.get(key)
    if prog is None:
        if impl == "rowscan":
            body = functools.partial(_rowscan_batch, sc=sc)
        else:
            from .profile_cuda import _paths_core

            body = functools.partial(_paths_core, sc=sc, impl=impl)
        gspec = P("gap")
        prog = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(gspec,) * 7,
            out_specs=(gspec, gspec),
        ))
        _SHARDED_PROGRAMS[key] = prog
    shard = NamedSharding(mesh, P("gap"))
    args = [put_global(x, shard) for x in (codes, sv, iv, top, erg, rr, cc)]
    return _split_paths(*_fetch_global(*prog(*args)), len(items))


def _fetch_global(paths, nsteps):
    """Materialize sharded outputs as host arrays; on a multi-process
    mesh the outputs are replicated first (an in-jit resharding — the
    same all-gather pattern dsort_ladder uses cross-process), so every
    process can read the full result locally."""
    import jax as _jax

    if _jax.process_count() > 1:
        from jax.sharding import NamedSharding, PartitionSpec

        mesh = paths.sharding.mesh
        rep = NamedSharding(mesh, PartitionSpec())

        @_jax.jit
        def _rep(a, b):
            return (
                _jax.lax.with_sharding_constraint(a, rep),
                _jax.lax.with_sharding_constraint(b, rep),
            )

        paths, nsteps = _rep(paths, nsteps)
    return np.asarray(paths), np.asarray(nsteps)
