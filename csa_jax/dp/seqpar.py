"""Sequence-parallel profile-DP wavefront with neighbor halo exchange.

SURVEY.md §5's long-context component: for ONE giant inter-anchor gap
(Set3's ~17k x 28k merges are the motivating case) the profile-NW fill is
distributed over a 1D ``("col",)`` device mesh by splitting the COLUMN
axis, with the DP wavefront's halo column exchanged between neighboring
devices — the only custom communication in the framework
(alignment.c:179-208 is per-gap independent; THIS path parallelizes
inside one gap).

Pipelined wavefront: rows are processed in bands of ``band_rows``; in
superstep ``s`` device ``d`` processes band ``s - d``, so after a fill
latency of ``D - 1`` supersteps all devices work concurrently.  After
each band a device sends the (band_rows,) vector of its right-edge DP
values to its right neighbor via ``jax.lax.ppermute`` — an XLA collective
(NCCL on a GPU mesh; the virtual CPU mesh in the tests).

Exactness: the in-row left-gap chain
``cur[c] = max(m1[c], cur[c-1] + cg[c])`` is a max-plus prefix scan;
seeding the local scan with the neighbor's boundary value reproduces the
global chain EXACTLY (integer max/plus, no reassociation error), so the
direction matrix is bit-identical to the single-device row scan
(tests/test_seqpar.py).  The carried row state ``prev_ext`` keeps the
left-halo element at index 0 — each row's boundary seed becomes the next
row's diagonal operand with no extra bookkeeping.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..align.progressive import D_DIAG, D_LEFT, D_UP, GAP
from ..config import Scoring, scoring as _current_scoring
from .wavefront import _base_counts

_PROGRAMS: dict = {}


def _seqpar_program(mesh, R: int, C: int, D: int, Rb: int, sc: Scoring):
    """Build (and cache) the shard_map fill program for padded shape
    (R, C) over a D-device mesh with band_rows=Rb.  R % Rb == 0,
    C % D == 0."""
    from jax.sharding import PartitionSpec as P

    key = (id(mesh), R, C, D, Rb, sc)
    prog = _PROGRAMS.get(key)
    if prog is not None:
        return prog

    Cs = C // D
    nb = R // Rb
    nsteps = nb + D - 1

    def body(codes, sv_loc, top, i, edge_rowgap):
        d = jax.lax.axis_index("col")
        sv_loc = sv_loc.astype(jnp.int32)
        cnt = _base_counts(codes, sv_loc)                        # (R, Cs)
        svg = sv_loc[:, GAP]
        sub = (sc.match * cnt + sc.indel * svg[None, :]
               + sc.mismatch * (i - cnt - svg[None, :]))
        rowgap = sc.indel * i
        cg = sc.doublegap * svg + sc.indel * (i - svg)           # (Cs,)
        S = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), jnp.cumsum(cg, dtype=jnp.int32)]
        )                                                        # (Cs+1,)

        # prev_ext covers global columns [d*Cs .. (d+1)*Cs]: the left-halo
        # element at index 0, then the Cs local columns
        c0 = d * jnp.int32(Cs)
        prev_ext0 = jax.lax.dynamic_slice(top, (c0,), (Cs + 1,))

        sub_bands = sub.reshape(nb, Rb, Cs)

        def superstep(carry, s):
            prev_ext, halo_in, first = carry
            b = s - d                       # this device's band index
            active = (b >= 0) & (b < nb)
            bb = jnp.clip(b, 0, nb - 1)
            sub_band = sub_bands[bb]

            def row_step(carry_r, r):
                prev_ext = carry_r
                j = bb * jnp.int32(Rb) + r + 1   # global DP row
                # left boundary cur[j][d*Cs]: device 0 owns the global
                # column-0 edge; others take the neighbor's halo
                B = jnp.where(
                    d == 0,
                    (j * edge_rowgap).astype(jnp.int32),
                    halo_in[r],
                )
                diag = prev_ext[:-1] + sub_band[r]
                up = prev_ext[1:] + rowgap
                dwin = diag >= up
                m1 = jnp.where(dwin, diag, up)
                d1 = jnp.where(dwin, jnp.int8(D_DIAG), jnp.int8(D_UP))
                t = jnp.concatenate([B[None], m1 - S[1:]])
                cur = jax.lax.cummax(t) + S      # (Cs+1,); cur[0] == B
                left = cur[:-1] + cg
                take_left = (left > m1) | ((left == m1) & (d1 == D_UP))
                dirs_row = jnp.where(take_left, jnp.int8(D_LEFT), d1)
                return cur, (dirs_row, cur[-1])

            prev_in = jnp.where(first & (b == 0), prev_ext0, prev_ext)
            prev_out, (dirs_band, halo_out) = jax.lax.scan(
                row_step, prev_in, jnp.arange(Rb, dtype=jnp.int32)
            )
            prev_ext = jnp.where(active, prev_out, prev_ext)
            halo_out = jnp.where(active, halo_out, halo_in * 0)
            # send right-edge values to the right neighbor for the band
            # they will process next superstep
            halo_next = jax.lax.ppermute(
                halo_out, "col", [(t, t + 1) for t in range(D - 1)]
            )
            first = first & ~active
            return (prev_ext, halo_next, first), jnp.where(
                active, dirs_band, jnp.int8(0)
            )

        # carry constants seeded varying over the mesh axis (halo from
        # axis_index, flag from a varying comparison) so the static
        # varying-axes checker passes without check_vma=False
        carry0 = (
            prev_ext0,
            jnp.zeros(Rb, jnp.int32) + d * jnp.int32(0),
            d == d,
        )
        _, ys = jax.lax.scan(
            superstep, carry0, jnp.arange(nsteps, dtype=jnp.int32)
        )                                          # (nsteps, Rb, Cs)
        # device d's band b lives at superstep b + d
        dirs_loc = jnp.take(
            ys, d + jnp.arange(nb, dtype=jnp.int32), axis=0
        ).reshape(R, Cs)
        return dirs_loc

    prog = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P(), P("col", None), P(), P(), P()),
            out_specs=P(None, "col"),
        )
    )
    _PROGRAMS[key] = prog
    return prog


def _seqpar_path_program(mesh, R: int, C: int, D: int, Rb: int, sc: Scoring):
    """Fill + ON-DEVICE backtrack: the sharded direction matrix is
    gathered across the mesh (a device collective, never the host link)
    and walked by a chunked ``while_loop``; only the O(R+C) path codes
    reach the host."""
    from ..dp.wavefront import BT_UNROLL

    key = ("path", id(mesh), R, C, D, Rb, sc)
    prog = _PROGRAMS.get(key)
    if prog is not None:
        return prog

    fill = _seqpar_program(mesh, R, C, D, Rb, sc)

    def walk(codes, sv, top, i, edge_rowgap, r_real, c_real):
        dirs = fill(codes, sv, top, i, edge_rowgap)      # (R, C) sharded
        # replicate once (all_gather over the mesh) so the serial walk
        # below is shard-local
        dirs = jax.lax.with_sharding_constraint(
            dirs,
            jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec()
            ),
        )
        L = R + C

        def cond(state):
            j, c, t, path = state
            return (j > 0) | (c > 0)

        def body(state):
            j, c, t, path = state
            for _ in range(BT_UNROLL):
                active = (j > 0) | (c > 0)
                inmain = (j > 0) & (c > 0)
                dmain = dirs[jnp.maximum(j - 1, 0), jnp.maximum(c - 1, 0)]
                dcode = jnp.where(
                    inmain,
                    dmain,
                    jnp.where(j > 0, jnp.int8(D_UP), jnp.int8(D_LEFT)),
                )
                path = path.at[jnp.clip(t, 0, L - 1)].set(dcode)
                j = jnp.where(active & (dcode != D_LEFT), j - 1, j)
                c = jnp.where(active & (dcode != D_UP), c - 1, c)
                t = jnp.where(active, t + 1, t)
            return (j, c, t, path)

        path0 = jnp.zeros(L, jnp.int8)
        _, _, nsteps, path = jax.lax.while_loop(
            cond, body, (r_real, c_real, jnp.int32(0), path0)
        )
        return path, nsteps

    prog = jax.jit(walk)
    _PROGRAMS[key] = prog
    return prog


def _pad_for_mesh(row_codes, scorevector, top_row, D: int, band_rows: int):
    R = len(row_codes)
    C = len(scorevector)
    Rb = band_rows
    Rp = max(Rb, -(-R // Rb) * Rb)
    Cp = max(D, -(-C // D) * D)
    if (Cp // D) % 128 and Cp >= 128 * D:
        Cp = -(-Cp // (128 * D)) * (128 * D)
    codes = np.zeros(Rp, dtype=np.int8)
    codes[:R] = row_codes
    sv = np.zeros((Cp, 5), dtype=np.int8)
    sv[:C] = scorevector
    top = np.zeros(Cp + 1, dtype=np.int32)
    top[: C + 1] = top_row[: C + 1]
    return codes, sv, top, R, C, Rp, Cp, Rb


def dp_path_seqpar(
    row_codes: np.ndarray,
    scorevector: np.ndarray,
    i: int,
    mesh=None,
    *,
    band_rows: int = 64,
    top_row=None,
    edge_rowgap=None,
) -> np.ndarray:
    """Column-sharded fill + device backtrack for ONE giant gap merge.

    The production mesh path for the "giant" merges that
    ``progressive_dp_batched`` peels off its padded batches (Set3's
    ~17k x 28k profile merges); returns the walk-order direction codes
    that ``progressive.merge_from_path`` consumes — bit-identical to
    every other backend (tests/test_seqpar.py).
    """
    from jax.sharding import Mesh

    from ..align.progressive import default_top_row

    if mesh is None:
        mesh = Mesh(np.asarray(jax.devices()), ("col",))
    elif tuple(mesh.axis_names) != ("col",):
        # re-lay the same devices as a 1D column mesh
        mesh = Mesh(mesh.devices.reshape(-1), ("col",))
    D = int(np.prod(mesh.devices.shape))
    from .wavefront import _on_gpu, dp_path_device

    if D == 1 and _on_gpu(mesh):
        # a 1-device "mesh" has no halo to exchange: the single-device
        # CUDA fill covers the whole matrix
        return dp_path_device(
            row_codes, scorevector, i, top_row=top_row,
            edge_rowgap=edge_rowgap,
        )
    if top_row is None:
        top_row = default_top_row(scorevector, i)
    sc = _current_scoring()
    if edge_rowgap is None:
        edge_rowgap = sc.indel * i
    codes, sv, top, R, C, Rp, Cp, Rb = _pad_for_mesh(
        row_codes, scorevector, top_row, D, band_rows
    )
    prog = _seqpar_path_program(mesh, Rp, Cp, D, Rb, sc)
    path, nsteps = prog(
        jnp.asarray(codes), jnp.asarray(sv), jnp.asarray(top),
        jnp.int32(i), jnp.int32(edge_rowgap), jnp.int32(R), jnp.int32(C),
    )
    n = int(nsteps)
    return np.asarray(path)[:n]


def dp_fill_seqpar(
    row_codes: np.ndarray,
    scorevector: np.ndarray,
    i: int,
    mesh=None,
    *,
    band_rows: int = 64,
    top_row=None,
    edge_rowgap=None,
):
    """Column-sharded profile-NW fill; bit-identical direction matrix to
    :func:`csa_jax.dp.wavefront.dp_fill_device` / the numpy ``dp_fill``.

    ``mesh``: a 1D ``("col",)`` device mesh (defaults to all devices).
    """
    from jax.sharding import Mesh

    from ..align.progressive import default_top_row

    if mesh is None:
        mesh = Mesh(np.asarray(jax.devices()), ("col",))
    D = int(np.prod(mesh.devices.shape))
    if top_row is None:
        top_row = default_top_row(scorevector, i)
    sc = _current_scoring()
    if edge_rowgap is None:
        edge_rowgap = sc.indel * i

    R = len(row_codes)
    C = len(scorevector)
    Rb = band_rows
    Rp = max(Rb, -(-R // Rb) * Rb)
    Cp = max(D, -(-C // D) * D)
    # keep local shards lane-aligned where possible
    if (Cp // D) % 128 and Cp >= 128 * D:
        Cp = -(-Cp // (128 * D)) * (128 * D)
    codes = np.zeros(Rp, dtype=np.int8)
    codes[:R] = row_codes
    sv = np.zeros((Cp, 5), dtype=np.int8)
    sv[:C] = scorevector
    top = np.zeros(Cp + 1, dtype=np.int32)
    top[: C + 1] = top_row[: C + 1]

    prog = _seqpar_program(mesh, Rp, Cp, D, Rb, sc)
    dev = np.asarray(
        prog(
            jnp.asarray(codes),
            jnp.asarray(sv),
            jnp.asarray(top),
            jnp.int32(i),
            jnp.int32(edge_rowgap),
        )
    )
    dirs = np.zeros((R + 1, C + 1), dtype=np.int8)
    dirs[1:, 1:] = dev[:R, :C]
    dirs[:, 0] = D_UP
    dirs[0, 1:] = D_LEFT
    dirs[0, 0] = D_DIAG
    return dirs
