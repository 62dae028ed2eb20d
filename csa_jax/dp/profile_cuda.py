"""GPU profile-DP fill and backtrack (CUDA through the XLA FFI).

The production gap-closing recurrence of ``--backend jax`` on a GPU
(``dynamicprogramming.c:993-1026``: NW of one sequence against the
expanding column-count profile, tie-break diag > left > up), for a batch
of independent gaps (``alignment.c:179-208``).  The fill is the CUDA
kernel in ``cuda/profile_dp.cu``: one warp per (gap, strip of
:data:`STRIP` columns), lanes skewed one row apart so a warp shuffle
carries each row's left neighbour, strips of one gap chained through a
device-memory boundary column.  Directions are stored 2 bits per cell in
the layout

    dirs[g, k, s, t]  (uint16)   k = (c-1) // STRIP,  t = (c-1) // COLS % WARP,
                                 s = j - 1 + t,  bits 2*((c-1) % COLS)

for DP cell (j, c), 1 <= j <= R, 1 <= c <= C.  A second kernel walks that
matrix, one thread per gap, so only the O(R+C) walk-order path codes
reach the host — the contract of ``wavefront._rowscan_path``, whose
consumers are reused unchanged.

The plain-JAX twin of both kernels runs on every platform:
:func:`_fill_reference` (a row scan that writes the same packed layout
from the same per-column channels) and :func:`_backtrack` (an XLA
``while_loop`` walk of that layout).  The CPU tests run the whole path
on the twin (tests/test_pallas_profile.py); the kernels are compiled
with ``nvcc`` on first use (:func:`_library`) and only run on a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess

import numpy as np

import jax
import jax.numpy as jnp

from ..align.progressive import D_LEFT, D_UP, GAP
from ..config import Scoring, scoring as _current_scoring

WARP = 32            # lanes per warp
COLS = 8             # DP columns per lane (one 16-bit direction word)
STRIP = WARP * COLS  # DP columns per warp; padded C must be a multiple
BT_UNROLL = 16       # steps per while_loop iteration of the twin's walk
TARGET = "csa_profile_paths"

# priority bits in the low 2 bits of the x4-scaled scores: numeric order
# diag > left > up makes one max implement the reference tie-break; the
# stored priority p decodes to the direction code 2 - p
PRI_DIAG = 2
PRI_LEFT = 1

_CUDA_DIR = os.path.join(os.path.dirname(__file__), "cuda")
_SRC = os.path.join(_CUDA_DIR, "profile_dp.cu")
_LIB = os.path.join(_CUDA_DIR, "libcsa_profile_dp.so")
_registered = False


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the GPU profile-DP kernel needs "
                       "the CUDA toolkit")


def _library() -> str:
    """Path of the kernel library, (re)built from source when missing or
    older than ``profile_dp.cu``.  Native code for Hopper (sm_90a) plus
    PTX that other GPUs compile at load time."""
    try:
        fresh = os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)
    except OSError:
        fresh = False
    if fresh:
        return _LIB
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-gencode", "arch=compute_80,code=compute_80",
        "-I", jax.ffi.include_dir(), "-o", tmp, _SRC,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr[-4000:]}")
    os.replace(tmp, _LIB)
    return _LIB


def _register() -> None:
    global _registered
    if _registered:
        return
    lib = ctypes.cdll.LoadLibrary(_library())
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.CsaProfilePaths), platform="CUDA"
    )
    _registered = True


def _channels(codes, sv, iv, top, erg, rr, cc, *, sc: Scoring):
    """Per-column kernel inputs, built on the device from the padded
    batch (``wavefront._pad_batch`` arrays).

    svpack: the four base counts in 7-bit fields (counts <= 64,
    csamsa.c:23), so the count of row base b is ``svpack >> 7b & 127``;
    rest4/cg4: x4-scaled diag remainder / left cost with their priority
    bits; top4: x4 top row; scal: [4*rowgap, 4*edge_rowgap, R, C].
    """
    sv32 = sv.astype(jnp.int32)
    i = iv.astype(jnp.int32)[:, None]
    svg = sv32[..., GAP]
    svpack = (sv32[..., 0] | (sv32[..., 1] << 7) | (sv32[..., 2] << 14)
              | (sv32[..., 3] << 21))
    rest4 = 4 * ((sc.indel - sc.mismatch) * svg + sc.mismatch * i) + PRI_DIAG
    cg4 = 4 * (sc.doublegap * svg + sc.indel * (i - svg)) + PRI_LEFT
    scal = jnp.stack(
        [4 * sc.indel * iv, 4 * erg, rr, cc], axis=1
    ).astype(jnp.int32)
    return (codes.astype(jnp.int8), svpack, rest4, cg4,
            4 * top.astype(jnp.int32), scal)


def _paths_cuda(codes, svpack, rest4, cg4, top4, scal, *, a4: int):
    """The CUDA fill + walk: (paths (G, R+C) int8, nsteps (G,) int32).
    The packed directions, boundary columns and strip counters are the
    call's scratch results."""
    _register()
    G, Rp = codes.shape
    Cp = svpack.shape[1]
    ns = Cp // STRIP
    vma = jax.typeof(codes).vma

    def sds(shape, dtype):
        return jax.ShapeDtypeStruct(shape, dtype, vma=vma)

    paths, nsteps, _dirs, _bnd, _flags = jax.ffi.ffi_call(
        TARGET,
        (sds((G, Rp + Cp), jnp.int8),
         sds((G,), jnp.int32),
         sds((G, ns, Rp + WARP, WARP), jnp.uint16),
         sds((G * ns, Rp + 1), jnp.int32),
         sds((G * ns + 1,), jnp.int32)),
    )(codes, svpack, rest4, cg4, top4, scal, a4=np.int32(a4))
    return paths, nsteps


def _fill_reference(codes, svpack, rest4, cg4, top4, scal, *, a4: int):
    """Plain-JAX twin of the kernel: same channels, same packed layout.

    Row scan with the closed-form left chain (``wavefront.py``) on clean
    scores; each cell's priority is then ``max(diag|up arm, left arm) & 3``
    in the x4 domain, exactly as the kernel computes it.
    """
    G, Rp = codes.shape
    Cp = svpack.shape[1]
    ns = Cp // STRIP

    def one(cds, svp, rs, cg, top4g, sg):
        rowgap4, erg = sg[0], sg[1] >> 2
        S = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), jnp.cumsum(cg >> 2, dtype=jnp.int32)]
        )

        def row(prev, xs):
            code, j = xs
            cnt = (svp >> (7 * code)) & 127
            m4 = jnp.maximum(4 * prev[:-1] + a4 * cnt + rs,
                             4 * prev[1:] + rowgap4)
            t = jnp.concatenate([(j * erg)[None], (m4 >> 2) - S[1:]])
            cur = jax.lax.cummax(t) + S
            pri = jnp.maximum(m4, 4 * cur[:-1] + cg) & 3
            return cur, pri.astype(jnp.uint16)

        rows = jnp.arange(1, Rp + 1, dtype=jnp.int32)
        _, pri = jax.lax.scan(row, top4g >> 2, (cds.astype(jnp.int32), rows))
        shifts = 2 * jnp.arange(COLS, dtype=jnp.uint16)
        words = jnp.sum(
            pri.reshape(Rp, ns, WARP, COLS) << shifts, axis=-1,
            dtype=jnp.uint16,
        ).transpose(1, 0, 2)                                  # (ns, Rp, WARP)
        # skew: lane t holds row j at step s = j - 1 + t
        src = (jnp.arange(Rp + WARP, dtype=jnp.int32)[:, None]
               - jnp.arange(WARP, dtype=jnp.int32)[None, :])  # (Rp+WARP, WARP)
        ok = (src >= 0) & (src < Rp)
        skewed = jnp.take_along_axis(
            words, jnp.clip(src, 0, Rp - 1)[None], axis=1
        )
        return jnp.where(ok[None], skewed, jnp.uint16(0))

    return jax.vmap(one)(codes, svpack, rest4, cg4, top4, scal)


def _backtrack(flat, g, rr, cc, *, ns: int, Rp: int, L: int):
    """Walk gap g's packed directions from (R, C) to (0, 0) on device.

    ``flat`` is the fill's (G, ns, Rp + WARP, WARP) array, flattened.
    Identical walk to ``wavefront._rowscan_path`` (the reference
    backtrack order, dynamicprogramming.c:1032-1138): main region by
    direction code, then the remaining j>0 / c>0 edge runs.  Returns
    (path codes in walk order, step count).
    """

    def cond(state):
        j, c, t, path = state
        return (j > 0) | (c > 0)

    def body(state):
        j, c, t, path = state
        for _ in range(BT_UNROLL):
            active = (j > 0) | (c > 0)
            inmain = (j > 0) & (c > 0)
            q = jnp.maximum(c - 1, 0)
            lane = (q // COLS) % WARP
            step = jnp.maximum(j - 1, 0) + lane
            word = flat[((g * ns + q // STRIP) * (Rp + WARP) + step) * WARP
                        + lane]
            pri = (word.astype(jnp.int32) >> (2 * (q % COLS))) & 3
            dcode = jnp.where(
                inmain,
                (2 - pri).astype(jnp.int8),
                jnp.where(j > 0, jnp.int8(D_UP), jnp.int8(D_LEFT)),
            )
            path = path.at[jnp.clip(t, 0, L - 1)].set(dcode)
            j = jnp.where(active & (dcode != D_LEFT), j - 1, j)
            c = jnp.where(active & (dcode != D_UP), c - 1, c)
            t = jnp.where(active, t + 1, t)
        return (j, c, t, path)

    # constants seeded from a varying input: keeps the varying-axes
    # checker satisfied under shard_map (see wavefront._rowscan_path)
    t0 = rr * jnp.int32(0)
    path0 = jnp.zeros(L, jnp.int8) + t0.astype(jnp.int8)
    _, _, nsteps, path = jax.lax.while_loop(cond, body, (rr, cc, t0, path0))
    return path, nsteps


def _paths_core(codes, sv, iv, top, erg, rr, cc, *, sc: Scoring, impl: str):
    """Channels + fill + backtrack over the padded batch
    (``wavefront._rowscan_batch`` signature): the CUDA kernels
    (``impl="cuda"``) or their plain-JAX twin (``"reference"``).
    Unjitted so the gap-axis shard_map can embed it as its body."""
    ch = _channels(codes, sv, iv, top, erg, rr, cc, sc=sc)
    a4 = 4 * (sc.match - sc.mismatch)
    if impl == "cuda":
        return _paths_cuda(*ch, a4=a4)
    dirs = _fill_reference(*ch, a4=a4)
    G, Rp = codes.shape
    Cp = sv.shape[1]
    flat = dirs.reshape(-1)
    return jax.vmap(
        lambda g, r, c: _backtrack(flat, g, r, c, ns=Cp // STRIP, Rp=Rp,
                                   L=Rp + Cp)
    )(jnp.arange(G, dtype=jnp.int32), rr, cc)


_paths_program = functools.partial(
    jax.jit, static_argnames=("sc", "impl")
)(_paths_core)


def profile_paths(items, *, impl: str = "cuda"):
    """Batched fill + device backtrack for independent gap merges.

    ``items``: (row_codes, scorevector, i, top_row, edge_rowgap) tuples
    (``GapProgressiveState.prepare`` outputs).  Returns per-item
    walk-order path codes — drop-in for
    ``wavefront.dp_paths_device_batched``.
    """
    from .wavefront import _pad_batch, _split_paths

    codes, sv, top, iv, erg, rr, cc, *_ = _pad_batch(
        items, min_g=1 if len(items) == 1 else 8
    )
    out = _paths_program(
        *(jnp.asarray(x) for x in (codes, sv, iv, top, erg, rr, cc)),
        sc=_current_scoring(), impl=impl,
    )
    return _split_paths(*out, len(items))


def profile_path(row_codes, scorevector, i: int, top_row=None,
                 edge_rowgap=None, *, impl: str = "cuda") -> np.ndarray:
    """Single-gap fill + device backtrack; returns walk-order codes.
    Drop-in for ``wavefront.dp_path_device``."""
    from ..align.progressive import default_top_row

    if top_row is None:
        top_row = default_top_row(scorevector, i)
    if edge_rowgap is None:
        edge_rowgap = _current_scoring().indel * i
    return profile_paths(
        [(row_codes, scorevector, i, top_row, edge_rowgap)], impl=impl
    )[0]
