"""Multi-chip sharding of the rotation engine.

The reference (`/root/reference/source/`) is single-core C with no
parallelism of any kind (SURVEY.md §2); every axis here is new design:

* **data parallel over sequences** (``"seq"`` mesh axis): the ``(k, n_max)``
  code matrix is sharded by row; per-sequence work (member tables,
  occurrence counting) stays shard-local.
* **sequence parallel over positions** (``"pos"`` mesh axis): each row's
  codes are sharded by column; the prefix-doubling global ranks and suffix
  order require cross-shard sorts, for which XLA's SPMD partitioner inserts
  the all-to-all / all-gather collectives over the interconnect (scaling-book recipe:
  annotate shardings, let XLA place collectives).

Two stages make the production path (``pipeline.analyze(backend="sharded")``):

1. **Index stage** (GSPMD jit): the fused device program — prefix-doubling
   ranks -> suffix order -> capped LCPs -> deepest-all-sequences block
   collection -> suffix-containment filter -> per-sequence member tables
   (equivalent of the reference's buildGeneralizedTree + collectNodes +
   removeSuffixNodes cascade, csamsa.c:271-308).  Inputs are sharded
   ``P("seq", "pos")``; XLA partitions the sorts/gathers and places the
   collectives.
2. **Collective chain merge** (explicit ``shard_map``): each "seq" shard
   answers occurrence-count and first-position queries for its OWN
   sequences from its local member-table rows, then the shards merge the
   candidates with explicit collectives — a ``psum`` vote decides
   all-sequence uniqueness (removeNonUniqueNodes, csamsa.c:230-257) and an
   ``all_gather`` assembles the per-sequence position table
   (collectPositions, csamsa.c:114-123).  The tiny merged block set goes
   to the host, where the exact chain linking/selection finishes
   (collectNodeChains, csamsa.c:132-226).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..index import engine


def _factor_mesh(n: int) -> Tuple[int, int]:
    """Split n devices into a (seq, pos) grid, favoring the seq axis."""
    best = (n, 1)
    a = 1
    while a * a <= n:
        if n % a == 0:
            best = (n // a, a)
        a += 1
    return best


def make_mesh(
    n_devices: Optional[int] = None,
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = ("seq", "pos"),
) -> Mesh:
    """Mesh over the GLOBAL device list: after
    ``parallel.distributed.initialize`` on an N-host launch,
    ``jax.devices()`` spans every process and the mesh axes cross the
    host boundary (within a host and across hosts)."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if shape is None:
        shape = _factor_mesh(n_devices)
    mesh_devices = np.asarray(devices[:n_devices]).reshape(shape)
    return Mesh(mesh_devices, axis_names)


def put_global(arr: np.ndarray, sharding: NamedSharding):
    """Create a (possibly cross-process) sharded array from host data.

    Single-process: plain ``device_put``.  Multi-process: every process
    holds the full host copy, and each builds only its addressable
    shards (``make_array_from_callback``) — the standard multi-host
    array-creation path, no cross-host data movement."""
    if jax.process_count() == 1:
        return jax.device_put(jnp.asarray(arr), sharding)
    return jax.make_array_from_callback(
        arr.shape, sharding, lambda idx: np.asarray(arr[idx])
    )


@functools.partial(
    jax.jit, static_argnames=("k", "n_max", "levels", "cap", "slots", "mesh")
)
def _index_stage(codes, lengths, *, k, n_max, levels, cap, slots, mesh):
    """Fused index + collect + suffix filter + member tables under GSPMD.

    ``codes`` arrives sharded P("seq", "pos"); the member tables leave
    sharded P("seq", None) so the merge stage reads them shard-locally.
    """
    rank_stack, sa, lcp, raw, dup = engine.device_index_program(
        codes, lengths, k=k, n_max=n_max, levels=levels
    )
    collected, start, end, _, _ = engine.collect_program(
        sa, lcp, lengths, k=k, n_max=n_max, levels=levels
    )
    nb, valid, bstart, bend, bdepth = engine.compact_blocks_program(
        collected, start, end, lcp, cap=cap
    )
    keep_suffix, num_distinct = engine.suffix_filter_program(
        sa, lcp, lengths, valid, bstart, bend, bdepth,
        k=k, n_max=n_max, cap=cap, slots=slots,
    )
    M, Mpos = engine.member_tables_program(sa, lengths, k=k, n_max=n_max)
    header = jnp.stack([dup.astype(jnp.int32), nb, num_distinct])
    rep = NamedSharding(mesh, P())
    row = NamedSharding(mesh, P("seq", None))
    header, valid, bstart, bend, bdepth, keep_suffix = (
        jax.lax.with_sharding_constraint(
            (header, valid, bstart, bend, bdepth, keep_suffix),
            (rep, rep, rep, rep, rep, rep),
        )
    )
    M, Mpos = jax.lax.with_sharding_constraint((M, Mpos), (row, row))
    return header, valid, bstart, bend, bdepth, keep_suffix, M, Mpos


def _merge_stage(mesh: Mesh, k_real: int):
    """Explicit collective chain merge over the "seq" axis.

    Each shard counts occurrences of every candidate block within its own
    sequences (local member-table rows), then:

    * uniqueness = psum of per-shard "occurs exactly once" votes == k
      (removeNonUniqueNodes semantics, csamsa.c:230-257);
    * positions  = per-shard first-occurrence columns assembled along
      the "seq" axis by the output sharding — the gather the reference's
      collectPositions (csamsa.c:114-123) does serially happens as the
      out-spec's implicit all-gather when a replicated consumer reads it.
    """

    def body(M_l, Mpos_l, bstart, bend, valid):
        cnts, first_pos = engine.uniqueness_counts(M_l, Mpos_l, bstart, bend)
        votes_local = jnp.sum((cnts == 1).astype(jnp.int32), axis=0)
        votes = jax.lax.psum(votes_local, "seq")
        unique = (votes == jnp.int32(k_real)) & valid
        return unique, first_pos

    return shard_map(
        body,
        mesh=mesh,
        in_specs=(P("seq", None), P("seq", None), P(), P(), P()),
        out_specs=(P(), P("seq", None)),
    )


_REPLICATE_CACHE: dict = {}


def _replicate(mesh: Mesh):
    """Jitted full replication over ``mesh`` (cached per mesh)."""
    prog = _REPLICATE_CACHE.get(id(mesh))
    if prog is None:
        rep = NamedSharding(mesh, P())
        prog = jax.jit(
            lambda x: jax.lax.with_sharding_constraint(x, rep)
        )
        _REPLICATE_CACHE[id(mesh)] = prog
    return prog


def rotation_blocks_sharded(
    encoded: Sequence[np.ndarray],
    mesh: Optional[Mesh] = None,
    cap: int = 4096,
):
    """Mesh-parallel fused rotation block stage; drop-in for
    :func:`csa_jax.index.engine.rotation_blocks_jax`.

    Returns an :class:`engine.RotationBlocks` (or ``None`` on duplicate
    within-sequence rotations, where the exact numpy fallback takes over).
    """
    k = len(encoded)
    if mesh is None or k % mesh.shape["seq"] != 0:
        # the "seq" axis must divide k so every shard owns whole sequences
        # (no padded phantom sequences polluting the all-seq coverage test);
        # re-factor the same device count with the largest compatible axis
        n_dev = len(jax.devices()) if mesh is None else mesh.size
        seq_axis = max(
            s for s in range(1, n_dev + 1) if n_dev % s == 0 and k % s == 0
        )
        mesh = make_mesh(n_dev, (seq_axis, n_dev // seq_axis))
    seq_axis = mesh.shape["seq"]
    pos_axis = mesh.shape["pos"]
    sizes = np.array([len(e) for e in encoded], dtype=np.int32)
    n_max = engine._bucket(max(int(sizes.max()), 8))
    n_max = ((n_max + pos_axis - 1) // pos_axis) * pos_axis
    levels = engine._num_levels(n_max)
    codes = np.zeros((k, n_max), dtype=np.int32)
    for i, e in enumerate(encoded):
        codes[i, : len(e)] = e

    code_shard = NamedSharding(mesh, P("seq", "pos"))
    len_shard = NamedSharding(mesh, P("seq"))
    jc = put_global(codes, code_shard)
    js = put_global(sizes, len_shard)

    merge = _merge_stage(mesh, k)
    slots = engine.MAX_DEPTH_SLOTS
    while True:
        header, valid, bstart, bend, bdepth, keep_suffix, M, Mpos = _index_stage(
            jc, js, k=k, n_max=n_max, levels=levels, cap=cap,
            slots=slots, mesh=mesh,
        )
        unique, positions = merge(M, Mpos, bstart, bend, valid)
        # positions leaves the merge sharded P("seq", None); replicate
        # before the host fetch (required on cross-process meshes, an
        # in-jit all-gather otherwise)
        positions = _replicate(mesh)(positions)
        h = np.asarray(header)
        dup, nb, ndepth = int(h[0]), int(h[1]), int(h[2])
        if dup:
            return None
        if nb <= cap and ndepth <= slots:
            nbv = min(nb, cap)
            return engine.RotationBlocks.from_fields(
                num_collected=nb,
                start=np.asarray(bstart)[:nbv],
                end=np.asarray(bend)[:nbv],
                depth=np.asarray(bdepth)[:nbv],
                keep_suffix=np.asarray(keep_suffix)[:nbv],
                unique=np.asarray(unique)[:nbv],
                positions=np.asarray(positions).T[:nbv, :k],
            )
        if nb > cap:
            cap = engine._bucket(nb, 1024)
        if ndepth > slots:
            slots = engine._bucket(ndepth, 256)


def sharded_rotation_step(mesh: Mesh, *, k: int, n_max: int, levels: int):
    """Jit the core rotation-analysis step over ``mesh`` (compile-check
    surface used by the driver's multi-chip dry run).

    Returns a compiled callable ``step(codes, lengths)`` with ``codes``
    sharded ``P("seq", "pos")`` and ``lengths`` sharded ``P("seq")``.
    Outputs are replicated (the collected block set is tiny).
    """
    code_shard = NamedSharding(mesh, P("seq", "pos"))
    len_shard = NamedSharding(mesh, P("seq"))
    out_shard = NamedSharding(mesh, P())

    def step(codes, lengths):
        rank_stack, sa, lcp, raw, dup = engine.device_index_program(
            codes, lengths, k=k, n_max=n_max, levels=levels
        )
        collected, start, end, _, _ = engine.collect_program(
            sa, lcp, lengths, k=k, n_max=n_max, levels=levels
        )
        return sa, lcp, raw, collected, start, end, dup

    return jax.jit(
        step,
        in_shardings=(code_shard, len_shard),
        out_shardings=out_shard,
        static_argnames=(),
    )


def run_sharded_collect(
    encoded: Sequence[np.ndarray], mesh: Optional[Mesh] = None
):
    """Host convenience wrapper: pad, shard, run one collection step."""
    if mesh is None:
        mesh = make_mesh()
    k = len(encoded)
    sizes = np.array([len(e) for e in encoded], dtype=np.int32)
    n_max = max(int(sizes.max()), 8)
    # round n_max up so the pos axis divides it evenly
    pos_axis = mesh.shape["pos"]
    n_max = ((n_max + pos_axis - 1) // pos_axis) * pos_axis
    levels = engine._num_levels(n_max)
    codes = np.zeros((k, n_max), dtype=np.int32)
    for i, e in enumerate(encoded):
        codes[i, : len(e)] = e
    step = sharded_rotation_step(mesh, k=k, n_max=n_max, levels=levels)
    code_shard = NamedSharding(mesh, P("seq", "pos"))
    len_shard = NamedSharding(mesh, P("seq"))
    jcodes = put_global(codes, code_shard)
    jsizes = put_global(sizes, len_shard)
    return step(jcodes, jsizes)
