"""Rotation analysis pipeline: blocks -> filters -> chains -> rotations.

Accelerator-first equivalent of the reference rotation phase
(``/root/reference/source/csamsa.c:271-308`` ``analyzeTree``): the
suffix-tree DFS + linked-list filter cascade is replaced by the cyclic
suffix-array engine (:mod:`csa_jax.index.cyclic`) plus vectorized filters,
with an exact host-side emulation of the chain linking/selection.

The pipeline produces bit-identical rotations to the reference on its own
example sets (see tests/fixtures).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, TextIO

import numpy as np

from ..index import cyclic
from ..io.fasta import SequenceSet
from . import chains as chains_mod
from .chains import INT_MAX, Block


class RotationError(RuntimeError):
    pass


# `auto` crossover: below this many total characters the native host
# engine's latency beats the device dispatch chain; above it the device
# engine is expected to win.  Not yet re-measured on the current device.
# Override with CSA_AUTO_DEVICE_MIN (characters).
AUTO_DEVICE_MIN_CHARS = 4_000_000


def _auto_device_min_chars() -> int:
    import os

    return int(os.environ.get("CSA_AUTO_DEVICE_MIN", AUTO_DEVICE_MIN_CHARS))


def auto_may_use_device(total_chars: int) -> bool:
    """Whether `auto` could resolve to the device engine for an input of
    this size — decided without starting JAX, for callers (the web
    server) that must not claim the device themselves."""
    from .. import native

    return not (native.available()
                and total_chars < _auto_device_min_chars())


def resolve_auto_backend(total_chars: int) -> str:
    """Size-dependent `auto` resolution: native for latency-bound small
    inputs, the device engine where the silicon wins (and an accelerator
    is actually present; the virtual-CPU test mesh does not count)."""
    from .. import native

    have_native = native.available()
    if not auto_may_use_device(total_chars):
        return "native"
    try:
        import jax

        accel = any(d.platform != "cpu" for d in jax.devices())
    except Exception:
        accel = False
    if accel:
        return "jax"
    return "native" if have_native else "jax"


@dataclass
class RotationResult:
    rotations: np.ndarray  # (K,) start offset per sequence
    blocks_sorted: List[Block]  # all blocks in final (size-sorted) list order
    num_collected: int
    num_after_suffix: int
    num_after_unique: int
    num_chains: int
    index: Optional[cyclic.RotationIndex] = None
    block_depths: np.ndarray = field(default_factory=lambda: np.empty(0))

    def chain_heads(self) -> List[Block]:
        return [b for b in self.blocks_sorted if b.totalsize != -1]


def analyze(
    seqs: SequenceSet,
    *,
    maxinterval: Optional[int] = None,
    log: Optional[TextIO] = None,
    backend: str = "numpy",
    mesh_shape: Optional[tuple] = None,
    cfg=None,
) -> RotationResult:
    """Compute optimal rotations for a set of circular sequences.

    ``cfg`` (a :class:`csa_jax.config.RunConfig`, built by the CLI)
    supplies ``max_interval`` and ``mesh_shape``; the explicit keyword
    arguments override it for programmatic callers.

    The console narrative mirrors the reference phase messages
    (csamsa.c:274-303) so existing tooling that scrapes them keeps working.
    """
    if cfg is None:
        from ..config import run_config

        cfg = run_config()
    if maxinterval is None:
        maxinterval = cfg.max_interval
    if mesh_shape is None:
        mesh_shape = cfg.mesh_shape
    log = log if log is not None else sys.stdout
    sizes = seqs.sizes
    encoded = seqs.encoded_all()

    if backend == "auto":
        backend = resolve_auto_backend(int(np.sum(sizes)))

    from ..utils.profiling import PROFILER

    fused = None
    index = None
    with PROFILER.phase(f"rot.block_stage[{backend}]"):
        if backend == "native":
            from .. import native

            fused = native.rotation_analyze(encoded)
            if fused is None:  # no toolchain: numpy twin
                backend = "numpy"
        elif backend == "jax":
            from ..index import engine as jax_engine

            # slim entry: only the filtered final blocks reach the host
            fused = jax_engine.rotation_final_jax(encoded)
        elif backend == "sharded":
            # mesh-parallel block stage: the round-3 engine under GSPMD
            # (XLA partitions the sorts/scans over the (seq, pos) mesh);
            # the explicit shard_map collective merge variant remains in
            # parallel/sharded.py (exercised by dryrun_multichip/tests).
            # Falls back to the exact numpy path on duplicate rotations,
            # like the single-device jax backend.
            from ..index import engine as jax_engine
            from ..parallel import sharded

            if mesh_shape:
                shape = tuple(int(x) for x in mesh_shape)
                mesh = sharded.make_mesh(
                    n_devices=shape[0] * shape[1], shape=shape
                )
            else:
                mesh = sharded.make_mesh()
            fused = jax_engine.rotation_final_jax(encoded, mesh=mesh)

    if fused is not None:
        # the whole block stage (collect + suffix filter + uniqueness +
        # positions) ran on the device with one small packed transfer
        print("> Collecting maximum common subsequences... ", end="", file=log)
        num_collected = fused.num_collected
        print(f"{num_collected} nodes found", file=log)
        if num_collected == 0:
            raise RotationError("No unique subsequences found")
        print("> Removing suffixes... ", end="", file=log)
        if hasattr(fused, "final_start"):  # slim device result
            num_after_suffix = fused.num_after_suffix
            fstart = fused.final_start
            fdepth = fused.final_depth
            fpos = fused.final_positions
        else:
            num_after_suffix = int(fused.keep_suffix.sum())
            final = fused.keep_suffix & fused.unique
            fstart = fused.start[final]
            fdepth = fused.depth[final]
            fpos = fused.positions[final]
        print(f"{num_after_suffix} nodes left", file=log)
        print("> Removing repeats... ", end="", file=log)
        num_after_unique = len(fstart)
    else:
        index = cyclic.build_rotation_index(encoded)
        blocks = cyclic.collect_blocks(index)

        print("> Collecting maximum common subsequences... ", end="", file=log)
        num_collected = len(blocks)
        print(f"{num_collected} nodes found", file=log)
        if num_collected == 0:
            # reference reaches this via the root-only block list being
            # filtered by the uniqueness pass (csamsa.c:290-293)
            raise RotationError("No unique subsequences found")

        print("> Removing suffixes... ", end="", file=log)
        keep = cyclic.remove_suffix_blocks(blocks)
        blocks = cyclic.BlockSet(
            blocks.index, blocks.start[keep], blocks.end[keep], blocks.depth[keep]
        )
        num_after_suffix = len(blocks)
        print(f"{num_after_suffix} nodes left", file=log)

        print("> Removing repeats... ", end="", file=log)
        unique, positions = blocks.positions_if_unique()
        fstart = blocks.start[unique]
        fdepth = blocks.depth[unique]
        fpos = positions[unique]
        num_after_unique = len(fstart)

    if num_after_unique == 0:
        raise RotationError("No unique subsequences found")
    print(f"{num_after_unique} nodes left", file=log)

    print("> Connecting block chains... ", end="", file=log)
    chains_timer = PROFILER.phase("rot.chains")
    chains_timer.__enter__()
    # reference list order: depth-descending (insertSortedItem,
    # nodeslinkedlists.c:34-51); ties keep a deterministic engine order.
    order = np.lexsort((fstart, -fdepth))
    chain_blocks = [
        Block(
            depth=int(fdepth[i]),
            positions=fpos[i],
            label_ref=int(fstart[i]),
        )
        for i in order
    ]
    chains_mod.link_blocks(
        chain_blocks, sizes, positions=fpos[order], depths=fdepth[order]
    )
    try:
        num_chains = chains_mod.assemble_chains(chain_blocks, sizes, maxinterval)
    except chains_mod.ChainCycleError as e:
        # the reference loops forever / segfaults on these inputs; surface
        # a clean pipeline error instead (see README, docs/PARITY.md)
        raise RotationError(str(e)) from e
    print(f"{num_chains} chains found", file=log)

    blocks_sorted = chains_mod.sort_by_chain_size(chain_blocks)
    rotations = chains_mod.pick_rotations(blocks_sorted)
    chains_timer.__exit__(None, None, None)
    if rotations is None:
        raise RotationError("No unique common subsequences found")

    return RotationResult(
        rotations=rotations,
        blocks_sorted=blocks_sorted,
        num_collected=num_collected,
        num_after_suffix=num_after_suffix,
        num_after_unique=num_after_unique,
        num_chains=num_chains,
        index=index,
        block_depths=fdepth[order] if len(order) else np.empty(0),
    )


def chain_label(head: Block, seqs: SequenceSet, seq_for_chars: int = 0) -> str:
    """Render a chain's label string: block characters joined by gap markers.

    Mirrors ``blockLabel`` (nodeslinkedlists.c:128-191): gaps of length <= 7
    render as that many ``-``; longer gaps render ``-(len)-``; negative
    intervals move the cursor backwards.  Characters are taken from the
    chain's occurrence in ``seq_for_chars`` (the reference mixes characters
    from whichever sequence created each tree node; the strings are equal up
    to IUPAC normalization).
    """
    text = seqs.texts[seq_for_chars]
    n = len(text)
    out: List[str] = []
    cursor = 0

    def put(s: str):
        nonlocal cursor
        for ch in s:
            if cursor < len(out):
                out[cursor] = ch
            else:
                out.extend([" "] * (cursor - len(out)))
                out.append(ch)
            cursor += 1

    b: Optional[Block] = head
    while b is not None:
        p = int(b.positions[seq_for_chars])
        chars = "".join(text[(p + j) % n] for j in range(b.depth))
        put(chars)
        gap = b.interval if b.nextblock is not None else 0
        if b.nextblock is not None:
            if gap < 0:
                cursor += gap  # reference: labelpos += n (n negative)
            elif gap > 7:
                put(f"-({gap})-")
            else:
                put("-" * gap)
        b = b.nextblock
    return "".join(out[:cursor])
