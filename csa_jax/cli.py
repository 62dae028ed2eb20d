"""Command-line driver for csa_jax.

Equivalent of the reference CLI (``/root/reference/source/csamsa.c:524-678``):

========  ==========================================================
mode      behavior
========  ==========================================================
(none)    Rotate + Align + Images (full pipeline)
R         Rotation only -> ``<base>-Rotated.fasta`` + block artifacts
A         Alignment only (rotations = 0) -> ``<base>-Aligned.fasta``
I         Circular alignment plot only
C         Clean/normalize a FASTA file -> ``Clean-<file>``
S         Sum-of-pairs score + stats of an alignment
M         Convert aligned FASTA -> MSF
========  ==========================================================

Extra (new in this framework): ``--backend {auto,numpy,jax,native,sharded}``,
``--mesh SEQxPOS`` (device mesh for the sharded backend), ``--profile``,
``--verify-rotations``, ``--min-block-size``, ``--max-interval``, and the
scoring-matrix flags ``--match/--mismatch/--indel/--doublegap`` (honored
identically by every DP backend; csa_jax/config.py).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from . import __version__
from .console import banner
from .io import fasta as fio
from .rotation import pipeline as rot
from .rotation.chains import INT_MAX

POSITIONS_SUFFIX = "-positions.txt"
IMAGEMAP_SUFFIX = "-imagemap.txt"
ROTATIONS_SUFFIX = "-Rotated.fasta"
ALIGNMENT_SUFFIX = "-Aligned.fasta"
BLOCKSINFO_SUFFIX = "-Blocks.csv"
BLOCKSIMAGE_SUFFIX = "-Blocks.bmp"
CIRCULARIMAGE_SUFFIX = "-CircularAlignment.bmp"


def output_filename(inputfilename: str, extra: str) -> str:
    """Join the input file's basename with a suffix (csamsa.c:44-58)."""
    base, dot, _ = inputfilename.rpartition(".")
    if not dot:
        base = inputfilename
    return base + extra


def _load(args) -> fio.SequenceSet:
    print(f"> Loading sequences from file <{args.input}> ... ", end="")
    try:
        size = os.path.getsize(args.input)
    except OSError:
        print()
        raise SystemExit("\n> ERROR: Sequence file not found")
    print(f"({size} bytes)")
    try:
        seqs = fio.load_fasta(args.input, log=sys.stdout)
    except fio.FastaError as e:
        raise SystemExit(f"\n> ERROR: {e}")
    print(f"> {len(seqs)} sequences successfully loaded")
    fio.discard_duplicate_rotations(seqs, log=sys.stdout)
    return seqs


def run_rotation(args, seqs: fio.SequenceSet) -> rot.RotationResult:
    from .utils.profiling import PROFILER

    t0 = time.time()
    try:
        res = rot.analyze(
            seqs,
            log=sys.stdout,
            backend=args.backend,
            cfg=args.cfg,
        )
    except rot.RotationError as e:
        raise SystemExit(f"\n> ERROR: {e}")
    if args.verify_rotations:
        from .rotation import verification

        with PROFILER.phase("rot.device_verify"):
            verification.verify_rotations(
                seqs.encoded_all(), res.rotations, log=sys.stdout
            )
    with PROFILER.phase("rot.artifacts"):
        rotfile = output_filename(args.input, ROTATIONS_SUFFIX)
        fio.save_rotated(seqs, res.rotations, rotfile)

        # chain report (csamsa.c:310-414 createImageAndShowResults)
        from .report import blocks_report

        blocks_report.write_blocks_artifacts(
            args.input, seqs, res,
            min_block_size=args.cfg.min_block_size,
            max_block_size=args.cfg.max_block_size,
        )
    if args.profile:
        print(f"> [profile] rotation phase: {time.time() - t0:.3f}s "
              f"(backend={args.backend})")
    return res


def _resolve_host_backend(backend: str) -> str:
    """Resolve ``auto`` for the alignment phase: the fastest host path
    when the native kernels are built, else numpy (the device alignment
    path stays an explicit ``--backend jax`` opt-in; rotation resolves
    ``auto`` separately and size-dependently in ``rotation.pipeline``)."""
    if backend != "auto":
        return backend
    from . import native

    return "native" if native.available() else "numpy"


def run_alignment(args, seqs: fio.SequenceSet, rotations) -> str:
    from .align import msa

    alignfile = output_filename(args.input, ALIGNMENT_SUFFIX)
    print("> Running multiple sequence alignment...")
    result = msa.align(
        seqs, rotations, backend=_resolve_host_backend(args.backend)
    )
    msa.save_alignment(seqs, rotations, result, alignfile)
    from .tools import files as tools_files

    rotfile = output_filename(args.input, ROTATIONS_SUFFIX)
    source = rotfile if os.path.exists(rotfile) else args.input
    tools_files.test_alignment_output(source, alignfile)
    return alignfile


def _parse_mesh(text: str):
    """``4x2`` -> (4, 2): (seq, pos) device-mesh axes."""
    try:
        seq, _, pos = text.lower().partition("x")
        shape = (int(seq), int(pos))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"mesh must look like SEQxPOS (e.g. 4x2), got {text!r}"
        )
    if shape[0] < 1 or shape[1] < 1:
        raise argparse.ArgumentTypeError("mesh axes must be >= 1")
    return shape


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="csa-jax",
        description="multiple circular sequence aligner",
    )
    parser.add_argument("mode", nargs="?", default=None,
                        help="R|A|I|C|S|M (omit for full pipeline)")
    parser.add_argument("input", nargs="?", default=None,
                        help="multi-FASTA file")
    parser.add_argument("--backend",
                        choices=["auto", "numpy", "jax", "native", "sharded"],
                        default=os.environ.get("CSA_BACKEND", "auto"))
    parser.add_argument("--min-block-size", type=int, default=10)
    parser.add_argument("--max-block-size", type=int, default=INT_MAX)
    parser.add_argument("--max-interval", type=int, default=INT_MAX)
    parser.add_argument("--match", type=int, default=1,
                        help="DP match score (default 1)")
    parser.add_argument("--mismatch", type=int, default=-1,
                        help="DP mismatch score (default -1)")
    parser.add_argument("--indel", type=int, default=-1,
                        help="DP indel score (default -1)")
    parser.add_argument("--doublegap", type=int, default=0,
                        help="DP gap-over-gap score (default 0)")
    parser.add_argument("--mesh", type=_parse_mesh, default=None,
                        metavar="SEQxPOS",
                        help="device mesh shape for --backend sharded, "
                             "e.g. 4x2 (default: auto-factor all devices)")
    parser.add_argument("--pack-w", type=int, default=None,
                        metavar="W", choices=range(2, 14),
                        help="k-mer packing width of the index engines "
                             "(2..13, default 12)")
    parser.add_argument("--device-min-cells", type=int, default=None,
                        metavar="N",
                        help="per-merge DP cell count above which the "
                             "device kernel is used (--backend jax)")
    parser.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                        help="multi-host launch: coordinator address "
                             "(same on every host; see docs/MANUAL.md)")
    parser.add_argument("--num-processes", type=int, default=None,
                        metavar="N", help="multi-host launch: process count")
    parser.add_argument("--process-id", type=int, default=None,
                        metavar="I", help="multi-host launch: this host's "
                        "0-based process index")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--verify-rotations", action="store_true",
                        help="score chosen vs alternative rotations with "
                             "the device NW kernel (sanity oracle)")
    parser.add_argument("--version", action="version",
                        version=f"csa-jax {__version__}")
    args = parser.parse_args(argv)

    from . import config

    sc = config.Scoring(
        match=args.match, mismatch=args.mismatch,
        indel=args.indel, doublegap=args.doublegap,
    )
    defaults = config.RunConfig()
    cfg = config.RunConfig(
        scoring=sc,
        min_block_size=args.min_block_size,
        max_block_size=args.max_block_size,
        max_interval=args.max_interval,
        mesh_shape=args.mesh,
        pack_w=(args.pack_w if args.pack_w is not None else defaults.pack_w),
        device_min_cells=(args.device_min_cells
                          if args.device_min_cells is not None
                          else defaults.device_min_cells),
    )
    config.set_run_config(cfg)
    args.cfg = cfg

    if args.backend in ("auto", "jax", "sharded"):
        from .utils.compile_cache import enable_compile_cache

        enable_compile_cache()

    # multi-host: form the global runtime BEFORE any mesh/device use so
    # jax.devices() spans every process (parallel/distributed.py)
    if args.coordinator or os.environ.get("CSA_COORDINATOR"):
        from .parallel import distributed

        multi = distributed.initialize(
            args.coordinator, args.num_processes, args.process_id
        )
        if multi:
            import jax

            print(f"> Multi-host runtime: process "
                  f"{jax.process_index()}/{jax.process_count()}, "
                  f"{jax.device_count()} global devices")

    print(banner("[ csa-jax: Multiple Circular Sequence Aligner ]"))

    from .utils.profiling import PROFILER, jax_trace

    PROFILER.enabled = bool(args.profile)

    # reference argument convention: one arg = full pipeline on that file;
    # two args = mode char + file (csamsa.c:539-547)
    mode = "N"
    if args.input is None and args.mode is not None:
        args.input = args.mode
    elif args.mode is not None:
        mode = args.mode.upper()
        if mode not in ("R", "A", "I", "C", "S", "M"):
            mode = ""
    if not args.input or not mode:
        parser.print_help()
        return 0

    with jax_trace(os.environ.get("CSA_JAX_TRACE")):
        if mode in ("N", "R", "A"):
            with PROFILER.phase("io.load_fasta"):
                seqs = _load(args)

        res = None
        if mode in ("N", "R"):
            print("> Building generalized cyclic suffix index...")
            res = run_rotation(args, seqs)

        alignfile = None
        if mode in ("N", "A"):
            import numpy as np

            rotations = (res.rotations if res is not None
                         else np.zeros(len(seqs), dtype=np.int64))
            with PROFILER.phase("align.total"):
                alignfile = run_alignment(args, seqs, rotations)

        if mode in ("N", "I"):
            from .report import circular_plot

            source = alignfile if alignfile else args.input
            out = output_filename(args.input, CIRCULARIMAGE_SUFFIX)
            with PROFILER.phase("report.circular_plot"):
                circular_plot.draw_circular_alignment_plot(source, out)

    if mode == "C":
        from .tools import files as tools_files

        tools_files.clean_fasta(args.input)

    if mode == "S":
        from .tools import files as tools_files

        tools_files.sum_of_pairs_score(args.input)

    if mode == "M":
        from .tools import files as tools_files

        tools_files.fasta_to_msf(args.input)

    if args.profile:
        PROFILER.report(sys.stdout)
    print("> Done!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
