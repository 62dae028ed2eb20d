"""High-level MSA entry: rotate-view, anchor, align, save.

Adapter between the CLI / pipeline drivers and the alignment engine
(:mod:`csa_jax.align.runner`).  Mirrors the reference main() alignment
phase (``/root/reference/source/csamsa.c:607-631``): the sequences are
viewed through their rotations, anchored recursively, gap-aligned with
the progressive profile DP, and written as an aligned multi-FASTA whose
headers carry ``@ <rotation>``.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence, TextIO

import numpy as np

from ..io import fasta as fio
from . import runner


def align(
    seqs: fio.SequenceSet,
    rotations: Sequence[int],
    *,
    backend: str = "numpy",
    log: Optional[TextIO] = None,
) -> runner.AlignmentResult:
    log = log if log is not None else sys.stdout
    rotated = [
        np.roll(e, -int(r)) for e, r in zip(seqs.encoded_all(), rotations)
    ]
    result = runner.run_alignment(rotated, log=log, dp_backend=backend)
    result.rotated_codes = rotated  # type: ignore[attr-defined]
    return result


def save_alignment(
    seqs: fio.SequenceSet,
    rotations: Sequence[int],
    result: runner.AlignmentResult,
    path: str,
    *,
    log: Optional[TextIO] = None,
) -> None:
    runner.save_alignment(
        path,
        result,
        result.rotated_codes,  # type: ignore[attr-defined]
        seqs.names,
        rotations,
        log=log,
    )
