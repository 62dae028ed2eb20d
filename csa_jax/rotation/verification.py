"""Device rotation-verification oracle (batched pairwise NW).

New-design subsystem (SURVEY.md §7 M1: the wavefront kernel serves
rotation verification): after the chain stage picks per-sequence
rotations (csamsa.c:260-267 getRotations), every chosen rotation is
scored against sequence 0's chosen rotation with the batched
Needleman-Wunsch fill (``dp/nw.py``) and compared with ``samples`` alternative
(deterministically spread) rotations of the same sequence.  A chosen
rotation that scores below an alternative is flagged — a cheap
independent check that the combinatorial chain stage picked a
alignment-consistent rotation, which the reference has no analog for.

All pairs in the batch share one padded length, and the comparison is
only ever *within* a sequence (chosen vs alternatives against the same
reference), so the constant padding penalty cancels.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import List, Optional, Sequence, TextIO

import numpy as np

A_PAD = 8  # never matches B_PAD or any real code
B_PAD = 9


@dataclass
class RotationVerification:
    num_checked: int
    num_confirmed: int
    margins: np.ndarray  # (k-1,) chosen_score - best_alternative_score
    chosen_scores: np.ndarray

    @property
    def all_confirmed(self) -> bool:
        return self.num_confirmed == self.num_checked


def _bucket(n: int, q: int = 1024) -> int:
    return ((n + q - 1) // q) * q


def verify_rotations(
    encoded: Sequence[np.ndarray],
    rotations: Sequence[int],
    *,
    samples: int = 8,
    log: Optional[TextIO] = None,
) -> RotationVerification:
    """Score chosen vs alternative rotations on the device.

    ``encoded``: original (un-rotated) code arrays; ``rotations``: the
    chain stage's picks.  Returns per-sequence margins; a negative margin
    means some sampled alternative rotation aligns better to the
    reference sequence than the chosen one.
    """
    from ..dp import nw

    log = log if log is not None else sys.stdout
    k = len(encoded)
    if k < 2:
        return RotationVerification(0, 0, np.zeros(0), np.zeros(0))
    n_pad = _bucket(max(len(e) for e in encoded))

    ref = np.full(n_pad, B_PAD, dtype=np.int32)
    r0 = np.roll(np.asarray(encoded[0]), -int(rotations[0]))
    ref[: len(r0)] = r0

    rows: List[np.ndarray] = []
    per_seq = 1 + samples
    for i in range(1, k):
        e = np.asarray(encoded[i])
        n = len(e)
        cands = [int(rotations[i])]
        # alternatives spread deterministically away from the chosen pick
        for s in range(samples):
            cands.append((int(rotations[i]) + (s + 1) * n // (samples + 1)) % n)
        for c in cands:
            row = np.full(n_pad, A_PAD, dtype=np.int32)
            row[:n] = np.roll(e, -c)
            rows.append(row)

    a = np.stack(rows)
    b = np.broadcast_to(ref, a.shape)
    scores = nw.pairwise_nw_scores(a, b).reshape(k - 1, per_seq)

    chosen = scores[:, 0]
    best_alt = scores[:, 1:].max(axis=1)
    margins = chosen - best_alt
    confirmed = int((margins >= 0).sum())
    print(
        f"> Verifying rotations on device (pairwise NW oracle)... "
        f"{confirmed}/{k - 1} confirmed",
        file=log,
    )
    for i in range(k - 1):
        if margins[i] < 0:
            print(
                f">   WARNING sequence {i + 1}: an alternative rotation "
                f"outscores the chosen one by {-int(margins[i])}",
                file=log,
            )
    return RotationVerification(k - 1, confirmed, margins, chosen)
