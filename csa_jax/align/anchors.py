"""Multi-MEM anchor (border node) discovery over the rotated linear sequences.

Accelerator-first equivalent of the reference's alignment-phase tree surgery
(``/root/reference/source/morenodeslinkedlists.c``: ``MarkUsedNodes`` /
``DeleteUnusedNodes`` / ``CollectBorderNodes``): instead of re-threading the
cyclic suffix tree into linear rotated sequences, a **linear suffix index**
of the rotated strings is built (prefix-doubling over the concatenation with
unique per-sequence separators) and border nodes fall out of suffix-array
interval arithmetic:

* a suffix's *matching statistic* ``mstat`` — the longest prefix occurring
  in every sequence — is the min over sequences of its best LCP with that
  sequence's suffixes (segmented running-min sweeps over the LCP array);
* its *attachment depth* is the deepest explicit node of depth <= mstat,
  i.e. the largest adjacent-boundary LCP once boundaries > mstat are
  skipped (full-suffix nodes are boundaries too because separators sort
  below real characters, so a suffix that is a prefix of another sits
  immediately left of its extension run with boundary LCP = its length);
* a border node = all suffixes sharing the same (interval, depth) pair,
  grouped per sequence (reference: each suffix position is attached to the
  deepest all-sequences explicit node on its path, morenodeslinkedlists.c
  ``CollectBorderNodes``/``AddPositions`` :260-326).

A node is kept only when every sequence contributes at least one position
(reference deletes others, morenodeslinkedlists.c:322-325).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


@dataclass
class BorderNode:
    """A Multi-MEM anchor candidate (reference: morenodeslinkedlists.h:11-22).

    ``positions[i]`` are the sorted occurrence starts in rotated sequence
    ``i`` coordinates; ``size`` is the string depth.
    """

    size: int
    positions: List[np.ndarray]  # per sequence, ascending


@dataclass
class LinearIndex:
    """Suffix order of the rotated linear sequences.

    sa entries are (seq, pos) pairs flattened as seq * stride + pos over
    real positions only; ``lcp[i]`` is the (length-capped) LCP between
    entries ``i-1`` and ``i``.
    """

    seq_of: np.ndarray  # (M,) sequence id per sorted entry
    pos_of: np.ndarray  # (M,) rotated-coordinate suffix start per entry
    cap: np.ndarray  # (M,) suffix length per entry
    lcp: np.ndarray  # (M,) adjacent capped LCPs, lcp[0] = 0
    num_seqs: int


def build_linear_index(
    encoded_rotated: Sequence[np.ndarray], backend: str = "numpy"
) -> LinearIndex:
    """Prefix-doubling suffix sort of the concatenated rotated sequences.

    Unique per-sequence separators (values 0..k-1, below all character
    codes) terminate matches and make shorter prefix-suffixes sort first.

    ``backend="jax"`` reuses the device engine's sort machinery
    (:func:`csa_jax.index.engine.linear_suffix_order`) — the same
    workload the reference re-runs tree surgery for
    (morenodeslinkedlists.c:303-326); the numpy path is the exactness
    twin (tests/test_anchors_backend.py).
    """
    k = len(encoded_rotated)
    sizes = np.array([len(e) for e in encoded_rotated], dtype=np.int64)
    total = int(sizes.sum()) + k
    s = np.empty(total, dtype=np.int64)
    offsets = np.zeros(k + 1, dtype=np.int64)
    at = 0
    for i, e in enumerate(encoded_rotated):
        offsets[i] = at
        s[at : at + len(e)] = np.asarray(e, dtype=np.int64) + k
        s[at + len(e)] = i  # unique separator, sorts below all chars
        at += len(e) + 1
    offsets[k] = at

    if backend in ("jax", "native"):
        if backend == "jax":
            from ..index import engine

            sa_all, lcp_all = engine.linear_suffix_order(s)
        else:
            from .. import native

            res = native.linear_index(s, k + 5)
            if res is None:  # no toolchain: numpy exactness twin
                return build_linear_index(encoded_rotated, backend="numpy")
            sa_all = res[0].astype(np.int64)
            lcp_all = res[1].astype(np.int64)
        # the k separator suffixes (first char < k < every real char) are
        # exactly the first k sorted entries; drop them.  Adjacency among
        # the remaining entries is unchanged, so their pairwise LCPs carry
        # over; the new first entry's lcp is 0 by definition.
        sa = sa_all[k:]
        lcp = lcp_all[k:].copy()
        if len(lcp):
            lcp[0] = 0
        seq_of = np.searchsorted(offsets, sa, side="right") - 1
        pos_of = sa - offsets[seq_of]
        cap = sizes[seq_of] - pos_of
        return LinearIndex(
            seq_of=seq_of, pos_of=pos_of, cap=cap, lcp=lcp, num_seqs=k
        )

    rank = s.copy()
    levels = [rank.copy()]
    length = 1
    idx = np.arange(total, dtype=np.int64)
    while length < total:
        shifted = np.full(total, -1, dtype=np.int64)
        shifted[: total - length] = rank[length:]
        order = np.lexsort((shifted, rank))
        r1 = rank[order]
        r2 = shifted[order]
        newgrp = np.ones(total, dtype=np.int64)
        newgrp[0] = 0
        newgrp[1:] = ((r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])).astype(np.int64)
        dense = np.cumsum(newgrp)
        rank = np.empty(total, dtype=np.int64)
        rank[order] = dense
        levels.append(rank.copy())
        length *= 2
        if dense[-1] == total - 1:
            break

    sa = np.argsort(levels[-1], kind="stable")
    # drop separator suffixes (they sort first: ranks of values 0..k-1)
    sep_positions = offsets[1:] - 1
    is_sep = np.zeros(total, dtype=bool)
    is_sep[sep_positions] = True
    sa = sa[~is_sep[sa]]
    m = len(sa)

    # adjacent LCPs by binary descent over the rank levels; separators are
    # unique so matches terminate at sequence ends automatically
    lcp = np.zeros(m, dtype=np.int64)
    if m > 1:
        a = sa[:-1]
        b = sa[1:]
        off = np.zeros(m - 1, dtype=np.int64)
        for t in range(len(levels) - 1, -1, -1):
            step = np.int64(1 << t)
            ga = a + off
            gb = b + off
            ok = (ga < total) & (gb < total)
            eq = ok & (levels[t][np.minimum(ga, total - 1)] == levels[t][np.minimum(gb, total - 1)])
            off = np.where(eq, off + step, off)
        lcp[1:] = off

    seq_of = np.searchsorted(offsets, sa, side="right") - 1
    pos_of = sa - offsets[seq_of]
    cap = sizes[seq_of] - pos_of
    return LinearIndex(
        seq_of=seq_of, pos_of=pos_of, cap=cap, lcp=lcp, num_seqs=k
    )


def _segmented_running_min(values: np.ndarray, seg_ids: np.ndarray) -> np.ndarray:
    """Running min of ``values`` within segments of non-decreasing ids."""
    m = len(values)
    if m == 0:
        return values
    out = values.astype(np.int64)
    # band trick: subtract seg_id * B (B > value range) so each segment's
    # values live in a disjoint decreasing band; a global running min then
    # never crosses bands upward, which is exactly a per-segment reset.
    B = np.int64(1 << 40)
    banded = out - seg_ids.astype(np.int64) * B
    acc = np.minimum.accumulate(banded)
    return acc + seg_ids.astype(np.int64) * B


def _nearest_le_threshold(values: np.ndarray, thresh: np.ndarray):
    """For each index x: Lb = largest j <= x with values[j] <= thresh[x],
    and Rb = smallest j > x with values[j] <= thresh[x] (may be M, the
    virtual 0 sentinel).  Range-min sparse table + binary descent."""
    m = len(values)
    tables = [values.astype(np.int64)]
    t = 0
    while (1 << (t + 1)) <= m:
        prev = tables[-1]
        half = 1 << t
        tables.append(np.minimum(prev[: m - 2 * half + 1], prev[half : m - half + 1]))
        t += 1
    ntab = len(tables)
    idx = np.arange(m, dtype=np.int64)

    # Lb: grow the run (x-len .. x] keeping min(values) > thresh
    ln = np.zeros(m, dtype=np.int64)
    for tt in range(ntab - 1, -1, -1):
        half = np.int64(1 << tt)
        j = idx - ln - half + 1  # window [j, j+half) ending at x-ln
        ok = j >= 0
        mv = np.where(ok, tables[tt][np.maximum(j, 0)], np.int64(-1))
        grow = ok & (mv > thresh)
        ln = np.where(grow, ln + half, ln)
    lb = idx - ln
    # values[0] = 0 <= thresh always, so lb >= 0

    rn = np.zeros(m, dtype=np.int64)
    for tt in range(ntab - 1, -1, -1):
        half = np.int64(1 << tt)
        j = idx + rn + 1
        ok = (j + half - 1) <= (m - 1)  # window [j, j+half) inside array
        jc = np.clip(j, 0, max(m - int(half), 0))
        mv = np.where(ok, tables[tt][jc], np.int64(-1))
        grow = ok & (mv > thresh)
        rn = np.where(grow, rn + half, rn)
    rb = idx + rn + 1  # may be m (virtual 0 sentinel)
    return lb, rb


def compute_border_nodes(
    encoded_rotated: Sequence[np.ndarray],
    backend: str = "numpy",
) -> List[BorderNode]:
    """Compute all border nodes with their per-sequence position lists."""
    idx = build_linear_index(encoded_rotated, backend=backend)
    k = idx.num_seqs
    m = len(idx.lcp)
    seq = idx.seq_of
    cap = idx.cap
    lcp = idx.lcp

    # the attach stats are host-side sweeps regardless of which backend
    # built the suffix index; the C++ kernels are the fastest host path,
    # so every backend uses them when built (the numpy twin below is the
    # exactness reference and the no-toolchain fallback)
    if backend in ("native", "jax"):
        from .. import native

        res = native.anchor_attach(seq, lcp, cap, k)
        if res is not None:
            att, lb2 = res
            return _group_border_nodes(idx, att, lb2)

    # matching statistic vs every other sequence: best lcp to the nearest
    # same-seq-j entry above/below, running-min of boundary lcps between
    INF = np.int64(1 << 60)
    mstat = np.full(m, INF, dtype=np.int64)
    lcp_up = np.concatenate([lcp[1:], [np.int64(0)]])
    for j in range(k):
        is_j = seq == j
        # downward sweep: lcp(x, nearest j-entry y above) =
        # min(lcp[y+1..x]); segments start AT each j entry, whose own
        # boundary lcp[y] must not participate — mask it to INF
        grp = np.cumsum(is_j)
        down = _segmented_running_min(np.where(is_j, INF, lcp), grp)
        has_above = grp > 0
        down = np.where(has_above & ~is_j, down, np.where(is_j, INF, -1))

        # upward sweep: lcp(x, nearest j-entry y below) = min(lcp[x+1..y])
        # = min of lcp_up over [x, y-1]; in reversed order segments start
        # at each j entry, again masking the entry's own boundary
        rev_is = is_j[::-1]
        rgrp = np.cumsum(rev_is)
        rv = np.where(rev_is, INF, lcp_up[::-1])
        up = _segmented_running_min(rv, rgrp)[::-1]
        has_below_mask = (np.cumsum(is_j[::-1])[::-1] - is_j) > 0
        up = np.where(has_below_mask & ~is_j, up, np.where(is_j, INF, -1))

        mj = np.maximum(down, up)
        mj = np.where(is_j, INF, mj)  # own sequence: no constraint
        mj = np.maximum(mj, 0)
        mstat = np.minimum(mstat, mj)
    mstat = np.minimum(mstat, cap)

    # attachment depth: deepest boundary lcp <= mstat around each entry
    lb, rb = _nearest_le_threshold(lcp, mstat)
    lcp_ext = np.concatenate([lcp, [np.int64(0)]])
    att = np.maximum(lcp_ext[lb], lcp_ext[rb])

    # node identity: interval run start at threshold att - 1
    lb2, _ = _nearest_le_threshold(lcp, att - 1)
    return _group_border_nodes(idx, att, lb2)


def _group_border_nodes(
    idx: LinearIndex, att: np.ndarray, lb2: np.ndarray
) -> List[BorderNode]:
    """Group suffix entries into border nodes by (interval, depth)."""
    k = idx.num_seqs
    seq = idx.seq_of
    valid = att >= 1

    nodes: List[BorderNode] = []
    if not np.any(valid):
        return nodes
    krot = idx.pos_of
    order = np.lexsort((krot, seq, att, lb2))
    order = order[valid[order]]
    l_o = lb2[order]
    a_o = att[order]
    s_o = seq[order]
    k_o = krot[order]
    group_break = np.ones(len(order), dtype=bool)
    group_break[1:] = (l_o[1:] != l_o[:-1]) | (a_o[1:] != a_o[:-1])
    group_ids = np.cumsum(group_break) - 1
    num_groups = int(group_ids[-1]) + 1 if len(group_ids) else 0
    if num_groups == 0:
        return nodes
    # vectorized split: entries are sorted by (group, seq, pos), so each
    # (group, seq) run is one contiguous slice
    seq_break = group_break | np.concatenate([[True], s_o[1:] != s_o[:-1]])
    run_starts = np.nonzero(seq_break)[0]
    run_ends = np.concatenate([run_starts[1:], [len(order)]])
    run_group = group_ids[run_starts]
    run_seq = s_o[run_starts]
    # keep only groups covering all k sequences
    seqs_per_group = np.bincount(run_group, minlength=num_groups)
    full = seqs_per_group == k
    depths = np.zeros(num_groups, dtype=np.int64)
    depths[group_ids] = a_o
    run_keep = full[run_group]
    rs = run_starts[run_keep]
    re = run_ends[run_keep]
    rg = run_group[run_keep]
    cuts = np.nonzero(np.concatenate([[True], rg[1:] != rg[:-1]]))[0]
    # emit plain int lists: the list machine consumes them directly, and
    # slicing one materialized Python list beats creating thousands of
    # tiny numpy views + per-node tolist conversions downstream
    k_o_list = k_o.tolist()
    rs_l = rs.tolist()
    re_l = re.tolist()
    for t, cut in enumerate(cuts):
        nxt = cuts[t + 1] if t + 1 < len(cuts) else len(rs)
        positions = [k_o_list[rs_l[r] : re_l[r]] for r in range(cut, nxt)]
        nodes.append(
            BorderNode(size=int(depths[rg[cut]]), positions=positions)
        )
    return nodes
