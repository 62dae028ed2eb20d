"""Bit-exact rotation parity against the reference CSA outputs.

The expected ``*-Rotated.fasta`` fixtures were produced by compiling and
running the reference implementation (``CSA R <set>``) on the example sets it
ships (Manual/Primates.txt, Manual/Mammals.txt, website/Examples.zip Set3).
"""

import io

import pytest

from csa_jax.io.fasta import (
    load_fasta,
    discard_duplicate_rotations,
    parse_rotated_header,
    rotate_text,
)
from csa_jax.rotation.pipeline import analyze

CASCADES = {
    # collected, after-suffix-filter, after-unique-filter, chains
    "Primates": (3004, 2209, 58, 19),
    "Mammals": (3136, 2412, 51, 20),
    "Set3": (2059, 1733, 5, 2),
}


def _expected(fixtures_dir, name):
    rots = {}
    texts = {}
    with open(fixtures_dir / f"{name}-Rotated.fasta") as f:
        cur = None
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                nm, rot = parse_rotated_header(line[1:])
                cur = nm.split()[0]
                rots[cur] = rot
                texts[cur] = ""
            elif cur:
                texts[cur] += line.strip()
    return rots, texts


@pytest.mark.parametrize("name", ["Primates", "Mammals", "Set3"])
def test_rotation_parity(fixtures_dir, name):
    seqs = load_fasta(fixtures_dir / f"{name}.txt", log=io.StringIO())
    discard_duplicate_rotations(seqs, log=io.StringIO())
    res = analyze(seqs, log=io.StringIO())

    expected_rots, expected_texts = _expected(fixtures_dir, name)
    got = {n.split()[0]: int(r) for n, r in zip(seqs.names, res.rotations)}
    assert got == expected_rots

    cascade = (
        res.num_collected,
        res.num_after_suffix,
        res.num_after_unique,
        res.num_chains,
    )
    assert cascade == CASCADES[name]

    # rotated text round-trip matches the reference output exactly
    for nm, text, rot in zip(seqs.names, seqs.texts, res.rotations):
        key = nm.split()[0]
        assert rotate_text(text, int(rot)) == expected_texts[key]


def test_chain_cycle_surfaces_as_rotation_error(fixtures_dir, monkeypatch):
    """A cycle in the successor links (reference: infinite loop/segfault)
    must surface as a clean RotationError, not a raw RuntimeError."""
    from csa_jax.rotation import chains as chains_mod
    from csa_jax.rotation import pipeline as pipeline_mod

    def boom(*a, **k):
        raise chains_mod.ChainCycleError("synthetic cycle")

    monkeypatch.setattr(chains_mod, "assemble_chains", boom)
    seqs = load_fasta(str(fixtures_dir / "tiny" / "t1.txt"), log=io.StringIO())
    with pytest.raises(pipeline_mod.RotationError):
        analyze(seqs, log=io.StringIO())


def test_chain_cycle_detected_linear_time():
    """An adversarial tail-into-cycle link graph raises in O(nb) walk
    steps (visited-mark check; the old guard spun len(blocks)^2
    iterations before erroring).  A FULL cycle back to the walking head
    is NOT an error: that is how cyclic genomes legitimately fold
    (csamsa.c:202-211 self-absorption, exercised by the sharded
    synthetic parity tests)."""
    import numpy as np

    from csa_jax.rotation import chains as chains_mod

    nb = 5000
    blocks = [
        chains_mod.Block(depth=2, positions=np.array([i, i]))
        for i in range(nb)
    ]
    # head 0 -> 1 -> 2 -> ... -> nb-1 -> 1  (cycle not through the head)
    for i, b in enumerate(blocks):
        b.nextblock = blocks[i + 1] if i + 1 < nb else blocks[1]
        b.next_interval = 1
    with pytest.raises(chains_mod.ChainCycleError):
        chains_mod.assemble_chains(blocks, [nb * 4, nb * 4])


def test_chain_absorb_previous_head_still_works():
    """A later head linking into an earlier-formed chain absorbs it
    (csamsa.c:202-211) and is not misdiagnosed as a cycle."""
    import numpy as np

    from csa_jax.rotation import chains as chains_mod

    # list order: A (head of A->B), then C with C->A
    a = chains_mod.Block(depth=5, positions=np.array([0, 0]))
    b = chains_mod.Block(depth=4, positions=np.array([10, 10]))
    c = chains_mod.Block(depth=3, positions=np.array([30, 30]))
    a.nextblock = b
    a.next_interval = 5
    c.nextblock = a
    c.next_interval = 2
    n = chains_mod.assemble_chains([a, b, c], [64, 64])
    assert n == 1
    assert c.totalsize != -1 and a.totalsize == -1 and b.totalsize == -1


def test_chain_cross_walk_revisit_is_not_a_cycle():
    """A block absorbed mid-chain by an EARLIER walk that a later walk
    reaches again (successor in-degree >= 2, which link_blocks can
    produce) is re-absorbed like csamsa.c:216-226, not misdiagnosed as a
    cycle (X->C->T walked first, then Y->C must not raise)."""
    import numpy as np

    from csa_jax.rotation import chains as chains_mod

    x = chains_mod.Block(depth=6, positions=np.array([0, 0]))
    y = chains_mod.Block(depth=5, positions=np.array([40, 40]))
    c = chains_mod.Block(depth=4, positions=np.array([10, 10]))
    t = chains_mod.Block(depth=3, positions=np.array([20, 20]))
    x.nextblock = c
    x.next_interval = 4
    y.nextblock = c
    y.next_interval = 2
    c.nextblock = t
    c.next_interval = 6
    n = chains_mod.assemble_chains([x, y, c, t], [64, 64])
    # reference semantics: walk X absorbs C,T (chains 4->2); walk Y
    # re-absorbs both, decrementing the count again (csamsa.c:224)
    assert n == 0
    assert x.totalsize != -1 and y.totalsize != -1
    assert c.totalsize == -1 and t.totalsize == -1
