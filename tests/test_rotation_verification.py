"""The rotation-verification oracle (SURVEY.md §7 M1 consumer).

Exactness of the batched NW scores vs the host kernel is covered by
tests/test_pallas_nw.py; these tests pin the oracle's verdicts.
"""

import io

import numpy as np

from csa_jax.rotation import verification


def _family(k=4, n=96, seed=5):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=n, dtype=np.int64)
    encoded = [base.copy()]
    shifts = [0]
    for _ in range(k - 1):
        sh = int(rng.integers(1, n))
        row = np.roll(base, sh).copy()
        for _ in range(2):
            row[int(rng.integers(0, n))] = int(rng.integers(0, 4))
        encoded.append(row)
        shifts.append(sh)
    return encoded, shifts


def test_correct_rotations_confirmed():
    encoded, shifts = _family()
    # rolling row i by -shift restores base alignment: rotation = shift
    sink = io.StringIO()
    res = verification.verify_rotations(encoded, shifts, log=sink)
    assert res.num_checked == len(encoded) - 1
    assert res.all_confirmed, res.margins
    assert "confirmed" in sink.getvalue()


def test_wrong_rotation_flagged():
    encoded, shifts = _family(seed=9)
    wrong = list(shifts)
    wrong[2] = (shifts[2] + len(encoded[2]) // 2) % len(encoded[2])
    sink = io.StringIO()
    res = verification.verify_rotations(
        encoded, wrong, samples=5, log=sink
    )
    assert not res.all_confirmed
    assert "WARNING" in sink.getvalue()


def test_cli_flag_reaches_oracle(tmp_path, fixtures_dir, monkeypatch):
    # tiny synthetic FASTA keeps the oracle's cost trivial
    encoded, shifts = _family(k=3, n=64, seed=2)
    chars = np.frombuffer(b"ACGT", dtype=np.uint8)
    fasta = tmp_path / "fam.fasta"
    with open(fasta, "w") as f:
        for i, e in enumerate(encoded):
            f.write(f">s{i}\n{chars[e].tobytes().decode()}\n")

    calls = {}
    from csa_jax.dp import nw

    real = nw.pairwise_nw_scores

    def spy(a, b):
        calls["n"] = calls.get("n", 0) + 1
        return real(a, b)

    monkeypatch.setattr(nw, "pairwise_nw_scores", spy)
    monkeypatch.chdir(tmp_path)
    from csa_jax import cli

    rc = cli.main(["R", str(fasta), "--verify-rotations"])
    assert rc == 0
    assert calls.get("n", 0) >= 1
