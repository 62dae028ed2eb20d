"""Tool-mode parity: SP score (S), MSF convert (M), clean (C)."""

import io
import pathlib
import shutil

from csa_jax.tools import files

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


def test_sum_of_pairs_score_primates_reference_values():
    """Reference `CSA S Primates-Rotated-Aligned.fasta` ground truth
    (SURVEY.md par.4: size 19138, SP 1078482, conserved 7704)."""
    log = io.StringIO()
    score = files.sum_of_pairs_score(
        str(FIXTURES / "Primates-Rotated-Aligned.fasta"), log=log
    )
    assert score == 1078482
    text = log.getvalue()
    assert "Consensus size = 19138" in text
    assert "Average gaps per sequence = 2556" in text
    assert "Number of conserved columns = 7704" in text


def test_msf_roundtrip_structure(tmp_path):
    src = FIXTURES / "tiny" / "t1-Aligned.fasta"
    dst = tmp_path / "t1-Aligned.fasta"
    shutil.copy(src, dst)
    out = files.fasta_to_msf(str(dst), log=io.StringIO())
    text = open(out).read()
    assert text.startswith("!!NA_MULTIPLE_ALIGNMENT 1.0")
    assert "MSF: " in text and "//" in text
    # all alignment chars present (gaps as dots)
    body = text.split("//", 1)[1]
    ref_rows = [
        l for l in open(src).read().splitlines() if not l.startswith(">")
    ]
    total_chars = sum(len(r) for r in ref_rows)
    got = sum(
        1 for c in body if c.isalpha() or c == "."
    ) - body.count("Name:")
    assert got >= total_chars  # names add letters; content is superset


def test_clean_fasta(tmp_path):
    dirty = tmp_path / "dirty.fasta"
    dirty.write_text(">seq one\nacg t-NRY\nTT\n>seq two\nGG gg\n")
    out = files.clean_fasta(str(dirty), log=io.StringIO())
    text = open(out).read()
    assert text == ">seq one\nACGTTT\n>seq two\nGGGG\n"


def test_integrity_check_detects_mismatch(tmp_path):
    a = tmp_path / "a.fasta"
    b = tmp_path / "b.fasta"
    a.write_text(">x\nACGT\n")
    b.write_text(">x\nAC-GA\n")
    log = io.StringIO()
    assert not files.test_alignment_output(str(a), str(b), log=log)
    assert "ERROR" in log.getvalue()
    b.write_text(">x\nAC--GT\n")
    assert files.test_alignment_output(str(a), str(b), log=io.StringIO())


def test_sum_of_pairs_score_mammals_set3_reference_values():
    """Reference `CSA S` ground truth captured from the compiled
    reference on the Mammals and Set3 aligned fixtures."""
    log = io.StringIO()
    score = files.sum_of_pairs_score(
        str(FIXTURES / "Mammals-Rotated-Aligned.fasta"), log=log
    )
    text = log.getvalue()
    assert score == 468662
    assert "Consensus size = 20736" in text
    assert "Average gaps per sequence = 3950" in text
    assert "Number of conserved columns = 7413" in text

    log = io.StringIO()
    score = files.sum_of_pairs_score(
        str(FIXTURES / "Set3-Rotated-Aligned.fasta"), log=log
    )
    text = log.getvalue()
    assert score == 1049049
    assert "Consensus size = 28148" in text
    assert "Average gaps per sequence = 11389" in text
    assert "Number of conserved columns = 3438" in text
