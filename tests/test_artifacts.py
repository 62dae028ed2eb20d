"""Artifact parity: Blocks.csv content vs the reference's own output.

Per docs/PARITY.md, the `Length` (totalsize) column and equal-size row order
are traversal-order-dependent in the reference, so rows are compared as a
set of (label, positions) pairs.
"""

import csv
import io
import os
import pathlib
import subprocess
import sys

from csa_jax.io.fasta import load_fasta, discard_duplicate_rotations

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent


def _csv_rows(path):
    rows = set()
    with open(path) as f:
        reader = csv.reader(f)
        next(reader)  # header
        for row in reader:
            label = row[1]
            positions = tuple(row[2:])
            rows.add((label, positions))
    return rows


def _positions_rows(path):
    """Parse positions.txt: first line = #seqs, then rows of
    ``R G B size pos0 .. posN-1``.  Returns (#seqs, [pos tuples],
    [color triplets])."""
    with open(path) as f:
        n = int(f.readline())
        pos, cols = [], []
        for line in f:
            vals = line.split()
            if not vals:
                continue
            cols.append(tuple(vals[:3]))
            pos.append(tuple(vals[4:]))
    return n, pos, cols


def test_blocks_csv_parity(fixtures_dir, tmp_path):
    src = tmp_path / "Primates.txt"
    src.write_text((fixtures_dir / "Primates.txt").read_text())
    proc = subprocess.run(
        [sys.executable, "-m", "csa_jax.cli", "R", str(src)],
        capture_output=True,
        text=True,
        cwd=tmp_path,
        timeout=1200,
        env={**os.environ,
             "PYTHONPATH": str(REPO_ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")},
    )
    assert proc.returncode == 0, proc.stderr
    assert "> Done!" in proc.stdout
    assert "19 chains found" in proc.stdout

    got = _csv_rows(tmp_path / "Primates-Blocks.csv")
    want = _csv_rows(fixtures_dir / "Primates-Blocks.csv")
    assert got == want

    # all artifacts exist
    for suffix in ("-Rotated.fasta", "-Blocks.csv", "-Blocks.bmp",
                   "-positions.txt", "-imagemap.txt"):
        assert (tmp_path / f"Primates{suffix}").exists()

    # positions.txt content vs the captured reference output
    # (csamsa.c:322-363).  The size column is the traversal-order-
    # dependent totalsize (same class as Blocks.csv Length, PARITY.md)
    # and equal-size rows can swap; the RGB columns are the renderer's
    # own palette (PARITY.md: images are behavioral, not pixel/palette
    # identical) — so the parity contract is the multiset of per-row
    # position tuples plus the sequence count.
    got_n, got_pos, _ = _positions_rows(
        tmp_path / "Primates-positions.txt"
    )
    want_n, want_pos, _ = _positions_rows(
        fixtures_dir / "Primates-positions-ref.txt"
    )
    assert got_n == want_n
    assert sorted(got_pos) == sorted(want_pos)

    # BMP is structurally valid
    from csa_jax.report.bmp import read_bmp_info

    info = read_bmp_info(str(tmp_path / "Primates-Blocks.bmp"))
    assert info["magic"] == "BM" and info["bpp"] == 8


def test_ring_pixels_vectorized_exact():
    """The vectorized quarter-arc enumeration must reproduce the scalar
    walk (graphics.c:1443-1702 semantics) pixel for pixel, in order."""
    import numpy as np

    from csa_jax.report import circular_plot as cp

    for r in (16, 17, 50, 99, 100, 137, 256, 401):
        sx, sy = cp._ring_pixels_scalar(r)
        vx, vy = cp._ring_pixels(r)
        assert np.array_equal(sx, vx), r
        assert np.array_equal(sy, vy), r


def test_rle8_vectorized_exact():
    """Vectorized RLE8 must emit the exact bytes of the serial
    two-pointer scan (runs split left-to-right into 255-pixel chunks,
    00 00 end-of-line, 00 01 end-of-bitmap)."""
    import numpy as np

    from csa_jax.report.bmp import _rle8_encode

    def serial(indices):
        h, w = indices.shape
        out = bytearray()
        for row in range(h - 1, -1, -1):
            line = indices[row]
            i = 0
            while i < w:
                j = i
                v = line[i]
                while j < w and line[j] == v and (j - i) < 255:
                    j += 1
                out += bytes((j - i, int(v)))
                i = j
            out += b"\x00\x00"
        out += b"\x00\x01"
        return bytes(out)

    rng = np.random.default_rng(0)
    for trial in range(12):
        h = int(rng.integers(1, 30))
        w = int(rng.integers(1, 700))
        img = rng.integers(0, 3, size=(h, w)).astype(np.uint8)
        if trial % 3 == 0:
            img[:] = 9  # >255-pixel runs
        assert _rle8_encode(img) == serial(img)


def test_palette_hint_matches_generic_path():
    """A correct Canvas color hint must yield the same palette mapping
    as the np.unique path; a wrong hint must fall back, not corrupt."""
    import numpy as np

    from csa_jax.report.bmp import _build_palette

    rng = np.random.default_rng(1)
    colors = [(0, 0, 0), (255, 255, 255), (10, 200, 30), (1, 2, 3)]
    img = np.array(colors, dtype=np.uint8)[
        rng.integers(0, len(colors), size=(40, 60))
    ]
    pal_g, idx_g = _build_palette(img)
    pal_h, idx_h = _build_palette(img, color_hint=set(colors))
    assert np.array_equal(pal_g, pal_h)
    assert np.array_equal(idx_g, idx_h)
    # hint missing a used color: exact fallback
    pal_w, idx_w = _build_palette(img, color_hint={(0, 0, 0)})
    assert np.array_equal(pal_w, pal_g)
    assert np.array_equal(idx_w, idx_g)
