"""Smoke run of the device path on one GPU (or a four-card mesh).

    python chip_smoke.py            # one card: phases 1-5 below
    python chip_smoke.py --cards 4  # four cards: the sharded backend only

One card, every phase through the entry points a user calls:

1. Primates rotation: ``csa-jax R Primates.txt --backend jax``; the
   rotated FASTA must equal the reference output byte for byte and the
   four cascade counts must equal the numpy engine's.
2. Set3 full pipeline: ``csa-jax Set3.txt --backend jax --profile``; the
   aligned rows must equal the reference alignment and the device gap DP
   must have run (``dp_device_dispatches > 0``).
3. 8 x 1 Mbp rotation through ``rotation.pipeline.analyze`` on the
   device engine; rotations must equal the native engine's.
4. Kernels at real widths: the CUDA profile-DP fill against the XLA row
   scan (8/32/64 x 8192^2 gaps and one 17k x 28k gap), the batched NW
   against the native host kernel (64 x 16384); exact equality.
5. Compile time: phases 1-3 run twice; the first (cold) and second
   (warm) walls are reported.  The parity references (numpy and native
   engines) are computed first, off those clocks.

Four cards: the 8 x 1 Mbp rotation and Set3's full pipeline on
``--backend sharded`` over all four cards, against the same references.

Prints one line per phase (wall, parity), and as its last line one JSON
object ``{"ok": true, "device": {...}}``.  Exits non-zero, without that
line, if JAX finds no GPU or any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

REPO = pathlib.Path(__file__).resolve().parent
FIXTURES = REPO / "tests" / "fixtures"


def nvidia_smi() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return (proc.stdout or proc.stderr).strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


class Phases:
    """Runs named phases; every one prints its wall and parity line."""

    def __init__(self):
        self.failed: list[str] = []
        self.walls: dict[str, float] = {}

    def run(self, name: str, fn, *args) -> None:
        t0 = time.perf_counter()
        try:
            ok, detail = fn(*args)
        except (Exception, SystemExit):
            traceback.print_exc()
            ok, detail = False, "raised (traceback above)"
        wall = time.perf_counter() - t0
        self.walls[name] = wall
        if not ok:
            self.failed.append(name)
        print(f"[{name}] wall {wall:.3f} s | parity "
              f"{'OK' if ok else 'FAIL'} | {detail}", flush=True)


def _cli(work: pathlib.Path, mode: list, fixture: str, *flags: str):
    """Run the CLI in-process on a copy of a fixture; returns stdout."""
    from csa_jax import cli
    from csa_jax.utils.profiling import PROFILER

    shutil.copy(FIXTURES / fixture, work)
    PROFILER.reset()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([*mode, str(work / fixture), *flags])
    if rc != 0:
        raise RuntimeError(f"cli exited {rc}:\n{out.getvalue()[-2000:]}")
    return out.getvalue()


def _cascade_counts(text: str):
    found = re.findall(r"(\d+) nodes found", text)
    left = re.findall(r"(\d+) nodes left", text)
    chains = re.findall(r"(\d+) chains found", text)
    return (int(found[-1]), int(left[-2]), int(left[-1]), int(chains[-1]))


def _aligned_rows(path: pathlib.Path):
    return [ln for ln in path.read_text().splitlines()
            if not ln.startswith(">")]


_REFS: dict = {}


def _numpy_primates_counts():
    if "primates" not in _REFS:
        from csa_jax.io import fasta as fio
        from csa_jax.rotation import pipeline as rot

        seqs = fio.load_fasta(str(FIXTURES / "Primates.txt"),
                              log=io.StringIO())
        fio.discard_duplicate_rotations(seqs, log=io.StringIO())
        r = rot.analyze(seqs, log=io.StringIO(), backend="numpy")
        _REFS["primates"] = (int(r.num_collected), int(r.num_after_suffix),
                             int(r.num_after_unique), int(r.num_chains))
    return _REFS["primates"]


def _native_mbp_rotations(seqs):
    if "mbp" not in _REFS:
        from csa_jax.rotation import pipeline as rot

        _REFS["mbp"] = rot.analyze(seqs, log=io.StringIO(),
                                   backend="native").rotations
    return _REFS["mbp"]


def primates_rotation():
    with tempfile.TemporaryDirectory() as td:
        work = pathlib.Path(td)
        text = _cli(work, ["R"], "Primates.txt", "--backend", "jax")
        same = ((work / "Primates-Rotated.fasta").read_bytes()
                == (FIXTURES / "Primates-Rotated.fasta").read_bytes())
    counts = _cascade_counts(text)
    want = _numpy_primates_counts()
    return (same and counts == want,
            f"rotated FASTA byte-identical={same}; counts {counts} "
            f"vs numpy {want}")


def set3_pipeline(backend: str = "jax"):
    with tempfile.TemporaryDirectory() as td:
        work = pathlib.Path(td)
        text = _cli(work, [], "Set3.txt", "--backend", backend, "--profile")
        same = (_aligned_rows(work / "Set3-Aligned.fasta")
                == _aligned_rows(FIXTURES / "Set3-Rotated-Aligned.fasta"))
    m = re.search(r"dp_device_dispatches: (\d+)", text)
    dispatches = int(m.group(1)) if m else 0
    fill = re.search(r"align\.dp_fill\s+([\d.]+)s", text)
    return (same and dispatches > 0,
            f"aligned rows byte-identical={same}; dp_device_dispatches="
            f"{dispatches}; align.dp_fill "
            f"{fill.group(1) if fill else '?'} s")


def mbp_rotation(backend: str = "jax"):
    import numpy as np

    from csa_jax.rotation import pipeline as rot
    from csa_jax.utils.synthetic import mbp_set

    seqs = mbp_set()
    got = rot.analyze(seqs, log=io.StringIO(), backend=backend).rotations
    want = _native_mbp_rotations(seqs)
    same = bool(np.array_equal(got, want))
    return same, f"8 x 1 Mbp rotations equal to native={same}"


def mbp_collect_share():
    """Stage walls of one profiled warm 8 x 1 Mbp device rotation."""
    from csa_jax.rotation import pipeline as rot
    from csa_jax.utils.profiling import PROFILER
    from csa_jax.utils.synthetic import mbp_set

    seqs = mbp_set()
    PROFILER.reset()
    PROFILER.enabled = True
    t0 = time.perf_counter()
    try:
        rot.analyze(seqs, log=io.StringIO(), backend="jax")
    finally:
        PROFILER.enabled = False
    wall = time.perf_counter() - t0
    idx = {k: round(v, 4) for k, v in PROFILER.phases.items()
           if k.startswith("idx.")}
    collect = idx.get("idx.collect_front", 0) + idx.get("idx.collect_tail", 0)
    return True, (f"profiled wall {wall:.3f} s; collect {collect:.3f} s "
                  f"({100 * collect / wall:.1f}%); stages {idx}")


def _timed(fn, *args, reps: int = 2):
    """(result, best wall of ``reps`` runs after one warm-up run)."""
    out = fn(*args)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        best = min(best, time.perf_counter() - t0)
    return out, best


def _dp_items(G: int, R: int, C: int, seed: int):
    import numpy as np

    from csa_jax.align import progressive

    rng = np.random.default_rng(seed)
    items = []
    for _ in range(G):
        i = int(rng.integers(2, 20))
        codes = rng.integers(0, 4, size=R).astype(np.int8)
        sv = rng.integers(0, i + 1, size=(C, 5)).astype(np.int64)
        items.append((codes, sv, i, progressive.default_top_row(sv, i),
                      -i))
    return items


def dp_kernel(G: int, R: int, C: int):
    """CUDA fill + backtrack vs the XLA row scan + backtrack."""
    import numpy as np

    from csa_jax.dp import profile_cuda, wavefront

    items = _dp_items(G, R, C, seed=G * 7 + R)
    if G == 1:
        it = items[0]
        cuda, t_cuda = _timed(lambda: [profile_cuda.profile_path(*it)])
        xla, t_xla = _timed(lambda: [wavefront.dp_path_rowscan(*it)])
    else:
        cuda, t_cuda = _timed(profile_cuda.profile_paths, items)
        xla, t_xla = _timed(wavefront.dp_paths_rowscan_batched, items)
    same = all(np.array_equal(a, b) for a, b in zip(cuda, xla))
    cells = G * R * C
    return same, (f"{G} x {R} x {C}: CUDA {t_cuda:.4f} s "
                  f"({cells / t_cuda / 1e9:.2f} Gcell/s), XLA row scan "
                  f"{t_xla:.4f} s ({cells / t_xla / 1e9:.2f} Gcell/s); "
                  f"paths equal={same}")


def nw_batch(B: int = 64, L: int = 16384):
    import numpy as np

    from csa_jax.dp import nw

    rng = np.random.default_rng(11)
    a = rng.integers(0, 4, size=(B, L))
    b = rng.integers(0, 4, size=(B, L))
    dev, t_dev = _timed(nw.pairwise_nw_scores, a, b, reps=1)
    t0 = time.perf_counter()
    host = nw.nw_scores_host(a, b)
    t_host = time.perf_counter() - t0
    same = bool((dev == host).all())
    cells = B * L * L
    return same, (f"{B} x {L}^2: device {t_dev:.3f} s "
                  f"({cells / t_dev / 1e9:.2f} Gcell/s), native host "
                  f"{t_host:.3f} s; scores equal={same}")


def references():
    """The parity references of phases 1 and 3, off the phases' clocks."""
    from csa_jax.utils.synthetic import mbp_set

    counts = _numpy_primates_counts()
    _native_mbp_rotations(mbp_set())
    return True, f"numpy Primates counts {counts}; native 8 x 1 Mbp rotations"


def one_card(ph: Phases) -> None:
    ph.run("0 references", references)
    for rnd in ("cold", "warm"):
        ph.run(f"1 primates rotation ({rnd})", primates_rotation)
        ph.run(f"2 set3 pipeline ({rnd})", set3_pipeline)
        ph.run(f"3 mbp rotation ({rnd})", mbp_rotation)
    ph.run("3 mbp rotation stage walls", mbp_collect_share)
    for G, R, C in [(8, 8192, 8192), (32, 8192, 8192), (64, 8192, 8192),
                    (1, 17408, 28672)]:
        ph.run(f"4 profile-DP kernel {G}x{R}x{C}", dp_kernel, G, R, C)
    ph.run("4 NW batch 64x16384", nw_batch)
    for n in ("1 primates rotation", "2 set3 pipeline", "3 mbp rotation"):
        cold, warm = ph.walls[f"{n} (cold)"], ph.walls[f"{n} (warm)"]
        print(f"[5 compile] {n}: cold {cold:.3f} s, warm {warm:.3f} s, "
              f"compile and first-run cost {cold - warm:.3f} s", flush=True)


def four_cards(ph: Phases) -> None:
    ph.run("mbp rotation (sharded, 4 cards)", mbp_rotation, "sharded")
    ph.run("set3 pipeline (sharded, 4 cards)", set3_pipeline, "sharded")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    for line in nvidia_smi().splitlines():
        print(f"nvidia-smi: {line}", flush=True)
    import jax

    devices = jax.devices()
    print(f"jax.devices(): {devices}", flush=True)
    if devices[0].platform != "gpu":
        print(f"FAIL: JAX found no GPU (platform {devices[0].platform})",
              file=sys.stderr)
        return 2
    if len(devices) < args.cards:
        print(f"FAIL: --cards {args.cards} but JAX sees {len(devices)}",
              file=sys.stderr)
        return 2
    from csa_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    print(f"compile cache: {jax.config.jax_compilation_cache_dir}",
          flush=True)

    ph = Phases()
    (one_card if args.cards == 1 else four_cards)(ph)
    if ph.failed:
        print(f"FAIL: {len(ph.failed)} phase(s) failed: {ph.failed}",
              file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
