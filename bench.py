"""Device benchmark: one process, one GPU, one JSON line.

    python bench.py              # everything below except the Mbp pipeline
    python bench.py --mbp-full   # also the 8 x 1 Mbp full pipeline

Every measurement runs in this process, which holds the card for its
whole life (a second JAX process would find most of the card's memory
reserved).  Walls are warm (one untimed run first, compile included
there) and taken with the host clock around calls that return host
arrays.  Each output-producing run is checked for parity with its
reference: the reference CSA fixtures, the numpy/native engines, or the
XLA row scan.

Measured:

- Primates rotation wall, ``auto`` (native below 4 M chars) and ``jax``;
- Primates full pipeline (rotate + align + images, CLI in-process) on the
  native and the device backends, aligned FASTA vs the fixture;
- Set3 full pipeline on the device backend (its ~480 Mcell merges run
  the device gap DP; ``dp_device_dispatches`` counts them);
- 8 x 1 Mbp and 4 x 5 Mbp rotation on the device engine (the first
  against the native engine);
- the profile-DP fill + backtrack, CUDA kernel vs the XLA row scan, at
  8/32/64 x 8192^2 gaps and one 17408 x 28672 gap;
- the batched pairwise NW (rotation-verification oracle) vs the native
  host kernel.

Exits non-zero if JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import re
import shutil
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from chip_smoke import FIXTURES, _aligned_rows, _dp_items, nvidia_smi  # noqa: E402,E501
from chip_smoke import _timed as _best  # noqa: E402

ROTATION_BASELINE_S = 0.45      # reference `CSA R Primates.txt` user time
FULL_PIPELINE_BASELINE_S = 9.5  # reference `CSA Primates.txt` user time


def _primates():
    from csa_jax.io import fasta as fio

    return fio.load_fasta(str(FIXTURES / "Primates.txt"), log=io.StringIO())


def bench_rotation(seqs, backend: str):
    from csa_jax.rotation import pipeline as rot

    res, wall = _best(
        lambda: rot.analyze(seqs, log=io.StringIO(), backend=backend)
    )
    return res.rotations, wall


def bench_pipeline(fixture: str, want: str, backend: str, reps: int = 2):
    """Full `N` mode through the CLI in-process; (wall, identical,
    stdout of the last run)."""
    from csa_jax import cli
    from csa_jax.utils.profiling import PROFILER

    with tempfile.TemporaryDirectory() as td:
        shutil.copy(FIXTURES / fixture, td)
        inp = str(pathlib.Path(td, fixture))

        def run():
            PROFILER.reset()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli.main([inp, "--backend", backend, "--profile"])
            if rc != 0:
                raise RuntimeError(f"cli exited {rc}")
            return out.getvalue()

        text, wall = _best(run, reps=reps)
        same = _aligned_rows(
            pathlib.Path(td, fixture.rsplit(".", 1)[0] + "-Aligned.fasta")
        ) == _aligned_rows(FIXTURES / want)
    return wall, same, text


def bench_profile_dp():
    """CUDA fill + backtrack vs the XLA row scan + backtrack."""
    import numpy as np

    from csa_jax.dp import profile_cuda, wavefront

    out = {}
    for G, R, C in [(8, 8192, 8192), (32, 8192, 8192), (64, 8192, 8192),
                    (1, 17408, 28672)]:
        items = _dp_items(G, R, C, seed=G * 7 + R)
        cuda, t_cuda = _best(profile_cuda.profile_paths, items)
        xla, t_xla = _best(wavefront.dp_paths_rowscan_batched, items)
        out[f"{G}x{R}x{C}"] = {
            "cuda_s": t_cuda,
            "xla_rowscan_s": t_xla,
            "cuda_gcells_per_s": G * R * C / t_cuda / 1e9,
            "xla_rowscan_gcells_per_s": G * R * C / t_xla / 1e9,
            "paths_equal": all(np.array_equal(a, b)
                               for a, b in zip(cuda, xla)),
        }
    # the seqpar XLA body (what --backend sharded runs for giant merges)
    # on a 1-card column mesh, against the CUDA path on the same gap
    (path, nsteps), t_sp = _best(_seqpar_xla, items[0])
    out[f"{G}x{R}x{C}"]["xla_seqpar_1card_s"] = t_sp
    out[f"{G}x{R}x{C}"]["xla_seqpar_equal"] = bool(
        np.array_equal(np.asarray(path)[: int(nsteps)], cuda[0]))
    return out


def _seqpar_xla(item):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from csa_jax.config import scoring
    from csa_jax.dp import seqpar

    row_codes, sv, i, top, erg = item
    codes, svp, topp, R, C, Rp, Cp, Rb = seqpar._pad_for_mesh(
        row_codes, sv, top, 1, 64)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("col",))
    prog = seqpar._seqpar_path_program(mesh, Rp, Cp, 1, Rb, scoring())
    path, nsteps = prog(jnp.asarray(codes), jnp.asarray(svp),
                        jnp.asarray(topp), jnp.int32(i), jnp.int32(erg),
                        jnp.int32(R), jnp.int32(C))
    return np.asarray(path), int(nsteps)


def bench_nw(B: int = 64, L: int = 16384):
    import numpy as np

    from csa_jax.dp import nw

    rng = np.random.default_rng(11)
    a = rng.integers(0, 4, size=(B, L))
    b = rng.integers(0, 4, size=(B, L))
    dev, t_dev = _best(nw.pairwise_nw_scores, a, b, reps=2)
    t0 = time.perf_counter()
    host = nw.nw_scores_host(a, b)
    t_host = time.perf_counter() - t0
    return {
        "shape": f"{B}x{L}x{L}",
        "device_s": t_dev,
        "device_gcells_per_s": B * L * L / t_dev / 1e9,
        "native_host_s": t_host,
        "scores_equal": bool((dev == host).all()),
    }


def bench_mbp_full():
    """8 x 1 Mbp full pipeline, native and device backends, in-process."""
    import numpy as np

    from csa_jax import cli
    from csa_jax.utils.synthetic import mbp_set

    out = {}
    letters = np.array(list("ACGT"))
    aligned = {}
    with tempfile.TemporaryDirectory() as td:
        fasta = pathlib.Path(td, "m1.fasta")
        with open(fasta, "w") as f:
            for idx, enc in enumerate(mbp_set().encoded_all()):
                s = "".join(letters[enc])
                f.write(f">m{idx}\n")
                for j in range(0, len(s), 70):
                    f.write(s[j:j + 70] + "\n")
        for backend in ("native", "jax"):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main([str(fasta), "--backend", backend])
            out[f"mbp_full_pipeline_{backend}_wall_s"] = (
                time.perf_counter() - t0)
            if rc == 0:
                aligned[backend] = pathlib.Path(
                    td, "m1-Aligned.fasta").read_text()
    out["mbp_full_pipeline_identical"] = (
        len(aligned) == 2 and aligned["native"] == aligned["jax"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mbp-full", action="store_true",
                    help="also run the 8 x 1 Mbp full pipeline")
    args = ap.parse_args(argv)

    import jax
    import numpy as np

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX's device platform is {dev.platform}",
              file=sys.stderr)
        return 2
    from csa_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    out = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices()),
                      "nvidia_smi": nvidia_smi()}}

    from csa_jax.rotation import pipeline as rot
    from csa_jax.utils.synthetic import mbp_set

    seqs = _primates()
    want = rot.analyze(seqs, log=io.StringIO(), backend="native").rotations
    for backend in ("auto", "jax"):
        rots, wall = bench_rotation(seqs, backend)
        out[f"primates_rotation_{backend}_wall_s"] = wall
        out[f"primates_rotation_{backend}_equal_native"] = bool(
            np.array_equal(rots, want))
    out["primates_rotation_auto_vs_reference"] = (
        ROTATION_BASELINE_S / out["primates_rotation_auto_wall_s"])

    for backend in ("native", "jax"):
        wall, same, _ = bench_pipeline(
            "Primates.txt", "Primates-Rotated-Aligned.fasta", backend)
        out[f"primates_pipeline_{backend}_wall_s"] = wall
        out[f"primates_pipeline_{backend}_identical"] = same
    out["primates_pipeline_native_vs_reference"] = (
        FULL_PIPELINE_BASELINE_S / out["primates_pipeline_native_wall_s"])

    wall, same, text = bench_pipeline(
        "Set3.txt", "Set3-Rotated-Aligned.fasta", "jax", reps=1)
    m = re.search(r"dp_device_dispatches: (\d+)", text)
    out["set3_pipeline_jax_wall_s"] = wall
    out["set3_pipeline_jax_identical"] = same
    out["set3_device_dp_dispatches"] = int(m.group(1)) if m else 0

    mbp = mbp_set()
    rots, wall = bench_rotation(mbp, "jax")
    nat, wall_nat = bench_rotation(mbp, "native")
    out["mbp_rotation_8x1m_jax_wall_s"] = wall
    out["mbp_rotation_8x1m_native_wall_s"] = wall_nat
    out["mbp_rotation_8x1m_jax_equal_native"] = bool(
        np.array_equal(rots, nat))
    _, wall = bench_rotation(mbp_set(n=5_000_000, k=4, seed=13), "jax")
    out["mbp_rotation_4x5m_jax_wall_s"] = wall

    out["profile_dp"] = bench_profile_dp()
    out["nw"] = bench_nw()
    if args.mbp_full:
        out.update(bench_mbp_full())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
