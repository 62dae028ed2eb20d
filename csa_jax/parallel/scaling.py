"""Virtual-mesh scaling measurement for the sharded rotation backend.

BASELINE.md's ">= 0.8 scaling efficiency at 2+ hosts" needs real
devices; what a virtual CPU mesh CAN measure and model, and what this
module produces, is:

* the warm wall time of the sharded block stage at 1/2/4/8 devices of the
  virtual CPU mesh (``--xla_force_host_platform_device_count``).  All
  virtual devices timeshare the same physical cores, so these walls
  validate that the sharded program COMPILES AND RUNS at every mesh size
  and that adding shards does not add superlinear overhead — they are NOT
  a hardware speedup curve and are labeled as such;
* the analytic per-shard work and collective-volume model that governs
  real-mesh efficiency: per device the block stage touches
  ``levels * 3 * (N / n_dev)`` sorted int32 elements (prefix-doubling
  ladder) while the explicit merge moves only ``O(cap)``-sized block
  tables (psum of uniqueness votes + all_gather of position columns),
  i.e. the communication:compute byte ratio shrinks linearly in sequence
  length — the regime where interconnect-bound efficiency >= 0.8 is
  expected.

Run standalone (prints one JSON line)::

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python -m csa_jax.parallel.scaling
"""

from __future__ import annotations

import json
import os as _os
import time

import numpy as np


def _synthetic_set(k: int = 8, n: int = 100_000, seed: int = 11):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=n, dtype=np.int64)
    enc = []
    for _ in range(k):
        row = np.roll(base, int(rng.integers(0, n))).copy()
        idxs = rng.integers(0, n, size=n // 200)
        row[idxs] = rng.integers(0, 4, size=n // 200)
        enc.append(row)
    return enc


def _require_devices(n_devices: int) -> None:
    """The virtual mesh comes from the command line (see the module
    docstring); fail early when it was not given."""
    import jax

    if len(jax.devices()) < n_devices:
        raise RuntimeError(
            f"need {n_devices} devices, have {len(jax.devices())}: run "
            "with JAX_PLATFORMS=cpu XLA_FLAGS="
            f"--xla_force_host_platform_device_count={n_devices}"
        )


def measure(k: int = 8, n: int = 100_000, devices=(1, 2, 4, 8), reps: int = 2):
    import jax

    from ..index import engine
    from . import sharded

    _require_devices(max(devices))

    from ..utils.profiling import PROFILER

    enc = _synthetic_set(k, n)
    n_dev_avail = len(jax.devices())
    walls = {}
    stage_walls = {}
    parity_ref = None
    for d in devices:
        if d > n_dev_avail or k % d:
            continue
        mesh = sharded.make_mesh(d, (d, 1))
        # the production sharded path: round-3 engine under GSPMD
        engine.rotation_final_jax(enc, mesh=mesh)  # compile + warm
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            rb = engine.rotation_final_jax(enc, mesh=mesh)
            times.append(time.perf_counter() - t0)
        walls[d] = round(min(times), 3)
        # stage attribution: per-phase walls of one run
        # with stage-boundary syncs (pack / L0 sort / refine / LCP /
        # replicate / collect front / collect tail)
        PROFILER.enabled = True
        PROFILER.reset()
        engine.rotation_final_jax(enc, mesh=mesh)
        stage_walls[d] = {
            name.replace("idx.", ""): round(t, 3)
            for name, t in sorted(PROFILER.phases.items())
        }
        PROFILER.enabled = False
        sig = (
            rb.num_collected,
            rb.num_after_suffix,
            len(rb.final_start),
        )
        if parity_ref is None:
            parity_ref = sig
        elif sig != parity_ref:
            raise AssertionError(
                f"sharded cascade diverged at {d} devices: {sig} != {parity_ref}"
            )

    n_max = engine._bucket(n)
    N = k * n_max
    levels = engine._num_levels(n_max)
    cap = 4096
    model = {
        # per-device bytes touched by the sort ladder (3 int32 operands)
        "per_device_sort_bytes": {
            d: int(levels * 3 * 4 * N / d) for d in walls
        },
        # collective payloads of the explicit merge (shard_map stage):
        # psum votes (cap int32) + all_gather positions (cap * k/d int32
        # per device step)
        "collective_bytes_per_merge": {
            d: int(4 * cap + 4 * cap * k // d) for d in walls
        },
    }
    for d in walls:
        model[f"comm_to_compute_ratio_{d}dev"] = round(
            model["collective_bytes_per_merge"][d]
            / model["per_device_sort_bytes"][d],
            6,
        )
    # sharded ALIGNMENT path parity on the full mesh (gap-axis
    # shard_map; compared against the single-device batch)
    from jax.sharding import Mesh

    from ..align import progressive
    from ..dp import wavefront

    rng = np.random.default_rng(5)
    items = []
    for _ in range(11):
        R = int(rng.integers(20, 200))
        C = int(rng.integers(20, 200))
        i = int(rng.integers(1, 5))
        cds = rng.integers(0, 4, size=R).astype(np.int8)
        sv = rng.integers(0, 3, size=(C, 5)).astype(np.int64)
        top = progressive.default_top_row(sv, i)
        items.append((cds, sv, i, top, -i))
    gap_mesh = Mesh(np.asarray(jax.devices()), ("gap",))
    single = wavefront.dp_paths_device_batched(items)
    shd = wavefront.dp_paths_device_sharded(items, mesh=gap_mesh)
    align_parity = all(
        np.array_equal(a, b) for a, b in zip(single, shd)
    )

    # Overhead attribution: XLA's partitioner
    # REPLICATES lax.sort along a sharded dimension (all-gather + full
    # sort on every device), so per-device sort work does not shrink
    # and the timeshared virtual-mesh walls grow ~linearly in device
    # count.  Measured head-to-head on the engine's sort shape, plus
    # the shard-local block-bitonic alternative (parallel/dsort.py)
    # whose per-device work actually divides.
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from . import dsort

    N = k * engine._bucket(n)
    x = np.random.default_rng(0).integers(0, 1 << 28, size=N, dtype=np.int32)
    xla_sort_walls = {}
    dsort_walls = {}
    g32 = jnp.arange(N, dtype=jnp.int32)
    for d in devices:
        if d > n_dev_avail:
            continue
        mesh1 = Mesh(np.asarray(jax.devices()[:d]), ("x",))
        sh = NamedSharding(mesh1, P("x"))
        xd = jax.device_put(jnp.asarray(x), sh)
        f = jax.jit(lambda a: jax.lax.sort((a, g32), num_keys=1,
                                           is_stable=True))
        jax.block_until_ready(f(xd))
        t0 = time.perf_counter()
        for _ in range(3):
            jax.block_until_ready(f(xd))
        xla_sort_walls[d] = round((time.perf_counter() - t0) / 3, 3)
        dsort.sharded_argsort(x, mesh1)
        t0 = time.perf_counter()
        for _ in range(3):
            dsort.sharded_argsort(x, mesh1)
        dsort_walls[d] = round((time.perf_counter() - t0) / 3, 3)
    ds_ok = bool(
        np.array_equal(
            np.asarray(
                dsort.sharded_argsort(
                    x, Mesh(np.asarray(jax.devices()), ("x",))
                )[1]
            ),
            np.argsort(x, kind="stable"),
        )
    )

    # Set3-scale GIANT merge through the production seqpar path: one
    # ~17k x 28k profile-DP fill column-sharded
    # over the full mesh with ppermute halo exchange + on-device
    # backtrack; walk-order path identical to the host engine's.
    from ..dp import seqpar

    rngg = np.random.default_rng(21)
    Rg, Cg, ig = 17408, 28160, 9
    gcodes = rngg.integers(0, 4, size=Rg).astype(np.int8)
    gsv = rngg.integers(0, 3, size=(Cg, 5)).astype(np.int64)
    gtop = progressive.default_top_row(gsv, ig)
    col_mesh = Mesh(np.asarray(jax.devices()), ("col",))
    seqpar.dp_path_seqpar(gcodes, gsv, ig, mesh=col_mesh, top_row=gtop,
                          edge_rowgap=-ig)  # compile + warm
    t0 = time.perf_counter()
    gpath = seqpar.dp_path_seqpar(gcodes, gsv, ig, mesh=col_mesh,
                                  top_row=gtop, edge_rowgap=-ig)
    giant_wall = time.perf_counter() - t0
    from .. import native

    ghost = native.dp_fill_path(
        gcodes.astype(np.int64), gsv, ig, gtop, -ig
    )
    giant_exact = ghost is not None and np.array_equal(gpath, ghost[1])

    return {
        "workload": f"{k}x{n//1000}kbp synthetic (0.5% mutations)",
        "virtual_mesh_walls_s": walls,
        "stage_walls_s": stage_walls,
        # the honest lens for a c-core host running d virtual devices:
        # every wall contains a min(d, c)/c... i.e. d/c oversubscription
        # factor of pure timesharing; dividing it out estimates the
        # per-device-silicon wall.  Stage sums also differ from e2e
        # walls because stage timing inserts sync barriers.
        "cores": int(_os.cpu_count() or 1),
        "timeshare_normalized_walls_s": {
            d: round(w / max(1, d / (_os.cpu_count() or 1)), 3)
            for d, w in walls.items()
        },
        "stage_walls_normalized_s": {
            d: {
                s: round(w / max(1, d / (_os.cpu_count() or 1)), 3)
                for s, w in sw.items()
            }
            for d, sw in stage_walls.items()
        },
        "giant_merge_seqpar": {
            "shape": f"{Rg}x{Cg} (Set3-scale, {Rg*Cg/1e6:.0f} Mcells)",
            "wall_s_8dev_virtual": round(giant_wall, 2),
            "path_identical_to_host_engine": bool(giant_exact),
        },
        "cascade_parity_across_meshes": True,
        "sharded_alignment_parity_8dev": bool(align_parity),
        "note": (
            "virtual CPU devices timeshare the same cores; walls validate "
            "sharded compile+run at every mesh size, not hardware speedup"
        ),
        "overhead_attribution": {
            "cause": (
                "GSPMD replicates lax.sort along a sharded dim "
                "(all-gather + full sort per device); per-device sort "
                "work does not shrink with the mesh"
            ),
            "xla_sharded_argsort_walls_s": xla_sort_walls,
            "dsort_block_bitonic_walls_s": dsort_walls,
            "dsort_exact_vs_stable_argsort": ds_ok,
        },
        "model": model,
    }


def main():
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    print(json.dumps(measure()))


if __name__ == "__main__":
    main()
