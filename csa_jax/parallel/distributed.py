"""Multi-host (multi-process) launch surface.

The reference is a single process (SURVEY §2: no MPI/NCCL/sockets); this
module is the framework's N-host entry (SURVEY §7 M3): each host runs
the same CLI with a coordinator address, ``jax.distributed.initialize``
forms the global runtime, and every mesh built from ``jax.devices()``
(which lists ALL processes' devices after initialization) spans the
fleet — GSPMD then places collectives within and across hosts, per the
standard JAX multi-controller model.

Launch line (documented in docs/MANUAL.md):

    # on every host h of N:
    csa-jax R input.fasta --backend sharded \
        --coordinator host0:8476 --num-processes N --process-id h

The three flags are required.  Env equivalents: CSA_COORDINATOR /
CSA_NUM_PROCESSES / CSA_PROCESS_ID.

The cross-process code paths are proven without a cluster by
:func:`run_multiprocess_dryrun`: it spawns N real OS processes on this
machine, each owning a disjoint set of virtual CPU devices
(``xla_force_host_platform_device_count``), initializes the distributed
runtime over localhost, and runs the production sharded rotation stage
(index + psum uniqueness vote + all_gather positions,
``parallel/sharded.py``) over the global cross-process mesh, checking
bit-parity against the single-process numpy engine.  ``bench.py``
records the result every round; ``__graft_entry__.dryrun_multihost``
exposes it to the driver.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from typing import Optional


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """``jax.distributed.initialize`` from flags or env; returns True if
    a multi-process runtime was initialized.

    All three values must be provided (flags or CSA_* env) for an
    explicit launch; with none provided, single-process is the quiet
    fallback.
    """
    coordinator = coordinator or os.environ.get("CSA_COORDINATOR")
    if num_processes is None:
        env = os.environ.get("CSA_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("CSA_PROCESS_ID")
        process_id = int(env) if env else None

    import jax

    if coordinator:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
        return jax.process_count() > 1
    return False


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# multi-process CPU dryrun (the cluster-free proof of the cross-process
# code paths)

_CHILD_FLAG = "--_csa-multihost-child"


def _child_main(argv) -> int:
    """One dryrun process: 4 virtual CPU devices, global 2x4 mesh."""
    port, nproc, pid, devs_per_proc = argv[:4]
    import numpy as np

    import jax

    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=int(nproc),
        process_id=int(pid),
    )
    assert jax.process_count() == int(nproc)
    assert jax.device_count() == int(nproc) * int(devs_per_proc), (
        jax.device_count()
    )

    from ..index import cyclic
    from ..parallel import sharded

    # small synthetic circular set: 8 sequences, shared core + noise
    rng = np.random.default_rng(5)
    base = rng.integers(0, 4, size=1500, dtype=np.int64)
    encoded = []
    for s in range(8):
        row = np.roll(base, int(rng.integers(0, 1500))).copy()
        idx = rng.integers(0, 1500, size=12)
        row[idx] = rng.integers(0, 4, size=12)
        encoded.append(row)

    # global mesh over ALL processes' devices: the "seq" axis spans the
    # process boundary, so the merge stage's psum/all_gather cross it
    mesh = sharded.make_mesh()  # all 8 global devices
    blocks = sharded.rotation_blocks_sharded(encoded, mesh=mesh)

    # the shard-local ladder across processes: a process-crossing
    # distributed sort (block-bitonic ppermute exchanges between
    # devices owned by DIFFERENT OS processes) driving the full
    # production index build
    from ..index import engine

    fin = engine.rotation_final_jax(encoded, mesh=mesh)
    fin_ok = None
    if int(pid) == 0 and fin is not None:
        single = engine.rotation_final_jax(encoded)
        fin_ok = bool(
            single is not None
            and np.array_equal(fin.final_start, single.final_start)
            and np.array_equal(fin.final_positions, single.final_positions)
        )
    # DP-phase leg: the batched inter-anchor gap DP
    # shard_mapped over the SAME cross-process mesh — gap shards live on
    # devices owned by different OS processes; every process gathers the
    # full result (process_allgather) and checks it against its local
    # single-device batch bit for bit
    from jax.sharding import Mesh as _Mesh

    from ..align import progressive
    from ..dp import wavefront

    rng_dp = np.random.default_rng(9)
    items = []
    for _ in range(2 * jax.device_count()):
        R = int(rng_dp.integers(30, 160))
        C = int(rng_dp.integers(30, 160))
        i = int(rng_dp.integers(1, 5))
        cds = rng_dp.integers(0, 4, size=R).astype(np.int8)
        sv = rng_dp.integers(0, 3, size=(C, 5)).astype(np.int64)
        top = progressive.default_top_row(sv, i)
        items.append((cds, sv, i, top, -i))
    gap_mesh = _Mesh(np.asarray(jax.devices()), ("gap",))
    paths_sh = wavefront.dp_paths_device_sharded(items, mesh=gap_mesh)
    paths_single = wavefront.dp_paths_device_batched(items)
    dp_ok = all(
        np.array_equal(a, b) for a, b in zip(paths_sh, paths_single)
    )

    result = {
        "ladder_parity_cross_process": fin_ok,
        "dp_parity_cross_process": bool(dp_ok),
        "processes": jax.process_count(),
        "global_devices": jax.device_count(),
        "local_devices": len(jax.local_devices()),
        "mesh_shape": dict(mesh.shape),
        "num_collected": None if blocks is None else int(blocks.num_collected),
        "parity_vs_single_process": None,
    }
    if int(pid) == 0 and blocks is not None:
        # single-process exact reference: the numpy cyclic engine's
        # filtered block set (same cascade pipeline.analyze runs)
        index = cyclic.build_rotation_index(encoded)
        bs = cyclic.collect_blocks(index)
        keep = cyclic.remove_suffix_blocks(bs)
        unique, positions = bs.positions_if_unique()
        wmask = keep & unique
        want = {
            (int(d), tuple(int(x) for x in p))
            for d, p in zip(bs.depth[wmask], positions[wmask])
        }
        gmask = blocks.keep_suffix & blocks.unique
        got = {
            (int(d), tuple(int(x) for x in p))
            for d, p in zip(blocks.depth[gmask], blocks.positions[gmask])
        }
        result["final_blocks"] = len(got)
        result["parity_vs_single_process"] = got == want
        print("CSA_MULTIHOST_RESULT " + json.dumps(result), flush=True)
    jax.distributed.shutdown()
    return 0


def run_multiprocess_dryrun(
    n_processes: int = 2, devices_per_process: int = 4, timeout: int = 900
) -> dict:
    """Spawn ``n_processes`` OS processes x ``devices_per_process``
    virtual CPU devices, run the sharded rotation stage over the global
    mesh, and return process 0's parity result."""
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("CSA_COORDINATOR", None)
    flags = [
        f
        for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    ]
    env["XLA_FLAGS"] = " ".join(
        flags + [f"--xla_force_host_platform_device_count={devices_per_process}"]
    )
    procs = []
    for pid in range(n_processes):
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, "-m", "csa_jax.parallel.distributed",
                    _CHILD_FLAG, str(port), str(n_processes), str(pid),
                    str(devices_per_process),
                ],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
        )
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        return {"ok": False, "error": f"dryrun exceeded {timeout}s"}
    # the result line is authoritative; distributed-runtime teardown can
    # emit nonzero exits / gRPC CANCELLED noise after the work completed
    for rc, out, err in outs:
        for line in out.splitlines():
            if line.startswith("CSA_MULTIHOST_RESULT "):
                res = json.loads(line[len("CSA_MULTIHOST_RESULT "):])
                res["ok"] = bool(
                    res.get("parity_vs_single_process")
                ) and bool(res.get("dp_parity_cross_process"))
                return res
    for rc, out, err in outs:
        if rc != 0:
            return {"ok": False, "error": (err or out)[-400:]}
    return {"ok": False, "error": "no result line from process 0"}


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == _CHILD_FLAG:
        sys.exit(_child_main(sys.argv[2:]))
    print(json.dumps(run_multiprocess_dryrun()))
