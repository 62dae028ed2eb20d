"""Run-time configuration for csa-jax.

The reference compiles every knob in (scoring at
``/root/reference/source/dynamicprogramming.c:16-19``, alphabet size,
``MAXNUMBEROFSEQS``, image geometry, ``minblocksize`` defaults at
``csamsa.c:573-575``); SURVEY.md §5 makes a real config system part of
this framework's scope.  This module is the single place those knobs
live:

* :class:`Scoring` — the progressive-DP scoring matrix, threaded through
  all three DP backends (numpy ``align/progressive.py``, native
  ``native/csa_host.cpp``, device ``dp/wavefront.py``) so a non-default
  matrix produces identical alignments on every backend
  (tests/test_config_scoring.py).
* :class:`RunConfig` — pipeline-level knobs: block-size/interval bounds
  (the reference's commented-out ``-M``/``-S``/``-W`` flag surface,
  csamsa.c:560-566), the device-mesh shape for the sharded backend, and
  the index engines' k-mer packing width.

Precision is a documented fixed choice, not a knob: DP scores are int32
on device / int64 on the numpy host path (both exact for every reachable
score; the parity tests pin them), sequence positions are int32 on
device (< 2^31 at the 5 Mbp BASELINE bound) and int64 on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

INT_MAX = 2**31 - 1


@dataclass(frozen=True)
class Scoring:
    """Progressive-DP scoring (dynamicprogramming.c:16-19 defaults)."""

    match: int = 1
    mismatch: int = -1
    indel: int = -1
    doublegap: int = 0

    def as_tuple(self):
        return (self.match, self.mismatch, self.indel, self.doublegap)


@dataclass(frozen=True)
class RunConfig:
    """Pipeline-level knobs (CLI flags map 1:1 onto these fields).

    Constructed by ``cli.main`` from the parsed flags and installed via
    :func:`set_run_config`; consumed by ``rotation.pipeline.analyze``
    (max_interval, mesh_shape), ``report.blocks_report`` (block-size
    display bounds), ``index.engine`` (pack_w, read at first import) and
    ``align.progressive`` (the host/device DP routing gates).
    """

    scoring: Scoring = Scoring()
    min_block_size: int = 10          # csamsa.c:573
    max_block_size: int = INT_MAX     # csamsa.c:574
    max_interval: int = INT_MAX       # csamsa.c:575
    mesh_shape: tuple | None = None   # (seq, pos) axes for --backend sharded
    pack_w: int = 12                  # k-mer packing width of the index
    #                                   engines (5**pack_w must fit int32);
    #                                   frozen into the compiled device
    #                                   programs at first engine import
    # DP device-routing gates: merges (and batched rounds) below these
    # cell counts stay on the host engine.  Not yet re-measured on the
    # current device; tune via --device-min-cells / env overrides.
    device_min_cells: int = 100_000_000  # per-merge device DP gate
    batch_min_cells: int = 70_000_000    # whole-round batched-launch gate


DEFAULT_SCORING = Scoring()
_scoring = DEFAULT_SCORING
_run_config = RunConfig()


def run_config() -> RunConfig:
    return _run_config


def set_run_config(cfg: RunConfig) -> None:
    """Install the pipeline config (and its scoring matrix).

    ``pack_w`` only takes effect if :mod:`csa_jax.index.engine` has not
    been imported yet (the width is frozen into every compiled program's
    shape space); the CLI installs the config before touching the
    engines.
    """
    global _run_config
    _run_config = cfg
    if cfg.scoring != scoring():
        set_scoring(cfg.scoring)


def scoring() -> Scoring:
    return _scoring


def set_scoring(s: Scoring) -> None:
    """Install a scoring matrix across all three DP backends.

    Rebinds the numpy backend's module globals (used at run time by
    every arithmetic site in ``align/progressive.py``) and pushes the
    values into the native host kernels when the library is built; the
    device backend reads :func:`scoring` per call and keys its jit cache
    on the tuple, so previously compiled programs stay valid.
    """
    global _scoring
    _scoring = s
    from .align import progressive

    progressive.MATCH = s.match
    progressive.MISMATCH = s.mismatch
    progressive.INDEL = s.indel
    progressive.DOUBLEGAP = s.doublegap
    from . import native

    native.push_scoring(s)
