"""Where JAX keeps compiled programs between runs.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module changes nothing.  Otherwise the cache lives in ``.jax_cache`` at
the root of the checkout (listed in ``.gitignore``): a fixed path, since
the path is part of what a later run must find again.
"""

from __future__ import annotations

import os
import pathlib

CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> None:
    """Point JAX's persistent compilation cache at :data:`CACHE_DIR`
    unless ``JAX_COMPILATION_CACHE_DIR`` already names one."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
