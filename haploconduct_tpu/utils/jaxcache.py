"""Where compiled XLA programs are kept between processes.

Every entry point (the CLI, chip_smoke.py, bench.py and the library's device
paths) calls enable_compile_cache() before its first compile. When
JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing else is
set here. Otherwise the cache lives in `.jax_cache` at the root of the
checkout (gitignored): a fixed path, because the path is part of what makes
a later process find the entries again.
"""

from __future__ import annotations

import functools
import os

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir(environ=None) -> str:
    """The cache directory for an environment (default: os.environ)."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV) or os.path.join(CHECKOUT, ".jax_cache")


@functools.lru_cache(maxsize=1)
def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir()
    (once per process) and return that directory."""
    path = compile_cache_dir()
    if not os.environ.get(ENV):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
