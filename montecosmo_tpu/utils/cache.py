"""JAX's persistent compilation cache, in one place.

The full model's value+grad takes minutes to compile, so every entry point
(`bench.py`, `chip_smoke.py`, `run/*.py`, the examples) keeps compiled
programs on disk.  Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it
itself and this module sets no other directory; otherwise the cache lives at
the fixed path `<checkout>/.jax_cache` (gitignored), so that repeated runs
from one checkout find it again.
"""
import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir(default=DEFAULT_DIR) -> str:
    """The cache directory: `$JAX_COMPILATION_CACHE_DIR` if set, else `default`."""
    return os.environ.get(ENV_VAR) or str(default)


def enable_compile_cache(default=DEFAULT_DIR, min_compile_secs=10.0) -> str:
    """Turn the persistent cache on for programs that take at least
    `min_compile_secs` to compile; returns the directory in use."""
    import jax

    path = compile_cache_dir(default)
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
