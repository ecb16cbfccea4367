"""JAX's persistent compilation cache, in one place.

Compiling the unrolled n=65536 decoders of a rate ladder can take most of a
cold run, so entry points that compile production programs (``bench.py``,
``chip_smoke.py``, the benchmark scripts) turn the persistent cache on here.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing.  Otherwise the cache lives at a fixed path inside the
checkout, ``<repo>/.jax_cache`` (listed in ``.gitignore``): the directory is
part of what makes a later run find the entries again, so it must not move.
"""

from __future__ import annotations

import os

__all__ = ["CHECKOUT_CACHE_DIR", "enable_compile_cache"]

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
