"""The persistent XLA compile cache, set up in one place.

A cache hit needs the same directory every time (the path is part of the
key), so the directory is fixed: `JAX_COMPILATION_CACHE_DIR` when it is
set, otherwise `.jax_cache` at the root of the checkout (listed in
.gitignore).
"""
import os

CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir():
    """The directory the persistent compile cache lives in."""
    return (os.environ.get('JAX_COMPILATION_CACHE_DIR')
            or os.path.join(CHECKOUT_ROOT, '.jax_cache'))


def enable_compile_cache(min_compile_time_secs=2.0):
    """Point JAX's persistent compile cache at compile_cache_dir() and cache
    every program that took at least `min_compile_time_secs` to compile.
    Returns the directory."""
    import jax
    path = compile_cache_dir()
    jax.config.update('jax_compilation_cache_dir', path)
    jax.config.update('jax_persistent_cache_min_compile_time_secs',
                      float(min_compile_time_secs))
    return path
