"""The persistent compile-cache location (utils/cache.py)."""
import os

import pytest

from mbpol_openmm_plugin_tpu.utils import cache


@pytest.mark.parametrize('env_dir', [None, 'from-env'])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is the
    fixed .jax_cache directory at the root of the checkout (never a temp,
    pid- or time-derived name, which would never hit)."""
    if env_dir is None:
        monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
        want = os.path.join(cache.CHECKOUT_ROOT, '.jax_cache')
        assert os.path.isfile(os.path.join(cache.CHECKOUT_ROOT, 'chip_smoke.py'))
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', want)
    assert cache.compile_cache_dir() == want
    assert cache.compile_cache_dir() == want       # stable across calls
