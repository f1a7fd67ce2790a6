"""Test configuration.

Tests validate numerics against the reference's float64-derived golden values,
so they run on CPU in float64 with a virtual 8-device mesh for the sharding
tests. Tests that need a GPU carry the `gpu` marker and take the `gpu_card`
fixture, which decides at run time whether a card is present and skips when
there is none (run them on a GPU machine with `pytest tests -m gpu`).
"""
import os
import shutil
import subprocess

import pytest

flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (flags + ' --xla_force_host_platform_device_count=8').strip()

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)

# The suite's wall time is dominated by XLA CPU compiles of the big jitted
# programs (REMD ladders, RESPA scans, PME pipelines), most of which are
# identical across runs. The persistent cache keys on the optimized HLO, so
# it is safe across source changes and cuts a full re-run severalfold.
from mbpol_openmm_plugin_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_time_secs=1.0)


@pytest.fixture
def gpu_card():
    """The `nvidia-smi -L` listing of this machine's GPUs; skips the test
    when there is none. (This process itself stays on the CPU: GPU tests
    run their work in a child process.)"""
    smi = shutil.which('nvidia-smi')
    out = ''
    if smi:
        r = subprocess.run([smi, '-L'], capture_output=True, text=True,
                           timeout=60)
        out = r.stdout.strip() if r.returncode == 0 else ''
    if not out:
        pytest.skip('no NVIDIA GPU on this machine')
    return out
