"""chip_smoke.py: its CPU-checkable phases and its contract.

The script's GPU run is the `gpu`-marked test at the end; the rest runs its
device check, its golden and float64-comparison phases at small size, and
the contract that it fails (printing no result) off a GPU and outside a
checkout of the repository.
"""
import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _no_result(stdout):
    return '"ok"' not in stdout


def test_device_check_refuses_cpu(capsys):
    """JAX on the CPU is not a GPU: the script exits non-zero before any
    phase and prints no result line."""
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert 'no GPU' in str(exc.value.code)
    assert _no_result(capsys.readouterr().out)


def test_script_alone_fails(tmp_path):
    """Copied into a directory without the rest of the repository, the
    script cannot import the package: non-zero exit, no result."""
    shutil.copy(os.path.join(REPO, 'chip_smoke.py'), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    r = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert _no_result(r.stdout)


@pytest.mark.parametrize('system', [('water3', None), ('water3', 1.9),
                                    ('water14', 1.8)])
def test_golden_phase_small_systems(system):
    """The golden phase's checks pass at water3/water14 size (the water50
    and water256 rows run on the card)."""
    name, box = system
    rows = [g for g in chip_smoke.GOLDENS if (g[1], g[2]) == (name, box)]
    assert rows
    assert chip_smoke.golden_phase(rows) == []


def test_compare_phase_against_f64_child():
    """The comparison phase at water14: the float64 reference comes from a
    CPU-only child process, and every term (and the total) is within the
    stated tolerances of this process's evaluation."""
    proc = chip_smoke.start_f64_reference('water14', 1.8)
    ref = chip_smoke.finish_f64_reference(proc, timeout=600)
    assert set(ref) == set(chip_smoke.TERMS) | {'total'}
    assert ref['total'][1].shape == (42, 3)          # 14 waters x O,H,H
    assert chip_smoke.compare_phase('water14', 1.8, ref) == []


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_card):
    """The whole smoke run on this machine's GPU, in a child process (this
    test process is pinned to the CPU)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ('JAX_PLATFORMS', 'XLA_FLAGS', 'JAX_ENABLE_X64')}
    r = subprocess.run([sys.executable, os.path.join(REPO, 'chip_smoke.py')],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=1500)
    sys.stdout.write(r.stdout[-20000:])
    assert r.returncode == 0, r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last['ok'] and last['device']['platform'] == 'gpu'
