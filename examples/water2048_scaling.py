#!/usr/bin/env python
"""Bulk scaling run (BASELINE config 4): 2x2x2 (water2048) or 2x2x4
(water4096, pass `4096`) replication of the water256 box, full PME
potential on the default device. Demonstrates the jit neighbor rebuild +
padded triplet lists at 8k-16k sites, and compares the electrostatics
modes: dense (O(N^2) memory) and the molecule-pair segment-sum path
(O(N) memory; models/pme_sparse.py).
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'tests'))

import numpy as np
import jax
# honor JAX_PLATFORMS even if jax was imported before this script set it
if os.environ.get('JAX_PLATFORMS'):
    jax.config.update('jax_platforms', os.environ['JAX_PLATFORMS'])
from mbpol_openmm_plugin_tpu.utils.cache import enable_compile_cache
enable_compile_cache()
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp

import fixtures
from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu.system import System, compute_virtual_sites

N_WATERS = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
MODES = (sys.argv[2].split(',') if len(sys.argv) > 2
         else (['sparse', 'dense'] if N_WATERS <= 2048 else ['sparse']))

reps = {2048: (2, 2, 2), 4096: (2, 2, 4), 6912: (3, 3, 3),
        8192: (2, 4, 4), 16384: (4, 4, 4), 32768: (4, 4, 8)}[N_WATERS]
fix = fixtures.load('water256_integration_test')
b = 19.3996888399961804 / 10.0
pos_np = np.concatenate([fix['positions'] + np.array([i * b, j * b, k * b])
                         for i in range(reps[0]) for j in range(reps[1])
                         for k in range(reps[2])])
assert len(pos_np) == 4 * N_WATERS
box = [reps[0] * b, reps[1] * b, reps[2] * b]
sys_ = System.waters(N_WATERS, box=box)
pos = compute_virtual_sites(sys_, jnp.asarray(pos_np, jnp.float32))

for mode in MODES:
    pot = MBPol(sys_, MBPolConfig(nonbonded_method='PME', cutoff=0.9,
                                  target_epsilon=1e-3, nlist_skin=0.02,
                                  electrostatics_mode=mode))
    pot.tune_capacities(pos)
    print(f'[{mode}] pair capacity {pot.pair_cap}, triplet capacity '
          f'{pot.trip_cap}, dispersion {pot.disp_mode}')

    t0 = time.time()
    e, f, parts, diag = pot._energy_forces(pos)
    jax.block_until_ready(f)
    print('[%s] compile+eval %.1f s' % (mode, time.time() - t0))
    print('[%s] E = %.2f kcal/mol  (%d x water256 = %.2f)'
          % (mode, float(e) / 4.184, N_WATERS // 256,
             N_WATERS / 256 * -2261.7))
    print('[%s] SCF iterations: %d converged: %s'
          % (mode, int(diag['iterations']), bool(diag['converged'])))
    if any(bool(diag[k]) for k in diag if 'overflow' in k):
        print('[%s] WARNING: overflow flags set: %s'
              % (mode, {k: bool(diag[k]) for k in diag if 'overflow' in k}))

    # warm evaluation throughput (prebuilt lists, warm dipoles)
    mu = diag['induced_dipoles']
    nl, _ = pot.build_neighbor_lists(pos)
    full = jax.jit(lambda p, m, n: pot._energy_forces_impl(p, m, nlists=n)[:2])
    out = full(pos, mu, nl)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(20):
        out = full(pos, mu, nl)
    jax.block_until_ready(out)
    print('[%s] warm evaluation: %.1f ms' % (mode, (time.time() - t0) / 20 * 1e3))
