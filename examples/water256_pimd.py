#!/usr/bin/env python
"""Bulk-water PIMD at near-classical cost: water256 PME, 8 beads, RPC.

Ring-polymer contraction (md/rpmd.py) evaluates the intermolecular terms
(PIPs + polarization + PME, ~98% of the step cost) on the bead centroid
(n_c = 1) and only the cheap Partridge-Schwenke monomer term on all 8
beads, so quantum nuclear dynamics costs barely more than classical MD.
This is the production PIMD recipe MB-pol is used with in the literature
(the reference plugin delegates it to external drivers; here it is
native and runs fully on-device under lax.scan).

Compares MD throughput of
  - classical dynamics (the n_beads = 1 limit of the same integrator),
  - 8-bead PIMD with centroid contraction (RPC 8 -> 1),
  - optionally full 8-bead PIMD (pass --full),
all with the same potential (PME, 0.9 nm cutoff, f32 SCF at 1e-3) and
per-step neighbor-list builds, and prints the centroid-virial quantum
kinetic energy (zero-point motion of the OH stretches: KE_q >> 3/2 kT).

GPU: python examples/water256_pimd.py [n_steps] [--full]
CPU (slow): JAX_PLATFORMS=cpu python examples/water256_pimd.py 10
"""
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import jax

if os.environ.get('JAX_PLATFORMS'):
    jax.config.update('jax_platforms', os.environ['JAX_PLATFORMS'])
from mbpol_openmm_plugin_tpu.utils.cache import enable_compile_cache
enable_compile_cache()
jax.config.update('jax_default_matmul_precision', 'highest')

import jax.numpy as jnp
import numpy as np

from mbpol_openmm_plugin_tpu.md import rpmd
from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu.system import System, compute_virtual_sites
from mbpol_openmm_plugin_tpu.utils import units

N_STEPS = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() else 100
RUN_FULL = '--full' in sys.argv
ISOTOPE = 'D2O' if '--d2o' in sys.argv else 'H2O'   # heavy water: same PES,
T = 300.0                                           # heavier masses, less ZPE
DT = 2e-4                      # ps (0.2 fs, the reference benchmark step)

fix = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), '..',
                           'tests', 'fixtures',
                           'water256_integration_test.npz'))
box = [19.3996888399961804 / 10.0] * 3
sys_ = System.waters(256, box=box, isotope=ISOTOPE)
pos = compute_virtual_sites(sys_, jnp.asarray(fix['positions'], jnp.float32))
pot = MBPol(sys_, MBPolConfig(nonbonded_method='PME', cutoff=0.9,
                              target_epsilon=1e-3, max_iterations=200,
                              nlist_skin=0.02))
pot.tune_capacities(pos)
kT = units.BOLTZMANN_KJ_MOL_K * T
n_real = 3 * 256


def measure(tag, n_beads, n_contract=None):
    if n_contract:
        step = rpmd.make_rpmd_contracted_potential_step(
            pot, n_beads, n_contract, DT, T, tau0=0.1)
        ef_intra, ef_inter = rpmd.mbpol_intra_inter_split(pot)
        ef_all = rpmd.contracted_energy_forces(ef_inter, ef_intra,
                                               n_beads, n_contract)
    else:
        step = rpmd.make_rpmd_potential_step(pot, n_beads, DT, T, tau0=0.1)

        def ef_all(q):
            def one(p):
                e, f, parts, diag = pot._energy_forces_impl(p)
                return e, f
            return jax.vmap(one)(q)

    state = rpmd.initial_state(sys_, pos, n_beads, T, jax.random.PRNGKey(0),
                               box=box, spread=0.002 if n_beads > 1 else 0.0)
    e0, f0 = jax.jit(ef_all)(state.positions)
    state = dataclasses.replace(state, forces=f0, potential_energy=e0)

    def chunk(s, _):
        s = step(s)
        ke = rpmd.kinetic_energy_virial(sys_, s.positions, s.forces, T)
        return s, (jnp.sum(s.potential_energy), ke)

    run = jax.jit(lambda s: jax.lax.scan(chunk, s, None, length=N_STEPS))
    state, _ = jax.block_until_ready(run(state))       # warm (compile+therm)
    t0 = time.time()
    state, (pes, kes) = jax.block_until_ready(run(state))
    wall = time.time() - t0

    ke_q = float(jnp.mean(kes[N_STEPS // 2:])) / 4.184
    print(f'{tag:28s} {N_STEPS / wall:7.1f} steps/s '
          f'({1e3 * wall / N_STEPS:6.2f} ms/step)  '
          f'KE_virial {ke_q:7.1f} kcal/mol  '
          f'(classical 3/2 NkT = {1.5 * n_real * kT / 4.184:.1f})')
    assert np.isfinite(float(pes[-1]))
    return N_STEPS / wall


cl = measure('classical (n=1)', 1)
rpc = measure('PIMD 8 beads, RPC -> 1', 8, 1)
print(f'quantum dynamics overhead with contraction: {cl / rpc:.2f}x')
if RUN_FULL:
    full = measure('PIMD 8 beads, full', 8)
    print(f'full-bead overhead: {cl / full:.2f}x')
