#!/usr/bin/env python
"""Path-integral MD of the water14 cluster (md/rpmd.py).

The reference cites PIMD as the method MB-pol is used with (README.md:13)
but ships no PIMD machinery; this framework provides it natively:
bead-replicated potential via vmap, exact normal-mode free ring-polymer
evolution as static [n, n] matmuls, PILE thermostat (Ceriotti et al.,
J. Chem. Phys. 133, 124104 (2010)).

Runs a short thermostatted trajectory at 150 K with 8 beads and prints
the centroid-virial quantum kinetic energy vs the classical
equipartition value - at 150 K water's intramolecular modes are deeply
quantum (KE_quantum >> KE_classical; zero-point motion).

CPU: JAX_PLATFORMS=cpu python examples/water14_pimd.py [n_beads] [n_steps]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'tests'))

import jax

# honor JAX_PLATFORMS even if jax was imported before this script set it
if os.environ.get('JAX_PLATFORMS'):
    jax.config.update('jax_platforms', os.environ['JAX_PLATFORMS'])
import jax.numpy as jnp
import numpy as np

import fixtures
from mbpol_openmm_plugin_tpu.md import rpmd
from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu.system import System, compute_virtual_sites
from mbpol_openmm_plugin_tpu.utils import units

N_BEADS = int(sys.argv[1]) if len(sys.argv) > 1 else 8
N_STEPS = int(sys.argv[2]) if len(sys.argv) > 2 else 400
# optional ring-polymer contraction (odd; expensive intermolecular terms
# run on this many beads, the monomer term on all beads)
N_CONTRACT = int(sys.argv[3]) if len(sys.argv) > 3 else 0
T = 150.0
DT = 1e-4          # ps (0.1 fs; OH stretch ~ 10 fs period)

fix = fixtures.load('water14_cluster')
sys_ = System.waters(14)
pos = compute_virtual_sites(sys_, jnp.asarray(fix['positions']))
pot = MBPol(sys_, MBPolConfig(nonbonded_method='NoCutoff',
                              target_epsilon=1e-5))

if N_CONTRACT:
    step = rpmd.make_rpmd_contracted_potential_step(pot, N_BEADS, N_CONTRACT,
                                                    DT, T, tau0=0.05)
else:
    step = rpmd.make_rpmd_potential_step(pot, N_BEADS, DT, T, tau0=0.05)
state = rpmd.initial_state(sys_, pos, N_BEADS, T, jax.random.PRNGKey(0),
                           spread=0.002)
e, f, _, _ = pot._energy_forces_impl(state.positions[0])
import dataclasses
state = dataclasses.replace(
    state, forces=jnp.broadcast_to(f[None], state.positions.shape).copy(),
    potential_energy=jnp.broadcast_to(e[None], (N_BEADS,)).copy())


def chunk(s, _):
    s = step(s)
    ke = rpmd.kinetic_energy_virial(sys_, s.positions, s.forces, T)
    return s, ke


run = jax.jit(lambda s: jax.lax.scan(chunk, s, None, length=N_STEPS))
t0 = time.time()
state, kes = jax.block_until_ready(run(state))
dt_wall = time.time() - t0

kT = units.BOLTZMANN_KJ_MOL_K * T
n_real = 3 * 14
ke_cl = 1.5 * n_real * kT
burn = N_STEPS // 2
ke_q = float(jnp.mean(kes[burn:]))
print(f'{N_BEADS} beads x {N_STEPS} steps in {dt_wall:.1f} s '
      f'({N_STEPS / dt_wall:.1f} steps/s)')
print(f'potential energy (bead mean): '
      f'{float(jnp.mean(state.potential_energy)) / 4.184:.2f} kcal/mol')
print(f'quantum KE (centroid-virial): {ke_q / 4.184:.2f} kcal/mol')
print(f'classical equipartition KE:   {ke_cl / 4.184:.2f} kcal/mol')
print(f'quantum/classical ratio:      {ke_q / ke_cl:.2f}  '
      f'(zero-point motion of the OH stretches)')
