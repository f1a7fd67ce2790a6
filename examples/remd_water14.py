#!/usr/bin/env python
"""Parallel-tempering (temperature REMD) on the water14 cluster.

The reference runs one context at one temperature (python/water14.py);
this framework's replica ladder is a vmap over a leading replica axis,
so all replicas advance in one jitted lax.scan and exchanges are [R]
permutation gathers (md/remd.py). On a multi-device mesh the ladder shards
over the 'dp' axis (pass --mesh).

Usage:
    python examples/remd_water14.py [n_blocks] [--replicas R] [--mesh]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import numpy as np
import jax
# honor JAX_PLATFORMS even if jax was imported before this script set it
if os.environ.get('JAX_PLATFORMS'):
    jax.config.update('jax_platforms', os.environ['JAX_PLATFORMS'])
from mbpol_openmm_plugin_tpu.utils.cache import enable_compile_cache
enable_compile_cache()

import jax.numpy as jnp

from mbpol_openmm_plugin_tpu import app
from mbpol_openmm_plugin_tpu.md import remd
from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu.parallel import mesh as M
from mbpol_openmm_plugin_tpu.system import compute_virtual_sites

n_blocks = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() else 100
R = int(sys.argv[sys.argv.index('--replicas') + 1]) if '--replicas' in sys.argv else 4
use_mesh = '--mesh' in sys.argv

here = os.path.dirname(os.path.abspath(__file__))
if not os.path.exists(os.path.join(here, 'water14_cluster.pdb')):
    os.system(f'{sys.executable} {here}/make_inputs.py')
pdb = app.PDBFile(os.path.join(here, 'water14_cluster.pdb'))
ff = app.ForceField(app.mbpol_xml_path())
spec = ff.createSystem(pdb.topology, nonbondedMethod=app.NoCutoff)
# --mesh shards the REPLICA axis over the devices (the potential itself
# stays unmeshed - one sharding level; see REMDSimulation docstring)
mesh = M.make_mesh(min(R, len(jax.devices()))) if use_mesh else None
pot = MBPol(spec.system, MBPolConfig(nonbonded_method='NoCutoff',
                                     cutoff=1e3))
from mbpol_openmm_plugin_tpu.app import unit
pos = compute_virtual_sites(
    spec.system, jnp.asarray(pdb.positions.value_in_unit(unit.nanometer)))

temps = remd.geometric_ladder(250.0, 450.0, R)
cfg = remd.REMDConfig(dt=0.0002, exchange_interval=25, friction=2.0)
sim = remd.REMDSimulation(pot, temperatures=temps, config=cfg, seed=0,
                          mesh=mesh)
sim.set_positions(pos)
sim.set_velocities_to_temperature()

print(f'water14 REMD: {R} replicas at', np.round(temps, 1), 'K',
      f'({cfg.exchange_interval} steps/exchange, dt {cfg.dt*1000:.2f} fs)',
      f'mesh={mesh.shape if mesh else None}')

t0 = time.time()
out = sim.run(2)   # compile + short equilibration
print('compile + first blocks: %.1f s' % (time.time() - t0))

t0 = time.time()
out = sim.run(n_blocks)
dt_wall = time.time() - t0
n_steps = n_blocks * cfg.exchange_interval
print('%d blocks (%d MD steps x %d replicas) in %.1f s -> %.1f replica-steps/s'
      % (n_blocks, n_steps, R, dt_wall, n_steps * R / dt_wall))

pe = out['potential_energy'] / 4.184   # kcal/mol
for r in range(R):
    print('  slot %d  T=%6.1f K  <U> = %9.3f kcal/mol  acceptance(->%d) %s'
          % (r, temps[r], pe[n_blocks // 4:, r].mean(), r + 1,
             '%.2f' % out['acceptance'][r] if r < R - 1 else '   -'))

# replica flow: how often the coldest slot's occupant changed
w0 = out['walker'][:, 0]
print('cold-slot occupant changed %d times over %d blocks; walkers seen: %s'
      % ((np.diff(w0) != 0).sum(), n_blocks, sorted(set(w0.tolist()))))

# MBAR post-processing (analysis.mbar_*): pool all slots' samples and
# reweight to ANY temperature in the ladder range - here <U>(T) on a
# fine grid, of which the simulated temperatures are just R points
from mbpol_openmm_plugin_tpu import analysis

burn = max(1, n_blocks // 4)
u_kn = out['potential_energy'][burn:].T          # [R, n_samples] kJ/mol
f = analysis.mbar_free_energies(u_kn, temps)
print('MBAR dimensionless free energies:', np.round(f, 2))
for t in np.linspace(temps[0], temps[-1], 2 * R - 1):
    w = analysis.mbar_reweight(u_kn, temps, float(t), f=f, observable=u_kn)
    print('  <U>(%5.1f K) = %9.3f kcal/mol   (n_eff %5.0f)'
          % (t, w['mean'] / 4.184, w['n_eff']))
