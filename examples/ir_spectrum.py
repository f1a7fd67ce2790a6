#!/usr/bin/env python
"""Classical IR spectrum of a water cluster from the total-dipole series.

Runs a short NVE trajectory on the water14 cluster (the reference's
flagship example system), records the total system dipole (fixed charges
+ converged induced dipoles, `analysis.dipole_series` - the reference's
getSystemElectrostaticsMoments convention) at every frame, and prints the
dominant bands of the classical IR lineshape
(`analysis.infrared_spectrum`: Wiener-Khinchin spectrum of the
dipole-derivative autocorrelation). Liquid-water bands to look for:
libration <1000 cm^-1, HOH bend ~1650 cm^-1, OH stretch ~3400-3700 cm^-1
(a classical-MD lineshape - no quantum correction beyond the harmonic
omega^2 prefactor implicit in the derivative form).

GPU:          python examples/ir_spectrum.py 40000
CPU (smoke):  JAX_PLATFORMS=cpu python examples/ir_spectrum.py 200
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import jax

if os.environ.get('JAX_PLATFORMS'):
    jax.config.update('jax_platforms', os.environ['JAX_PLATFORMS'])
from mbpol_openmm_plugin_tpu.utils.cache import enable_compile_cache
enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from mbpol_openmm_plugin_tpu import analysis
from mbpol_openmm_plugin_tpu.md.simulation import Simulation, SimulationConfig
from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu.system import System, compute_virtual_sites

N_STEPS = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
DT = 2e-4                    # ps (0.2 fs - resolves the OH stretch)
FRAME_EVERY = 2              # record the dipole every 2 steps (0.4 fs)

here = os.path.dirname(os.path.abspath(__file__))
if not os.path.exists(os.path.join(here, 'water14_cluster.pdb')):
    os.system(f'{sys.executable} {here}/make_inputs.py')
from mbpol_openmm_plugin_tpu import app  # noqa: E402

pdb = app.PDBFile(os.path.join(here, 'water14_cluster.pdb'))
sys_ = System.waters(14)
pos = compute_virtual_sites(sys_, jnp.asarray(pdb.positions.to_internal()))
pot = MBPol(sys_, MBPolConfig(nonbonded_method='NoCutoff',
                              target_epsilon=1e-5))

sim = Simulation(pot, SimulationConfig(dt=DT, temperature=300.0,
                                       thermostat='langevin', friction=5.0),
                 seed=1)
sim.set_positions(pos)
print(f'equilibrating 200 steps, then {N_STEPS} NVE steps at dt={DT*1e3} fs')
sim.step(200, check_health=False)

# switch to NVE for the production segment (thermostat noise broadens
# the lineshape) and harvest positions every FRAME_EVERY steps
sim_nve = Simulation(pot, SimulationConfig(dt=DT, temperature=None))
sim_nve.state = sim.state
frames = []
for _ in range(N_STEPS // FRAME_EVERY):
    sim_nve.step(FRAME_EVERY)
    frames.append(np.asarray(sim_nve.state.positions))

mu = analysis.dipole_series(pot, np.asarray(frames))
freq, inten = analysis.infrared_spectrum(mu, dt=DT * FRAME_EVERY)
inten = inten / inten.max()

print(f'{len(frames)} frames, resolution {freq[1]:.0f} cm^-1')
for lo, hi, name in ((10, 1200, 'libration'), (1200, 2200, 'HOH bend'),
                     (2800, 4400, 'OH stretch')):
    m = (freq >= lo) & (freq < hi)
    if m.any():
        k = np.argmax(inten[m])
        print(f'{name:12s} peak {freq[m][k]:7.0f} cm^-1  '
              f'(relative intensity {inten[m][k]:.3f})')
