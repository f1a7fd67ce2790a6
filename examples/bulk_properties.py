#!/usr/bin/env python
"""Standard liquid-water observables from one water256 PME trajectory.

Equilibrates water256 under a Langevin thermostat, then runs NVE
production (thermostat noise corrupts dynamical observables) and
computes, with `mbpol_openmm_plugin_tpu.analysis`:

  - O-O radial distribution function (first peak ~0.28 nm for MB-pol
    liquid water),
  - molecular-COM mean-squared displacement -> self-diffusion D via the
    Einstein relation (experiment: 2.3e-5 cm^2/s at 298 K; converged
    classical MB-pol is in the 2.0-2.5e-5 range, but needs >=100 ps),
  - static dielectric constant from total-dipole fluctuations (tin-foil
    formula; experiment ~78 - converging <M^2> needs ns trajectories,
    short runs report a lower bound),
  - VDOS band positions from the velocity autocorrelation (libration
    <1000 cm^-1, bend ~1650 cm^-1, OH stretch ~3400-3700 cm^-1).

The reference plugin exports trajectories to external analysis tools
(PDB/NetCDF reporters); here the same observables come straight off the
in-memory trajectory arrays.

GPU:          python examples/bulk_properties.py 50000
CPU (smoke):  JAX_PLATFORMS=cpu python examples/bulk_properties.py 200
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
T = 298.15
DT = 2e-4                     # ps (0.2 fs, the reference benchmark step)
FRAME_EVERY = 20              # 4 fs frame cadence
DIPOLE_EVERY = 5              # dipole every 5th frame (each costs an SCF)
N_EQ = min(N_STEPS, 2000)

fix = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), '..',
                           'tests', 'fixtures',
                           'water256_integration_test.npz'))
box = [19.3996888399961804 / 10.0] * 3
sys_ = System.waters(256, box=box)
pos = compute_virtual_sites(sys_, jnp.asarray(fix['positions'], jnp.float32))
pot = MBPol(sys_, MBPolConfig(nonbonded_method='PME', cutoff=0.9,
                              target_epsilon=1e-3, max_iterations=200,
                              nlist_skin=0.02))
pot.tune_capacities(pos)

sim = Simulation(pot, SimulationConfig(dt=DT, temperature=T,
                                       thermostat='langevin', friction=1.0),
                 seed=11)
sim.set_positions(pos)
sim.set_velocities_to_temperature(T)
print(f'equilibrating {N_EQ} NVT steps, then {N_STEPS} NVE steps '
      f'(frames every {FRAME_EVERY * DT * 1e3:.1f} fs)')
sim.step(N_EQ, check_health=False)

sim_nve = Simulation(pot, SimulationConfig(dt=DT, temperature=None))
sim_nve.state = sim.state
frames, vels = [], []
for _ in range(max(N_STEPS // FRAME_EVERY, 2)):
    sim_nve.step(FRAME_EVERY)
    frames.append(np.asarray(sim_nve.state.positions))
    vels.append(np.asarray(sim_nve.state.velocities))
frames = np.asarray(frames)
vels = np.asarray(vels)
dt_frame = FRAME_EVERY * DT
print(f'{len(frames)} frames over {len(frames) * dt_frame:.2f} ps')

# --- structure: O-O RDF -------------------------------------------------
r, g = analysis.radial_distribution(sys_, frames, species='OO')
k = np.argmax(g)
print(f'g_OO(r) first peak: r = {r[k]:.3f} nm, g = {g[k]:.2f} '
      f'(MB-pol liquid: ~0.28 nm)')

# --- structure: S(q), hydrogen bonds, tetrahedrality ---------------------
q, s_q = analysis.static_structure_factor(sys_, frames[::4], q_max=40.0)
j = np.argmax(s_q[q > 10.0])
print(f'S(q) main peak: q = {q[q > 10.0][j]:.1f} 1/nm, S = '
      f'{s_q[q > 10.0][j]:.2f} (liquid water: ~20 1/nm (2 A^-1), ~2-3)')
hb = analysis.hydrogen_bonds(sys_, frames[::4])
# each bond is shared by a donor and an acceptor molecule
print(f'H-bonds/molecule = {2.0 * hb.mean() / sys_.n_waters:.2f} '
      f'(liquid water: ~3.5)')
qt = analysis.tetrahedral_order(sys_, frames[::4])
print(f'tetrahedral order <q> = {qt.mean():.3f} '
      f'(liquid ~0.6-0.7, ice 1, ideal gas 0)')

# --- dynamics: MSD -> self-diffusion ------------------------------------
t, msd = analysis.mean_squared_displacement(sys_, frames, dt_frame,
                                            species='com')
try:
    d = analysis.diffusion_coefficient(t, msd)
    print(f'D(COM, Einstein) = {d:.3e} nm^2/ps = {d * 1e-2:.3e} cm^2/s '
          f'(expt 2.3e-5 cm^2/s; needs >=100 ps to converge)')
except ValueError as e:
    print(f'MSD too short for a diffusion fit ({e})')
tg, d_run = analysis.diffusion_coefficient_gk(sys_, vels, dt_frame,
                                              species='com')
# plateau read over 1-5 ps (after the COM-VACF decay, before tail noise)
sel = (tg >= 1.0) & (tg <= 5.0)
if sel.any():
    print(f'D(COM, Green-Kubo) = {d_run[sel].mean():.3e} nm^2/ps')
else:
    print(f'GK running integral at t_max={tg[-1]:.2f} ps: '
          f'{d_run[-1]:.3e} nm^2/ps (trajectory too short for a plateau)')

# --- dielectric: total-dipole fluctuations ------------------------------
mu = analysis.dipole_series(pot, frames[::DIPOLE_EVERY])
eps = analysis.static_dielectric(mu, box, T)
print(f'epsilon_0 = {eps:.1f} from {len(mu)} dipole samples '
      f'(expt ~78; <M^2> converges on ns scales - short runs '
      f'underestimate)')

# --- spectra: VDOS band peaks -------------------------------------------
freq, vdos = analysis.vibrational_density_of_states(sys_, vels, dt_frame)
for lo, hi, name in ((10, 1200, 'libration'), (1200, 2200, 'HOH bend'),
                     (2800, 4400, 'OH stretch')):
    m = (freq >= lo) & (freq < hi)
    if m.any() and vdos[m].max() > 0:
        j = np.argmax(vdos[m])
        print(f'VDOS {name:12s} peak {freq[m][j]:7.0f} cm^-1')
nyq = 0.5 / dt_frame / 0.0299792458
if nyq < 4400:
    print(f'(frame cadence Nyquist {nyq:.0f} cm^-1 - OH stretch needs '
          f'FRAME_EVERY <= 2 at this dt)')
