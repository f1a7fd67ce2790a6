#!/usr/bin/env python
"""H2O vs D2O liquid densities from NPT path-integral MD.

The water density isotope effect is a pure quantum nuclear effect: the
MB-pol PES is a Born-Oppenheimer surface (mass-independent), so in
*classical* NPT the H2O and D2O molar volumes are identical — the
configurational ensemble exp(-beta U(q)) does not see the masses, and the
densities differ only by the trivial molar-mass ratio (20.03/18.02 =
1.112). Ring-polymer NPT (md/rpmd.py: rpmd_barostat_move centroid-scaling
volume moves on the ring polymer) puts the nuclear zero-point motion back:
lighter H has a wider ring-polymer spread, which perturbs the liquid
structure and shifts the *molar volume* between the isotopologues — the
part of the experimental rho(D2O)/rho(H2O) = 1.1077 (1.10445/0.99705
g/cm^3 at 25 C) that is NOT the mass ratio (1.1117): the molar volume of
D2O is ~0.36% larger.

Protocol (production): water256 PME box, P = 1 atm, T = 298.15 K,
n_beads = 32 contracted to the centroid (RPC 32 -> 1, near-classical
cost), MC volume move every 25 steps with OpenMM-style adaptive move
sizing, >= 100 ps after equilibration. This script runs a configurable
slice of that protocol and prints the running density; the quick defaults
below demonstrate the machinery, not converged ensemble averages (the
volume autocorrelation time of water is ~10 ps).

GPU:          python examples/isotope_density.py 20000 --beads 32
CPU (smoke):  JAX_PLATFORMS=cpu python examples/isotope_density.py 4 \
                  --beads 2 --interval 2 --classical
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import jax

if os.environ.get('JAX_PLATFORMS'):
    jax.config.update('jax_platforms', os.environ['JAX_PLATFORMS'])
from mbpol_openmm_plugin_tpu.utils.cache import enable_compile_cache
enable_compile_cache()
jax.config.update('jax_default_matmul_precision', 'highest')

import jax.numpy as jnp
import numpy as np

from mbpol_openmm_plugin_tpu.md.rpmd import PIMDSimulation
from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu.system import System, compute_virtual_sites

N_STEPS = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() \
    else 2000
N_BEADS = int(sys.argv[sys.argv.index('--beads') + 1]) \
    if '--beads' in sys.argv else 8
BARO_INTERVAL = int(sys.argv[sys.argv.index('--interval') + 1]) \
    if '--interval' in sys.argv else 25
CLASSICAL_TOO = '--classical' in sys.argv
T = 298.15                     # K
P_BAR = 1.01325                # 1 atm
DT = 2e-4                      # ps (0.2 fs; OH stretches need a small step)
AMU_PER_NM3_TO_G_CM3 = 1.66053906892e-3   # 1 amu/nm^3 in g/cm^3

fix = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), '..',
                           'tests', 'fixtures',
                           'water256_integration_test.npz'))
box = [19.3996888399961804 / 10.0] * 3
pos0 = jnp.asarray(fix['positions'], jnp.float32)


def run(isotope, n_beads):
    sys_ = System.waters(256, box=box, isotope=isotope)
    pos = compute_virtual_sites(sys_, pos0)
    pot = MBPol(sys_, MBPolConfig(nonbonded_method='PME', cutoff=0.9,
                                  target_epsilon=1e-3, max_iterations=200,
                                  nlist_skin=0.02))
    pot.tune_capacities(pos)
    sim = PIMDSimulation(pot, n_beads, dt=DT, temperature=T, tau0=0.1,
                         contraction=1 if n_beads > 1 else None,
                         barostat_pressure=P_BAR,
                         barostat_interval=BARO_INTERVAL,
                         seed={'H2O': 7, 'D2O': 13}[isotope])
    sim.set_positions(pos, box=box, spread=0.002 if n_beads > 1 else 0.0)
    report = max(BARO_INTERVAL, (N_STEPS // 20) // BARO_INTERVAL
                 * BARO_INTERVAL or BARO_INTERVAL)
    rows = sim.step(N_STEPS, report_interval=report)
    total_mass = float(np.sum(sys_.masses))          # amu per box
    rho = total_mass * AMU_PER_NM3_TO_G_CM3 / rows['volume']
    tail = rho[len(rho) // 2:]
    tag = f'{isotope} {"classical" if n_beads == 1 else f"{n_beads}-bead"}'
    print(f'{tag:22s} rho = {tail.mean():.4f} +- '
          f'{tail.std() / max(np.sqrt(len(tail)), 1):.4f} g/cm^3   '
          f'(V: {rows["volume"][0]:.2f} -> {rows["volume"][-1]:.2f} nm^3, '
          f'<KE_cv> = {np.mean(rows["kinetic_virial"][len(rows["volume"]) // 2:]):.0f} kJ/mol)')
    return tail.mean(), total_mass


print(f'NPT {T} K, {P_BAR} bar, water256 PME, dt = {DT * 1e3} fs, '
      f'{N_STEPS} steps, volume move every {BARO_INTERVAL}')
rho_h, m_h = run('H2O', N_BEADS)
rho_d, m_d = run('D2O', N_BEADS)
print(f'quantum rho(D2O)/rho(H2O)   = {rho_d / rho_h:.4f}   '
      f'(mass ratio alone {m_d / m_h:.4f}; experiment 1.1077 at 25 C)')
print(f'molar-volume isotope effect = '
      f'{(rho_d / rho_h) / (m_d / m_h) - 1.0:+.4%} (NQE beyond the mass ratio)')
if CLASSICAL_TOO:
    rho_hc, _ = run('H2O', 1)
    rho_dc, _ = run('D2O', 1)
    print(f'classical rho(D2O)/rho(H2O) = {rho_dc / rho_hc:.4f}   '
          f'(= the mass ratio up to sampling noise: the classical NPT '
          f'ensemble is mass-independent)')
