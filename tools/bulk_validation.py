#!/usr/bin/env python
"""Bulk-observable validation against published MB-pol liquid-water values.

Density, g_OO(r) and D_self (examples/bulk_properties.py) pinned against
the literature values MB-pol is known for reproducing - a silently-wrong
production force path must not ship. This tool runs the full production
pipeline on the accelerator and asserts loose bands:

  1. NPT (Langevin + MC barostat, 298.15 K / 1 bar, --npt-ps):
       mean density over the second half.
       Band 0.96-1.06 g/cm^3. Classical MB-pol NPT reports ~1.007
       (Reddy et al., J. Chem. Phys. 145, 194504 (2016)); the band is
       wide enough for the short-window statistics of a 50 ps run but
       far tighter than any wrong-physics failure mode.
  2. Production at the NPT mean box (--nve-ps, frames every 4 fs):
       g_OO first peak position 0.265-0.290 nm, height 2.4-3.6
       (MB-pol: ~0.276 nm / ~3.1); D_self(COM, Einstein) 1.0e-5 -
       3.5e-5 cm^2/s (MB-pol classical ~2.2e-5; N=256 finite-size
       depresses it ~10%). Production runs NVE by default (dynamics
       uncorrupted by thermostat noise) - requires the low-drift
       integrator settings; --thermostat langevin falls back
       to weak-friction Langevin (0.2/ps) if NVE drift is still too
       large for 100 ps windows.

Prints one JSON line with every observable + band verdicts; exits 1 if
any band fails.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WATER_MOLAR_G = 18.01528
AMU_G = 1.66053906660e-24


def density_g_cm3(n_waters, vol_nm3):
    return n_waters * WATER_MOLAR_G * AMU_G / (vol_nm3 * 1e-21)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--npt-ps', type=float, default=50.0)
    ap.add_argument('--nve-ps', type=float, default=100.0)
    ap.add_argument('--npt-eq-ps', type=float, default=10.0)
    ap.add_argument('--dt-fs', type=float, default=0.2)
    ap.add_argument('--thermostat', default='nve',
                    choices=['nve', 'langevin'])
    ap.add_argument('--aspc-n-corr', type=int, default=2)
    ap.add_argument('--frame-every', type=int, default=100)
    ap.add_argument('--seed', type=int, default=11)
    a = ap.parse_args()

    import jax
    from mbpol_openmm_plugin_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    jax.config.update('jax_default_matmul_precision', 'highest')
    import jax.numpy as jnp

    from mbpol_openmm_plugin_tpu import analysis
    from mbpol_openmm_plugin_tpu.md.simulation import (Simulation,
                                                       SimulationConfig)
    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu.system import System, compute_virtual_sites

    T = 298.15
    dt = a.dt_fs * 1e-3
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fix = np.load(os.path.join(root, 'tests', 'fixtures',
                               'water256_integration_test.npz'))
    box = [19.3996888399961804 / 10.0] * 3
    sys_ = System.waters(256, box=box)
    pos = compute_virtual_sites(sys_, jnp.asarray(fix['positions'],
                                                  jnp.float32))
    pot = MBPol(sys_, MBPolConfig.for_dynamics(aspc_n_corr=a.aspc_n_corr))
    pot.tune_capacities(pos, margin=1.6)

    t0 = time.time()
    # ---- stage 1: NPT --------------------------------------------------
    npt = Simulation(pot, SimulationConfig(
        dt=dt, temperature=T, thermostat='langevin', friction=1.0,
        barostat_pressure=1.0, barostat_interval=25,
        nlist_rebuild_interval='auto'), seed=a.seed)
    npt.set_positions(pos)
    npt.set_velocities_to_temperature(T)
    n_eq = int(round(a.npt_eq_ps * 1e3 / a.dt_fs))
    n_npt = int(round(a.npt_ps * 1e3 / a.dt_fs))
    npt.step(n_eq, report_interval=min(n_eq, 2500), check_health=False)
    vols = []
    done = 0
    seg = 2500
    while done < n_npt:
        npt.step(seg, report_interval=seg, check_health=False)
        b = np.asarray(npt.state.box, np.float64)
        vols.append(float(b[0] * b[1] * b[2]))
        done += seg
    vols = np.asarray(vols)
    half = vols[len(vols) // 2:]
    rho = density_g_cm3(256, half.mean())
    rho_sd = float(np.std(density_g_cm3(256, half)))

    # ---- stage 2: production at the NPT mean box -----------------------
    # rescale molecule centroids onto the mean-density box
    L = float(half.mean() ** (1.0 / 3.0))
    st = npt.state
    scale = L / float(np.asarray(st.box)[0])
    mol = np.asarray(sys_.mol_index)
    m = np.asarray(sys_.masses)
    p = np.asarray(st.positions, np.float64)
    mw = m[:, None] * p
    nmol = mol.max() + 1
    mm = np.zeros(nmol)
    np.add.at(mm, mol, m)
    cen = np.zeros((nmol, 3))
    np.add.at(cen, mol, mw)
    cen /= mm[:, None]
    p = p + (cen * (scale - 1.0))[mol]
    box2 = [L, L, L]
    sys2 = System.waters(256, box=box2)
    pot2 = MBPol(sys2, MBPolConfig.for_dynamics(aspc_n_corr=a.aspc_n_corr))
    pot2.tune_capacities(jnp.asarray(p, jnp.float32), margin=1.6)
    cfg2 = SimulationConfig(dt=dt, temperature=None,
                            nlist_rebuild_interval='auto')
    if a.thermostat == 'langevin':
        cfg2 = SimulationConfig(dt=dt, temperature=T, thermostat='langevin',
                                friction=0.2, nlist_rebuild_interval='auto')
    prod = Simulation(pot2, cfg2, seed=a.seed + 1)
    prod.set_positions(jnp.asarray(p, jnp.float32))
    prod.state = __import__('dataclasses').replace(
        prod.state, velocities=jnp.asarray(np.asarray(st.velocities),
                                           jnp.float32))
    n_prod = int(round(a.nve_ps * 1e3 / a.dt_fs))
    # short settle after the box rescale
    prod.step(1000, report_interval=1000, check_health=False)
    frames = []
    e_first = e_last = None
    done = 0
    while done < n_prod:
        mtr = prod.step(a.frame_every, report_interval=a.frame_every,
                        check_health=False)
        if e_first is None:
            e_first = float(mtr['total_energy'][-1])
        e_last = float(mtr['total_energy'][-1])
        frames.append(np.asarray(prod.state.positions))
        done += a.frame_every
    frames = np.asarray(frames)
    dt_frame = a.frame_every * dt

    r, g = analysis.radial_distribution(sys2, frames, species='OO')
    k = int(np.argmax(g))
    g_peak_r, g_peak = float(r[k]), float(g[k])
    t, msd = analysis.mean_squared_displacement(sys2, frames, dt_frame,
                                                species='com')
    d_nm2_ps = float(analysis.diffusion_coefficient(t, msd))
    d_cm2_s = d_nm2_ps * 1e-2

    drift_K_per_ns = ((e_last - e_first)
                      / (0.5 * 3 * 768 * 0.008314462618)
                      / (n_prod * dt * 1e-3)) if a.thermostat == 'nve' \
        else None

    bands = dict(
        density=(0.96, 1.06), g_oo_peak_r=(0.265, 0.290),
        g_oo_peak_h=(2.4, 3.6), d_self_cm2_s=(1.0e-5, 3.5e-5))
    vals = dict(density=rho, g_oo_peak_r=g_peak_r, g_oo_peak_h=g_peak,
                d_self_cm2_s=d_cm2_s)
    ok = {k: bool(bands[k][0] <= vals[k] <= bands[k][1]) for k in bands}
    out = dict(
        protocol=dict(npt_ps=a.npt_ps, nve_ps=a.nve_ps, dt_fs=a.dt_fs,
                      thermostat=a.thermostat, n_corr=a.aspc_n_corr,
                      frames=len(frames), seed=a.seed),
        density_g_cm3=round(rho, 4), density_sd=round(rho_sd, 4),
        g_oo_first_peak_nm=round(g_peak_r, 4),
        g_oo_first_peak_height=round(g_peak, 3),
        d_self_cm2_s=float(f'{d_cm2_s:.3e}'),
        production_drift_K_per_ns=(None if drift_K_per_ns is None
                                   else round(drift_K_per_ns, 1)),
        bands={k: list(v) for k, v in bands.items()},
        band_ok=ok, all_ok=bool(all(ok.values())),
        minutes=round((time.time() - t0) / 60.0, 1))
    print(json.dumps(out), flush=True)
    sys.exit(0 if out['all_ok'] else 1)


if __name__ == '__main__':
    main()
