#!/usr/bin/env python
"""RESPA NVE drift A/B harness.

The three-level r-RESPA point (mid=3, inner=2, ASPC closure on the
middle rung) drifts far more than the single-step ASPC path, and
DISSIPATIVELY - the signature of dipole-closure lag rather than
impulse-MTS noise. This harness measures drift per variant:

  --scf keep|auto       'keep' runs the potential's own SCF (converged
                        loop) on the middle rung; 'auto' derives ASPC
  --scf-method ...      base potential SCF (sor|diis|aspc) for 'keep'
  --epsilon/--eps-floor convergence target for the 'keep' arms
  --n-corr              ASPC corrector depth (with --scf auto)
  --mid/--inner         RESPA ladder

Usage (GPU): python tools/respa_drift.py --steps 8333 --mid 3
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KB = 0.008314462618


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=8333)   # outer steps
    ap.add_argument('--therm', type=int, default=1000)
    ap.add_argument('--mid', type=int, default=3)
    ap.add_argument('--inner', type=int, default=2)
    ap.add_argument('--scf', default='auto', choices=['auto', 'keep'])
    ap.add_argument('--scf-method', default='sor')
    ap.add_argument('--epsilon', type=float, default=1e-3)
    ap.add_argument('--eps-floor', type=float, default=None)
    ap.add_argument('--n-corr', type=int, default=1)
    ap.add_argument('--seg', type=int, default=500)
    ap.add_argument('--polar-rung', default='mid', choices=['mid', 'inner'])
    a = ap.parse_args()

    import jax
    from mbpol_openmm_plugin_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    jax.config.update('jax_default_matmul_precision', 'highest')
    import jax.numpy as jnp

    from mbpol_openmm_plugin_tpu.md.simulation import (Simulation,
                                                       SimulationConfig)
    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu.system import System, compute_virtual_sites

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fix = np.load(os.path.join(root, 'tests', 'fixtures',
                               'water256_integration_test.npz'))
    box = [19.3996888399961804 / 10.0] * 3
    sys_ = System.waters(256, box=box)
    pos = compute_virtual_sites(sys_, jnp.asarray(fix['positions'],
                                                  jnp.float32))
    pot = MBPol(sys_, MBPolConfig.for_dynamics(
        scf_method=a.scf_method, target_epsilon=a.epsilon,
        scf_eps_floor=a.eps_floor, aspc_n_corr=a.n_corr))
    pot.tune_capacities(pos, margin=1.4)
    dt_outer = 0.2e-3 * a.inner * a.mid
    sim = Simulation(pot, SimulationConfig(
        dt=dt_outer, temperature=None, scf=a.scf,
        respa_inner=a.inner, respa_mid=a.mid,
        respa_polarization_rung=a.polar_rung,
        nlist_rebuild_interval='auto'), seed=0)
    sim.set_positions(pos)
    sim.set_velocities_to_temperature(300.0)
    sim.step(a.therm, report_interval=a.therm, check_health=False)

    ts, es = [], []
    t0 = time.time()
    done = 0
    while done < a.steps:
        m = sim.step(a.seg, report_interval=a.seg, check_health=False)
        done += a.seg
        ts.append(done * dt_outer)
        es.append(float(np.asarray(m['total_energy'])[-1]))
    elapsed = time.time() - t0
    ts = np.asarray(ts); es = np.asarray(es)
    slope = float(np.polyfit(ts, es, 1)[0])          # kJ/mol per ps
    ndof = 3 * 768
    out = dict(variant=dict(mid=a.mid, inner=a.inner, scf=a.scf,
                            scf_method=a.scf_method, epsilon=a.epsilon,
                            eps_floor=a.eps_floor, n_corr=a.n_corr,
                            polar_rung=a.polar_rung,
                            outer_steps=a.steps),
               window_ps=round(float(ts[-1] - ts[0]), 3),
               outer_steps_per_second=round(a.steps / elapsed, 1),
               ns_per_day=round(a.steps / elapsed * dt_outer * 1e-3
                                * 86400.0, 3),
               drift_K_per_ns=round(slope * 1e3 / (0.5 * ndof * KB), 1),
               endpoint_drift_kJmol=round(float(es[-1] - es[0]), 2),
               nan=bool(np.isnan(es).any()))
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
