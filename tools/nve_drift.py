#!/usr/bin/env python
"""Long-horizon NVE energy-drift measurement at production settings.

A 0.2 ps NVE window is far too short to state a production drift number
(engines quote K/ns). This tool runs water256 f32 NVE for
tens-to-hundreds of picoseconds on the accelerator and reports the TOTAL-energy drift as a linear fit over segment
boundaries, in both kJ/mol/ns and K/ns (Delta E / ((3N/2) k_B)).

Protocol anchor: the reference's f64 NVT->NVE example
(/root/reference/python/example_nvt_nve.py:15-71), which is drift-free by
construction (double precision Verlet); this tool measures what the
f32 path achieves and is the A/B harness for the mitigations:

  --kahan          compensated (Neumaier) position/velocity accumulation
                   (utils/compensated.py) - recovers the low bits the
                   f32 `p += dt*v` update rounds away each step
  --aspc-k K       Kolafa predictor order (higher = smaller closure error)
  --dt-fs          timestep (default 0.2 fs, the MB-pol OH-stretch limit)

Usage (GPU):  python tools/nve_drift.py --steps 250000 --kahan
Output: one JSON line per variant.
"""
import argparse
import dataclasses
import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KB = 0.008314462618      # kJ/mol/K


def build(dt_fs, aspc_k, kahan, n_corr=1, scf='aspc', epsilon=1e-3,
          terms=None, ewald_tol=1e-4, disp_switch=0.0, skin=0.02,
          therm_temp=300.0, seed=0):
    import jax
    from mbpol_openmm_plugin_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    jax.config.update('jax_default_matmul_precision', 'highest')
    import jax.numpy as jnp

    from mbpol_openmm_plugin_tpu.md import integrators as I
    from mbpol_openmm_plugin_tpu.models import electrostatics as elec
    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu.system import (System, compute_virtual_sites,
                                                make_molecules_whole)
    from mbpol_openmm_plugin_tpu.utils.compensated import comp_add

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fix = np.load(os.path.join(root, 'tests', 'fixtures',
                               'water256_integration_test.npz'))
    box = [19.3996888399961804 / 10.0] * 3
    sys_ = System.waters(256, box=box)
    dtype = jnp.float32
    pos = compute_virtual_sites(sys_, jnp.asarray(fix['positions'], dtype))
    kw = {'ewald_error_tolerance': ewald_tol,
          'dispersion_switch_width': disp_switch}
    if terms is not None:
        kw['terms'] = tuple(terms)
    pot = MBPol(sys_, MBPolConfig(nonbonded_method='PME', cutoff=0.9,
                                  target_epsilon=epsilon, max_iterations=200,
                                  scf_method=scf, aspc_k=aspc_k,
                                  aspc_n_corr=n_corr,
                                  nlist_skin=skin, **kw))
    # margin 1.6: a 50 ps NVE window samples far deeper density
    # fluctuations than the 0.2 ps bench windows - margin 1.3 overflowed
    # ~10 ps into the first long run (truncated lists then corrupt the
    # drift measurement itself)
    pot.tune_capacities(pos, margin=1.6)

    masses = np.asarray(sys_.masses, np.float64)
    dt = dt_fs * 1e-3
    inv_m = np.where(masses > 0, 1.0 / np.where(masses > 0, masses, 1.0), 0.0)
    inv_m = jnp.asarray(inv_m, dtype)[:, None]
    o_idx = np.asarray(sys_.o_index)
    skin = pot.config.nlist_skin
    if scf == 'aspc':
        B = jnp.asarray(elec.aspc_predictor_coefficients(aspc_k), dtype)
        hist_len = aspc_k + 2
    else:
        # SOR control arm: plain previous-step warm start (an extrapolated
        # start into the loosely-converged loop is unstable - bench.py)
        B = jnp.asarray([1.0], dtype)
        hist_len = 1

    def rebuild_lists(p):
        pl, tl, d = pot._neighbor_lists(make_molecules_whole(sys_, p))
        return (pl, tl), d['pair_overflow'] | d['triplet_overflow']

    def md_chunk(carry, n):
        """ASPC velocity-Verlet scan with displacement-triggered rebuilds;
        optionally compensated integration (the --kahan A/B arm)."""
        def body(c, _):
            st, comp, mu_hist, nlists, p_build, ovf = c
            vc, pc = comp
            dv1 = 0.5 * dt * st.forces * inv_m
            if kahan:
                v_half, vc = comp_add(st.velocities, vc, dv1)
                p, pc = comp_add(st.positions, pc, dt * v_half)
            else:
                v_half = st.velocities + dv1
                p = st.positions + dt * v_half
            disp = jnp.max(jnp.linalg.norm(p[o_idx] - p_build[o_idx],
                                           axis=-1))
            nlists, p_build, ovf = jax.lax.cond(
                2.0 * disp > 0.5 * skin,
                lambda: (lambda nl_o: (nl_o[0], p, ovf | nl_o[1]))(
                    rebuild_lists(p)),
                lambda: (nlists, p_build, ovf))
            mu0 = jnp.einsum('h,hnd->nd', B, mu_hist)
            e, f, parts, diag = pot._energy_forces_impl(p, mu0,
                                                        nlists=nlists)
            mu_hist = jnp.roll(mu_hist, 1, axis=0).at[0].set(
                diag.get('induced_dipoles', mu_hist[0]))
            dv2 = 0.5 * dt * f * inv_m
            if kahan:
                v, vc = comp_add(v_half, vc, dv2)
            else:
                v = v_half + dv2
            st = dataclasses.replace(st, positions=p, velocities=v,
                                     forces=f, potential_energy=e,
                                     step=st.step + 1)
            return (st, (vc, pc), mu_hist, nlists, p_build, ovf), e
        return jax.lax.scan(body, carry, None, length=n)

    chunk = jax.jit(md_chunk, static_argnames=('n',))

    e0, f0, _, diag0 = pot.energy_forces(pos)
    key = jax.random.PRNGKey(seed)
    v0 = I.maxwell_boltzmann_velocities(sys_, therm_temp, key, dtype)
    state = I.MDState(positions=pos, velocities=v0, forces=f0,
                      potential_energy=e0, box=jnp.asarray(box, dtype),
                      step=jnp.zeros((), jnp.int32), rng=key)
    comp0 = (jnp.zeros_like(v0), jnp.zeros_like(pos))
    mu_seed = diag0.get('induced_dipoles',
                        jnp.zeros_like(pos))
    mu0 = jnp.tile(mu_seed[None], (hist_len, 1, 1))
    nl0, d0 = pot.build_neighbor_lists(pos)
    carry = (state, comp0, mu0, nl0, state.positions,
             jnp.asarray(bool(d0['pair_overflow'])
                         | bool(d0['triplet_overflow'])))
    return carry, chunk, masses, sys_, pot


def run(dt_fs, aspc_k, kahan, steps, therm, seg, seed=0, t_target=300.0,
        n_corr=1, scf='aspc', epsilon=1e-3, terms=None, ewald_tol=1e-4,
        disp_switch=0.0, skin=0.02):
    import jax
    import jax.numpy as jnp

    from mbpol_openmm_plugin_tpu.md import integrators as I
    carry, chunk, masses, sys_, pot = build(dt_fs, aspc_k, kahan,
                                            n_corr=n_corr, scf=scf,
                                            epsilon=epsilon, terms=terms,
                                            ewald_tol=ewald_tol,
                                            disp_switch=disp_switch,
                                            skin=skin, seed=seed)
    ndof = 3 * int((masses > 0).sum())

    def ke(carry):
        v = np.asarray(carry[0].velocities, np.float64)
        return 0.5 * float((masses[:, None] * v * v).sum())

    # Thermalize AT the target temperature: periodic Maxwell-Boltzmann
    # velocity reassignment (massive Andersen) every `seg` steps pumps the
    # PE<->KE equipartition loss back in, so the NVE window that follows
    # actually sits near t_target instead of ~t_target/2 (assigning 300 K
    # velocities to relaxed positions halves the temperature within 0.1 ps).
    key = jax.random.PRNGKey(seed + 1)
    done = 0
    while done < therm:
        key, sub = jax.random.split(key)
        st = carry[0]
        v = I.maxwell_boltzmann_velocities(sys_, t_target, sub,
                                           st.positions.dtype)
        carry = (dataclasses.replace(st, velocities=v),
                 (jnp.zeros_like(v), jnp.zeros_like(st.positions))) + carry[2:]
        n = min(seg, therm - done)
        carry, _ = chunk(carry, n)
        done += n
    # settle: one resample-free segment so the measured window starts
    # equipartitioned
    carry, _ = chunk(carry, seg)
    np.asarray(carry[0].positions)        # sync
    t_now = 2.0 * ke(carry) / (ndof * KB)

    ts, es, pes = [], [], []
    t0 = time.time()
    done = 0
    while done < steps:
        carry, pe = chunk(carry, seg)
        done += seg
        pe_last = float(np.asarray(pe)[-1])   # syncs the chunk
        ts.append(done * dt_fs * 1e-3)        # ps
        es.append(pe_last + ke(carry))
        pes.append(pe_last)
    elapsed = time.time() - t0
    ovf = bool(np.asarray(carry[5]))

    ts = np.asarray(ts)
    es = np.asarray(es)
    # linear fit over segment boundaries: robust against the ps-scale
    # energy oscillation that makes endpoint differences noisy
    slope_per_ps = float(np.polyfit(ts, es, 1)[0]) if len(ts) > 2 else \
        float((es[-1] - es[0]) / (ts[-1] - ts[0]))
    out = dict(
        variant=dict(dt_fs=dt_fs, aspc_k=aspc_k, kahan=bool(kahan),
                     n_corr=n_corr, scf=scf, epsilon=epsilon, terms=terms,
                     ewald_tol=ewald_tol, disp_switch=disp_switch,
                     skin=skin, steps=steps, therm=therm, seed=seed),
        temperature_K=round(t_now, 1),
        window_ps=round(float(ts[-1] - ts[0]), 3),
        steps_per_second=round(steps / elapsed, 1),
        drift_kJmol_per_ns=round(slope_per_ps * 1e3, 3),
        drift_K_per_ns=round(slope_per_ps * 1e3 / (0.5 * ndof * KB), 3),
        endpoint_drift_kJmol=round(float(es[-1] - es[0]), 3),
        e_first=round(float(es[0]), 3), e_last=round(float(es[-1]), 3),
        series=[round(float(v), 3) for v in es],
        nan=bool(np.isnan(es).any()), neighbor_overflow=ovf)
    print(json.dumps(out), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=50000)
    ap.add_argument('--therm', type=int, default=2000)
    ap.add_argument('--seg', type=int, default=1000)
    ap.add_argument('--dt-fs', type=float, default=0.2)
    ap.add_argument('--aspc-k', type=int, default=3)
    ap.add_argument('--kahan', action='store_true')
    ap.add_argument('--n-corr', type=int, default=1)
    ap.add_argument('--scf', default='aspc', choices=['aspc', 'sor', 'diis'])
    ap.add_argument('--ewald-tol', type=float, default=1e-4)
    ap.add_argument('--disp-switch', type=float, default=0.0)
    ap.add_argument('--skin', type=float, default=0.02)
    ap.add_argument('--terms', default=None,
                    help='comma list, e.g. one_body,two_body,dispersion')
    ap.add_argument('--epsilon', type=float, default=1e-3)
    ap.add_argument('--seed', type=int, default=0)
    a = ap.parse_args()
    run(a.dt_fs, a.aspc_k, a.kahan, a.steps, a.therm, a.seg, a.seed,
        n_corr=a.n_corr, scf=a.scf, epsilon=a.epsilon,
        terms=None if a.terms is None else a.terms.split(','),
        ewald_tol=a.ewald_tol, disp_switch=a.disp_switch, skin=a.skin)


if __name__ == '__main__':
    main()
