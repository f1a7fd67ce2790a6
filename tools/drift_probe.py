#!/usr/bin/env python
"""Per-step NVE total-energy probe at full physics.

The segment-boundary drift harness (nve_drift.py) showed full-physics
ASPC runs jumping +-15 kJ/mol between 0.2 ps segments while converged-SOR
runs decline smoothly - structure the 1000-step sampling cannot resolve.
This probe records E_tot at EVERY step for a few thousand steps, plus the
rebuild indicator and min r_OO, so jumps can be correlated with discrete
events (list rebuilds, close encounters) vs continuous pumping.

Usage (GPU): python tools/drift_probe.py --steps 2000 --scf aspc
Writes /tmp/drift_probe_<scf>.npz and prints a JSON summary.
"""
import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KB = 0.008314462618


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=2000)
    ap.add_argument('--therm', type=int, default=3000)
    ap.add_argument('--scf', default='aspc', choices=['aspc', 'sor', 'diis'])
    ap.add_argument('--epsilon', type=float, default=1e-3)
    ap.add_argument('--n-corr', type=int, default=1)
    ap.add_argument('--disp-switch', type=float, default=0.1)
    ap.add_argument('--skin', type=float, default=0.02)
    ap.add_argument('--dt-fs', type=float, default=0.2)
    a = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from tools import nve_drift as D

    carry, chunk, masses, sys_, pot = D.build(
        a.dt_fs, 3, False, n_corr=a.n_corr, scf=a.scf, epsilon=a.epsilon,
        disp_switch=a.disp_switch, skin=a.skin)
    o_idx = np.asarray(sys_.o_index)
    inv_m = jnp.asarray(np.where(masses > 0, 1.0 / np.where(masses > 0,
                                                            masses, 1.0), 0.0),
                        jnp.float32)[:, None]
    dt = a.dt_fs * 1e-3
    m32 = jnp.asarray(masses, jnp.float32)[:, None]
    skin = pot.config.nlist_skin
    box = jnp.asarray(sys_.box, jnp.float32)

    from mbpol_openmm_plugin_tpu.models import electrostatics as elec

    def instrumented(carry, n):
        """Same Verlet body as nve_drift.build but emitting per-step
        (E_tot, rebuilt?, min rOO)."""
        B = (jnp.asarray(elec.aspc_predictor_coefficients(3), jnp.float32)
             if a.scf == 'aspc' else jnp.asarray([1.0], jnp.float32))

        def body(c, _):
            st, comp, mu_hist, nlists, p_build, ovf = c
            dv1 = 0.5 * dt * st.forces * inv_m
            v_half = st.velocities + dv1
            p = st.positions + dt * v_half
            disp = jnp.max(jnp.linalg.norm(p[o_idx] - p_build[o_idx], axis=-1))
            doit = 2.0 * disp > 0.5 * skin
            from mbpol_openmm_plugin_tpu.system import make_molecules_whole
            def reb():
                pl, tl, d = pot._neighbor_lists(make_molecules_whole(sys_, p))
                return (pl, tl), p, ovf | d['pair_overflow'] | d['triplet_overflow']
            nlists, p_build, ovf = jax.lax.cond(
                doit, reb, lambda: (nlists, p_build, ovf))
            mu0 = jnp.einsum('h,hnd->nd', B, mu_hist)
            e, f, parts, diag = pot._energy_forces_impl(p, mu0, nlists=nlists)
            mu_hist = jnp.roll(mu_hist, 1, axis=0).at[0].set(
                diag.get('induced_dipoles', mu_hist[0]))
            v = v_half + 0.5 * dt * f * inv_m
            ke = 0.5 * jnp.sum(m32 * v * v)
            op = p[o_idx]
            d = op[:, None, :] - op[None, :, :]
            d = d - jnp.round(d / box) * box
            r2 = jnp.sum(d * d, -1) + jnp.eye(len(o_idx)) * 100.0
            st = dataclasses.replace(st, positions=p, velocities=v, forces=f,
                                     potential_energy=e, step=st.step + 1)
            return (st, comp, mu_hist, nlists, p_build, ovf), \
                (e + ke, e, doit, jnp.sqrt(jnp.min(r2)))
        return jax.lax.scan(body, carry, None, length=n)

    inst = jax.jit(instrumented, static_argnames=('n',))

    # thermalize with the production chunk
    import jax.random as jr
    from mbpol_openmm_plugin_tpu.md import integrators as I
    key = jr.PRNGKey(1)
    done = 0
    while done < a.therm:
        key, sub = jr.split(key)
        st = carry[0]
        v = I.maxwell_boltzmann_velocities(sys_, 300.0, sub, jnp.float32)
        carry = (dataclasses.replace(st, velocities=v),
                 carry[1]) + carry[2:]
        carry, _ = chunk(carry, 1000)
        done += 1000
    carry, _ = chunk(carry, 1000)

    carry, (etot, pe, reb, rmin) = inst(carry, a.steps)
    etot = np.asarray(etot, np.float64)
    reb = np.asarray(reb)
    rmin = np.asarray(rmin)
    de = np.diff(etot)
    reb_steps = np.where(reb[1:])[0]
    non_reb = np.setdiff1d(np.arange(len(de)), np.concatenate(
        [reb_steps + k for k in (-1, 0, 1)]) if len(reb_steps) else [])
    out = dict(
        scf=a.scf, n_corr=a.n_corr, steps=a.steps,
        n_rebuilds=int(reb.sum()),
        de_rms_all=float(np.sqrt((de ** 2).mean())),
        de_rms_at_rebuild=float(np.sqrt((de[reb_steps] ** 2).mean()))
        if len(reb_steps) else None,
        de_rms_elsewhere=float(np.sqrt((de[non_reb] ** 2).mean())),
        de_mean_at_rebuild=float(de[reb_steps].mean()) if len(reb_steps) else None,
        de_mean_elsewhere=float(de[non_reb].mean()),
        drift_total=float(etot[-1] - etot[0]),
        rmin_min=float(rmin.min()), rmin_mean=float(rmin.mean()))
    np.savez(f'/tmp/drift_probe_{a.scf}_{a.n_corr}.npz', etot=etot, pe=pe,
             reb=reb, rmin=rmin)
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
