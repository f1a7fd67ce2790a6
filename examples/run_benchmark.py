#!/usr/bin/env python
"""Benchmark harness, port of python/utils/run_benchmark.py.

The reference times MB-pol (vs AMOEBA) on the OpenMM Reference platform for
{256, 512} waters x {PME, cluster}, 100 steps, and prints wall seconds.
This port runs the same protocol on this framework (the AMOEBA arm is
out of scope - it is a different force field provided by OpenMM itself).

Usage: python examples/run_benchmark.py [--steps 100] [--sizes 256,512]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'tests'))

import numpy as np


def run_case(n_waters, pme, n_steps):
    import jax
    jax.config.update('jax_default_matmul_precision', 'highest')
    import dataclasses

    import jax.numpy as jnp

    import fixtures
    from mbpol_openmm_plugin_tpu.md import integrators as I
    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu.system import System, compute_virtual_sites

    if n_waters == 256:
        fix = fixtures.load('water256_integration_test')
        pos_np = fix['positions']
        box = [19.3996888399961804 / 10.0] * 3
    else:
        # replicate the 256-water box 2x along x for the 512-water case
        fix = fixtures.load('water256_integration_test')
        b = 19.3996888399961804 / 10.0
        shifted = fix['positions'] + np.array([b, 0.0, 0.0])
        pos_np = np.concatenate([fix['positions'], shifted])
        box = [2 * b, b, b]

    sys_ = System.waters(n_waters, box=box if pme else None)
    dtype = jnp.float32
    pos = compute_virtual_sites(sys_, jnp.asarray(pos_np, dtype))
    cfg = MBPolConfig(nonbonded_method='PME' if pme else 'NoCutoff', cutoff=0.9,
                      target_epsilon=1e-3)
    pot = MBPol(sys_, cfg)
    pot.tune_capacities(pos)

    dt = 0.02e-3  # 0.02 fs, the reference harness timestep
    m = np.asarray(sys_.masses)
    inv_m = jnp.asarray(np.where(m > 0, 1.0 / np.where(m > 0, m, 1), 0.0), dtype)[:, None]

    def chunk(carry, n):
        def body(c, _):
            st, mu = c
            v_half = st.velocities + 0.5 * dt * st.forces * inv_m
            p = st.positions + dt * v_half
            e, f, parts, diag = pot._energy_forces_impl(p, mu)
            v = v_half + 0.5 * dt * f * inv_m
            st = dataclasses.replace(st, positions=p, velocities=v, forces=f,
                                     potential_energy=e, step=st.step + 1)
            return (st, diag.get('induced_dipoles', mu)), e
        return jax.lax.scan(body, carry, None, length=n)

    e0, f0, parts0, diag0 = pot._energy_forces_impl(pos)
    st = I.MDState(positions=pos, velocities=jnp.zeros_like(pos), forces=f0,
                   potential_energy=e0,
                   box=jnp.asarray(box if pme else [0, 0, 0], dtype),
                   step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))
    carry = (st, diag0.get('induced_dipoles', jnp.zeros_like(pos)))
    step = jax.jit(chunk, static_argnames=('n',))
    carry, es = step(carry, n_steps)
    _ = np.asarray(es)                 # compile+run
    t0 = time.time()
    carry, es = step(carry, n_steps)
    _ = np.asarray(es)
    elapsed = time.time() - t0
    print('mbpol %4d waters  %-7s  %3d steps: %8.3f s  (%.1f steps/s)'
          % (n_waters, 'PME' if pme else 'cluster', n_steps, elapsed,
             n_steps / elapsed))
    return elapsed


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=100)
    ap.add_argument('--sizes', default='256,512')
    args = ap.parse_args()
    for n in [int(s) for s in args.sizes.split(',')]:
        for pme in (True, False):
            run_case(n, pme, args.steps)


if __name__ == '__main__':
    main()
