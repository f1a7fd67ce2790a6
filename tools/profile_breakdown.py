#!/usr/bin/env python
"""Per-term wall-time breakdown of the MB-pol step on the attached device.

Times each jitted component of the water256 PME MD step separately (full
potential, smooth-term grad, per-term grads, electrostatics, neighbor build)
so optimization effort goes where the milliseconds are. Not a benchmark —
bench.py is the headline number.

Usage: python tools/profile_breakdown.py [n_waters] [stage]
  stage: 'main' (full step + lists + electrostatics, default) or 'terms'
  (per-term grads) — split because each stage compiles its own set of
  programs.
"""
import functools
import os
import sys
import time

import numpy as np

print = functools.partial(print, flush=True)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def timeit(fn, *args, n=30, **kw):
    import jax
    out = fn(*args, **kw)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args, **kw)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3  # ms


def main():
    import jax
    jax.config.update('jax_default_matmul_precision', 'highest')
    import functools

    import jax.numpy as jnp

    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu.system import System, compute_virtual_sites

    n_w = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    stage = sys.argv[2] if len(sys.argv) > 2 else 'main'
    if n_w == 256:
        fix = np.load(os.path.join(REPO, 'tests', 'fixtures',
                                   'water256_integration_test.npz'))
        box = [19.3996888399961804 / 10.0] * 3
        pos = jnp.asarray(fix['positions'], jnp.float32)
    else:
        # cubic lattice at liquid density
        rho_per_nm3 = 33.4
        side = (n_w / rho_per_nm3) ** (1.0 / 3.0)
        box = [side] * 3
        m = int(np.ceil(n_w ** (1 / 3)))
        g = (np.stack(np.meshgrid(*[np.arange(m)] * 3), -1).reshape(-1, 3)
             [:n_w] + 0.5) * side / m
        p = np.zeros((4 * n_w, 3), np.float32)
        p[0::4] = g
        p[1::4] = g + [0.0757, 0.0586, 0.0]
        p[2::4] = g + [-0.0757, 0.0586, 0.0]
        pos = jnp.asarray(p)
    sys_ = System.waters(n_w, box=box)
    pos = compute_virtual_sites(sys_, pos)

    pot = MBPol(sys_, MBPolConfig(nonbonded_method='PME', cutoff=0.9,
                                  target_epsilon=1e-3, max_iterations=200,
                                  nlist_skin=0.05))
    pot.tune_capacities(pos)
    print(f'device={jax.devices()[0]}  n_waters={n_w}  '
          f'pair_cap={pot.pair_cap} trip_cap={pot.trip_cap} '
          f'elec_mode={pot.elec_mode}')

    nl, _ = pot.build_neighbor_lists(pos)
    e, f, parts, diag = pot.energy_forces(pos)
    mu = diag['induced_dipoles']
    print({k: round(float(v), 2) for k, v in parts.items()})
    print('scf iterations (cold):', int(diag.get('iterations', -1)))

    if stage == 'main':
        full = jax.jit(lambda p, m, n: pot._energy_forces_impl(p, m, nlists=n)[:2])
        print(f'full step (warm mu, prebuilt lists): '
              f'{timeit(full, pos, mu, nl):8.3f} ms')

        nlj = jax.jit(lambda p: pot._neighbor_lists(p))
        print(f'neighbor lists:                      {timeit(nlj, pos):8.3f} ms')

        if pot.elec_mode == 'dense':
            from mbpol_openmm_plugin_tpu.models import pme as pme_mod
            pv = compute_virtual_sites(sys_, pos)
            ej = jax.jit(lambda p, m: pme_mod.pme_electrostatics(
                pot.elec_params, pot.pme, p, mu0=m)[:2])
            print(f'electrostatics (PME, warm mu):       {timeit(ej, pv, mu):8.3f} ms')
            it_warm = jax.jit(lambda p, m: pme_mod.pme_electrostatics(
                pot.elec_params, pot.pme, p, mu0=m)[2]['iterations'])
            print('scf iterations (warm):', int(it_warm(pv, mu)))
        else:
            from mbpol_openmm_plugin_tpu.models import pme_sparse
            from mbpol_openmm_plugin_tpu.ops import neighbors as NB
            pv = compute_virtual_sites(sys_, pos)
            cut = pot.config.cutoff + pme_sparse.PAIR_MARGIN + pot.config.nlist_skin
            mp, mp_mask, _ = NB.pair_list(pv[sys_.o_index],
                                          jnp.asarray(box), cut, pot.elec_pair_cap)
            ej = jax.jit(lambda p, m: pme_sparse.pme_electrostatics_sparse(
                pot.elec_params, pot.pme, p, mp, mp_mask, mu0=m)[:2])
            print(f'electrostatics (sparse, warm mu):    {timeit(ej, pv, mu):8.3f} ms')

    if stage == 'terms':
        import dataclasses

        def one_term(name):
            cfg2 = dataclasses.replace(pot.config, terms=(name,))
            p2 = MBPol(pot.system, cfg2)
            p2.pair_cap, p2.trip_cap = pot.pair_cap, pot.trip_cap
            return jax.jit(lambda p, n: p2._energy_forces_impl(p, nlists=n)[:2])

        for t in ['one_body', 'two_body', 'three_body', 'dispersion']:
            fn = one_term(t)
            print(f'{t:12s} grad only: {timeit(fn, pos, nl):8.3f} ms')


if __name__ == '__main__':
    main()
