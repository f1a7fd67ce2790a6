#!/usr/bin/env python
"""In-graph per-term marginal costs of the water256 MD evaluation.

Times `pot._energy_forces_impl` (warm dipoles, prebuilt lists) as a lax.scan
of K data-dependent iterations - once with all terms, then with each term
removed - so per-term marginals come from ONE compiled program each, free of
the per-call dispatch floor that inflates isolated timings.

Usage: python tools/step_breakdown.py [n_waters] [K]
"""
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    import jax
    jax.config.update('jax_default_matmul_precision', 'highest')
    from mbpol_openmm_plugin_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu.system import System, compute_virtual_sites

    n_w = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 30

    fix = np.load(os.path.join(REPO, 'tests', 'fixtures',
                               'water256_integration_test.npz'))
    box = [19.3996888399961804 / 10.0] * 3
    sys_ = System.waters(256, box=box)
    pos = jnp.asarray(fix['positions'], jnp.float32)
    pos_v = compute_virtual_sites(sys_, pos)

    compact = os.environ.get('MBPOL_SB_COMPACT', '')
    compact = {'': None, 'rebuild': 'rebuild', '1': True}.get(compact, None)

    def make(terms):
        cfg = MBPolConfig(nonbonded_method='PME', cutoff=0.9,
                          target_epsilon=1e-3, max_iterations=200,
                          terms=terms, nlist_skin=0.02,
                          compact_eval=compact)
        p = MBPol(sys_, cfg)
        p.tune_capacities(pos_v)
        return p

    all_terms = ('electrostatics', 'one_body', 'two_body', 'three_body',
                 'dispersion')
    variants = [('full', all_terms)]
    for t in all_terms:
        variants.append((f'-{t}', tuple(x for x in all_terms if x != t)))

    results = {}
    base = None
    for name, terms in variants:
        pot = make(terms)
        nl, _ = pot.build_neighbor_lists(pos_v)
        e0, f0, parts0, diag0 = pot.energy_forces(pos_v)
        mu0 = diag0.get('induced_dipoles')

        def step(x, pot=pot, nl=nl, mu0=mu0):
            e, f, parts, diag = pot._energy_forces_impl(
                x, mu0, nlists=nl)
            return x + 1e-18 * f

        def run(k):
            f = jax.jit(lambda x: jax.lax.scan(
                lambda c, _: (step(c), None), x, None, length=k)[0])
            y = f(pos_v)
            jax.block_until_ready(y)
            reps = 5
            t0 = time.perf_counter()
            for _ in range(reps):
                y = f(pos_v)
            jax.block_until_ready(y)
            return (time.perf_counter() - t0) / reps

        t1, tk = run(1), run(K)
        ms = (tk - t1) / (K - 1) * 1e3
        results[name] = ms
        if name == 'full':
            base = ms
            print(f'{name:20s} {ms:8.3f} ms/eval', flush=True)
        else:
            print(f'{name:20s} {ms:8.3f} ms/eval   marginal '
                  f'{base - ms:7.3f} ms', flush=True)


if __name__ == '__main__':
    main()
