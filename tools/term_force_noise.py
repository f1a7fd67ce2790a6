#!/usr/bin/env python
"""Per-term f32 force noise vs the f64 oracle + predicted NVE heating.

Drift forensics: NVE heating that scales ~linearly with dt is the
signature of white force noise (heating per ns = sum dF^2 dt / 2m).
This tool measures dF per TERM for the PRODUCTION evaluation path (f32)
against a float64 CPU oracle, and converts each term's noise to a
predicted heating rate at dt = 0.2 fs.

Stage 1 (CPU):  JAX_PLATFORMS=cpu python tools/term_force_noise.py --oracle
Stage 2 (GPU):  python tools/term_force_noise.py
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TERMS = ('one_body', 'two_body', 'three_body', 'dispersion', 'electrostatics')
ORACLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      'artifacts', 'term_forces_f64.npz')


def build(term, dtype_bits, positions_f64=None):
    import jax
    if dtype_bits == 64:
        jax.config.update('jax_enable_x64', True)
    jax.config.update('jax_default_matmul_precision', 'highest')
    from mbpol_openmm_plugin_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu.system import System, compute_virtual_sites
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fix = np.load(os.path.join(root, 'tests', 'fixtures',
                               'water256_integration_test.npz'))
    box = [19.3996888399961804 / 10.0] * 3
    sys_ = System.waters(256, box=box)
    dtype = jnp.float64 if dtype_bits == 64 else jnp.float32
    pos = compute_virtual_sites(sys_, jnp.asarray(fix['positions'], dtype))
    pme = term == 'electrostatics'
    pot = MBPol(sys_, MBPolConfig(
        nonbonded_method='PME' if pme else 'NoCutoff', cutoff=0.9,
        target_epsilon=(1e-10 if dtype_bits == 64 else 1e-6),
        scf_eps_floor=(None if dtype_bits == 64 else 1e-7),
        max_iterations=500, dispersion_switch_width=0.1,
        terms=(term,)))
    e, f, _, _ = pot.energy_forces(pos)
    return sys_, float(e), np.asarray(f, np.float64)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--oracle', action='store_true')
    a = ap.parse_args()
    if a.oracle:
        out = {}
        for t in TERMS:
            _, e, f = build(t, 64)
            out[t + '_e'] = e
            out[t] = f
            print(t, 'f64 E =', e, flush=True)
        os.makedirs(os.path.dirname(ORACLE), exist_ok=True)
        np.savez(ORACLE, **out)
        return
    z = np.load(ORACLE)
    kB = 0.008314462618
    dt = 0.2e-3
    res = {}
    sys_ = None
    for t in TERMS:
        sys_, e, f = build(t, 32)
        dF = f - z[t]
        m = np.asarray(sys_.masses, np.float64)
        act = m > 0
        per_ns = float((dF[act] ** 2 / (2 * m[act, None])).sum()
                       * dt * dt * (1e3 / dt))
        ndof = 3 * int(act.sum())
        res[t] = dict(e_f32=round(e, 3), de=round(e - float(z[t + '_e']), 4),
                      dF_rms=float(f'{np.sqrt((dF[act]**2).mean()):.3e}'),
                      dF_max=float(f'{np.abs(dF[act]).max():.3e}'),
                      predicted_heating_K_per_ns=round(
                          per_ns / (0.5 * ndof * kB), 1))
        print(t, res[t], flush=True)
    print(json.dumps(res))


if __name__ == '__main__':
    main()
