#!/usr/bin/env python
"""Directional-derivative force/energy consistency probe, per term.

Drift forensics: when f32 NVE heats even with FULLY CONVERGED induced
dipoles and compensated integration, while the f32-vs-f64 force rounding
predicts little white-noise heating, a SYSTEMATIC inconsistency between
the energy surface and the explicit forces is the candidate: a missing
or mis-scaled force term of relative size ~5e-5 hides below every
golden-force tolerance (1e-3..1e-4 kcal/mol/A).

This probe measures, in float64 on CPU (exact same code paths, dense
mode), the relative defect

    defect = (E(p + h u) - E(p - h u)) / (2h) + F . u) / |F . u|

per term (one_body/two_body/three_body/dispersion/electrostatics+PME)
along thermal-velocity-like directions u at thermal configurations. An
analytic inconsistency shows up as a defect far above the O(h^2) central-
difference floor (~1e-9 at h=1e-6 nm); discontinuity-crossing effects do
NOT show here (those are locally consistent gradients).

Usage: JAX_PLATFORMS=cpu python tools/force_consistency.py
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    jax.config.update('jax_enable_x64', True)
    import jax.numpy as jnp

    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu.system import System, compute_virtual_sites

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fix = np.load(os.path.join(root, 'tests', 'fixtures',
                               'water256_integration_test.npz'))
    box = [19.3996888399961804 / 10.0] * 3
    sys_ = System.waters(256, box=box)
    pos = compute_virtual_sites(sys_, jnp.asarray(fix['positions'],
                                                  jnp.float64))
    rng = np.random.default_rng(0)
    # thermal-ish direction: random unit vector over REAL atoms (M rows 0;
    # virtual sites are recomputed inside the energy fn)
    m = np.asarray(sys_.masses)
    u = rng.normal(size=pos.shape)
    u[m == 0] = 0.0
    u /= np.linalg.norm(u)
    u = jnp.asarray(u)

    out = {}
    for term in ('one_body', 'two_body', 'three_body', 'dispersion',
                 'electrostatics'):
        pot = MBPol(sys_, MBPolConfig(
            nonbonded_method='PME' if term == 'electrostatics' else 'NoCutoff',
            cutoff=0.9, target_epsilon=1e-10, max_iterations=400,
            dispersion_switch_width=0.1 if term == 'dispersion' else 0.0,
            terms=(term,)))
        if term == 'dispersion':
            # also probe the PLAIN truncation variant for comparison
            pass

        def energy(p, pot=pot):
            e, f, parts, diag = pot.energy_forces(p)
            return e, f

        e0, f0 = energy(pos)
        fu = float(jnp.sum(f0 * u))
        h = 1e-6
        ep, _ = energy(pos + h * u)
        em, _ = energy(pos - h * u)
        dnum = float((ep - em) / (2 * h))
        defect = (dnum + fu) / max(abs(fu), 1e-300)
        out[term] = dict(F_dot_u=fu, dE_du_num=dnum,
                         rel_defect=float(f'{defect:.3e}'))
        print(term, out[term], flush=True)
    print(json.dumps(out))


if __name__ == '__main__':
    main()
