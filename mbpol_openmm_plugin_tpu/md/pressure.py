"""Instantaneous virial pressure via exact autodiff of the box-scaling
energy derivative.

The classic difficulty of the MD virial - getting every term's
contribution right (PME reciprocal space, switching functions, virtual
M-sites, charge redistribution, multi-body polynomials) - disappears
when the pressure is computed as P = (2 K_com - dU/dlambda) / (3V) with
dU/dlambda taken by jax.grad through the same molecular-centroid +
box scaling the Monte Carlo barostat applies
(integrators.monte_carlo_barostat_move): U(lambda) evaluates the full
potential at centroids scaled by lambda and box lambda*box, and AD
differentiates through M-site construction, dq/dr charge redistribution,
PME (the eterm is box-differentiable - the NPT path), switches, and the
SCF fixed point exactly.

The molecular (group-based) convention is used: molecule centroids scale,
intramolecular geometry stays rigid, and the kinetic part is the
molecular center-of-mass kinetic energy (2 <K_com> = 3 N_mol kT). The
reference plugin has no pressure observable at all (its NPT runs use
OpenMM's MC barostat, which also avoids the virial); this is
beyond-parity, enabled by the potential being one differentiable program.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mbpol_openmm_plugin_tpu.utils import units

# 1 bar in kJ/mol/nm^3 (k_B * 1 bar / (R T) bookkeeping collapses to this)
BAR_IN_KJ_MOL_NM3 = 0.0602214076


def _molecular_coms(system, arr):
    """Mass-weighted molecule centroids of a per-atom [natoms, 3] array
    (virtual sites carry zero mass and drop out)."""
    mol = jnp.asarray(system.mol_index)
    nmol = int(system.mol_index.max()) + 1
    m = jnp.asarray(system.masses, arr.dtype)
    mol_mass = jax.ops.segment_sum(m, mol, nmol)
    com = jax.ops.segment_sum(m[:, None] * arr, mol, nmol)
    return com / mol_mass[:, None], mol_mass


def virial_pressure(potential, positions, velocities=None,
                    temperature_k=None, box=None):
    """Instantaneous molecular virial pressure, in bar.

    P = (2 K_com - dU/dlambda|_{lambda=1}) / (3 V)

    where lambda isotropically scales molecule centers of mass and the
    box edges (rigid intramolecular geometry - the barostat's move,
    OpenMM MonteCarloBarostatImpl convention), U is the full MB-pol
    energy (kJ/mol), and K_com the molecular center-of-mass kinetic
    energy. Provide `velocities` ([natoms, 3] nm/ps) for the
    instantaneous kinetic part, or `temperature_k` to use its
    equipartition average 2<K_com> = 3 N_mol kT.

    Periodic (PME) systems only - pressure is undefined for a cluster.
    Differentiable and jittable; the lambda-derivative flows through
    M-site construction, charge redistribution, PME, switches, and the
    SCF solve exactly (no per-term virial bookkeeping).
    """
    system = potential.system
    b = box if box is not None else system.box
    if b is None or not np.all(np.asarray(b) > 0):
        raise ValueError('virial_pressure needs a periodic system')
    positions = jnp.asarray(positions)
    b = jnp.asarray(b, positions.dtype)

    fn = getattr(potential, '_virial_du_jit', None)
    if fn is None:
        mol = jnp.asarray(system.mol_index)

        def du(pos0, box0):
            com, _ = _molecular_coms(system, pos0)

            def energy(lam):
                pos = pos0 + (com * (lam - 1.0))[mol]
                e, _, _, _ = potential._energy_forces_impl(pos,
                                                           box=box0 * lam)
                return e

            # forward-mode: reverse cannot cross the SCF while_loop, but a
            # JVP carries the tangent through it (and the variational
            # energy makes the dipole-tangent contribution vanish at
            # convergence).
            one = jnp.asarray(1.0, pos0.dtype)
            return jax.jvp(energy, (one,), (one,))[1]

        fn = jax.jit(du)
        potential._virial_du_jit = fn

    du_dlam = fn(positions, b)
    vol = b[0] * b[1] * b[2]
    nmol = int(system.mol_index.max()) + 1

    if velocities is not None:
        vcom, mol_mass = _molecular_coms(system, jnp.asarray(velocities))
        twice_k = jnp.sum(mol_mass[:, None] * vcom * vcom)
    elif temperature_k is not None:
        twice_k = 3.0 * nmol * units.BOLTZMANN_KJ_MOL_K * temperature_k
    else:
        raise ValueError('provide velocities or temperature_k')

    p_kj_nm3 = (twice_k - du_dlam) / (3.0 * vol)
    return p_kj_nm3 / BAR_IN_KJ_MOL_NM3


def rpmd_virial_pressure(potential, positions, temperature_k, box=None):
    """Instantaneous NPT-PIMD pressure, in bar (ring-polymer analog of
    `virial_pressure`, matching rpmd.rpmd_barostat_move's ensemble).

    The barostat's scaling map translates each molecule's beads rigidly
    with the molecular ring-polymer centroid, so the configurational
    weight is exp[-beta(mean_b U(q_b) + P V)] V^N_mol and the estimator is

        P = (3 N_mol kT - d Ubar/dlambda|_{lambda=1}) / (3 V),
        Ubar(lambda) = mean_b U(q_b + (lambda-1) centroid_mol, lambda box).

    The ring-spring energy is scaling-invariant (identical shift on every
    bead) and contributes nothing; the ideal part is N_mol kT/V exactly
    (the map scales one centroid per molecule, not per bead). At
    n_beads = 1 this reduces to `virial_pressure(..., temperature_k=...)`.

    positions: [n_beads, natoms, 3] nm. Periodic (PME) systems only.
    """
    system = potential.system
    b = box if box is not None else system.box
    if b is None or not np.all(np.asarray(b) > 0):
        raise ValueError('rpmd_virial_pressure needs a periodic system')
    positions = jnp.asarray(positions)
    b = jnp.asarray(b, positions.dtype)

    fn = getattr(potential, '_rpmd_virial_du_jit', None)
    if fn is None:
        mol = jnp.asarray(system.mol_index)

        def du(q0, box0):
            # molecular ring-polymer centroid (rpmd_barostat_move
            # convention): the mass-weighted molecular COM of the
            # bead-mean - mass weighting commutes with the bead mean
            centroid, _ = _molecular_coms(system, jnp.mean(q0, axis=0))

            def mean_energy(lam):
                q = q0 + (centroid * (lam - 1.0))[mol][None]

                def one(qb):
                    e, _, _, _ = potential._energy_forces_impl(
                        qb, box=box0 * lam)
                    return e

                return jnp.mean(jax.vmap(one)(q))

            one_ = jnp.asarray(1.0, q0.dtype)
            return jax.jvp(mean_energy, (one_,), (one_,))[1]

        fn = jax.jit(du)
        potential._rpmd_virial_du_jit = fn

    du_dlam = fn(positions, b)
    vol = b[0] * b[1] * b[2]
    nmol = int(system.mol_index.max()) + 1
    twice_k = 3.0 * nmol * units.BOLTZMANN_KJ_MOL_K * temperature_k
    return (twice_k - du_dlam) / (3.0 * vol) / BAR_IN_KJ_MOL_NM3
