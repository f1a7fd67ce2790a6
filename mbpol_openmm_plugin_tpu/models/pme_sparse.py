"""Sparse (molecule-pair-list) PME electrostatics for large periodic systems.

The dense path (models/pme.py) materializes [N,N] tensors - exact and fast up
to ~1-2k molecules, but O(N^2) in memory/compute. For production boxes the
direct-space work is restricted to a padded molecule-pair list (O-O distance
< cutoff + margin): per pair, the 4x4 site-site block is evaluated densely,
and per-molecule results are combined with segment sums. Intramolecular
(same-water) terms form a separate [nmol,4,4] block. The reciprocal-space
machinery (separable-spline spreading, FFT convolution, read-back) is shared
with the dense path and is already O(N + grid log grid).

Physics is identical to models/pme.py (same reference formulas, same
same-water scale conventions); equivalence is asserted in
tests/test_pme_sparse.py against the dense path.

Requires the standard contiguous OHHM stride-4 layout (System.waters), which
lets all [N,3] <-> [nmol,4,3] conversions be reshapes instead of gathers,
and cutoff <= box/2 (the reference enforces the same at context init,
MBPolReferenceKernels.cpp:219-222; beyond it multiple periodic images fall
inside the cutoff and the minimum-image pair-list decomposition no longer
matches the dense path).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mbpol_openmm_plugin_tpu import data as _data
from mbpol_openmm_plugin_tpu.models import electrostatics as elec
from mbpol_openmm_plugin_tpu.models import pme as pme_mod
from mbpol_openmm_plugin_tpu.utils import units

_SQRT_PI = np.sqrt(np.pi)

# extra O-O margin so every site-site pair within the cutoff is covered
# (max site offset from its O: H ~0.10-0.15 nm stretched, M ~0.03 nm).
# Single-sourced from models/dispersion.py: the molecule-pair dispersion
# path shares this list (models/potential.py), so the radii must match.
from mbpol_openmm_plugin_tpu.models.dispersion import PAIR_MARGIN  # noqa: E402


def _slot_tables(params: elec.ElecParams, dtype):
    """Static per-site-slot (O,H1,H2,M) tables: inverse damp products and
    intramolecular TDD gammas."""
    ff = _data.load('forcefield')
    damping = np.array([ff['atom_O'][1], ff['atom_H'][1], ff['atom_H'][1],
                        ff['atom_M'][1]])
    d16 = damping ** (1.0 / 6.0)
    inv_damp = 1.0 / (d16[:, None] * d16[None, :])
    th = params.thole
    is_o = np.array([True, False, False, False])
    one_is_o = is_o[:, None] | is_o[None, :]
    gamma_intra = np.where(one_is_o, th[elec.TDDOH], th[elec.TDDHH])
    return (jnp.asarray(inv_damp, dtype), jnp.asarray(gamma_intra, dtype),
            float(th[elec.TCC]), float(th[elec.TCD]), float(th[elec.TDD]))


def pme_electrostatics_sparse(params: elec.ElecParams, setup: pme_mod.PmeSetup,
                              positions, mol_pairs, pair_mask, mu0=None,
                              box=None, mesh=None):
    """PME energy/forces/diagnostics on a padded molecule-pair list.

    Args:
      positions: [4*nmol, 3] nm, contiguous OHHM layout, M sites placed,
        molecules whole.
      mol_pairs: [P, 2] int32 molecule-index pairs with min-image O-O
        distance < cutoff + PAIR_MARGIN (+ skin); any superset is exact.
      pair_mask: [P] validity for padding.
      mesh: optional jax.sharding.Mesh - the pair dimension P is partitioned
        over the 'dp' axis; XLA turns the per-molecule segment sums into
        partial sums + psum (parallel/mesh.py). Positions, the
        [nmol,4,*] intra block and the PME grids stay replicated.
    """
    dtype = positions.dtype
    f_elec = units.ELECTRIC
    alpha = setup.alpha
    nmol = positions.shape[0] // 4
    dyn_box = box
    box = jnp.asarray(setup.box if box is None else box, dtype)
    pscale = jnp.asarray(np.asarray(setup.grid), dtype) / box

    charges, dq_w = elec.assemble_charges(params, positions)
    q4 = charges.reshape(nmol, 4)
    pos4 = positions.reshape(nmol, 4, 3)
    alpha_pol4 = jnp.asarray(params.polarity, dtype).reshape(nmol, 4)

    inv_damp, gamma_intra, g_cc, g_cd, g_dd = _slot_tables(params, dtype)

    if mesh is not None:
        from mbpol_openmm_plugin_tpu.parallel import mesh as M
        rs = M.row_sharded(mesh)
        mol_pairs = M.constrain(mol_pairs, rs)
        pair_mask = M.constrain(pair_mask, rs)

    ia = mol_pairs[:, 0]
    ib = mol_pairs[:, 1]

    # ---- inter-molecular pair block tensors [P,4,4] ----
    pa = pos4[ia]                                   # [P,4,3]
    pb = pos4[ib]
    delta = pb[:, None, :, :] - pa[:, :, None, :]   # [P,4,4,3] (r_b - r_a)
    if mesh is not None:
        delta = M.constrain(delta, rs)
    delta = delta - jnp.floor(delta / box + 0.5) * box
    r2 = jnp.sum(delta * delta, axis=-1)
    within = pair_mask[:, None, None] & (r2 <= setup.cutoff ** 2)
    r = jnp.sqrt(jnp.where(within, r2, 1.0))
    inv_r = jnp.where(within, 1.0 / r, 0.0)
    rr1 = inv_r
    rr3 = inv_r ** 3
    rr5 = 3.0 * inv_r ** 5
    rr7 = 15.0 * inv_r ** 7
    bn0, bn1, bn2, bn3 = [jnp.where(within, b, 0.0)
                          for b in pme_mod._bn_factors(alpha, r, inv_r)]
    u = r * inv_damp[None]
    s_cc = elec.thole_scales(u, g_cc, orders=(1, 3))
    s_cd = elec.thole_scales(u, g_cd, orders=(3, 5))
    s_dd = elec.thole_scales(u, g_dd, orders=(3, 5, 7))

    qa = q4[ia]                                     # [P,4]
    qb = q4[ib]

    # ---- intra-molecular block [nmol,4,4] (always within cutoff) ----
    delta_in = pos4[:, None, :, :] - pos4[:, :, None, :]   # r_b - r_a
    r2_in = jnp.sum(delta_in * delta_in, axis=-1)
    offdiag = ~jnp.eye(4, dtype=bool)[None]
    r_in = jnp.sqrt(jnp.where(offdiag, r2_in, 1.0))
    inv_r_in = jnp.where(offdiag, 1.0 / r_in, 0.0)
    rr3_in = inv_r_in ** 3
    rr5_in = 3.0 * inv_r_in ** 5
    bn_in = [jnp.where(offdiag, b, 0.0)
             for b in pme_mod._bn_factors(alpha, r_in, inv_r_in)]
    u_in = r_in * inv_damp[None]
    s_dd_in = elec.thole_scales(u_in, gamma_intra[None], orders=(3, 5))

    def seg(vals, idx, is_sorted=False):
        return jax.ops.segment_sum(vals, idx, num_segments=nmol,
                                   indices_are_sorted=is_sorted)

    def seg_a(vals):
        # pair lists from ops/neighbors.py emit ascending first indices
        return seg(vals, ia, is_sorted=True)

    # ---- fixed field ----
    # reciprocal (shared grid machinery)
    Sx, Sy, Sz = pme_mod._spline_matrices(setup, positions, box=dyn_box,
                                          mesh=mesh)
    sx0, sy0, sz0 = Sx[..., 0], Sy[..., 0], Sz[..., 0]
    sx1, sy1, sz1 = Sx[..., 1], Sy[..., 1], Sz[..., 1]

    grid = pme_mod._spread_separable(setup, charges[:, None] * sx0, sy0, sz0)
    conv = pme_mod._convolve(setup, grid, dtype, box=dyn_box)
    phi = pme_mod._readback_phi10(conv, Sx, Sy, Sz)
    efield = (-pscale[None, :] * phi[:, 1:4]).reshape(nmol, 4, 3)

    # direct inter: kdir = bn1 - (1 - s3cc) rr3  (cross-water damping sign
    # FIXED vs the reference's bn1 - (s3-1) rr3; see models/pme.py - the
    # SCF field operator must match the energy's q-mu coupling)
    kdir = jnp.where(within, bn1 - (1.0 - s_cc[3]) * rr3, 0.0)
    fa = -jnp.einsum('pab,pb,pabd->pad', kdir, qb, delta)
    fb = jnp.einsum('pab,pa,pabd->pbd', kdir, qa, delta)
    efield = efield + seg_a(fa) + seg(fb, ib)
    # direct intra: same-water s3 := 2 (cpp:1382-1384)
    kdir_in = bn_in[1] - rr3_in
    efield = efield - jnp.einsum('mab,mb,mabd->mad', kdir_in, q4, delta_in)

    # ---- SCF ----
    pf1 = jnp.where(within, (1.0 - s_dd[3]) * rr3 - bn1, 0.0)
    pf2 = jnp.where(within, bn2 - (1.0 - s_dd[5]) * rr5, 0.0)
    pf1_in = (1.0 - s_dd_in[3]) * rr3_in - bn_in[1]
    pf2_in = bn_in[2] - (1.0 - s_dd_in[5]) * rr5_in
    self_term = (4.0 / 3.0) * alpha ** 3 / _SQRT_PI

    def mu_recip_phi(mu4):
        mu = mu4.reshape(-1, 3)
        smu = mu * pscale[None, :]
        g = (pme_mod._spread_separable(setup, smu[:, 0:1] * sx1, sy0, sz0)
             + pme_mod._spread_separable(setup, smu[:, 1:2] * sx0, sy1, sz0)
             + pme_mod._spread_separable(setup, smu[:, 2:3] * sx0, sy0, sz1))
        c = pme_mod._convolve(setup, g, dtype, box=dyn_box)
        return pme_mod._readback_phi10(c, Sx, Sy, Sz)

    def dipole_field(mu4):
        mua = mu4[ia]
        mub = mu4[ib]
        dotb = jnp.einsum('pbd,pabd->pab', mub, delta)
        fa = jnp.einsum('pab,pabd->pad', pf2 * dotb, delta) \
            + jnp.einsum('pab,pbd->pad', pf1, mub)
        dota = jnp.einsum('pad,pabd->pab', mua, delta)
        fb = jnp.einsum('pab,pabd->pbd', pf2 * dota, delta) \
            + jnp.einsum('pab,pad->pbd', pf1, mua)
        field = seg_a(fa) + seg(fb, ib)
        dot_in = jnp.einsum('mbd,mabd->mab', mu4, delta_in)
        field = field + jnp.einsum('mab,mabd->mad', pf2_in * dot_in, delta_in) \
                      + jnp.einsum('mab,mbd->mad', pf1_in, mu4)
        phid = mu_recip_phi(mu4)
        field = field + (-pscale[None, :] * phid[:, 1:4]).reshape(nmol, 4, 3)
        return field + self_term * mu4

    # SOR iteration (reference semantics, elec.scf_induced_dipoles inlined
    # over the [nmol,4,3] layout)
    n_sites = 4 * nmol
    target = params.target_epsilon
    if dtype == jnp.float32:
        # same floor policy as the dense path (typed config knob wins,
        # then MBPOL_F32_SCF_EPS_FLOOR, then the historical 1e-4)
        target = max(target, elec._f32_eps_floor(
            getattr(params, 'scf_eps_floor', None)))
    big = jnp.asarray(jnp.finfo(dtype).max / 4, dtype)
    efield_alpha = efield * alpha_pol4[:, :, None]

    def one_iter(mu4):
        new = efield_alpha + dipole_field(mu4) * alpha_pol4[:, :, None]
        dmu = new - mu4
        eps = elec._POLAR_SOR * units.DEBYE * jnp.sqrt(jnp.sum(dmu * dmu) / n_sites)
        return mu4 + elec._POLAR_SOR * dmu, eps

    def cond(c):
        return ~c[3]

    def body(c):
        mu4, prev_eps, it, _, _ = c
        mu2, eps = one_iter(mu4)
        converged = eps < target
        done = converged | (prev_eps < eps) | (it + 1 >= params.max_iterations)
        return (mu2, eps, it + 1, done, converged)

    mu_init = efield_alpha if mu0 is None else mu0.reshape(nmol, 4, 3)
    if params.scf_method == 'aspc' and mu0 is not None:
        # Kolafa ASPC closure: one damped corrector on the caller's history
        # predictor (see elec.scf_induced_dipoles_aspc). Cold starts
        # (mu0=None) take the converged loop below.
        omega = elec.aspc_omega(params.aspc_k)
        new = efield_alpha + dipole_field(mu_init) * alpha_pol4[:, :, None]
        dmu = new - mu_init
        # SOR-damped corrector step - see elec.scf_induced_dipoles_aspc for
        # why the bare Picard corrector is unstable here
        mu4 = mu_init + omega * elec._POLAR_SOR * dmu
        eps = elec._POLAR_SOR * units.DEBYE * jnp.sqrt(jnp.sum(dmu * dmu) / n_sites)
        diag = dict(iterations=jnp.ones((), jnp.int32), epsilon=eps,
                    converged=jnp.ones((), bool))
    else:
        mu4, eps, iters, _, converged = jax.lax.while_loop(
            cond, body, (mu_init, big, jnp.zeros((), jnp.int32),
                         jnp.zeros((), bool), jnp.zeros((), bool)))
        diag = dict(iterations=iters, epsilon=eps, converged=converged)

    # ---- direct-space energy / forces / potential ----
    mua = mu4[ia]
    mub = mu4[ib]
    dot_a = jnp.einsum('pad,pabd->pab', mua, delta)      # mu_a . (r_b - r_a)
    dot_b = jnp.einsum('pbd,pabd->pab', mub, delta)
    qq = qa[:, :, None] * qb[:, None, :]
    gli1 = qb[:, None, :] * dot_a - qa[:, :, None] * dot_b
    mumu = jnp.einsum('pad,pbd->pab', mua, mub)

    e_pair = (bn0 - rr1 * (1.0 - s_cc[1])) * qq \
        + 0.5 * (bn1 - rr3 * (1.0 - s_cd[3])) * gli1
    # intramolecular energy: scales zeroed (cpp:2605-2613)
    dot_in = jnp.einsum('mbd,mabd->mab', mu4, delta_in)
    dot_in_a = jnp.einsum('mad,mabd->mab', mu4, delta_in)
    qq_in = q4[:, :, None] * q4[:, None, :]
    gli1_in = q4[:, None, :] * dot_in_a - q4[:, :, None] * dot_in
    e_in = (bn_in[0] - inv_r_in) * qq_in + 0.5 * (bn_in[1] - rr3_in) * gli1_in
    e_direct = jnp.sum(jnp.where(within, e_pair, 0.0)) \
        + 0.5 * jnp.sum(e_in)

    coeff = (bn1 - (1.0 - s_cc[3]) * rr3) * qq \
        + (bn2 - rr5 * (1.0 - s_cd[5])) * gli1 \
        + (bn2 - rr5 * (1.0 - s_dd[5])) * mumu \
        - (bn3 - rr7 * (1.0 - s_dd[7])) * (dot_a * dot_b)
    coeff = jnp.where(within, coeff, 0.0)
    w5 = jnp.where(within, bn2 - rr5 * (1.0 - s_dd[5]), 0.0)
    w3 = jnp.where(within, bn1 - rr3 * (1.0 - s_cd[3]), 0.0)

    # F_ab acts -f on a-sites, +f on b-sites (antisymmetric construction)
    F = jnp.einsum('pab,pabd->pabd', coeff, delta)
    F = F + jnp.einsum('pab,pad->pabd', w5 * dot_b, mua) \
          + jnp.einsum('pab,pbd->pabd', w5 * dot_a, mub)
    F = F + jnp.einsum('pab,pbd->pabd', w3 * qa[:, :, None], mub) \
          - jnp.einsum('pab,pad->pabd', w3 * qb[:, None, :], mua)
    # dense convention: force_i = -f * sum_j F_ij; F is antisymmetric under
    # (a<->b, delta -> -delta), so b-sites get the negated a-row sums
    force_pair4 = seg_a(jnp.sum(F, axis=2)) - seg(jnp.sum(F, axis=1), ib)

    # intramolecular forces (same structure, zeroed qq/cd scales)
    coeff_in = (bn_in[1] - rr3_in) * qq_in \
        + (bn_in[2] - rr5_in) * gli1_in \
        + (bn_in[2] - rr5_in * (1.0 - s_dd_in[5])) * jnp.einsum('mad,mbd->mab', mu4, mu4) \
        - (bn_in[3] - 15.0 * inv_r_in ** 7 * (1.0 - elec.thole_scales(u_in, gamma_intra[None], orders=(7,))[7])) * (dot_in_a * dot_in)
    w5_in = bn_in[2] - rr5_in * (1.0 - s_dd_in[5])
    w3_in = bn_in[1] - rr3_in
    F_in = jnp.einsum('mab,mabd->mabd', coeff_in, delta_in)
    F_in = F_in + jnp.einsum('mab,mad->mabd', w5_in * dot_in, mu4) \
                + jnp.einsum('mab,mbd->mabd', w5_in * dot_in_a, mu4)
    F_in = F_in + jnp.einsum('mab,mbd->mabd', w3_in * q4[:, :, None], mu4) \
                - jnp.einsum('mab,mad->mabd', w3_in * q4[:, None, :], mu4)
    # intra block covers ordered pairs, so the dense row-sum applies directly
    force_pair4 = force_pair4 + jnp.sum(F_in, axis=2)

    forces = (-f_elec * force_pair4).reshape(-1, 3)

    # per-site potential (direct)
    k1 = jnp.where(within, bn0 - rr1 * (1.0 - s_cc[1]), 0.0)
    k3 = jnp.where(within, bn1 - rr3 * (1.0 - s_cd[3]), 0.0)
    pot_a = jnp.einsum('pab,pb->pa', k1, qb) - jnp.sum(k3 * dot_b, axis=2)
    pot_b = jnp.einsum('pab,pa->pb', k1, qa) + jnp.sum(k3 * dot_a, axis=1)
    pot4 = seg_a(pot_a) + seg(pot_b, ib)
    k1_in = bn_in[0] - inv_r_in
    k3_in = bn_in[1] - rr3_in
    pot4 = pot4 + jnp.einsum('mab,mb->ma', k1_in, q4) - jnp.sum(k3_in * dot_in, axis=2)
    pot = pot4.reshape(-1)

    # ---- reciprocal fixed + induced, self (same as dense path) ----
    mu_flat = mu4.reshape(-1, 3)
    e_recip_fixed = 0.5 * jnp.sum(charges * phi[:, 0])
    forces = forces - f_elec * (charges[:, None] * phi[:, 1:4] * pscale[None, :])
    pot = pot + phi[:, 0]

    phid = mu_recip_phi(mu4)
    e_recip_ind = 0.5 * jnp.sum((mu_flat * pscale[None, :]) * phi[:, 1:4])
    hess_fixed = phi[:, pme_mod._HESS]
    hess_ind = phid[:, pme_mod._HESS]
    smu = mu_flat * pscale[None, :]
    f_ind = 2.0 * jnp.einsum('ndk,nk->nd', hess_fixed + hess_ind, smu)
    f_ind = f_ind + 2.0 * charges[:, None] * phid[:, 1:4]
    forces = forces - 0.5 * f_elec * pscale[None, :] * f_ind
    pot = pot + phid[:, 0]

    e_self = -(alpha / _SQRT_PI) * jnp.sum(charges * charges)
    pot = pot + charges * (-2.0 * alpha / _SQRT_PI)

    if params.include_charge_redistribution and dq_w is not None:
        phi_sites = pot.reshape(nmol, 4)[:, 1:]
        f_atoms = -f_elec * jnp.einsum('masd,ms->mad', dq_w, phi_sites)
        pad = jnp.zeros((nmol, 1, 3), pot.dtype)
        forces = forces + jnp.concatenate([f_atoms, pad], axis=1).reshape(-1, 3)

    energy = f_elec * (e_direct + e_recip_fixed + e_recip_ind + e_self)
    return energy, forces, dict(**diag, charges=charges, induced_dipoles=mu_flat)
