"""Two-body term: short-range MB-pol dimer correction (poly-2b-v6x).

Physics (reference: MBPolReferenceTwoBodyForce.cpp:110-296):
  - active for 2 A < rOO <= 6.5 A, with a cosine switch on rOO in [4.5, 6.5] A
    (mbpol_2body_constants.cpp:97-111),
  - two lone-pair extra points per monomer (monomer::setup,
    mbpol_2body_constants.cpp:59-72) with in-plane/out-of-plane gammas,
  - 31 exponential/coulomb-type variables over atom+extra-point pairs
    (cpp:170-207) feeding a degree-4 PIP with 1153 fit coefficients,
  - optional periodic imaging of the molecule pair (cpp:66-109).

Design: pairs are batched; the PIP evaluates as matmuls
(ops/polyeval.py). Forces come from jax.grad of the total energy - the
reference's chain-rule gradients (variable::grads, monomer::grads, switch
gradient) are the exact derivative of the same expression; parity is
asserted against golden forces in tests/test_two_body.py.
"""
import functools

import jax.numpy as jnp
import numpy as np

from mbpol_openmm_plugin_tpu import data as _data
from mbpol_openmm_plugin_tpu.ops.polyeval import pip_apply
from mbpol_openmm_plugin_tpu.system import System, water_positions
from mbpol_openmm_plugin_tpu.utils import units

_D0_INTRA = 1.0   # A (cpp:162)
_D0_INTER = 4.0   # A (cpp:163)
_RMIN = 2.0       # A early exit (cpp:144)


@functools.lru_cache(maxsize=None)
def _consts():
    return {k: float(v) for k, v in _data.load('twobody_constants').items()
            if np.ndim(v) == 0}


def f_switch(r, r_lo, r_hi):
    """Cosine switching function, 1 below r_lo, 0 above r_hi."""
    x = (r - r_lo) * (np.pi / (r_hi - r_lo))
    s = (1.0 + jnp.cos(x)) / 2.0
    return jnp.where(r > r_hi, 0.0, jnp.where(r > r_lo, s, 1.0))


def _image_pair(pos_a, pos_b, box):
    """Periodic imaging of a molecule pair, reference convention
    (imageMolecules, MBPolReferenceTwoBodyForce.cpp:78-109): hydrogens are
    imaged w.r.t. their own oxygen, the second oxygen w.r.t. the first.
    Positions in Angstrom; box in Angstrom."""
    def image(ref, p):
        d = ref - p
        return p + jnp.floor(d / box + 0.5) * box

    oa = pos_a[..., 0, :]
    ha1 = image(oa, pos_a[..., 1, :])
    ha2 = image(oa, pos_a[..., 2, :])
    ob = image(oa, pos_b[..., 0, :])
    hb1 = image(ob, pos_b[..., 1, :])
    hb2 = image(ob, pos_b[..., 2, :])
    return (jnp.stack([oa, ha1, ha2], axis=-2),
            jnp.stack([ob, hb1, hb2], axis=-2))


def monomer_extra_points(o, h1, h2, in_plane_g, out_of_plane_g):
    """Lone-pair sites (mbpol_2body_constants.cpp:59-72). Angstrom in/out."""
    oh1 = h1 - o
    oh2 = h2 - o
    v = jnp.cross(oh1, oh2)
    in_plane = o + (oh1 + oh2) * (0.5 * in_plane_g)
    out_of_plane = v * out_of_plane_g
    return in_plane + out_of_plane, in_plane - out_of_plane


def _safe_norm(d, eps=1e-12):
    return jnp.sqrt(jnp.maximum(jnp.sum(d * d, axis=-1), eps))


def two_body_energy_pairs(pos_a, pos_b, valid):
    """Two-body energy for a batch of molecule pairs.

    Args:
      pos_a, pos_b: [P, 3, 3] monomer positions (O,H1,H2) in Angstrom,
        already imaged if periodic.
      valid: [P] bool mask for padded/invalid entries.
    Returns:
      [P] pair energies in kcal/mol.
    """
    c = _consts()
    dtype = pos_a.dtype

    oa, ha1, ha2 = pos_a[:, 0], pos_a[:, 1], pos_a[:, 2]
    ob, hb1, hb2 = pos_b[:, 0], pos_b[:, 1], pos_b[:, 2]

    roo = _safe_norm(oa - ob)
    active = valid & (roo < c['r2f']) & (roo > _RMIN)

    # Sanitize inactive entries (padding repeats molecule 0; the reference's
    # r < 2 A early exit): substitute a well-separated geometry BEFORE the
    # exponential variables. The value is masked to 0 below either way, but
    # without the substitution coincident monomers drive the coulomb-type
    # variables to ~1e8 and the polynomial's f32 intermediates to the
    # overflow boundary - a single inf there turns the masked backward pass
    # into 0*inf = NaN forces (rare, trajectory-killing; see
    # three_body_energy_triplets for the same guard).
    pos_b = jnp.where((~active)[:, None, None],
                      pos_a + jnp.asarray([5.0, 0.0, 0.0], dtype), pos_b)
    ob, hb1, hb2 = pos_b[:, 0], pos_b[:, 1], pos_b[:, 2]

    xa1, xa2 = monomer_extra_points(oa, ha1, ha2, c['in_plane_gamma'], c['out_of_plane_gamma'])
    xb1, xb2 = monomer_extra_points(ob, hb1, hb2, c['in_plane_gamma'], c['out_of_plane_gamma'])

    def v_exp(k, p1, p2):
        return jnp.exp(k * (_D0_INTRA - _safe_norm(p1 - p2)))

    def v_exp_inter(k, p1, p2):
        return jnp.exp(k * (_D0_INTER - _safe_norm(p1 - p2)))

    def v_coul(k, p1, p2):
        r = _safe_norm(p1 - p2)
        return jnp.exp(k * (_D0_INTER - r)) / r

    # variable layout mirrors MBPolReferenceTwoBodyForce.cpp:170-207
    x = jnp.stack([
        v_exp(c['k_HH_intra'], ha1, ha2),
        v_exp(c['k_HH_intra'], hb1, hb2),
        v_exp(c['k_OH_intra'], oa, ha1),
        v_exp(c['k_OH_intra'], oa, ha2),
        v_exp(c['k_OH_intra'], ob, hb1),
        v_exp(c['k_OH_intra'], ob, hb2),
        v_coul(c['k_HH_coul'], ha1, hb1),
        v_coul(c['k_HH_coul'], ha1, hb2),
        v_coul(c['k_HH_coul'], ha2, hb1),
        v_coul(c['k_HH_coul'], ha2, hb2),
        v_coul(c['k_OH_coul'], oa, hb1),
        v_coul(c['k_OH_coul'], oa, hb2),
        v_coul(c['k_OH_coul'], ob, ha1),
        v_coul(c['k_OH_coul'], ob, ha2),
        v_coul(c['k_OO_coul'], oa, ob),
        v_exp_inter(c['k_XH_main'], xa1, hb1),
        v_exp_inter(c['k_XH_main'], xa1, hb2),
        v_exp_inter(c['k_XH_main'], xa2, hb1),
        v_exp_inter(c['k_XH_main'], xa2, hb2),
        v_exp_inter(c['k_XH_main'], xb1, ha1),
        v_exp_inter(c['k_XH_main'], xb1, ha2),
        v_exp_inter(c['k_XH_main'], xb2, ha1),
        v_exp_inter(c['k_XH_main'], xb2, ha2),
        v_exp_inter(c['k_XO_main'], oa, xb1),
        v_exp_inter(c['k_XO_main'], oa, xb2),
        v_exp_inter(c['k_XO_main'], ob, xa1),
        v_exp_inter(c['k_XO_main'], ob, xa2),
        v_exp_inter(c['k_XX_main'], xa1, xb1),
        v_exp_inter(c['k_XX_main'], xa1, xb2),
        v_exp_inter(c['k_XX_main'], xa2, xb1),
        v_exp_inter(c['k_XX_main'], xa2, xb2),
    ], axis=-1)

    e_poly = pip_apply('poly2b')(x)
    sw = f_switch(roo, c['r2i'], c['r2f'])
    return jnp.where(active, sw * e_poly, jnp.zeros((), dtype))


def two_body_energy(system: System, positions, pairs=None, pair_mask=None, box=None):
    """Total two-body energy in kJ/mol.

    Args:
      system: topology; if periodic, pair imaging uses system.box.
      positions: [natoms, 3] nm.
      pairs: optional [P, 2] int array of water-molecule index pairs
        (e.g. from a neighbor list). Defaults to all i<j pairs.
      pair_mask: optional [P] bool validity mask for padded lists.
    """
    wpos = water_positions(system, positions) * units.NM_TO_ANGSTROM
    if pairs is None:
        ii, jj = np.triu_indices(system.n_waters, k=1)
        pairs = np.stack([ii, jj], axis=1).astype(np.int32)
    if pair_mask is None:
        pair_mask = jnp.ones(len(pairs), bool)
    wflat = wpos.reshape(-1, 9)
    pos_a = wflat[pairs[:, 0]].reshape(-1, 3, 3)
    pos_b = wflat[pairs[:, 1]].reshape(-1, 3, 3)
    if system.periodic:
        b = system.box if box is None else box
        box_a = jnp.asarray(b, positions.dtype) * units.NM_TO_ANGSTROM
        pos_a, pos_b = _image_pair(pos_a, pos_b, box_a)
    e_kcal = two_body_energy_pairs(pos_a, pos_b, pair_mask)
    return jnp.sum(e_kcal) * units.KCAL_PER_MOL_TO_KJ_PER_MOL
