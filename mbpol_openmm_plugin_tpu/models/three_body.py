"""Three-body term: short-range MB-pol trimer correction (poly-3b-v2x).

Physics (reference: MBPolReferenceThreeBodyForce.cpp:122-293):
  - early exit if any O-O distance < 2 A (cpp:165),
  - 36 exponential variables exp(-k(d - d0)) over all intra/inter atom pairs
    (cpp:170-206) feeding a degree-4 PIP with 1163 fit coefficients,
  - switch product s = sab*sac + sab*sbc + sac*sbc, each switch a cosine on
    [r3i=0, r3f=4.5] A (cpp:106-120, 213-217); a triplet therefore only
    contributes when at least two of its three O-O distances are below r3f,
    which is exactly the set enumerated by the reference's ThreeNeighborList
    (i, j in nbr(i), k in nbr(j)) - so evaluating any superset of triplets
    (dense or padded) yields identical energies.
  - optional periodic imaging of the molecule triple (imageMolecules).

Forces come from jax.grad (the reference's g_var/switch gradients are the
exact derivative of the same expression).
"""
import functools

import jax.numpy as jnp
import numpy as np

from mbpol_openmm_plugin_tpu import data as _data
from mbpol_openmm_plugin_tpu.models.two_body import _safe_norm, f_switch
from mbpol_openmm_plugin_tpu.ops.polyeval import pip_apply
from mbpol_openmm_plugin_tpu.system import System, water_positions
from mbpol_openmm_plugin_tpu.utils import units

_RMIN = 2.0   # A


@functools.lru_cache(maxsize=None)
def _consts():
    return {k: float(v) for k, v in _data.load('threebody_constants').items()
            if np.ndim(v) == 0}


def _image_triplet(pos_a, pos_b, pos_c, box):
    """imageMolecules for three waters (MBPolReferenceTwoBodyForce.cpp:78-109):
    each water's hydrogens w.r.t. its own O; Ob and Oc w.r.t. Oa."""
    def image(ref, p):
        d = ref - p
        return p + jnp.floor(d / box + 0.5) * box

    oa = pos_a[..., 0, :]
    out = [jnp.stack([oa, image(oa, pos_a[..., 1, :]), image(oa, pos_a[..., 2, :])], axis=-2)]
    for pos in (pos_b, pos_c):
        o = image(oa, pos[..., 0, :])
        out.append(jnp.stack([o, image(o, pos[..., 1, :]), image(o, pos[..., 2, :])], axis=-2))
    return tuple(out)


def three_body_energy_triplets(pos_a, pos_b, pos_c, valid):
    """Three-body energy for a batch of molecule triplets.

    Args:
      pos_a/b/c: [T, 3, 3] monomer positions (O,H1,H2) in Angstrom.
      valid: [T] bool mask.
    Returns:
      [T] energies in kcal/mol.
    """
    c = _consts()
    dtype = pos_a.dtype

    oa, ha1, ha2 = pos_a[:, 0], pos_a[:, 1], pos_a[:, 2]
    ob, hb1, hb2 = pos_b[:, 0], pos_b[:, 1], pos_b[:, 2]
    oc, hc1, hc2 = pos_c[:, 0], pos_c[:, 1], pos_c[:, 2]

    rab = _safe_norm(oa - ob)
    rac = _safe_norm(oa - oc)
    rbc = _safe_norm(ob - oc)
    active = valid & (rab > _RMIN) & (rac > _RMIN) & (rbc > _RMIN)

    # Sanitize inactive entries (padding repeats molecule 0; the reference's
    # r < 2 A early exit): substitute a well-separated geometry BEFORE the
    # exponential variables. The value is masked to 0 below either way, but
    # without the substitution coincident monomers drive exp variables to
    # ~1e8 and the polynomial's f32 intermediates to the overflow boundary -
    # a single inf there turns the masked backward pass into 0*inf = NaN
    # forces (observed once per ~1e3 MD steps at water256; energy stays
    # finite, the trajectory NaNs one step later).
    safe = ~active[:, None, None]
    pos_b = jnp.where(safe, pos_a + jnp.asarray([4.0, 0.0, 0.0], dtype), pos_b)
    pos_c = jnp.where(safe, pos_a + jnp.asarray([0.0, 4.0, 0.0], dtype), pos_c)
    ob, hb1, hb2 = pos_b[:, 0], pos_b[:, 1], pos_b[:, 2]
    oc, hc1, hc2 = pos_c[:, 0], pos_c[:, 1], pos_c[:, 2]

    def var(k, d0, p1, p2):
        return jnp.exp(-k * (_safe_norm(p1 - p2) - d0))

    kHHi, dHHi = c['kHH_intra'], c['dHH_intra']
    kOHi, dOHi = c['kOH_intra'], c['dOH_intra']
    kHH, dHH = c['kHH'], c['dHH']
    kOH, dOH = c['kOH'], c['dOH']
    kOO, dOO = c['kOO'], c['dOO']

    # variable layout mirrors MBPolReferenceThreeBodyForce.cpp:170-206
    x = jnp.stack([
        var(kHHi, dHHi, ha1, ha2), var(kHHi, dHHi, hb1, hb2), var(kHHi, dHHi, hc1, hc2),
        var(kOHi, dOHi, oa, ha1), var(kOHi, dOHi, oa, ha2),
        var(kOHi, dOHi, ob, hb1), var(kOHi, dOHi, ob, hb2),
        var(kOHi, dOHi, oc, hc1), var(kOHi, dOHi, oc, hc2),
        var(kHH, dHH, ha1, hb1), var(kHH, dHH, ha1, hb2),
        var(kHH, dHH, ha1, hc1), var(kHH, dHH, ha1, hc2),
        var(kHH, dHH, ha2, hb1), var(kHH, dHH, ha2, hb2),
        var(kHH, dHH, ha2, hc1), var(kHH, dHH, ha2, hc2),
        var(kHH, dHH, hb1, hc1), var(kHH, dHH, hb1, hc2),
        var(kHH, dHH, hb2, hc1), var(kHH, dHH, hb2, hc2),
        var(kOH, dOH, oa, hb1), var(kOH, dOH, oa, hb2),
        var(kOH, dOH, oa, hc1), var(kOH, dOH, oa, hc2),
        var(kOH, dOH, ob, ha1), var(kOH, dOH, ob, ha2),
        var(kOH, dOH, ob, hc1), var(kOH, dOH, ob, hc2),
        var(kOH, dOH, oc, ha1), var(kOH, dOH, oc, ha2),
        var(kOH, dOH, oc, hb1), var(kOH, dOH, oc, hb2),
        var(kOO, dOO, oa, ob), var(kOO, dOO, oa, oc), var(kOO, dOO, ob, oc),
    ], axis=-1)

    e_poly = pip_apply('poly3b')(x)

    sab = f_switch(rab, c['r3i'], c['r3f'])
    sac = f_switch(rac, c['r3i'], c['r3f'])
    sbc = f_switch(rbc, c['r3i'], c['r3f'])
    s = sab * sac + sab * sbc + sac * sbc

    return jnp.where(active, s * e_poly, jnp.zeros((), dtype))


def three_body_energy(system: System, positions, triplets=None, triplet_mask=None, box=None):
    """Total three-body energy in kJ/mol.

    Args:
      positions: [natoms, 3] nm.
      triplets: optional [T, 3] water-molecule index triplets (i<j<k or the
        neighbor-list generation order - the energy is permutation invariant).
        Defaults to all combinations i<j<k.
      triplet_mask: optional [T] validity mask for padded lists.
    """
    wpos = water_positions(system, positions) * units.NM_TO_ANGSTROM
    if triplets is None:
        n = system.n_waters
        idx = np.array([(i, j, k) for i in range(n) for j in range(i + 1, n)
                        for k in range(j + 1, n)], np.int32).reshape(-1, 3)
        triplets = idx
    if triplet_mask is None:
        triplet_mask = jnp.ones(len(triplets), bool)
    wflat = wpos.reshape(-1, 9)
    pos_a = wflat[triplets[:, 0]].reshape(-1, 3, 3)
    pos_b = wflat[triplets[:, 1]].reshape(-1, 3, 3)
    pos_c = wflat[triplets[:, 2]].reshape(-1, 3, 3)
    if system.periodic:
        b = system.box if box is None else box
        box_a = jnp.asarray(b, positions.dtype) * units.NM_TO_ANGSTROM
        pos_a, pos_b, pos_c = _image_triplet(pos_a, pos_b, pos_c, box_a)
    e_kcal = three_body_energy_triplets(pos_a, pos_b, pos_c, triplet_mask)
    return jnp.sum(e_kcal) * units.KCAL_PER_MOL_TO_KJ_PER_MOL
