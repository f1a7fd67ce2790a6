"""One-body term: Partridge-Schwenke water monomer PES ("pot_nasa").

Physics (reference: MBPolReferenceOneBodyForce.cpp:69-201):
  - Morse-like OH stretches Va, H-H repulsion Vb,
  - 245-term polynomial Vc in (x1, x2, x3) = ((rOH1-re)/re, (rOH2-re)/re,
    cos(theta) - cos(theta_e)), symmetrized in (x1 <-> x2), damped by a
    Gaussian efac in the OH displacements,
  - coefficient blend c5z = f5z*c5zA + fbasis*cbasis + fcore*ccore + frest*crest
    (cpp:103-105), energy correction +0.44739574026257 cm^-1 (cpp:166),
    units cm^-1 -> kcal/mol -> kJ/mol.

Design: molecules are batched along the leading axis; the 245-term
polynomial is evaluated with one-hot gather matrices contracted as a
matmul (vander powers @ one-hot), and forces come from jax.grad of this function
(the reference's hand-derived gradients are the exact derivative of the same
expression; parity is asserted in tests/test_one_body.py against the golden
forces of TestReferenceMBPolOneBodyForce.cpp:98-107).
"""
import functools

import jax.numpy as jnp
import numpy as np

from mbpol_openmm_plugin_tpu import data as _data
from mbpol_openmm_plugin_tpu.utils import units

# scaling factors for the contributions to the empirical potential
# (MBPolReferenceOneBodyForce.cpp:76-79)
_F5Z = 0.999677885
_FBASIS = 0.15860145369897
_FCORE = -1.6351695982132
_FREST = 1.0
_COSTHE = -0.24780227221366464506
_ENERGY_CORRECTION_CM1 = 0.44739574026257

_MAX_POW = 15   # fmat powers x^0 .. x^14 (idx entries span 1..15)


@functools.lru_cache(maxsize=None)
def _tables(dtype=np.float64):
    d = _data.load('onebody')
    c5z = (_F5Z * d['c5zA'] + _FBASIS * d['cbasis'] +
           _FCORE * d['ccore'] + _FREST * d['crest'])
    idx1, idx2, idx3 = d['idx1'], d['idx2'], d['idx3']

    def onehot(idx):
        # power p = idx - 1 (fmat[i][n] == x^(n-1), fmat[i][0] == 0)
        m = np.zeros((len(idx), _MAX_POW), dtype)
        m[np.arange(len(idx)), idx - 1] = 1.0
        return m

    t = dict(
        c5z0=float(c5z[0]),
        c5z=c5z[1:].astype(dtype),            # terms j = 1..244
        A1=onehot(idx1[1:]), A2=onehot(idx2[1:]), A3=onehot(idx3[1:]),
    )
    scal = {k: float(d[k]) for k in
            ['reoh', 'b1', 'roh', 'alphaoh', 'deohA', 'phh1A', 'phh2', 'cm1_kcalmol']}
    t.update(scal)
    return t


def _vander(x, dtype, n=_MAX_POW):
    """[batch, n] powers x^0..x^(n-1) by iterated multiplication (gradient
    well-defined at x == 0, unlike x ** arange(n); see use below)."""
    cols = [jnp.ones_like(x)]
    for _ in range(n - 1):
        cols.append(cols[-1] * x)
    return jnp.stack(cols, axis=-1).astype(dtype)


def one_body_energy(pos_ohh):
    """Monomer distortion energy.

    Args:
      pos_ohh: [nmol, 3, 3] positions in nm, per molecule ordered [O, H1, H2].
    Returns:
      [nmol] energies in kJ/mol.
    """
    dtype = pos_ohh.dtype
    t = _tables()

    o, h1, h2 = pos_ohh[:, 0], pos_ohh[:, 1], pos_ohh[:, 2]
    roh1 = (h1 - o) * units.NM_TO_ANGSTROM
    roh2 = (h2 - o) * units.NM_TO_ANGSTROM
    rhh = (h1 - h2) * units.NM_TO_ANGSTROM
    d1 = jnp.linalg.norm(roh1, axis=-1)
    d2 = jnp.linalg.norm(roh2, axis=-1)
    dhh = jnp.linalg.norm(rhh, axis=-1)
    costh = jnp.sum(roh1 * roh2, axis=-1) / (d1 * d2)

    deoh = _F5Z * t['deohA']
    phh1 = _F5Z * t['phh1A'] * np.exp(t['phh2'])

    exp1 = jnp.exp(-t['alphaoh'] * (d1 - t['roh']))
    exp2 = jnp.exp(-t['alphaoh'] * (d2 - t['roh']))
    va = deoh * (exp1 * (exp1 - 2.0) + exp2 * (exp2 - 2.0))
    vb = phh1 * jnp.exp(-t['phh2'] * dhh)

    x1 = (d1 - t['reoh']) / t['reoh']
    x2 = (d2 - t['reoh']) / t['reoh']
    x3 = costh - _COSTHE

    # vander powers [nmol, 15]: column p holds x^p, built by iterated
    # multiplication. NOT x ** jnp.arange(15): the power-rule gradient of
    # the p=0 column is 0 * x**(-1), which is 0*inf = NaN exactly at x == 0
    # - and x1/x2 cross zero every OH vibration period, so a thermalized
    # f32 trajectory hits the exact zero about once per 1e3 MD steps
    # (observed: finite energy, NaN forces, trajectory death one step
    # later). Products have well-defined gradients everywhere.
    v1 = _vander(x1, dtype)
    v2 = _vander(x2, dtype)
    v3 = _vander(x3, dtype)

    A1 = jnp.asarray(t['A1'], dtype)
    A2 = jnp.asarray(t['A2'], dtype)
    A3 = jnp.asarray(t['A3'], dtype)
    p11 = v1 @ A1.T        # x1^(idx1-1)  [nmol, 244]
    p22 = v2 @ A2.T        # x2^(idx2-1)
    p12 = v1 @ A2.T        # x1^(idx2-1)  (symmetrized partner)
    p21 = v2 @ A1.T        # x2^(idx1-1)
    p3 = v3 @ A3.T         # x3^(idx3-1)

    c5z = jnp.asarray(t['c5z'], dtype)
    sum0 = ((p11 * p22 + p12 * p21) * p3) @ c5z

    efac = jnp.exp(-t['b1'] * ((d1 - t['reoh']) ** 2 + (d2 - t['reoh']) ** 2))
    vc = 2.0 * t['c5z0'] + efac * sum0

    e_cm1 = va + vb + vc + _ENERGY_CORRECTION_CM1
    return e_cm1 * t['cm1_kcalmol'] * units.KCAL_PER_MOL_TO_KJ_PER_MOL
