"""Golden tests for the two-body term.

Goldens from platforms/reference/tests/TestReferenceMBPolTwoBodyForce.cpp:99-127
(full-precision dimer geometry, E = 6.14207815 kcal/mol + per-atom forces) and
the PBC-imaging invariance test (:174-229).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mbpol_openmm_plugin_tpu.models.two_body import two_body_energy
from mbpol_openmm_plugin_tpu.system import System
from mbpol_openmm_plugin_tpu.utils import units

WATER2_POS = np.array([
    [-1.516074336e+00, -2.023167650e-01, 1.454672917e+00],
    [-6.218989773e-01, -6.009430735e-01, 1.572437625e+00],
    [-2.017613812e+00, -4.190350349e-01, 2.239642849e+00],
    [-1.763651687e+00, -3.816594649e-01, -1.300353949e+00],
    [-1.903851736e+00, -4.935677617e-01, -3.457810126e-01],
    [-2.527904158e+00, -7.613550077e-01, -1.733803676e+00],
]) * 0.1  # A -> nm

# reference "expectedForces" are gradients in kcal/mol/A
WATER2_GRAD_KCAL_A = np.array([
    [-4.85337479, -4.47836379, -20.08989563],
    [-0.31239868, 0.52518586, -1.88893830],
    [0.00886712, 0.73323536, -1.81715325],
    [-0.65181727, -0.72947395, 5.88973293],
    [4.82340981, 3.20090213, 16.49522051],
    [0.98531382, 0.74851439, 1.41103374],
])

GOLDEN_ENERGY_KCAL = 6.14207815


def _as_full_positions(pos6):
    """Embed the 2x(O,H1,H2) geometry into the stride-4 OHHM layout."""
    sys_ = System.waters(2)
    full = np.zeros((8, 3))
    full[[0, 1, 2, 4, 5, 6]] = pos6
    return sys_, jnp.asarray(full)


def test_two_body_energy_golden():
    sys_, pos = _as_full_positions(WATER2_POS)
    e = two_body_energy(sys_, pos)
    e_kcal = float(e) * units.KJ_PER_MOL_TO_KCAL_PER_MOL
    assert abs(e_kcal - GOLDEN_ENERGY_KCAL) < 1e-6, e_kcal


def test_two_body_forces_golden():
    sys_, pos = _as_full_positions(WATER2_POS)
    grad = jax.grad(lambda p: two_body_energy(sys_, p))(pos)
    grad_kcal_a = np.asarray(grad) * units.KJ_PER_MOL_TO_KCAL_PER_MOL / units.NM_TO_ANGSTROM
    np.testing.assert_allclose(grad_kcal_a[[0, 1, 2, 4, 5, 6]], WATER2_GRAD_KCAL_A, atol=2e-4)
    # M-site rows receive no two-body force
    np.testing.assert_allclose(grad_kcal_a[[3, 7]], 0.0, atol=1e-12)


def test_two_body_periodic_imaging():
    """Offsetting one molecule by a box vector must not change the energy
    (reference testImageMolecules, TestReferenceMBPolTwoBodyForce.cpp:174-229)."""
    box = 5.0  # nm
    sys_, pos = _as_full_positions(WATER2_POS)
    sys_p = sys_.with_box([box, box, box])
    e0 = two_body_energy(sys_p, pos)
    shifted = np.asarray(pos).copy()
    shifted[4:8, 1] += box
    e1 = two_body_energy(sys_p, jnp.asarray(shifted))
    np.testing.assert_allclose(float(e0), float(e1), rtol=1e-8)
    e_kcal = float(e0) * units.KJ_PER_MOL_TO_KCAL_PER_MOL
    assert abs(e_kcal - GOLDEN_ENERGY_KCAL) < 1e-6


def test_two_body_out_of_range_pairs_are_zero_and_nan_free():
    sys_, pos = _as_full_positions(WATER2_POS)
    far = np.asarray(pos).copy()
    far[4:8] += 2.0  # move second water ~20 A away (> r2f cutoff)
    e = two_body_energy(sys_, jnp.asarray(far))
    assert float(e) == 0.0
    g = jax.grad(lambda p: two_body_energy(sys_, p))(jnp.asarray(far))
    assert np.all(np.isfinite(np.asarray(g)))
    assert np.allclose(np.asarray(g), 0.0)


def test_quad_basis_gather_matches_exponent_form():
    """The gather-form exact-product basis must equal exp(log x @ F) in f64
    (same monomials; the gather form exists because f32 log rounding costs
    ~0.3 kcal/mol per close dimer - see ops/polyeval.py)."""
    import jax.numpy as jnp

    from mbpol_openmm_plugin_tpu.ops import polyeval as PE
    rng = np.random.default_rng(0)
    for name in ('poly2b', 'poly3b'):
        F, W = PE.load_quad(name)
        x = jnp.asarray(rng.uniform(0.05, 0.9, size=(16, F.shape[1])))
        m2_gather = PE.quad_basis(x, name)
        m2_exp = jnp.exp(jnp.log(x) @ jnp.asarray(F.T, x.dtype))
        np.testing.assert_allclose(np.asarray(m2_gather), np.asarray(m2_exp),
                                   rtol=1e-12)


@pytest.mark.parametrize('name', ['poly2b', 'poly3b'])
def test_monomial_reference_matches_quad_form(name):
    """The plain monomial expansion (the PIP reference, HIGHEST precision)
    and the quadratic-form evaluator used in production agree on energies
    and gradients in float64."""
    from mbpol_openmm_plugin_tpu.ops import polyeval as PE
    rng = np.random.default_rng(1)
    pip = PE.load_pip(name)
    F, W = PE.load_quad(name)
    x = jnp.asarray(rng.uniform(0.05, 0.9, size=(32, pip.nvars)))
    e_m, g_m = PE.pip_energy_and_grad(x, jnp.asarray(pip.exponents),
                                      jnp.asarray(pip.coeffs))
    e_q, g_q = PE.pip_quad_energy_and_grad(x, jnp.asarray(F), jnp.asarray(W),
                                           name=name)
    sc = float(np.abs(np.asarray(e_m)).max())
    np.testing.assert_allclose(np.asarray(e_q), np.asarray(e_m),
                               atol=1e-9 * sc)
    np.testing.assert_allclose(np.asarray(g_q), np.asarray(g_m),
                               atol=1e-8 * float(np.abs(np.asarray(g_m)).max()))
    np.testing.assert_allclose(np.asarray(PE.pip_apply(name)(x)),
                               np.asarray(e_q), rtol=1e-13, atol=1e-13 * sc)
