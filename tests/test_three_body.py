"""Golden tests for the three-body term.

Goldens from platforms/reference/tests/TestReferenceMBPolThreeBodyForce.cpp:95-141
(full-precision trimer geometry, E = 0.15586446 kcal/mol + per-atom gradients).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mbpol_openmm_plugin_tpu.models.three_body import three_body_energy
from mbpol_openmm_plugin_tpu.system import System
from mbpol_openmm_plugin_tpu.utils import units

WATER3_POS = np.array([
    [-1.516074336e+00, -2.023167650e-01, 1.454672917e+00],
    [-6.218989773e-01, -6.009430735e-01, 1.572437625e+00],
    [-2.017613812e+00, -4.190350349e-01, 2.239642849e+00],
    [-1.763651687e+00, -3.816594649e-01, -1.300353949e+00],
    [-1.903851736e+00, -4.935677617e-01, -3.457810126e-01],
    [-2.527904158e+00, -7.613550077e-01, -1.733803676e+00],
    [-5.588472140e-01, 2.006699172e+00, -1.392786582e-01],
    [-9.411558180e-01, 1.541226676e+00, 6.163293071e-01],
    [-9.858551734e-01, 1.567124294e+00, -8.830970941e-01],
]) * 0.1

WATER3_GRAD_KCAL_A = np.array([
    [0.29919011, -0.34960381, -0.16238472],
    [0.34138467, -0.01255068, -0.00998383],
    [-0.44376649, 0.03687577, 0.54604510],
    [-0.01094164, -0.36171476, -0.05130395],
    [0.24939202, 1.29382952, 0.22930712],
    [-0.13250943, -0.19313418, -0.34123592],
    [0.56722869, 0.46036139, -0.39999973],
    [-0.75669111, -0.76132457, -0.29799486],
    [-0.11328682, -0.11273867, 0.48755080],
])

GOLDEN_ENERGY_KCAL = 0.15586446


def _as_full_positions(pos9):
    sys_ = System.waters(3)
    full = np.zeros((12, 3))
    full[[0, 1, 2, 4, 5, 6, 8, 9, 10]] = pos9
    return sys_, jnp.asarray(full)


def test_three_body_energy_golden():
    sys_, pos = _as_full_positions(WATER3_POS)
    e = three_body_energy(sys_, pos)
    e_kcal = float(e) * units.KJ_PER_MOL_TO_KCAL_PER_MOL
    assert abs(e_kcal - GOLDEN_ENERGY_KCAL) < 1e-6, e_kcal


def test_three_body_forces_golden():
    sys_, pos = _as_full_positions(WATER3_POS)
    grad = jax.grad(lambda p: three_body_energy(sys_, p))(pos)
    grad_kcal_a = np.asarray(grad) * units.KJ_PER_MOL_TO_KCAL_PER_MOL / units.NM_TO_ANGSTROM
    np.testing.assert_allclose(grad_kcal_a[[0, 1, 2, 4, 5, 6, 8, 9, 10]],
                               WATER3_GRAD_KCAL_A, atol=2e-4)


def test_three_body_periodic_offset_invariance():
    box = 5.0
    sys_, pos = _as_full_positions(WATER3_POS)
    sys_p = sys_.with_box([box, box, box])
    e0 = three_body_energy(sys_p, pos)
    shifted = np.asarray(pos).copy()
    shifted[4:8, 1] += box
    e1 = three_body_energy(sys_p, jnp.asarray(shifted))
    np.testing.assert_allclose(float(e0), float(e1), rtol=1e-8)


def test_three_body_far_triplet_zero_nan_free():
    sys_, pos = _as_full_positions(WATER3_POS)
    far = np.asarray(pos).copy()
    far[8:12] += 3.0   # third water far outside r3f
    # only pairs a-b remain close: switch product vanishes
    e = three_body_energy(sys_, jnp.asarray(far))
    assert float(e) == 0.0
    g = jax.grad(lambda p: three_body_energy(sys_, p))(jnp.asarray(far))
    assert np.all(np.isfinite(np.asarray(g)))


def test_triplet_semantics_reference_parity_water50():
    """Opt-in strict-parity triplet mode vs the default complete set.

    The reference's enumeration (ReferenceThreeNeighborList.cpp:215-225)
    emits only middle-centered ascending chains {a<b<c: edge(a,b), edge(b,c)}
    and therefore misses two-edge triplets whose shared center is the
    smallest or largest index. On the water50 fixture (0.45 nm cutoff,
    1.8 nm box) that is 1.2847 kcal/mol of three-body energy - the documented
    deviation (ops/neighbors.py docstring). Both values are pinned so a
    change to either enumeration is caught.
    """
    import fixtures
    from mbpol_openmm_plugin_tpu.ops import neighbors

    sys_, pos = fixtures.load_system('water50', box=[1.8, 1.8, 1.8])
    o_pos = pos[sys_.o_index]
    box = sys_.box
    cutoff = 0.45
    cap = neighbors.triplet_capacity(sys_.n_waters, box, cutoff)
    vals = {}
    for sem in ('complete', 'reference'):
        trips, mask, n = neighbors.triplet_list(o_pos, box, cutoff, cap,
                                                semantics=sem)
        assert int(n) <= cap
        e = three_body_energy(sys_, pos, trips, mask, box=jnp.asarray(box))
        vals[sem] = float(e) * units.KJ_PER_MOL_TO_KCAL_PER_MOL
    assert abs(vals['complete'] - 3.848850) < 1e-4, vals
    assert abs(vals['reference'] - 2.564164) < 1e-4, vals
    assert abs((vals['complete'] - vals['reference']) - 1.284686) < 1e-4


def test_pip_typed_config_knobs():
    """The PIP evaluator has one implementation: MBPolConfig carries no
    evaluator knobs, so the removed pip_impl/pip_basis options fail at
    construction instead of selecting a kernel, and the default config
    evaluates the 2B+3B terms finitely."""
    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
    for knob in ('pip_impl', 'pip_basis'):
        with pytest.raises(TypeError, match=knob):
            MBPolConfig(**{knob: 'quad'})
    sys_, pos = _as_full_positions(WATER3_POS)
    pot = MBPol(sys_, MBPolConfig(terms=('two_body', 'three_body')))
    e, f, parts, _ = pot.energy_forces(jnp.asarray(pos))
    assert np.isfinite(float(e)) and np.isfinite(np.asarray(f)).all()
    np.testing.assert_allclose(float(e),
                               float(parts['two_body'] + parts['three_body']),
                               rtol=1e-12)


def test_scf_eps_floor_typed_config():
    """The typed scf_eps_floor reaches the f32 SCF clamp (and wins over
    the env default)."""
    from mbpol_openmm_plugin_tpu.models import electrostatics as E
    assert E._f32_eps_floor(None) == 1e-4
    assert E._f32_eps_floor(1e-6) == 1e-6
