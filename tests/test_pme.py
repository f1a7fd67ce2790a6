"""PME electrostatics goldens.

Sources (platforms/reference/tests/TestReferenceMBPolElectrostaticsForce.cpp):
  - testWater3PMEHugeBox (:895): PME with alpha=1e-15, grid 20^3, box 50 nm
    must reproduce the cluster result (E=-7.08652 kcal/mol + forces).
  - testWater3VirtualSitePMESmallBox (:1327): full 4-site water3 with charge
    redistribution, box 1.8 nm, cutoff 0.9 nm, auto alpha/grid from
    tol=1e-4: E = -66.7426 kJ/mol (rel. tol 1e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np

import fixtures
from mbpol_openmm_plugin_tpu.models import electrostatics as E
from mbpol_openmm_plugin_tpu.models import pme as P
from mbpol_openmm_plugin_tpu.utils import units
from test_electrostatics_cluster import (GOLDEN_W3_FORCES_KCAL_A, WATER3_POS9,
                                         _three_site_params)


def test_pme_huge_box_equals_cluster():
    import dataclasses
    params = _three_site_params()
    params = dataclasses.replace(params, target_epsilon=1e-12)
    setup = P.PmeSetup(alpha=1e-15, grid=(20, 20, 20), cutoff=0.9,
                       box=(50.0, 50.0, 50.0))
    pos = jnp.asarray(WATER3_POS9)
    energy, forces, diag = P.pme_electrostatics(params, setup, pos)
    assert bool(diag['converged'])
    e_kcal = float(energy) * units.KJ_PER_MOL_TO_KCAL_PER_MOL
    assert abs(e_kcal - (-7.08652)) < 1e-3, e_kcal
    f_kcal_a = np.asarray(forces) * units.KJ_PER_MOL_TO_KCAL_PER_MOL / units.NM_TO_ANGSTROM
    np.testing.assert_allclose(f_kcal_a, GOLDEN_W3_FORCES_KCAL_A, rtol=1e-3, atol=1e-3)


def test_pme_small_box_virtual_site_golden():
    from mbpol_openmm_plugin_tpu.system import System, compute_virtual_sites
    sys_ = System.waters(3, box=[1.8, 1.8, 1.8])
    full = np.zeros((12, 3))
    full[[0, 1, 2, 4, 5, 6, 8, 9, 10]] = WATER3_POS9
    pos = compute_virtual_sites(sys_, jnp.asarray(full))
    params = E.ElecParams.for_system(sys_, target_epsilon=1e-12)

    # auto alpha/grid from tol=1e-4, cutoff=0.9 (OpenMM calcPMEParameters)
    tol = 1e-4
    alpha = float(np.sqrt(-np.log(2 * tol)) / 0.9)
    grid = int(np.ceil(2 * alpha * 1.8 / (3 * tol ** 0.2)))
    setup = P.PmeSetup(alpha=alpha, grid=(grid, grid, grid), cutoff=0.9,
                       box=(1.8, 1.8, 1.8))
    energy, forces, diag = P.pme_electrostatics(params, setup, pos)
    assert bool(diag['converged'])
    assert abs(float(energy) - (-66.7426)) / 66.74 < 1e-2, float(energy)


def test_separable_chunked_matches_single_shot(monkeypatch):
    """Above the temp-memory budget the separable spread/readback chunk
    the site dimension under a scan/map; results must equal the
    single-shot path exactly (f64) for non-divisible chunk counts too."""
    rng = np.random.default_rng(7)
    n, dims = 37, (8, 6, 10)
    setup = P.PmeSetup(alpha=3.0, grid=dims, cutoff=0.9, box=(1.2, 1.1, 1.3))
    pos = jnp.asarray(rng.uniform(0, 1.1, (n, 3)))
    Sx, Sy, Sz = P._spline_matrices(setup, pos)
    wx = jnp.asarray(rng.normal(size=(n, dims[0])))
    ref_grid = P._spread_separable(setup, wx, Sy[..., 0], Sz[..., 0])
    ref_back = P._readback_separable(ref_grid, Sx, Sy, Sz)

    monkeypatch.setattr(P, '_SEP_CHUNK_ELEMS', 1)   # force max chunking
    grid_c = P._spread_separable(setup, wx, Sy[..., 0], Sz[..., 0])
    back_c = P._readback_separable(ref_grid, Sx, Sy, Sz)
    np.testing.assert_allclose(np.asarray(grid_c), np.asarray(ref_grid),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(back_c), np.asarray(ref_back),
                               atol=1e-12)


def test_pme_force_energy_consistency_directional():
    """The explicit PME electrostatic forces must be the gradient of the
    reported energy (round-5 regression test).

    The reference's PME fixed-field pair formula (cpp:1386-1388, marked
    "FIXME verify this" there) flips the sign of the cross-water Thole
    damping correction, making the SCF's field operator differ from the
    energy's q-mu coupling - the forces then disagree with dE/dp by
    ~0.2-3% (first order in mu, concentrated on H-bond pairs), which
    heated f32 NVE at O(100) K/ns. This directional-derivative probe
    pins the fix: (E(p+hu)-E(p-hu))/2h must match -F.u to ~1e-5
    relative (f64; the pre-fix defect was 1.9e-3 on water3, 60x above
    the threshold; finite-difference noise is ~1e-7).
    """
    import fixtures
    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig

    sys_, pos = fixtures.load_system('water3', box=[1.2] * 3)
    pos = jnp.asarray(pos, jnp.float64)
    rng = np.random.default_rng(0)
    m = np.asarray(sys_.masses)
    u = rng.normal(size=pos.shape)
    u[m == 0] = 0.0
    u /= np.linalg.norm(u)
    u = jnp.asarray(u)
    pot = MBPol(sys_, MBPolConfig(nonbonded_method='PME', cutoff=0.45,
                                  target_epsilon=1e-10, max_iterations=500,
                                  terms=('electrostatics',)))
    ef = jax.jit(lambda p: pot.energy_forces(p)[:2])
    e0, f0 = ef(pos)
    fu = float(jnp.sum(f0 * u))
    h = 1e-5
    ep, _ = ef(pos + h * u)
    em, _ = ef(pos - h * u)
    defect = abs(float((ep - em) / (2 * h)) + fu) / abs(fu)
    assert defect < 1e-5, defect


def test_convolve_matches_direct_dft():
    """The reciprocal convolution (jnp.fft, cuFFT on a GPU) equals the
    unnormalized backward DFT of eterm * DFT(grid), written out as dense
    DFT matrices on a small non-cubic grid."""
    setup = P.PmeSetup(alpha=3.0, grid=(5, 6, 4), cutoff=0.9,
                       box=(1.7, 1.9, 1.6))
    rng = np.random.default_rng(0)
    grid = rng.normal(size=setup.grid)
    et = np.asarray(P._eterm(setup))
    mats = []
    for n in setup.grid:
        k = np.arange(n)
        mats.append(np.exp(-2j * np.pi * np.outer(k, k) / n))
    gk = np.einsum('abc,ax,by,cz->xyz', grid, *mats)
    want = np.einsum('xyz,ax,by,cz->abc', gk * et,
                     *[m.conj() for m in mats]).real
    got = np.asarray(P._convolve(setup, jnp.asarray(grid), jnp.float64))
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
