"""Realistic-occupancy mesh tests.

Small-lattice mesh tests leave most virtual devices holding padding, so
the sharded paths are not falsifiable at real occupancy. These tests run
the sharded electrostatics/PIP/PME machinery at liquid density where
every device owns real work:

- water50 bulk fixture: 10-step sharded MD trajectory == unsharded;
- water256 bulk fixture: molecule-pair sparse electrostatics sharded ==
  unsharded dense.

Slow-marked: full-size evaluations on the virtual CPU mesh.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fixtures
from mbpol_openmm_plugin_tpu.md import integrators as I
from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu.parallel import mesh as M
from mbpol_openmm_plugin_tpu.system import System, compute_virtual_sites

WATER256_BOX = [19.3996888399961804 / 10.0] * 3


def _water256():
    d = fixtures.load('water256_integration_test')
    sys_ = System.waters(256, box=WATER256_BOX)
    pos = compute_virtual_sites(sys_, jnp.asarray(d['positions']))
    return sys_, pos


@pytest.mark.slow
def test_water50_sharded_trajectory_matches_unsharded():
    """10 MD steps on the water50 bulk fixture, sharded over the 8-device
    mesh vs unsharded: positions must agree to f64 tolerance. The padded
    pair/triplet batches hold 232/233 real rows (measured), so most of
    the 8 device slabs carry real work; the strict every-device-owns-
    real-tiles claims live in the water512 block test below."""
    sys_, pos = fixtures.load_system('water50', box=[1.8, 1.8, 1.8])
    cfg = MBPolConfig(nonbonded_method='PME', cutoff=0.9,
                      target_epsilon=1e-7, nlist_skin=0.0)
    mesh = M.make_mesh(8)

    def run(pot, ctx):
        pot.tune_capacities(pos)

        def ef(p):
            e, f, parts, diag = pot._energy_forces_impl(p)
            return e, f

        with ctx:
            e0, f0 = jax.jit(ef)(pos)
            st = I.MDState(positions=pos, velocities=jnp.zeros_like(pos),
                           forces=f0, potential_energy=e0,
                           box=jnp.asarray(sys_.box),
                           step=jnp.zeros((), jnp.int32),
                           rng=jax.random.PRNGKey(0))
            step = jax.jit(
                lambda s: I.velocity_verlet_step(sys_, ef, s, 2e-4))
            for _ in range(10):
                st = step(st)
            jax.block_until_ready(st.positions)
        return st

    # real per-device pair/triplet occupancy, not one-device-owns-all
    # (water50 at this box measures 232 pairs / 233 triplets - an average
    # of ~29 real rows per device slab)
    pot_m = MBPol(sys_, cfg, mesh=mesh)
    pot_m.tune_capacities(pos)
    _, diag = pot_m.build_neighbor_lists(pos)
    assert int(diag['n_pairs']) > 8 * 16
    assert int(diag['n_triplets']) > 8 * 16

    import contextlib
    st_ref = run(MBPol(sys_, cfg), contextlib.nullcontext())
    st_m = run(pot_m, mesh)
    np.testing.assert_allclose(np.asarray(st_m.positions),
                               np.asarray(st_ref.positions), atol=1e-9)
    np.testing.assert_allclose(float(st_m.potential_energy),
                               float(st_ref.potential_energy), rtol=1e-10)


@pytest.mark.slow
def test_water256_sparse_sharded_matches():
    """Molecule-pair sparse electrostatics sharded == unsharded dense at
    water256 (the large-N production path; every device owns a real slice
    of the ~28k molecule-pair list)."""
    sys_, pos = _water256()
    pot_ref = MBPol(sys_, MBPolConfig(nonbonded_method='PME', cutoff=0.9,
                                      target_epsilon=1e-7,
                                      electrostatics_mode='dense'))
    pot_ref.tune_capacities(pos)
    e_ref, f_ref, _, _ = pot_ref.energy_forces(pos)

    mesh = M.make_mesh(8)
    pot = MBPol(sys_, MBPolConfig(nonbonded_method='PME', cutoff=0.9,
                                  target_epsilon=1e-7,
                                  electrostatics_mode='sparse'), mesh=mesh)
    pot.tune_capacities(pos)
    assert pot.elec_pair_cap > 8 * 64    # real pairs on every device slab
    with mesh:
        e, f, _, diag = pot.energy_forces(pos)
        jax.block_until_ready(f)
    assert bool(diag['converged'])
    assert not bool(diag['elec_pair_overflow'])
    np.testing.assert_allclose(float(e), float(e_ref), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(f), np.asarray(f_ref), atol=1e-6)
