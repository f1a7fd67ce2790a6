"""Multi-device mesh tests on the virtual 8-CPU-device mesh.

The reference has no distributed execution (SURVEY 2.6); this validates the
beyond-parity sharding design (parallel/mesh.py): sharded evaluation must
equal the unsharded one to tight tolerance, following the reference's
no-mocks test ethos (SURVEY 4) - the real potential runs on a real (virtual)
mesh, no stand-ins.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mbpol_openmm_plugin_tpu.md import integrators as I
from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu.parallel import mesh as M
from mbpol_openmm_plugin_tpu.system import System, compute_virtual_sites


def _lattice(n_side=2, spacing=0.47):
    # spacing keeps cutoff (0.45) < box/2: the reference rejects larger
    # cutoffs at context init (MBPolReferenceKernels.cpp:219-222), and in
    # that invalid regime the dense and molecule-pair-list electrostatics
    # legitimately differ (multiple periodic images inside the cutoff).
    n = n_side ** 3
    box = [n_side * spacing] * 3
    sys_ = System.waters(n, box=box)
    pos = np.zeros((4 * n, 3))
    k = 0
    for i in range(n_side):
        for j in range(n_side):
            for l in range(n_side):
                o = np.array([i, j, l]) * spacing + 0.05
                pos[4 * k + 0] = o
                pos[4 * k + 1] = o + [0.0757, 0.0586, 0.0]
                pos[4 * k + 2] = o + [-0.0757, 0.0586, 0.0]
                k += 1
    return sys_, compute_virtual_sites(sys_, jnp.asarray(pos))


@pytest.fixture(scope='module')
def lattice():
    return _lattice()


def _pot(sys_, mesh=None, **kw):
    cfg = MBPolConfig(nonbonded_method='PME', cutoff=0.45,
                      target_epsilon=1e-7, max_iterations=100,
                      use_neighbor_lists=True, **kw)
    return MBPol(sys_, cfg, mesh=mesh)


def test_mesh_has_devices():
    assert len(jax.devices()) >= 8, 'conftest should force 8 virtual devices'


def test_sharded_pme_matches_unsharded(lattice):
    sys_, pos = lattice
    e_ref, f_ref, parts_ref, _ = _pot(sys_).energy_forces(pos)

    mesh = M.make_mesh(8)
    pot = _pot(sys_, mesh=mesh)
    with mesh:
        e, f, parts, diag = pot.energy_forces(pos)
        jax.block_until_ready(f)
    np.testing.assert_allclose(float(e), float(e_ref), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(f), np.asarray(f_ref), atol=1e-8)
    for k in parts_ref:
        np.testing.assert_allclose(float(parts[k]), float(parts_ref[k]),
                                   rtol=1e-9, atol=1e-10)


def test_sharded_sparse_pme_matches_dense(lattice):
    sys_, pos = lattice
    e_ref, f_ref, _, _ = _pot(sys_, electrostatics_mode='dense').energy_forces(pos)

    mesh = M.make_mesh(8)
    pot = _pot(sys_, mesh=mesh, electrostatics_mode='sparse')
    with mesh:
        e, f, _, diag = pot.energy_forces(pos)
        jax.block_until_ready(f)
    assert bool(diag['converged'])
    np.testing.assert_allclose(float(e), float(e_ref), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(f), np.asarray(f_ref), atol=1e-6)


def test_sharded_md_step(lattice):
    sys_, pos = lattice
    mesh = M.make_mesh(8)
    pot = _pot(sys_, mesh=mesh)

    def energy_forces(p):
        e, f, parts, diag = pot._energy_forces_impl(p)
        return e, f

    def md_step(state):
        return I.velocity_verlet_step(sys_, energy_forces, state, 2e-4)

    with mesh:
        e0, f0 = jax.jit(energy_forces)(pos)
        state = I.MDState(positions=pos, velocities=jnp.zeros_like(pos),
                          forces=f0, potential_energy=e0,
                          box=jnp.asarray(sys_.box),
                          step=jnp.zeros((), jnp.int32),
                          rng=jax.random.PRNGKey(0))
        out = jax.jit(md_step)(state)
        jax.block_until_ready(out.positions)
    assert np.isfinite(float(out.potential_energy))
    assert int(out.step) == 1

    # two steps unsharded from the same start must agree with the sharded step
    pot_ref = _pot(sys_)

    def ef_ref(p):
        e, f, parts, diag = pot_ref._energy_forces_impl(p)
        return e, f

    out_ref = jax.jit(lambda s: I.velocity_verlet_step(sys_, ef_ref, s, 2e-4))(
        dataclasses.replace(state))
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(out_ref.positions), atol=1e-9)


def test_pme_grid_pipeline_shards_over_sites(lattice):
    """The reciprocal-space pipeline shards its SITE dimension: the spline
    matrices carry a 'dp' sharding constraint (models/pme.py
    _spline_matrices), so charge/dipole spreading contracts a sharded dim -
    per-device partial grids reduced by one psum of the tiny [nx,ny,nz]
    grid - and read-back is row-parallel. The compiled sharded module must
    therefore contain a grid-shaped cross-device reduction (equality with
    the unsharded result is pinned by test_sharded_pme_matches_unsharded)."""
    sys_, pos = lattice
    mesh = M.make_mesh(8)
    pot = _pot(sys_, mesh=mesh)
    with mesh:
        txt = jax.jit(
            lambda p: pot._energy_forces_impl(p)[0]).lower(pos).compile().as_text()
    nx, ny, nz = pot.pme.grid
    # the psum fires on the spread matmul's output [nx, ny*nz] (the grid
    # before its final reshape), or on the reshaped [nx,ny,nz] grid
    shapes = (f'[{nx},{ny * nz}]', f'[{nx},{ny},{nz}]')
    assert any(('all-reduce' in ln or 'reduce-scatter' in ln)
               and any(s in ln for s in shapes)
               for ln in txt.splitlines()), \
        f'no grid-shaped {shapes} cross-device reduction in the sharded HLO'


def test_dryrun_entrypoint_inproc(monkeypatch):
    """The driver-contract function itself, run in-process on the virtual
    mesh (the driver invokes it via the subprocess wrapper)."""
    import sys as _sys
    import os as _os
    _sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
    import __graft_entry__ as G
    monkeypatch.setenv('MBPOL_DRYRUN_INPROC', '1')
    G.dryrun_multichip(8)
