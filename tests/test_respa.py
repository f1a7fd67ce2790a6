"""r-RESPA multiple-timestep integration tests.

The reference integrates with OpenMM's single-timestep Verlet (SURVEY 3.4);
this framework adds the OpenMM MTSIntegrator / MTSLangevinIntegrator role
natively: the expensive intermolecular terms (PIPs, polarization, dispersion)
kick at the outer step, the Partridge-Schwenke monomer term - whose OH
stretch pins MB-pol's 0.2 fs timestep - integrates at dt/n_inner.

Validation without reference goldens (the reference has no MTS): the
splitting algebra reduces to velocity Verlet when the fast channel is empty,
the split energies rebuild the full potential exactly, and NVE conservation
holds at an outer step where the expensive terms run 2x less often.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

import fixtures
from mbpol_openmm_plugin_tpu.md import integrators as I
from mbpol_openmm_plugin_tpu.md.simulation import Simulation, SimulationConfig
from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig


def _sim(respa_inner, dt, temperature=None, thermostat='andersen', seed=1,
         **cfg_kw):
    sys_, pos = fixtures.load_system('water3')
    pot = MBPol(sys_, MBPolConfig(nonbonded_method='NoCutoff', cutoff=0.9))
    sim = Simulation(pot, SimulationConfig(dt=dt, temperature=temperature,
                                           thermostat=thermostat,
                                           respa_inner=respa_inner, **cfg_kw),
                     seed=seed)
    sim.set_positions(pos)
    return sim


def test_respa_step_reduces_to_verlet():
    """With an empty fast channel and n_inner=1, one RESPA step is exactly
    one velocity-Verlet step (the inner drift sees constant velocity)."""
    sys_, pos = fixtures.load_system('water3')
    pot = MBPol(sys_, MBPolConfig(nonbonded_method='NoCutoff', cutoff=0.9))

    def ef(p):
        e, f, _, _ = pot._energy_forces_impl(p)
        return e, f

    def ef_zero(p):
        return jnp.zeros((), p.dtype), jnp.zeros_like(p)

    pos = jnp.asarray(pos)
    e0, f0 = ef(pos)
    key = jax.random.PRNGKey(0)
    v0 = I.maxwell_boltzmann_velocities(sys_, 50.0, key, pos.dtype)
    state = I.MDState(positions=pos, velocities=v0, forces=f0,
                      potential_energy=e0, box=jnp.zeros(3, pos.dtype),
                      step=jnp.zeros((), jnp.int32), rng=key)
    dt = 0.0002

    s_vv = state
    s_mts, f_slow = state, f0
    for _ in range(5):
        s_vv = I.velocity_verlet_step(sys_, ef, s_vv, dt)
        s_mts, f_slow, _ = I.respa_velocity_verlet_step(
            sys_, ef_zero, ef, s_mts, f_slow, dt, 1)
    np.testing.assert_allclose(np.asarray(s_mts.positions),
                               np.asarray(s_vv.positions), atol=1e-13)
    np.testing.assert_allclose(np.asarray(s_mts.velocities),
                               np.asarray(s_vv.velocities), atol=1e-11)
    np.testing.assert_allclose(float(s_mts.potential_energy),
                               float(s_vv.potential_energy), rtol=1e-12)


def test_respa_split_energy_matches_full():
    """The reported potential energy (fast + slow channels at the new
    positions) equals a full-potential evaluation there. SCF warm start is
    off so both evaluations run an identical cold-started SCF (warm start
    shifts the converged dipoles at the SCF tolerance, ~1e-7 relative)."""
    sim = _sim(respa_inner=2, dt=0.0004, scf_warm_start=False)
    sim.set_velocities_to_temperature(50.0)
    sim.step(3)
    e_full, _, _, _ = sim.potential.energy_forces(sim.state.positions)
    np.testing.assert_allclose(float(sim.state.potential_energy),
                               float(e_full), rtol=1e-10)
    # total forces too (slow + fast at the step's final positions)
    _, f_full, _, _ = sim.potential.energy_forces(sim.state.positions)
    np.testing.assert_allclose(np.asarray(sim.state.forces),
                               np.asarray(f_full), atol=1e-6)


def test_respa_nve_energy_conservation():
    """NVE at a 0.4 fs OUTER step (intermolecular terms evaluated 2x less
    often than the reference's 0.2 fs protocol), monomer term at 0.2 fs."""
    sim = _sim(respa_inner=2, dt=0.0004)
    sim.set_velocities_to_temperature(50.0)
    m0 = sim.step(5)
    e0 = m0['total_energy'][-1]
    m = sim.step(100, report_interval=20)
    drift = np.max(np.abs(m['total_energy'] - e0))
    assert drift < 0.05, (drift, m['total_energy'], e0)


def test_respa_langevin_thermalizes():
    sim = _sim(respa_inner=2, dt=0.0004, temperature=300.0,
               thermostat='langevin')
    sim.step(150, report_interval=150)
    t = sim.step(50)['temperature'][-1]
    assert 100.0 < t < 700.0, t


def test_respa_checkpoint_resume_determinism(tmp_path):
    sim = _sim(respa_inner=2, dt=0.0004, temperature=300.0,
               thermostat='langevin')
    sim.set_velocities_to_temperature(300.0)
    sim.step(10)
    path = str(tmp_path / 'ck.npz')
    sim.save_checkpoint(path)
    sim.step(10)
    ref_pos = np.asarray(sim.state.positions)

    sim2 = _sim(respa_inner=2, dt=0.0004, temperature=300.0,
                thermostat='langevin')
    sim2.load_checkpoint_file(path)
    sim2.step(10)
    np.testing.assert_allclose(np.asarray(sim2.state.positions), ref_pos,
                               atol=1e-12)


def test_respa3_split_energy_matches_full():
    """Three-level split (3b outer / 2b+disp+elec mid / monomer inner):
    the reported PE at the new positions equals a full-potential
    evaluation, and the summed channel forces rebuild the full forces."""
    sim = _sim(respa_inner=2, dt=0.0008, respa_mid=2, scf_warm_start=False)
    sim.set_velocities_to_temperature(50.0)
    sim.step(3)
    e_full, f_full, _, _ = sim.potential.energy_forces(sim.state.positions)
    np.testing.assert_allclose(float(sim.state.potential_energy),
                               float(e_full), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(sim.state.forces),
                               np.asarray(f_full), atol=1e-6)


def test_respa3_nve_energy_conservation():
    """NVE with the three-body term on a 0.8 fs OUTER rung, the remaining
    intermolecular terms at 0.4 fs and the monomer term at 0.2 fs - the
    production MTS ladder (verdict r2 item 2)."""
    sim = _sim(respa_inner=2, dt=0.0008, respa_mid=2)
    sim.set_velocities_to_temperature(50.0)
    m0 = sim.step(5)
    e0 = m0['total_energy'][-1]
    m = sim.step(100, report_interval=20)
    drift = np.max(np.abs(m['total_energy'] - e0))
    assert drift < 0.05, (drift, m['total_energy'], e0)


def test_respa3_with_aspc_runs_and_conserves():
    """ASPC polarization closure on the middle rung: the predictor/
    corrector history advances per MIDDLE evaluation (dt/respa_mid)."""
    sys_, pos = fixtures.load_system('water3')
    pot = MBPol(sys_, MBPolConfig(nonbonded_method='NoCutoff', cutoff=0.9,
                                  scf_method='aspc', aspc_k=2))
    sim = Simulation(pot, SimulationConfig(dt=0.0008, temperature=None,
                                           respa_inner=2, respa_mid=2),
                     seed=1)
    sim.set_positions(pos)
    sim.set_velocities_to_temperature(50.0)
    m0 = sim.step(5)
    e0 = m0['total_energy'][-1]
    m = sim.step(60, report_interval=20)
    drift = np.max(np.abs(m['total_energy'] - e0))
    assert np.isfinite(m['total_energy']).all()
    assert drift < 0.1, (drift, m['total_energy'], e0)


def test_respa3_polarization_on_inner_rung():
    """respa_polarization_rung='inner': electrostatics joins the monomer
    term on the base-step rung, so the ASPC history advances at the
    single-step cadence (the measured low-drift regime) while 2b/disp
    stay mid and 3B outer. Must conserve at least as well as the
    mid-rung split on the same protocol, with all terms present."""
    sys_, pos = fixtures.load_system('water3')
    pot = MBPol(sys_, MBPolConfig(nonbonded_method='NoCutoff', cutoff=0.9,
                                  scf_method='aspc', aspc_k=2))
    sim = Simulation(pot, SimulationConfig(
        dt=0.0008, temperature=None, respa_inner=2, respa_mid=2,
        respa_polarization_rung='inner'), seed=1)
    sim.set_positions(pos)
    sim.set_velocities_to_temperature(50.0)
    m0 = sim.step(5)
    e0 = m0['total_energy'][-1]
    m = sim.step(60, report_interval=20)
    drift = np.max(np.abs(m['total_energy'] - e0))
    assert np.isfinite(m['total_energy']).all()
    assert drift < 0.1, (drift, m['total_energy'], e0)
    # the split potentials must cover every term exactly once
    _, pot_mid, pot_slow, _, pot_fast = sim._respa_split3()
    assert pot_fast is not None
    covered = (set(pot_fast.config.terms) | set(pot_mid.config.terms)
               | set(pot_slow.config.terms))
    assert covered == set(pot.config.terms)
    assert 'electrostatics' not in pot_mid.config.terms


def test_respa3_carried_fast_forces_skip_boundary_reeval():
    """With `f_fast` supplied, respa3_velocity_verlet_step must NOT
    re-evaluate the fast rung at the step boundary: the re-evaluation is
    what injected the per-outer-step force discontinuity when the fast
    rung is stateful (ASPC predictor vs previous corrected dipoles), and
    with a carry every ef_fast call must be an inner-loop evaluation at
    a fresh position (exactly n_mid*n_inner calls). For a stateless
    ef_fast the carried step must also be bitwise identical to the
    re-evaluating one."""
    sys_, pos = fixtures.load_system('water3')
    pos = jnp.asarray(pos)
    calls = [0]

    def ef_fast(p):
        calls[0] += 1
        return jnp.sum(p * p), -2.0 * p

    def ef_mid(p):
        return jnp.sum(p[:, 0]), 0.1 * jnp.ones_like(p)

    def ef_slow(p):
        return jnp.sum(p[:, 1]), -0.05 * jnp.ones_like(p)

    key = jax.random.PRNGKey(0)
    v0 = I.maxwell_boltzmann_velocities(sys_, 50.0, key, pos.dtype)
    _, f_fast0 = ef_fast(pos)
    _, f_mid0 = ef_mid(pos)
    _, f_slow0 = ef_slow(pos)
    state = I.MDState(positions=pos, velocities=v0, forces=f_fast0,
                      potential_energy=jnp.zeros((), pos.dtype),
                      box=jnp.zeros(3, pos.dtype),
                      step=jnp.zeros((), jnp.int32), rng=key)
    n_mid, n_inner = 3, 2

    calls[0] = 0
    s_a, _, _, ff_a = I.respa3_velocity_verlet_step(
        sys_, ef_fast, ef_mid, ef_slow, state, f_mid0, f_slow0,
        0.0012, n_mid, n_inner, unroll_inner=True, f_fast=f_fast0)
    assert calls[0] == n_mid * n_inner, calls[0]

    calls[0] = 0
    s_b, _, _, ff_b = I.respa3_velocity_verlet_step(
        sys_, ef_fast, ef_mid, ef_slow, state, f_mid0, f_slow0,
        0.0012, n_mid, n_inner, unroll_inner=True, f_fast=None)
    assert calls[0] == n_mid * n_inner + 1, calls[0]

    np.testing.assert_array_equal(np.asarray(s_a.positions),
                                  np.asarray(s_b.positions))
    np.testing.assert_array_equal(np.asarray(s_a.velocities),
                                  np.asarray(s_b.velocities))
    np.testing.assert_array_equal(np.asarray(ff_a), np.asarray(ff_b))


def test_respa3_inner_rung_keeps_configured_aspc_depth():
    """The RESPA n_corr>=2 auto-deepening applies to the MID-cadence
    closure only; with respa_polarization_rung='inner' the closure runs
    at the base step (the single-step regime) and the potential's
    configured corrector depth must be kept - the extra corrector would
    cost ~33% of every fast-rung evaluation for nothing."""
    sys_, pos = fixtures.load_system('water3')
    for rung, expect in (('inner', 1), ('mid', 2)):
        pot = MBPol(sys_, MBPolConfig(nonbonded_method='NoCutoff',
                                      cutoff=0.9, scf_method='sor'))
        sim = Simulation(pot, SimulationConfig(
            dt=0.0008, temperature=None, respa_inner=2, respa_mid=2,
            respa_polarization_rung=rung), seed=1)
        assert sim.potential.config.scf_method == 'aspc'
        assert sim.potential.config.aspc_n_corr == expect, (
            rung, sim.potential.config.aspc_n_corr)


def test_respa3_rejects_trivial_split():
    import pytest
    sys_, pos = fixtures.load_system('water3')
    pot = MBPol(sys_, MBPolConfig(nonbonded_method='NoCutoff', cutoff=0.9,
                                  terms=('three_body',)))
    sim = Simulation(pot, SimulationConfig(dt=0.0008, respa_mid=2), seed=1)
    sim.set_positions(pos)
    with pytest.raises(ValueError, match='non-trivial'):
        sim.step(1)


def test_app_mts_integrator_end_to_end(tmp_path):
    """app.MTSVerletIntegrator drives the same RESPA machinery (water3
    cluster through the OpenMM-compatible surface)."""
    from mbpol_openmm_plugin_tpu import app
    from mbpol_openmm_plugin_tpu.app import units_compat as unit
    from mbpol_openmm_plugin_tpu.app.pdbfile import (Atom, Topology,
                                                     write_pdb_frame)

    d = fixtures.load('water3')
    atoms = [Atom(i, str(n), str(rn), int(ri)) for i, (n, rn, ri) in
             enumerate(zip(d['names'], d['resnames'], d['resids']))]
    path = tmp_path / 'water3.pdb'
    with open(path, 'w') as fh:
        write_pdb_frame(fh, Topology(atoms), d['positions'])
    pdb = app.PDBFile(str(path))
    ff = app.ForceField(app.mbpol_xml_path())
    system = ff.createSystem(pdb.topology,
                             nonbondedMethod=app.CutoffNonPeriodic,
                             nonbondedCutoff=0.9 * unit.nanometer)
    integ = app.MTSVerletIntegrator(0.4 * unit.femtoseconds, innerSteps=2)
    sim = app.Simulation(pdb.topology, system, integ)
    sim.context.setPositions(pdb.positions)
    sim.context.computeVirtualSites()
    assert sim._core.config.respa_inner == 2
    e0 = float(sim.context.getState(getEnergy=True).getPotentialEnergy()
               .value_in_unit(unit.kilojoule_per_mole))
    sim.step(5)
    e1 = float(sim.context.getState(getEnergy=True).getPotentialEnergy()
               .value_in_unit(unit.kilojoule_per_mole))
    assert np.isfinite(e1) and abs(e1 - e0) < 50.0
