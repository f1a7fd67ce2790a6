"""App-layer tests: the reference's python test patterns run on our
OpenMM-compatible surface (PDBFile/ForceField/Simulation/force isolation),
mirroring python/tests/TestReferenceMBPolTwoBodyForce.py:28-39 and
TestReferenceMBPol14WaterTest.py."""
import os

import numpy as np
import pytest

import fixtures
from mbpol_openmm_plugin_tpu import app
from mbpol_openmm_plugin_tpu.app import unit
from mbpol_openmm_plugin_tpu.app.pdbfile import write_pdb_frame


@pytest.fixture
def pdb_dir(tmp_path):
    """Regenerate PDB files from the extracted fixtures with our writer."""
    from mbpol_openmm_plugin_tpu.app.pdbfile import Atom, Topology
    paths = {}
    for name in ['water2', 'water3', 'water14', 'water_and_ion']:
        d = fixtures.load(name)
        atoms = [Atom(i, str(n), str(rn), int(ri)) for i, (n, rn, ri) in
                 enumerate(zip(d['names'], d['resnames'], d['resids']))]
        topo = Topology(atoms)
        p = tmp_path / f'{name}.pdb'
        with open(p, 'w') as fh:
            write_pdb_frame(fh, topo, d['positions'])
        paths[name] = str(p)
    return paths


def _simulation(pdb_path, remove=(), nonbondedMethod=app.CutoffNonPeriodic,
                cutoff=1.0, box=None):
    pdb = app.PDBFile(pdb_path)
    if box is not None:
        pdb.topology.setUnitCellDimensions(box)
    ff = app.ForceField(app.mbpol_xml_path())
    system = ff.createSystem(pdb.topology, nonbondedMethod=nonbondedMethod,
                             nonbondedCutoff=cutoff * unit.nanometer)
    for i in remove:
        system.removeForce(i)
    integrator = app.VerletIntegrator(0.02 * unit.femtoseconds)
    sim = app.Simulation(pdb.topology, system, integrator)
    sim.context.setPositions(pdb.positions)
    sim.context.computeVirtualSites()
    return sim


def _energy_kcal(sim):
    state = sim.context.getState(getEnergy=True, getForces=True)
    return state.getPotentialEnergy().value_in_unit(unit.kilocalorie_per_mole)


def test_force_isolation_two_body(pdb_dir):
    # force order: elec, one, two, three, CMMotionRemover, CustomDispersion
    sim = _simulation(pdb_dir['water2'], remove=[0, 0, 1, 1, 1])
    e = _energy_kcal(sim)
    assert abs(e - 6.14207815) < 0.01, e


def test_force_isolation_dispersion(pdb_dir):
    sim = _simulation(pdb_dir['water3'], remove=[0, 0, 0, 0, 0])
    e = _energy_kcal(sim)
    assert abs(e - (-6.84471477)) < 0.01, e


def test_water14_total_pme(pdb_dir):
    sim = _simulation(pdb_dir['water14'], nonbondedMethod=app.PME, cutoff=0.9,
                      box=[1.8, 1.8, 1.8])
    e = _energy_kcal(sim)
    assert abs(e - (-60.0)) < 1.0, e


def test_water3_total_cluster_app(pdb_dir):
    sim = _simulation(pdb_dir['water3'], cutoff=0.9)
    e = _energy_kcal(sim)
    assert abs(e - (-8.78893485)) < 0.1, e


def test_md_with_reporters(pdb_dir, tmp_path):
    sim = _simulation(pdb_dir['water3'], cutoff=0.9)
    log = str(tmp_path / 'run.log')
    traj = str(tmp_path / 'traj.pdb')
    sim.reporters.append(app.StateDataReporter(log, 5, step=True, potentialEnergy=True,
                                               kineticEnergy=True, temperature=True,
                                               speed=True, totalSteps=10))
    sim.reporters.append(app.PDBReporter(traj, 5))
    sim.context.setVelocitiesToTemperature(100 * unit.kelvin)
    sim.step(10)
    assert os.path.exists(log) and len(open(log).readlines()) >= 3
    assert 'MODEL' in open(traj).read()


def test_reporters_fire_after_offgrid_equilibration(pdb_dir, tmp_path):
    """Builder-generated scripts equilibrate (1 step) before attaching the
    production reporters, leaving the global step counter off the report
    grid. Reporters with interval k must still fire at absolute steps
    k, 2k, ... (OpenMM describeNextReport countdown semantics) - a naive
    `chunk = min(intervals)` walk visits only odd steps and never reports
    (regression: 200-step builder run wrote zero frames)."""
    sim = _simulation(pdb_dir['water3'], cutoff=0.9)
    sim.context.setVelocitiesToTemperature(100 * unit.kelvin)
    sim.step(1)                                  # equilibration: step == 1
    log = str(tmp_path / 'run.log')
    nc_path = str(tmp_path / 'run.nc')
    sim.reporters.append(app.StateDataReporter(log, 2, step=True,
                                               potentialEnergy=True))
    sim.reporters.append(app.NetCDFReporter(nc_path, 2, crds=True, vels=True))
    sim.step(9)                                  # -> global step 10
    steps = [int(l.split(',')[0]) for l in open(log).readlines()[1:]]
    assert steps == [2, 4, 6, 8, 10], steps
    from scipy.io import netcdf_file
    nc = netcdf_file(nc_path, mmap=False)
    assert nc.variables['coordinates'].shape[0] == 5
    assert nc.variables['velocities'].shape[0] == 5


def test_statedata_pressure_column(pdb_dir, tmp_path):
    """pressure=True (superset of OpenMM's StateDataReporter) writes a
    finite instantaneous virial pressure for a periodic (PME) system."""
    sim = _simulation(pdb_dir['water3'], nonbondedMethod=app.PME,
                      cutoff=0.8, box=(1.8, 1.8, 1.8))
    sim.context.setVelocitiesToTemperature(300 * unit.kelvin)
    log = str(tmp_path / 'p.log')
    sim.reporters.append(app.StateDataReporter(log, 2, step=True,
                                               pressure=True))
    sim.step(4)
    lines = open(log).readlines()
    assert 'Pressure (bar)' in lines[0]
    p = [float(l.split(',')[1]) for l in lines[1:]]
    assert len(p) == 2 and all(np.isfinite(p)), p


def test_pdb_roundtrip(pdb_dir):
    pdb = app.PDBFile(pdb_dir['water3'])
    ref = fixtures.load('water3')
    np.testing.assert_allclose(np.asarray(pdb.positions.to_internal()),
                               ref['positions'], atol=1e-4)


def test_xml_variant_no_dispersion_no_redistribution(pdb_dir, tmp_path):
    """The reference ships an XML variant that disables the dispersion script
    and charge redistribution (mbpol_no_custom_dispersion_no_charge_
    redistribution.xml); our ForceField must honor both switches."""
    variant = tmp_path / 'variant.xml'
    base = open(app.mbpol_xml_path()).read()
    import re
    # drop the dispersion script and add the redistribution toggle
    base = re.sub(r'<Script>.*?</Script>', '', base, flags=re.S)
    base = base.replace(
        '</MBPolElectrostaticsForce>',
        '    <setIncludeChargeRedistribution chargeRedistribution="False"/>\n'
        '    </MBPolElectrostaticsForce>')
    variant.write_text(base)
    ff = app.ForceField(str(variant))
    assert not ff.has_dispersion
    assert not ff.include_charge_redistribution
    pdb = app.PDBFile(pdb_dir['water3'])
    system = ff.createSystem(pdb.topology, nonbondedMethod=app.CutoffNonPeriodic,
                             nonbondedCutoff=0.9 * unit.nanometer)
    # force order without dispersion: elec, one, two, three, CMMotionRemover
    assert system.getNumForces() == 5
    sim = app.Simulation(pdb.topology, system, app.VerletIntegrator(0.02 * unit.femtoseconds))
    sim.context.setPositions(pdb.positions)
    e = sim.context.getState(getEnergy=True).getPotentialEnergy()
    v = e.value_in_unit(unit.kilocalorie_per_mole)
    assert np.isfinite(v)
    assert not sim.potential.config.include_charge_redistribution


def test_cutoff_periodic_electrostatics_rejected(pdb_dir):
    """Reference parity: the electrostatics generator has no CutoffPeriodic
    entry in its methodMap and raises (reference python/mbpol.py:291-296);
    silently falling back to non-imaged cluster electrostatics on a periodic
    box would mix imaging conventions across terms."""
    pdb = app.PDBFile(pdb_dir['water3'])
    pdb.topology.setUnitCellDimensions([1.9, 1.9, 1.9])
    ff = app.ForceField(app.mbpol_xml_path())
    with pytest.raises(ValueError, match='CutoffPeriodic'):
        ff.createSystem(pdb.topology, nonbondedMethod=app.CutoffPeriodic,
                        nonbondedCutoff=0.9 * unit.nanometer)


def test_shipped_xml_variants(pdb_dir):
    """The ported variant parameter files ship in the package (reference
    ships mbpol_no_custom_dispersion_no_charge_redistribution.xml and
    customdispersion.xml under python/)."""
    d = os.path.dirname(app.mbpol_xml_path())
    ff = app.ForceField(os.path.join(
        d, 'mbpol_no_custom_dispersion_no_charge_redistribution.xml'))
    assert ff.has_electrostatics and ff.has_one_body
    assert not ff.has_dispersion
    assert not ff.include_charge_redistribution
    pdb = app.PDBFile(pdb_dir['water3'])
    system = ff.createSystem(pdb.topology, nonbondedMethod=app.CutoffNonPeriodic,
                             nonbondedCutoff=0.9 * unit.nanometer)
    assert system.getNumForces() == 5       # no dispersion force
    sim = app.Simulation(pdb.topology, system,
                         app.VerletIntegrator(0.02 * unit.femtoseconds))
    sim.context.setPositions(pdb.positions)
    e = sim.context.getState(getEnergy=True).getPotentialEnergy()
    assert np.isfinite(e.value_in_unit(unit.kilocalorie_per_mole))
    assert not sim.potential.config.include_charge_redistribution


def test_shipped_customdispersion_xml(pdb_dir):
    """Dispersion-only force field reproduces the dispersion golden
    (python/tests/TestCustomDispersion.py:14, water3 -6.84471477 kcal/mol)."""
    d = os.path.dirname(app.mbpol_xml_path())
    ff = app.ForceField(os.path.join(d, 'customdispersion.xml'))
    assert ff.has_dispersion and not ff.has_electrostatics
    pdb = app.PDBFile(pdb_dir['water3'])
    system = ff.createSystem(pdb.topology, nonbondedMethod=app.CutoffNonPeriodic,
                             nonbondedCutoff=1.0 * unit.nanometer)
    sim = app.Simulation(pdb.topology, system,
                         app.VerletIntegrator(0.02 * unit.femtoseconds))
    sim.context.setPositions(pdb.positions)
    e = sim.context.getState(getEnergy=True).getPotentialEnergy()
    assert abs(e.value_in_unit(unit.kilocalorie_per_mole) - (-6.84471477)) < 0.01


def test_old_dialect_per_residue_thole(tmp_path):
    """The reference's variant file carries the Thole parameters as five
    per-Residue attributes (older dialect); the parser must map them to
    [TCC, TCD, TDD, TDDOH, TDDHH]."""
    xml = """<ForceField>
    <MBPolElectrostaticsForce>
        <Residue name="HOH" class1="O" class2="H" class3="H" thole-charge-charge="0.4" thole-charge-dipole="0.4" thole-dipole-dipole-intermolecules="0.055" thole-dipole-dipole-OH="0.626" thole-dipole-dipole-HH="0.055"/>
        <Atom type="MBPol-O" charge="-5.1966000e-01" damping-factor="0.00131" polarizability="0.00131" />
        <setIncludeChargeRedistribution chargeRedistribution="False"/>
    </MBPolElectrostaticsForce>
</ForceField>"""
    p = tmp_path / 'old_dialect.xml'
    p.write_text(xml)
    ff = app.ForceField(str(p))
    np.testing.assert_allclose(ff.thole, [0.4, 0.4, 0.055, 0.626, 0.055])
    assert not ff.include_charge_redistribution


def test_create_system_hydrogen_mass_repartitioning(pdb_dir):
    """OpenMM createSystem(hydrogenMass=...) semantics: H set to the given
    mass, the difference subtracted from the bonded O (molecular mass
    conserved)."""
    pdb = app.PDBFile(pdb_dir['water3'])
    ff = app.ForceField(app.mbpol_xml_path())
    spec = ff.createSystem(pdb.topology, hydrogenMass=3.024 * unit.amu)
    m = np.asarray(spec.system.masses)
    h = np.concatenate([spec.system.h1_index, spec.system.h2_index])
    np.testing.assert_allclose(m[h], 3.024)
    # molecular mass conserved vs the unrepartitioned system
    spec0 = ff.createSystem(pdb.topology)
    np.testing.assert_allclose(m[spec.system.o_index] + 2 * 3.024,
                               np.asarray(spec0.system.masses)[spec0.system.o_index]
                               + 2 * np.asarray(spec0.system.masses)[spec0.system.h1_index])
    with pytest.raises(ValueError):
        ff.createSystem(pdb.topology, hydrogenMass=30.0 * unit.amu)


def test_create_system_isotope(pdb_dir):
    """createSystem(isotope='D2O'|'HDO'): true isotopologue masses (the
    total molecular mass changes; System.waters(isotope=...) semantics),
    mutually exclusive with hydrogenMass (which conserves it)."""
    from mbpol_openmm_plugin_tpu.system import MASS_D
    pdb = app.PDBFile(pdb_dir['water3'])
    ff = app.ForceField(app.mbpol_xml_path())
    spec = ff.createSystem(pdb.topology, isotope='D2O')
    m = np.asarray(spec.system.masses)
    np.testing.assert_allclose(m[spec.system.h1_index], MASS_D)
    np.testing.assert_allclose(m[spec.system.h2_index], MASS_D)
    spec0 = ff.createSystem(pdb.topology)
    np.testing.assert_array_equal(m[spec.system.o_index],
                                  np.asarray(spec0.system.masses)[spec0.system.o_index])
    hdo = ff.createSystem(pdb.topology, isotope='HDO')
    mh = np.asarray(hdo.system.masses)
    np.testing.assert_allclose(mh[hdo.system.h1_index], MASS_D)
    assert np.all(mh[hdo.system.h2_index] < 1.1)
    with pytest.raises(ValueError):
        ff.createSystem(pdb.topology, isotope='T2O')
    with pytest.raises(ValueError):
        ff.createSystem(pdb.topology, isotope='D2O',
                        hydrogenMass=2.0 * unit.amu)


def test_pdb_from_stream_equals_file(pdb_dir):
    """PDBFile reads an open text stream like a path (OpenMM's PDBFile
    accepts both), so a PDB written in memory needs no file."""
    import io
    path = pdb_dir['water14']
    with open(path) as fh:
        text = fh.read()
    a = app.PDBFile(path)
    b = app.PDBFile(io.StringIO(text))
    np.testing.assert_array_equal(np.asarray(b._positions_nm),
                                  np.asarray(a._positions_nm))
    assert b.topology.atom_names == a.topology.atom_names
