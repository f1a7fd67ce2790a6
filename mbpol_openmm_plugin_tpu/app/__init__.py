"""OpenMM-app-compatible layer.

The reference is consumed through OpenMM's application layer
(app.PDBFile / app.ForceField / app.Simulation / reporters; see
python/water14.py, python/example_nvt_nve.py, python/bin/mbpol_builder).
This package provides the same surface on top of this framework so those
driver scripts port by swapping imports:

    from mbpol_openmm_plugin_tpu import app
    from mbpol_openmm_plugin_tpu.app import unit

    pdb = app.PDBFile("water14_cluster.pdb")
    ff = app.ForceField(app.mbpol_xml_path())
    system = ff.createSystem(pdb.topology, nonbondedMethod=app.CutoffNonPeriodic)
    sim = app.Simulation(pdb.topology, system, app.VerletIntegrator(0.2*unit.femtoseconds))
    sim.context.setPositions(pdb.positions)
    sim.context.computeVirtualSites()
    state = sim.context.getState(getEnergy=True, getForces=True)
"""
from mbpol_openmm_plugin_tpu.app import units_compat as unit  # noqa: F401
from mbpol_openmm_plugin_tpu.app.forcefield import (ForceField, NoCutoff, PME,  # noqa: F401
                                                    CutoffNonPeriodic, CutoffPeriodic,
                                                    mbpol_xml_path)
from mbpol_openmm_plugin_tpu.app.netcdf import NetCDFReporter  # noqa: F401
from mbpol_openmm_plugin_tpu.app.pdbfile import PDBFile, PDBReporter  # noqa: F401
from mbpol_openmm_plugin_tpu.app.simulation import (AndersenThermostat,  # noqa: F401
                                                    LangevinIntegrator,
                                                    LocalEnergyMinimizer,
                                                    MonteCarloBarostat,
                                                    MTSLangevinIntegrator,
                                                    MTSVerletIntegrator,
                                                    PIMDCentroidWriter, Simulation,
                                                    TrajectoryFrameWriter,
                                                    StateDataReporter, VerletIntegrator)
