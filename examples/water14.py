#!/usr/bin/env python
"""water14 cluster example: single-point energy/forces, minimization, NVE.

Port of the reference driver python/water14.py to this framework's app
layer (imports swapped, OpenMM API shape preserved).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from mbpol_openmm_plugin_tpu import app
from mbpol_openmm_plugin_tpu.app import unit

here = os.path.dirname(os.path.abspath(__file__))
if not os.path.exists(os.path.join(here, 'water14_cluster.pdb')):
    os.system(f'{sys.executable} {here}/make_inputs.py')

pdb = app.PDBFile(os.path.join(here, 'water14_cluster.pdb'))
forcefield = app.ForceField(app.mbpol_xml_path())

system = forcefield.createSystem(pdb.topology, nonbondedMethod=app.CutoffNonPeriodic,
                                 nonbondedCutoff=1e3 * unit.nanometer)
integrator = app.VerletIntegrator(0.2 * unit.femtoseconds)

simulation = app.Simulation(pdb.topology, system, integrator)
simulation.context.setPositions(pdb.positions)
simulation.context.computeVirtualSites()

state = simulation.context.getState(getForces=True, getEnergy=True)
print('Potential energy:',
      state.getPotentialEnergy().value_in_unit(unit.kilocalorie_per_mole), 'kcal/mol')

kcal_a = unit.kilocalorie_per_mole / unit.angstrom
for f in state.getForces():
    print(f.value_in_unit(kcal_a))

print('Minimizing...')
simulation.minimizeEnergy(maxIterations=100)
state = simulation.context.getState(getEnergy=True)
print('After minimization:',
      state.getPotentialEnergy().value_in_unit(unit.kilocalorie_per_mole), 'kcal/mol')

print('Short NVE run...')
simulation.context.setVelocitiesToTemperature(300 * unit.kelvin)
simulation.step(100)
state = simulation.context.getState(getEnergy=True)
print('Final PE:', state.getPotentialEnergy().value_in_unit(unit.kilocalorie_per_mole))
