"""Low-level Force API, mirroring the reference's `mbpolplugin` SWIG module.

The reference exposes four Force classes (openmmapi/include/openmm/
MBPol*Force.h) consumed either through the force-field layer or directly
(as the C++/Python tests do). This module reproduces that surface - the
parameter-container semantics plus direct evaluation helpers - on top of
this framework. Example:

    from mbpol_openmm_plugin_tpu import api
    force = api.MBPolElectrostaticsForce()
    for ... : force.addElectrostatics(charge, molecule, atom_type, damping, polarizability)
    force.setTholeParameters([0.4, 0.4, 0.055, 0.626, 0.055])
    e, f = force.computeForceAndEnergy(positions_nm)
"""
from __future__ import annotations

import numpy as np

from mbpol_openmm_plugin_tpu import data as _data

NoCutoff = 0
PME = 1
CutoffPeriodic = 2
CutoffNonPeriodic = 3


class _TripletForce:
    """Shared container for per-molecule [O, H1, H2] index triplets."""

    def __init__(self):
        self._molecules = []
        self._nonbonded_method = NoCutoff
        self._cutoff = 1.0e10
        self._box = None

    def setNonbondedMethod(self, method):
        self._nonbonded_method = method

    def getNonbondedMethod(self):
        return self._nonbonded_method

    def setCutoff(self, cutoff):
        self._cutoff = float(cutoff)

    def getCutoff(self):
        return self._cutoff

    def setPeriodicBox(self, box):
        self._box = np.asarray(box, float)

    def getNumMolecules(self):
        return len(self._molecules)

    def _check_contiguous_ohhm(self):
        """The evaluation path assumes the stride-4 OHHM layout (like the
        reference's electrostatics, cpp:879-884). Map arbitrary index
        triplets onto it."""
        idx = np.asarray(self._molecules, np.int64)
        return idx

    def _gather(self, positions):
        import jax.numpy as jnp
        idx = self._check_contiguous_ohhm()
        pos = jnp.asarray(positions)
        return pos[idx]         # [nmol, 3, 3]


class MBPolOneBodyForce(_TripletForce):
    NonPeriodic, Periodic = 0, 1

    def addOneBody(self, particle_indices):
        self._molecules.append(list(particle_indices))
        return len(self._molecules) - 1

    def getOneBodyParameters(self, index):
        return list(self._molecules[index])

    def setOneBodyParameters(self, index, particle_indices):
        self._molecules[index] = list(particle_indices)

    def computeForceAndEnergy(self, positions):
        """positions [natoms,3] nm -> (energy kJ/mol, forces kJ/mol/nm)."""
        import jax
        import jax.numpy as jnp

        from mbpol_openmm_plugin_tpu.models.one_body import one_body_energy

        def total(p):
            return jnp.sum(one_body_energy(self._gather(p)))

        e, g = jax.value_and_grad(total)(jnp.asarray(positions))
        return float(e), -np.asarray(g)


class MBPolTwoBodyForce(_TripletForce):
    def addParticle(self, particle_indices):
        self._molecules.append(list(particle_indices))
        return len(self._molecules) - 1

    def getParticleParameters(self, index):
        return list(self._molecules[index])

    def computeForceAndEnergy(self, positions):
        import jax
        import jax.numpy as jnp

        from mbpol_openmm_plugin_tpu.models.two_body import (_image_pair,
                                                             two_body_energy_pairs)
        from mbpol_openmm_plugin_tpu.utils import units

        n = len(self._molecules)
        ii, jj = np.triu_indices(n, k=1)

        def total(p):
            w = self._gather(p) * units.NM_TO_ANGSTROM
            pa, pb = w[ii], w[jj]
            if self._nonbonded_method == CutoffPeriodic and self._box is not None:
                pa, pb = _image_pair(pa, pb, jnp.asarray(self._box * 10.0, p.dtype))
            mask = jnp.ones(len(ii), bool)
            return jnp.sum(two_body_energy_pairs(pa, pb, mask)) * units.CAL_TO_JOULE

        e, g = jax.value_and_grad(total)(jnp.asarray(positions))
        return float(e), -np.asarray(g)


class MBPolThreeBodyForce(_TripletForce):
    def addParticle(self, particle_indices):
        self._molecules.append(list(particle_indices))
        return len(self._molecules) - 1

    def getParticleParameters(self, index):
        return list(self._molecules[index])

    def computeForceAndEnergy(self, positions):
        import itertools

        import jax
        import jax.numpy as jnp

        from mbpol_openmm_plugin_tpu.models.three_body import (
            _image_triplet, three_body_energy_triplets)
        from mbpol_openmm_plugin_tpu.utils import units

        n = len(self._molecules)
        trips = np.asarray(list(itertools.combinations(range(n), 3)), np.int64).reshape(-1, 3)

        def total(p):
            w = self._gather(p) * units.NM_TO_ANGSTROM
            pa, pb, pc = w[trips[:, 0]], w[trips[:, 1]], w[trips[:, 2]]
            if self._nonbonded_method == CutoffPeriodic and self._box is not None:
                pa, pb, pc = _image_triplet(pa, pb, pc, jnp.asarray(self._box * 10.0, p.dtype))
            mask = jnp.ones(len(trips), bool)
            return jnp.sum(three_body_energy_triplets(pa, pb, pc, mask)) * units.CAL_TO_JOULE

        e, g = jax.value_and_grad(total)(jnp.asarray(positions))
        return float(e), -np.asarray(g)


class MBPolElectrostaticsForce:
    """Parameter container + direct evaluation (cluster or PME)."""
    NoCutoff, PME = 0, 1

    def __init__(self):
        ff = _data.load('forcefield')
        self._charges = []
        self._mols = []
        self._types = []
        self._dampings = []
        self._polarities = []
        self._method = MBPolElectrostaticsForce.NoCutoff
        self._cutoff = 0.9
        self._alpha = 0.0
        self._grid = [0, 0, 0]
        self._ewald_tol = 1e-4
        self._thole = list(ff['thole'])
        self._include_charge_redistribution = True
        self._max_iter = 200
        self._target_eps = 1e-7
        self._box = None

    # --- reference API surface (MBPolElectrostaticsForce.h) ---
    def addElectrostatics(self, charge, moleculeIndex, atomType, dampingFactor,
                          polarity):
        self._charges.append(charge)
        self._mols.append(moleculeIndex)
        self._types.append(atomType)
        self._dampings.append(dampingFactor)
        self._polarities.append(polarity)
        return len(self._charges) - 1

    def getNumElectrostatics(self):
        return len(self._charges)

    def getElectrostaticsParameters(self, i):
        return (self._charges[i], self._mols[i], self._types[i],
                self._dampings[i], self._polarities[i])

    def setElectrostaticsParameters(self, i, charge, moleculeIndex, atomType,
                                    dampingFactor, polarity):
        self._charges[i] = charge
        self._mols[i] = moleculeIndex
        self._types[i] = atomType
        self._dampings[i] = dampingFactor
        self._polarities[i] = polarity

    def setNonbondedMethod(self, m):
        self._method = m

    def getNonbondedMethod(self):
        return self._method

    def setCutoffDistance(self, c):
        self._cutoff = float(c)

    def getCutoffDistance(self):
        return self._cutoff

    def setAEwald(self, a):
        self._alpha = float(a)

    def getAEwald(self):
        return self._alpha

    def setPmeGridDimensions(self, dims):
        self._grid = list(dims)

    def getPmeGridDimensions(self):
        return list(self._grid)

    def setEwaldErrorTolerance(self, t):
        self._ewald_tol = float(t)

    def getEwaldErrorTolerance(self):
        return self._ewald_tol

    def setTholeParameters(self, thole):
        self._thole = list(thole)

    def getTholeParameters(self):
        return list(self._thole)

    def setIncludeChargeRedistribution(self, flag):
        self._include_charge_redistribution = bool(flag)

    def getIncludeChargeRedistribution(self):
        return self._include_charge_redistribution

    def setMutualInducedMaxIterations(self, n):
        self._max_iter = int(n)

    def getMutualInducedMaxIterations(self):
        return self._max_iter

    def setMutualInducedTargetEpsilon(self, e):
        self._target_eps = float(e)

    def getMutualInducedTargetEpsilon(self):
        return self._target_eps

    def setPeriodicBox(self, box):
        self._box = np.asarray(box, float)

    # --- evaluation ---
    def _params(self):
        from mbpol_openmm_plugin_tpu.models.electrostatics import ElecParams
        n = len(self._charges)
        mols = np.asarray(self._mols, np.int32)
        types = np.asarray(self._types, np.int32)
        kw = dict(
            thole=np.asarray(self._thole), damping=np.asarray(self._dampings),
            polarity=np.asarray(self._polarities), mol_index=mols,
            atom_type=types, charges=np.asarray(self._charges),
            include_charge_redistribution=self._include_charge_redistribution,
            target_epsilon=self._target_eps, max_iterations=self._max_iter)
        if self._include_charge_redistribution:
            # infer OHHM site indices per molecule from types (0=O,1=H,2=M)
            o_idx, h1_idx, h2_idx, m_idx = [], [], [], []
            for mol in range(mols.max() + 1):
                sel = np.nonzero(mols == mol)[0]
                t = types[sel]
                o_idx.append(int(sel[t == 0][0]))
                hs = sel[t == 1]
                h1_idx.append(int(hs[0]))
                h2_idx.append(int(hs[1]))
                m_idx.append(int(sel[t == 2][0]))
            kw.update(o_index=np.asarray(o_idx), h1_index=np.asarray(h1_idx),
                      h2_index=np.asarray(h2_idx), m_index=np.asarray(m_idx))
        return ElecParams(**kw)

    def computeForceAndEnergy(self, positions):
        import jax.numpy as jnp

        from mbpol_openmm_plugin_tpu.models import electrostatics as E
        from mbpol_openmm_plugin_tpu.models import pme as P
        pos = jnp.asarray(positions)
        params = self._params()
        if self._method == MBPolElectrostaticsForce.PME:
            assert self._box is not None, 'setPeriodicBox required for PME'
            alpha, grid = self._alpha, self._grid
            if not alpha or not grid[0]:
                tol = self._ewald_tol
                alpha = float(np.sqrt(-np.log(2 * tol)) / self._cutoff)
                grid = [int(np.ceil(2 * alpha * b / (3 * tol ** 0.2))) for b in self._box]
            setup = P.PmeSetup(alpha=alpha, grid=tuple(grid), cutoff=self._cutoff,
                               box=tuple(self._box))
            e, f, diag = P.pme_electrostatics(params, setup, pos)
        else:
            e, f, diag = E.cluster_electrostatics(params, pos)
        self._last_diag = diag
        return float(e), np.asarray(f)

    def getElectrostaticPotential(self, grid_points, positions):
        import jax.numpy as jnp

        from mbpol_openmm_plugin_tpu.models import electrostatics as E
        return np.asarray(E.electrostatic_potential_on_grid(
            self._params(), jnp.asarray(positions), jnp.asarray(grid_points)))

    def getSystemElectrostaticsMoments(self, masses, positions):
        import jax.numpy as jnp

        from mbpol_openmm_plugin_tpu.models import electrostatics as E
        return np.asarray(E.system_moments(self._params(), jnp.asarray(positions),
                                           np.asarray(masses)))
