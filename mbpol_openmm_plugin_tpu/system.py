"""System topology and state for the MB-pol framework.

A `System` holds the *static* description (index arrays, types, masses, box
flag) as numpy arrays — these shape the jitted computations and never live on
the accelerator as traced values. Dynamic state (positions, velocities) is a
pytree of jnp arrays.

Atom layout convention (matching the reference force-field layer,
python/mbpol.py:310-323 and the OHHM stride-4 assumption of
MBPolReferenceElectrostaticsForce.cpp:879-884): each water contributes four
sites in order [O, H1, H2, M]; monatomic ions (Cl-) follow as single sites.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np

from mbpol_openmm_plugin_tpu import data as _data

# atom class codes (order of the dispersion C6/d6 tables, mbpol.xml:45-50)
CLASS_O, CLASS_H, CLASS_M, CLASS_CL = 0, 1, 2, 3
# CODATA deuterium atomic mass (amu); the PES is mass-independent,
# so isotopologues differ only here
MASS_D = 2.01410177812


@dataclasses.dataclass(frozen=True)
class System:
    """Static topology of a (water + optional Cl-) system."""
    n_waters: int
    n_ions: int
    atom_class: np.ndarray          # [natoms] int32, CLASS_*
    mol_index: np.ndarray           # [natoms] int32, molecule id per atom
    masses: np.ndarray              # [natoms] float64 (amu); M sites have 0
    o_index: np.ndarray             # [n_waters] int32
    h1_index: np.ndarray
    h2_index: np.ndarray
    m_index: np.ndarray
    ion_index: np.ndarray           # [n_ions] int32
    box: Optional[np.ndarray]       # [3] nm box lengths (orthorhombic) or None

    @property
    def n_atoms(self):
        return len(self.atom_class)

    @property
    def periodic(self):
        return self.box is not None

    def with_box(self, box):
        box = None if box is None else np.asarray(box, np.float64)
        return dataclasses.replace(self, box=box)

    # ------------------------------------------------------------------
    @classmethod
    def waters(cls, n_waters, n_ions=0, box=None, isotope='H2O'):
        """Standard layout: n_waters x [O,H1,H2,M] then n_ions x [Cl].

        isotope: 'H2O' (default), 'D2O' (both hydrogens deuterated) or
        'HDO' (H1 -> D). The MB-pol PES is a Born-Oppenheimer surface -
        mass-independent - so isotopologues differ ONLY in the masses
        (CODATA deuterium atomic mass 2.01410177812 amu); the isotope
        effect enters through the dynamics, classically via time scales
        and quantum-mechanically via the ring-polymer ZPE (md/rpmd.py).
        """
        ff = _data.load('forcefield')
        m_h1 = m_h2 = float(ff['mass_H'])
        if isotope == 'D2O':
            m_h1 = m_h2 = MASS_D
        elif isotope == 'HDO':
            m_h1 = MASS_D
        elif isotope != 'H2O':
            raise ValueError(f'unknown isotope {isotope!r}')
        base = 4 * np.arange(n_waters, dtype=np.int32)
        atom_class = np.concatenate([
            np.tile([CLASS_O, CLASS_H, CLASS_H, CLASS_M], n_waters),
            np.full(n_ions, CLASS_CL)]).astype(np.int32)
        mol_index = np.concatenate([
            np.repeat(np.arange(n_waters), 4),
            n_waters + np.arange(n_ions)]).astype(np.int32)
        masses = np.concatenate([
            np.tile([ff['mass_O'], m_h1, m_h2, ff['mass_M']], n_waters),
            np.full(n_ions, ff['mass_Cl'])]).astype(np.float64)
        return cls(
            n_waters=n_waters, n_ions=n_ions,
            atom_class=atom_class, mol_index=mol_index, masses=masses,
            o_index=base, h1_index=base + 1, h2_index=base + 2, m_index=base + 3,
            ion_index=(4 * n_waters + np.arange(n_ions, dtype=np.int32)),
            box=None if box is None else np.asarray(box, np.float64))

    @classmethod
    def from_atom_names(cls, names, resnames, box=None, isotope='H2O'):
        """Build from PDB-style atom/residue name arrays (order O,H1,H2,M per
        HOH residue, optional Cl residues). isotope: see `waters`."""
        names = [str(n) for n in names]
        resnames = [str(r) for r in resnames]
        n_waters = sum(1 for n, r in zip(names, resnames) if r == 'HOH' and n == 'O')
        n_ions = sum(1 for r in resnames if r in ('Cl', 'CL', 'CL-'))
        expected = [n for _ in range(n_waters) for n in ('O', 'H1', 'H2', 'M')]
        got = [n for n, r in zip(names, resnames) if r == 'HOH']
        if got != expected:
            raise ValueError('unsupported atom ordering; expected O,H1,H2,M per water')
        return cls.waters(n_waters, n_ions, box=box, isotope=isotope)


def _contiguous_waters(system: System):
    """True when the layout is the standard stride-4 OHHM block (then all
    per-molecule restructuring is a reshape - no gathers/scatters, whose
    transposes are scatter-adds)."""
    n = system.n_waters
    return bool(np.array_equal(system.o_index, 4 * np.arange(n)))


def compute_virtual_sites(system: System, positions):
    """Place each water's M site: average3 virtual site with weights
    (w1, w2, w3) over (O, H1, H2) (mbpol.xml:14). Differentiable."""
    ff = _data.load('forcefield')
    w1, w2, w3 = ff['vsite_weights']
    if _contiguous_waters(system) and system.n_ions == 0:
        p4 = positions.reshape(system.n_waters, 4, 3)
        m = w1 * p4[:, 0] + w2 * p4[:, 1] + w3 * p4[:, 2]
        return jnp.concatenate([p4[:, :3], m[:, None]], axis=1).reshape(-1, 3)
    m_pos = (w1 * positions[system.o_index] +
             w2 * positions[system.h1_index] +
             w3 * positions[system.h2_index])
    return positions.at[system.m_index].set(m_pos)


def water_positions(system: System, positions):
    """[n_waters, 3, 3] (O,H1,H2) position blocks (reshape on the standard
    layout; gather otherwise)."""
    if _contiguous_waters(system):
        return positions[:4 * system.n_waters].reshape(system.n_waters, 4, 3)[:, :3]
    idx = np.stack([system.o_index, system.h1_index, system.h2_index], axis=1)
    return positions[idx]


def make_molecules_whole(system: System, positions, box=None):
    """Image each water's hydrogens next to its oxygen (reference convention:
    imageParticles w.r.t. the molecule's O, MBPolReferenceTwoBodyForce.cpp:66-76).
    Required for PDB inputs with wrapped molecules; a no-op for whole ones."""
    if not system.periodic:
        return positions
    box = jnp.asarray(system.box if box is None else box, positions.dtype)
    if _contiguous_waters(system) and system.n_ions == 0:
        p4 = positions.reshape(system.n_waters, 4, 3)
        o = p4[:, 0:1]
        rest = p4[:, 1:] + jnp.floor((o - p4[:, 1:]) / box + 0.5) * box
        return jnp.concatenate([o, rest], axis=1).reshape(-1, 3)
    o = positions[system.o_index]

    def image(p):
        return p + jnp.floor((o - p) / box + 0.5) * box

    positions = positions.at[system.h1_index].set(image(positions[system.h1_index]))
    positions = positions.at[system.h2_index].set(image(positions[system.h2_index]))
    return positions


def minimum_image(delta, box):
    """Minimum-image displacement for an orthorhombic box.

    Matches the reference convention delta -= floor(delta/box + 0.5) * box
    (MBPolReferenceElectrostaticsForce.cpp:1234-1239)."""
    if box is None:
        return delta
    b = jnp.asarray(box, delta.dtype)
    return delta - jnp.floor(delta / b + 0.5) * b
