"""TT6-damped C6 dispersion.

In the reference this term is not native code: it is an OpenMM
CustomNonbondedForce built by the <Script> embedded in python/mbpol.xml
(:37-108), with energy -C6*tt6/r^6 where tt6 is the order-6 Tang-Toennies
damping function

    tt6(x) = 1 - exp(-x) * sum_{k=0..6} x^k / k!,   x = d6 * r

with per-class-pair (O,H,M,Cl) C6/d6 tables and exclusions for intra-residue
pairs and any pair involving an M site (mbpol.xml:100-104). Here it is a
first-class term: dense masked pair evaluation (the M/M-pair and Cl-Cl
entries of the tables are zero, which — together with the explicit same-
molecule mask — reproduces the exclusion rules exactly).
"""
import jax.numpy as jnp
import numpy as np

from mbpol_openmm_plugin_tpu import data as _data
from mbpol_openmm_plugin_tpu.system import (System, minimum_image,
                                            water_positions)

# Site-vs-oxygen offset bound for molecule-pair lists (canonical
# definition; models/pme_sparse.py imports it so both consumers of the
# shared list use the same radius): a water's real sites sit within
# ~0.125 nm of its O even for thermally stretched OH bonds, so every site
# pair under the cutoff lives in a molecule pair with O-O distance under
# cutoff + PAIR_MARGIN.
PAIR_MARGIN = 0.25

def tt6(x):
    """Order-6 Tang-Toennies damping, numerically safe at x=0.
    Horner form of sum_{k=0..6} x^k/k! (one fused pass, no extra axis)."""
    s = 1.0 / 720.0
    for k in (120.0, 24.0, 6.0, 2.0, 1.0, 1.0):
        s = s * x + 1.0 / k
    return 1.0 - jnp.exp(-x) * s


def switch_factor(r2, cutoff, width):
    """OpenMM CustomNonbondedForce switching function S(x) = 1 - 10x^3 +
    15x^4 - 6x^5 over [cutoff - width, cutoff] (C2-continuous to 0).

    width = 0 reproduces the reference's PLAIN truncation - which makes
    the dispersion force field discontinuous at the cutoff sphere: every
    pair crossing r = 0.9 nm does non-conservative work ~C6/r^6, the
    bulk of the no-electrostatics NVE drift at water256
    (tools/nve_drift.py --terms). The switch keeps energy AND
    forces consistent for free because the dispersion forces come from
    autodiff of this energy. OpenMM exposes exactly this option on
    CustomNonbondedForce (setUseSwitchingFunction); the reference script
    simply leaves it off."""
    x = (jnp.sqrt(r2) - (cutoff - width)) / width
    x = jnp.clip(x, 0.0, 1.0)
    return 1.0 - x * x * x * (10.0 + x * (-15.0 + 6.0 * x))


def dispersion_energy(system: System, positions, cutoff=None, box=None,
                      mesh=None, switch_width=0.0):
    """Total dispersion energy in kJ/mol.

    Args:
      system: topology (provides atom classes, molecule ids, box).
      positions: [natoms, 3] nm (M sites already placed; their C6 is 0).
      cutoff: optional truncation distance in nm (plain truncation, like
        OpenMM CustomNonbondedForce without a switching function).
      mesh: optional device mesh - the pair matrix's ROW dimension is
        constrained to the 'dp' axis, so each device evaluates a row slab
        of the [N,N] pair grid and the total reduces with one psum.

    The per-pair C6/d6 tables are expanded on-device from the [N] class
    vector via one-hot matmuls ([N,4] @ [4,4] @ [4,N]) - avoiding both
    per-element gathers and [N,N] literals in the HLO.
    """
    ff = _data.load('forcefield')
    dtype = positions.dtype
    onehot = jnp.asarray(np.eye(4)[np.asarray(system.atom_class)], dtype)  # [N,4]
    row_oh = onehot
    mol = jnp.asarray(system.mol_index)
    rows = positions
    if mesh is not None:
        from mbpol_openmm_plugin_tpu.parallel import mesh as M
        rows = M.constrain(rows, M.row_sharded(mesh))
        row_oh = M.constrain(row_oh, M.row_sharded(mesh))
    C6 = row_oh @ jnp.asarray(ff['C6'], dtype) @ onehot.T
    d6 = row_oh @ jnp.asarray(ff['d6'], dtype) @ onehot.T

    delta = positions[None, :, :] - rows[:, None, :]
    delta = minimum_image(delta, (system.box if box is None else box)
                          if system.periodic else None)
    r2 = jnp.sum(delta * delta, axis=-1)

    mask = mol[:, None] != mol[None, :]
    if cutoff is not None:
        mask = mask & (r2 < cutoff * cutoff)

    r2 = jnp.where(mask, r2, 1.0)           # avoid 0/0 on the diagonal
    r = jnp.sqrt(r2)
    e_pair = -C6 * tt6(d6 * r) / (r2 * r2 * r2)
    if cutoff is not None and switch_width > 0.0:
        e_pair = e_pair * switch_factor(r2, cutoff, switch_width)
    return 0.5 * jnp.sum(jnp.where(mask, e_pair, 0.0))


def dispersion_energy_pairs(system: System, positions, mol_pairs, pair_mask,
                            cutoff, box=None, mesh=None, switch_width=0.0):
    """O(N)-memory dispersion over a padded molecule-pair list (water-only).

    Same physics as `dispersion_energy` (TT6-damped C6 with plain
    truncation at `cutoff` on each SITE pair), evaluated per listed water
    pair over the 3x3 real-site block - the M row of the C6/d6 tables is
    zero, so skipping M sites is exact. Exact for any list containing
    every water pair with O-O distance < cutoff + PAIR_MARGIN (any
    superset is fine: out-of-cutoff site pairs mask to zero). This is the
    large-N path: the dense pair grid materializes [N,N] tensors, the
    next memory wall after block-sparse electrostatics and site-chunked
    PME grids.

    Args:
      mol_pairs: [P, 2] int water indices, each unordered pair listed once
        (ops/neighbors.pair_list convention); padded entries masked by
        pair_mask [P] (their indices must stay in range, as pair_list
        guarantees).
      mesh: optional device mesh - the pair batch rows shard over 'dp'.
    """
    if system.n_ions:
        raise ValueError('dispersion_energy_pairs supports water-only '
                         'systems (ions take the dense path)')
    ff = _data.load('forcefield')
    dtype = positions.dtype
    cls = np.array([0, 1, 1])                      # O, H, H class codes
    C6b = jnp.asarray(np.asarray(ff['C6'])[np.ix_(cls, cls)], dtype)
    d6b = jnp.asarray(np.asarray(ff['d6'])[np.ix_(cls, cls)], dtype)

    if mesh is not None:
        from mbpol_openmm_plugin_tpu.parallel import mesh as M
        rs = M.row_sharded(mesh)
        mol_pairs = M.constrain(mol_pairs, rs)
        pair_mask = M.constrain(pair_mask, rs)

    w = water_positions(system, positions)          # [n_waters, 3, 3]
    pa = w[mol_pairs[:, 0]]                         # [P, 3, 3]
    pb = w[mol_pairs[:, 1]]
    delta = pb[:, None, :, :] - pa[:, :, None, :]   # [P, 3(a), 3(b), 3]
    delta = minimum_image(delta, (system.box if box is None else box)
                          if system.periodic else None)
    r2 = jnp.sum(delta * delta, axis=-1)            # [P, 3, 3]

    mask = pair_mask[:, None, None] & (r2 < cutoff * cutoff)
    r2 = jnp.where(mask, r2, 1.0)
    r = jnp.sqrt(r2)
    e_pair = -C6b[None] * tt6(d6b[None] * r) / (r2 * r2 * r2)
    if switch_width > 0.0:
        e_pair = e_pair * switch_factor(r2, cutoff, switch_width)
    # each unordered molecule pair appears once - no double-count factor
    return jnp.sum(jnp.where(mask, e_pair, 0.0))
