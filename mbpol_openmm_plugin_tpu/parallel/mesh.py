"""Device mesh utilities for multi-device evaluation.

The reference has no distributed execution (single-thread CPU / single GPU;
SURVEY 2.6). Beyond-parity design: every term shards
over a 1-D 'dp' mesh axis - the one-body molecule batch, 2b pair batches,
3b triplet batches, the dispersion pair-grid rows, and the dense
electrostatics row dimension; XLA inserts the collectives (psum for
energy/force reductions, all-gathers for the SCF dipole vector). The
mesh is 1-D over jax.devices(): every GPU of a host reaches every other
over NVLink at the same rate, so the layout follows the algorithm alone.
The PME grid pipeline shards its SITE dimension (spline matrices carry a
'dp' constraint: spreading psums per-device partial grids, read-back is
row-parallel); only the grid convolution itself stays replicated - the
[nx,ny,nz] grid is tiny relative to the pair work.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices=None, axis='dp'):
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def replicated(mesh):
    return NamedSharding(mesh, P())


def row_sharded(mesh, axis='dp'):
    return NamedSharding(mesh, P(axis))


def constrain(x, sharding):
    return jax.lax.with_sharding_constraint(x, sharding)


def round_up(n, k):
    return ((n + k - 1) // k) * k
