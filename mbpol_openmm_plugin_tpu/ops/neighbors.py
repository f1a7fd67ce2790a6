"""Jit-able neighbor machinery: padded O-O pair and triplet lists.

Replaces the reference's per-call voxel-hash lists (OpenMM NeighborList for
pairs, ReferenceThreeNeighborList for triplets) with fixed-capacity padded
index lists built from masked distance matrices - static shapes, no host
sync, overflow surfaced as a flag (cf. the CUDA platform's maxNeighborPairs
re-try logic, CudaMBPolKernels.cpp:1787).

Triplet semantics: MB-pol's 3-body switch s = s_ab s_ac + s_ab s_bc + s_ac s_bc
is nonzero iff at least two of the three O-O distances are below the cutoff,
so the correct triplet set is "all unordered triplets with >= 2 edges".
We enumerate each exactly once via its center: candidate (center j, i < k
both neighbors of j) is kept unless the triplet is a triangle whose smallest
vertex is not j (keep iff no edge(i,k) or j < i).

NOTE deviation from the reference: ReferenceThreeNeighborList.cpp:215-225
enumerates strictly-descending index paths (i > j > k with edges (i,j),(j,k)),
which *misses* two-edge triplets whose center is the largest index (e.g.
1.28 kcal/mol of 3-body energy on the water50 fixture). That makes the
reference's energy depend on molecule numbering; we implement the complete,
permutation-independent set (all golden totals still pass within the
reference's own test tolerances).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def pair_capacity(n_mol, box, cutoff, factor=1.5, floor=64):
    """Static capacity estimate for the O-O pair list."""
    if box is None:
        return n_mol * (n_mol - 1) // 2
    vol = float(np.prod(np.asarray(box)))
    density = n_mol / vol
    per = density * 4.0 / 3.0 * np.pi * cutoff ** 3
    est = int(factor * n_mol * per / 2) + floor
    return min(est, n_mol * (n_mol - 1) // 2)


def max_neighbors(n_mol, box, cutoff, factor=2.0, floor=16):
    if box is None:
        return n_mol - 1
    vol = float(np.prod(np.asarray(box)))
    per = n_mol / vol * 4.0 / 3.0 * np.pi * cutoff ** 3
    return min(int(factor * per) + floor, n_mol - 1)


def triplet_capacity(n_mol, box, cutoff, factor=1.5, floor=128):
    if box is None:
        return n_mol * (n_mol - 1) * (n_mol - 2) // 6
    k = max_neighbors(n_mol, box, cutoff, factor=1.0, floor=0)
    est = int(factor * n_mol * k * max(k - 1, 1) / 2) + floor
    return min(est, n_mol * (n_mol - 1) * (n_mol - 2) // 6)


def _edge_matrix(o_pos, box, cutoff):
    d = o_pos[None, :, :] - o_pos[:, None, :]
    if box is not None:
        b = jnp.asarray(box, o_pos.dtype)
        d = d - jnp.floor(d / b + 0.5) * b
    r2 = jnp.sum(d * d, axis=-1)
    n = o_pos.shape[0]
    return (r2 < cutoff * cutoff) & ~jnp.eye(n, dtype=bool)


def pair_list(o_pos, box, cutoff, capacity):
    """Padded i<j pair list.

    Returns (pairs [capacity,2] int32, mask [capacity], n_found)."""
    n = o_pos.shape[0]
    edge = _edge_matrix(o_pos, box, cutoff)
    upper = edge & (jnp.arange(n)[:, None] < jnp.arange(n)[None, :])
    ii, jj = jnp.nonzero(upper, size=capacity, fill_value=0)
    mask = jnp.arange(capacity) < jnp.sum(upper)
    return jnp.stack([ii, jj], axis=1).astype(jnp.int32), mask, jnp.sum(upper)


def triplet_list(o_pos, box, cutoff, capacity, k_max=None, kt=None,
                 semantics='complete'):
    """Padded triplet list.

    semantics='complete' (default): all unordered {a,b,c} with >= 2 O-O
    edges - the full support of the 3-body switch product, permutation
    independent (see module docstring).
    semantics='reference': bit-parity with the reference's enumeration
    (ReferenceThreeNeighborList.cpp:215-225): nearbyAtoms[x] holds only
    previously-inserted atoms (y < x), so the emitted set is exactly the
    middle-centered ascending chains {a < b < c : edge(a,b) and edge(b,c)}
    - triplets whose only two edges share the smallest or largest index
    are missed, making the energy depend on molecule numbering. Provided
    as an opt-in strict-parity mode (MBPolConfig.triplet_semantics).

    Selection is two-stage: stage 1 compacts each center's [K, K] candidate
    block to `kt` slots (n small independent sorts), stage 2 places every
    center's run at its exclusive-cumsum offset (searchsorted + gather).
    A single flat nonzero over the [n*K*K] candidate tensor lowers to one
    huge sort; K itself is
    the main cost lever (MBPol.tune_capacities sizes it from the actual
    neighbor counts).

    kt: per-center triplet capacity (static). Default k_max*(k_max-1)//2 is
    exact (no per-center overflow possible); a tuned smaller value (from
    measured per-center counts) speeds stage 1 up, with overflow folded
    into n_found so the standard `n_found > capacity` check catches it.

    Returns (triplets [capacity,3] int32 as (i, center, k), mask, n_found)."""
    n = o_pos.shape[0]
    if k_max is None:
        k_max = max_neighbors(n, box, cutoff)
    max_kt = k_max * (k_max - 1) // 2
    if max_kt == 0:          # n < 3 or k_max < 2: no triplets possible
        return (jnp.zeros((capacity, 3), jnp.int32),
                jnp.zeros((capacity,), bool), jnp.zeros((), jnp.int32))
    kt = max_kt if kt is None else min(int(kt), max_kt)
    edge = _edge_matrix(o_pos, box, cutoff)

    # per-center padded neighbor list, ascending index order
    order = jnp.argsort(~edge, axis=1, stable=True)[:, :k_max]     # [n, K]
    valid = jnp.take_along_axis(edge, order, axis=1)               # [n, K]

    centers = jnp.arange(n)[:, None, None]                         # j
    i_idx = order[:, :, None]                                      # [n, K, 1]
    k_idx = order[:, None, :]                                      # [n, 1, K]
    vi = valid[:, :, None]
    vk = valid[:, None, :]
    pq_upper = (jnp.arange(k_max)[:, None] < jnp.arange(k_max)[None, :])[None]
    cand = vi & vk & pq_upper                                      # i < k guaranteed
    if semantics == 'reference':
        keep = cand & (i_idx < centers) & (centers < k_idx)
    else:
        ik_edge = edge[i_idx, k_idx]
        keep = cand & (~ik_edge | (centers < i_idx))

    # stage 1: per-center compaction (kept (p, q) flat offsets, ascending)
    flat = keep.reshape(n, k_max * k_max)
    t_j = jnp.sum(flat, axis=1)                                    # [n]
    iota = jnp.arange(k_max * k_max, dtype=jnp.int32)[None]
    sentinel = jnp.where(flat, iota, k_max * k_max)
    local = jnp.sort(sentinel, axis=1)[:, :kt]                     # [n, kt]

    # stage 2: each center's run starts at its exclusive-cumsum offset
    off = jnp.concatenate([jnp.zeros((1,), t_j.dtype), jnp.cumsum(t_j)])
    n_found = off[-1]
    s = jnp.arange(capacity)
    jj = jnp.minimum(jnp.searchsorted(off[1:], s, side='right'),
                     n - 1).astype(jnp.int32)
    mask = s < n_found
    r = jnp.where(mask, s - off[jj], 0)
    rem = local[jj, jnp.minimum(r, kt - 1)]
    pi = jnp.minimum(rem // k_max, k_max - 1)
    pk = jnp.minimum(rem % k_max, k_max - 1)
    a = order[jj, pi]
    c = order[jj, pk]
    trip = jnp.where(mask[:, None],
                     jnp.stack([a, jj, c], axis=1).astype(jnp.int32), 0)
    if kt < max_kt:
        # per-center truncation would silently drop triplets; surface it
        # through the existing n_found > capacity overflow contract
        n_found = jnp.where(jnp.max(t_j) > kt,
                            jnp.maximum(n_found, capacity + 1), n_found)
    if k_max < n - 1:
        # a center with more than k_max neighbors would silently lose
        # candidates to the order[:, :k_max] truncation (possible when a
        # tuned k_max meets a density fluctuation) - same overflow contract
        n_found = jnp.where(jnp.max(jnp.sum(edge, axis=1)) > k_max,
                            jnp.maximum(n_found, capacity + 1), n_found)
    mask = jnp.arange(capacity) < jnp.minimum(n_found, capacity)
    return trip, mask, n_found


# ----------------------------------------------------------------------
# Per-step active-set compaction
#
# Lists built with a Verlet skin stay valid across an MD chunk but inflate
# the expensive PIP batches: the triplet count grows ~ (r+skin)^6/r^6 (~1.9x
# at 4.5 A + 0.5 A skin). The switch functions vanish identically beyond the
# *physical* cutoffs, so at any given step only the entries currently within
# the physical cutoff contribute. Compacting those to the front of a smaller
# fixed-capacity buffer before the polynomial evaluation halves the dominant
# FLOPs of the step, with exact energies (dropped entries have s == 0 or are
# inside the r < 2 A early-exit of the reference physics,
# MBPolReferenceTwoBodyForce.cpp:141-145 / ThreeBodyForce.cpp:165).
# ----------------------------------------------------------------------

def _min_image_dist2(o_pos, box, idx_a, idx_b):
    d = o_pos[idx_a] - o_pos[idx_b]
    if box is not None:
        b = jnp.asarray(box, o_pos.dtype)
        d = d - jnp.floor(d / b + 0.5) * b
    return jnp.sum(d * d, axis=-1)


def _compact(items, active, capacity):
    """Stable compaction of active rows to the front of a [capacity] buffer.

    Returns (items [capacity, k], mask [capacity], n_active). n_active may
    exceed capacity (overflow - surface as a health flag)."""
    order = jnp.argsort(jnp.logical_not(active), stable=True)
    take = order[:capacity]
    out = jnp.take(items, take, axis=0)
    n = jnp.sum(active)
    mask = jnp.arange(capacity) < n
    return jnp.where(mask[:, None], out, 0), mask, n


def compact_pairs(o_pos, box, pairs, mask, cutoff, rmin, capacity):
    """Keep pairs with rmin < r_OO < cutoff (the exact support of the 2-body
    term); compact into a [capacity] buffer."""
    r2 = _min_image_dist2(o_pos, box, pairs[:, 0], pairs[:, 1])
    active = mask & (r2 < cutoff * cutoff) & (r2 > rmin * rmin)
    return _compact(pairs, active, capacity)


def compact_triplets(o_pos, box, trips, mask, cutoff, rmin, capacity):
    """Keep triplets with >= 2 O-O edges inside the physical cutoff and all
    edges above rmin (the exact support of the 3-body switch product)."""
    r2ab = _min_image_dist2(o_pos, box, trips[:, 0], trips[:, 1])
    r2bc = _min_image_dist2(o_pos, box, trips[:, 1], trips[:, 2])
    r2ac = _min_image_dist2(o_pos, box, trips[:, 0], trips[:, 2])
    c2 = cutoff * cutoff
    n_in = ((r2ab < c2).astype(jnp.int32) + (r2bc < c2).astype(jnp.int32)
            + (r2ac < c2).astype(jnp.int32))
    m2 = rmin * rmin
    active = mask & (n_in >= 2) & (r2ab > m2) & (r2bc > m2) & (r2ac > m2)
    return _compact(trips, active, capacity)
