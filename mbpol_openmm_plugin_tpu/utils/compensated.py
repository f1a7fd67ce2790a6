"""Compensated (Kahan-Babuska-Neumaier) accumulation for f32 integration.

Long NVE trajectories in float32 drift because the per-step position update
p += dt*v adds an increment ~4 orders of magnitude below |p| (0.2 fs x
thermal velocity ~ 1e-4 nm against |p| ~ 1 nm): every step rounds away
~half the increment's low bits, a bias-bearing random walk that shows up
as monotone total-energy drift. Production engines integrate in f64 or
64-bit fixed point for exactly this reason (the reference runs OpenMM's
f64 Reference Verlet throughout, python/example_nvt_nve.py:15-71).

Without a fast f64 path, the equivalent keeps each integrated quantity
as an UNEVALUATED f32 PAIR (value + compensation):
Neumaier two-sum recovers the bits the naive add rounds away and carries
them forward, giving ~2x f32 precision (double-single) on the
accumulated sum while every downstream consumer (force evaluation, PME)
still sees a plain f32 array - only the two adds per
update change, a measured-negligible cost against the O(N) force work.

No multiplications appear in the error extraction, so FMA contraction
cannot break it; XLA preserves float semantics (no reassociation) for
these adds.
"""
from __future__ import annotations

import jax.numpy as jnp


def comp_add(x, c, dx):
    """One compensated accumulation step: (x, c) <- (x + c) + dx.

    x: the f32 running value consumers read; c: the carried low-order
    compensation; dx: the increment. Returns (x', c') with
    x' + c' == x + c + dx to ~f32^2 precision (Neumaier two-sum: the
    error term is extracted from whichever operand dominates, so it is
    exact for any magnitude ordering, unlike classic Kahan)."""
    y = dx + c
    t = x + y
    c_new = jnp.where(jnp.abs(x) >= jnp.abs(y),
                      (x - t) + y,       # low bits of y lost in the add
                      (y - t) + x)       # x was the small operand
    return t, c_new


def comp_zero_like(x):
    """Fresh compensation term for an integrated quantity."""
    return jnp.zeros_like(x)
