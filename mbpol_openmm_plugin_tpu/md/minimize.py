"""On-device L-BFGS energy minimization.

The reference delegates minimization to OpenMM's LocalEnergyMinimizer
(L-BFGS; used by the builder's minimization configs, reference
bin/mbpol_builder template and examples/example_ini/
mbpol_cluster_minimization.ini). On-device equivalent: limited-memory BFGS
with a fixed-depth history and an Armijo backtracking line search, the whole
minimization a single `lax.while_loop` - no host round-trips per iteration.

Shapes are static: the history is a [m, n] ring buffer with a validity
count; the two-loop recursion unrolls over the (small, static) depth m.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def lbfgs_minimize(energy_grad_fn, x0, max_iterations=200, tolerance=10.0,
                   history=8, max_backtracks=20):
    """Minimize a scalar function of an [N, D] array.

    Args:
      energy_grad_fn: x -> (energy, gradient) (gradient, NOT force).
      x0: initial point.
      tolerance: convergence when RMS gradient < tolerance (OpenMM
        LocalEnergyMinimizer semantics: kJ/mol/nm for positions).
      history: L-BFGS memory depth (static; unrolled two-loop recursion).
      max_backtracks: line-search step halvings before giving up.

    Returns (x, energy, diagnostics dict with iterations/grad_rms/converged).
    """
    shape = x0.shape
    dtype = x0.dtype
    n = x0.size
    m = history
    x0f = x0.reshape(-1)

    def eg(xf):
        e, g = energy_grad_fn(xf.reshape(shape))
        return e, g.reshape(-1)

    def two_loop(g, S, Y, rho, k):
        """Standard L-BFGS two-loop recursion with the ring buffer holding
        the last min(k, m) (s, y) pairs; slot (k-1) % m is the newest."""
        q = g
        alphas = [None] * m
        for i in range(m):                       # newest -> oldest
            idx = (k - 1 - i) % m
            valid = i < jnp.minimum(k, m)
            a = jnp.where(valid, rho[idx] * jnp.dot(S[idx], q), 0.0)
            q = q - a * Y[idx]
            alphas[i] = (idx, valid, a)
        newest = (k - 1) % m
        ys = jnp.dot(S[newest], Y[newest])
        yy = jnp.dot(Y[newest], Y[newest])
        gamma = jnp.where((k > 0) & (yy > 0), ys / jnp.maximum(yy, 1e-30), 1.0)
        r = gamma * q
        for idx, valid, a in reversed(alphas):   # oldest -> newest
            b = jnp.where(valid, rho[idx] * jnp.dot(Y[idx], r), 0.0)
            r = r + (a - b) * S[idx]
        return r

    def line_search(xf, e0, g, d):
        """Backtracking Armijo search along descent direction d."""
        gTd = jnp.dot(g, d)
        # initial step: cap the max per-coordinate move at 0.02 (nm) so the
        # first trial of a cold start cannot tear molecules apart
        dmax = jnp.max(jnp.abs(d)) + 1e-30
        t0 = jnp.minimum(1.0, 0.02 / dmax)

        def cond(c):
            t, it, e_t, done = c
            return (~done) & (it < max_backtracks)

        def body(c):
            t, it, _, _ = c
            e_t, _ = eg(xf + t * d)
            ok = e_t <= e0 + 1e-4 * t * gTd
            return (jnp.where(ok, t, 0.5 * t), it + 1, e_t, ok)

        t, _, e_t, ok = jax.lax.while_loop(
            cond, body, (t0, jnp.zeros((), jnp.int32), e0, jnp.zeros((), bool)))
        return jnp.where(ok, t, 0.0), ok

    def cond(c):
        xf, e, g, S, Y, rho, k, it, done = c
        return (~done) & (it < max_iterations)

    def body(c):
        xf, e, g, S, Y, rho, k, it, _ = c
        d = -two_loop(g, S, Y, rho, k)
        # safeguard: fall back to steepest descent if d is not a descent dir
        descent = jnp.dot(g, d) < 0
        d = jnp.where(descent, d, -g)
        t, ok = line_search(xf, e, g, d)
        x_new = xf + t * d
        e_new, g_new = eg(x_new)
        s = x_new - xf
        y = g_new - g
        ys = jnp.dot(y, s)
        update = ok & (ys > 1e-10)
        slot = k % m
        S = jnp.where(update, S.at[slot].set(s), S)
        Y = jnp.where(update, Y.at[slot].set(y), Y)
        rho = jnp.where(update, rho.at[slot].set(1.0 / jnp.maximum(ys, 1e-30)), rho)
        k = jnp.where(update, k + 1, k)
        grad_rms = jnp.sqrt(jnp.sum(g_new * g_new) / (n / x0.shape[-1]))
        done = (~ok) | (grad_rms < tolerance)
        return (jnp.where(ok, x_new, xf), jnp.where(ok, e_new, e),
                jnp.where(ok, g_new, g), S, Y, rho, k, it + 1, done)

    e0, g0 = eg(x0f)
    S = jnp.zeros((m, n), dtype)
    Y = jnp.zeros((m, n), dtype)
    rho = jnp.zeros((m,), dtype)
    xf, e, g, _, _, _, _, iters, _ = jax.lax.while_loop(
        cond, body,
        (x0f, e0, g0, S, Y, rho, jnp.zeros((), jnp.int32),
         jnp.zeros((), jnp.int32), jnp.zeros((), bool)))
    grad_rms = jnp.sqrt(jnp.sum(g * g) / (n / x0.shape[-1]))
    return xf.reshape(shape), e, dict(iterations=iters, grad_rms=grad_rms,
                                      converged=grad_rms < tolerance)
