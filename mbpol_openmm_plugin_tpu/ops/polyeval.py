"""Data-driven evaluation of permutationally-invariant polynomials (PIPs).

The MB-pol 2-body/3-body corrections are polynomials of degree <= 4 in 31/36
positive variables (exponentials of inter-atomic distances; reference:
MBPolReferenceTwoBodyForce.cpp:170-207, MBPolReferenceThreeBodyForce.cpp:168-206).
The reference evaluates them with ~42k lines of generated scalar C++
(poly-2b-v6x.cpp, poly-3b-v2x.cpp). Here the polynomial is *data*:

    E(x) = mono(x) @ c,   mono_m(x) = prod_i x_i^{e_mi} = exp(log(x) @ e_m)

so a batch of P pair/triplet evaluations is two matmuls:

    M   = exp(log(X) @ E^T)          # [P, nvars] @ [nvars, nmono]
    E_p = M @ c                      # [P, nmono] @ [nmono]

and the gradient (for forces) is one more matmul:

    dE/dX = ((M * c) @ E) / X        # [P, nmono] @ [nmono, nvars]

All variables are strictly positive (they are exp(-k(d-d0)) or exp(..)/d), so
the log/exp transform is exact. Extraction and validation against the
reference binaries: tools/extract_poly.py (agreement ~1e-13 relative).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from mbpol_openmm_plugin_tpu import data as _data


class PIPData:
    """Container for one extracted polynomial (exponent matrix + coefficients)."""

    def __init__(self, exponents, coeffs):
        self.exponents = np.asarray(exponents)        # [nmono, nvars] int8
        self.coeffs = np.asarray(coeffs)              # [nmono] float64
        self.nmono, self.nvars = self.exponents.shape


@functools.lru_cache(maxsize=None)
def load_pip(name):
    """name in {'poly2b', 'poly3b'}"""
    d = _data.load(name)
    return PIPData(d['exponents'], d['coeffs'])


# PIP fits have large canceling coefficients (|c| up to ~1e5 summing to
# ~kcal/mol), so every PIP contraction runs in full float32. HIGHEST keeps a
# GPU's float32 dots off TF32 (about 10 mantissa bits), which would corrupt
# energies by O(100 kcal/mol).
_PREC = jax.lax.Precision.HIGHEST


def pip_energy(x, exponents, coeffs):
    """Batched PIP evaluation.

    Args:
      x: [..., nvars] strictly-positive polynomial variables.
      exponents: [nmono, nvars] integer exponent matrix (cast to x.dtype).
      coeffs: [nmono] coefficients.
    Returns:
      [...] energies. Differentiable; the VJP is the natural transpose matmul.
    """
    et = exponents.astype(x.dtype)
    mono = jnp.exp(jnp.dot(jnp.log(x), et.T, precision=_PREC))
    return jnp.dot(mono, coeffs.astype(x.dtype), precision=_PREC)


def pip_energy_and_grad(x, exponents, coeffs):
    """Energy and analytic dE/dx in one pass (three matmuls). The plain
    monomial form: the reference the quadratic form below is checked
    against."""
    et = exponents.astype(x.dtype)
    c = coeffs.astype(x.dtype)
    mono = jnp.exp(jnp.dot(jnp.log(x), et.T, precision=_PREC))
    e = jnp.dot(mono, c, precision=_PREC)
    g = jnp.dot(mono * c, et, precision=_PREC) / x
    return e, g


@functools.lru_cache(maxsize=None)
def load_quad(name):
    """Quadratic-form factorization (tools/factor_pip.py):
    E(x) = m2(x)^T W m2(x) over the degree-<=2 monomial basis."""
    d = _data.load(name + '_quad')
    return np.asarray(d['basis_exponents']), np.asarray(d['W'])


@functools.lru_cache(maxsize=None)
def _quad_factor_indices(name):
    """(idxA, idxB) int32 [B] such that m2_k = xa[idxA_k] * xa[idxB_k] with
    xa = [x, 1]: every degree-<=2 basis monomial is an EXACT product of two
    augmented variables. This avoids the exp(log x @ F) round trip, whose
    f32 exponent rounding (~2e-6 absolute) turns into ~1e-5 relative
    monomial error - amplified by the PIP's canceling coefficients to
    several kcal/mol on close dimers."""
    F, _ = load_quad(name)
    b, v = F.shape
    if F.sum(axis=1).max() > 2:
        raise ValueError(
            f'{name}: quadratic-form basis has a column of total degree '
            f'{int(F.sum(axis=1).max())} > 2; the two-factor product '
            'decomposition does not apply (re-run tools/factor_pip.py)')
    ia = np.full(b, v, np.int32)          # index v is the constant 1
    ib = np.full(b, v, np.int32)
    for k in range(b):
        nz = np.nonzero(F[k])[0]
        if len(nz) == 1:
            ia[k] = nz[0]
            if F[k, nz[0]] == 2:
                ib[k] = nz[0]
        elif len(nz) == 2:
            assert F[k, nz[0]] == 1 and F[k, nz[1]] == 1, (name, k, F[k, nz])
            ia[k], ib[k] = nz
    return ia, ib


def quad_basis(x, name):
    """Degree-<=2 basis monomials by exact products of the augmented
    variables xa = [x, 1]: two static column gathers, multiplied pairwise.
    Exact in f32 (one product rounding), no transcendentals."""
    xa = jnp.concatenate([x, jnp.ones_like(x[..., :1])], axis=-1)
    idx_a, idx_b = _quad_factor_indices(name)
    return jnp.take(xa, jnp.asarray(idx_a), axis=-1) \
        * jnp.take(xa, jnp.asarray(idx_b), axis=-1)


def pip_quad_energy_and_grad(x, F, W, name=None):
    """Quadratic-form PIP evaluation: ~18x fewer FLOPs than the monomial
    expansion (528/703-column basis instead of 12.7k/33.5k monomials), with
    the gradient reusing the W matvec: dE/dm2 = 2 W m2.

    With `name` the basis is built by exact products (quad_basis): the
    exp(log x @ F) form is limited by the f32 rounding of log x (~4e-6
    absolute exponent error -> ~0.3 kcal/mol per close dimer after the
    fits' 6-orders-of-magnitude cancellation), while exact products reach
    the f32 product floor (~0.02). Without it (float64 oracles) the
    exp/log form is used.

    Both contractions run at HIGHEST: the W matvec's coefficient
    cancellation on physical configurations (variables spanning 1e-4..1)
    loses ~46 kcal/mol on water256 with bf16-based passes, and rounding
    noise in the gradient contraction is white force noise that heats an
    NVE run."""
    Ft = F.astype(x.dtype)
    Wt = W.astype(x.dtype)
    if name is not None:
        m2 = quad_basis(x, name)
    else:
        m2 = jnp.exp(jnp.dot(jnp.log(x), Ft.T, precision=_PREC))
    wm = jnp.dot(m2, Wt, precision=_PREC)
    e = jnp.sum(m2 * wm, axis=-1)
    g = jnp.dot(m2 * (2.0 * wm), Ft, precision=_PREC) / x
    return e, g


@functools.lru_cache(maxsize=None)
def pip_apply(name):
    """Batched PIP energy fn with an analytic-gradient JVP.

    Returns f(x[P, nvars]) -> e[P], differentiable once, evaluated through
    the quadratic-form factorization (load_quad). The analytic gradient is
    the tangent rule, so differentiation never rematerializes the basis
    matrices.
    """
    def impl_fn(x):
        F, W = load_quad(name)
        return pip_quad_energy_and_grad(x, jnp.asarray(F), jnp.asarray(W),
                                        name=name)

    @jax.custom_jvp
    def f(x):
        return impl_fn(x)[0]

    @f.defjvp
    def f_jvp(primals, tangents):
        # custom_jvp (not custom_vjp) so the PIP term is differentiable in
        # BOTH modes from the one analytic gradient: reverse (forces) via
        # transposition of the linear tangent rule, and forward (jvp) for
        # scalar derivatives like the virial dU/dlambda (md/pressure.py),
        # where reverse-mode is unavailable through the SCF while_loop.
        (x,), (xdot,) = primals, tangents
        e, g = impl_fn(x)
        return e, jnp.sum(g * xdot, axis=-1)

    return f
