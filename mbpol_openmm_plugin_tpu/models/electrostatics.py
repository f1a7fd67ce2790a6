"""Many-body polarization electrostatics (cluster / NoCutoff path).

Physics (reference: MBPolReferenceElectrostaticsForce.cpp):
  - TTM4-F style geometry-dependent charges from the Partridge-Schwenke
    dipole-moment surface, with analytic dq/dr tensors (computeWaterCharge,
    cpp:2793-3095),
  - MB-pol Thole damping: damped 1/r^n factors of orders 1/3/5/7 with
    damp = (A_i A_j)^(1/6) and exp(-gamma (r/damp)^4) form; the order-1
    factor involves the regularized incomplete gamma Q(3/4, x)
    (getAndScaleInverseRs, cpp:261-334),
  - induced-dipole SCF: fixed field from charges (same-water pairs excluded),
    SOR iteration (polarSOR = 0.55) with convergence metric
    polarSOR * debye * sqrt(sum|d mu|^2 / N) (cpp:516-616),
  - pair energy/forces: charge-charge + charge-induced-dipole +
    induced-induced terms with per-order Thole scales (cpp:649-836),
  - charge-derivative forces: contraction of dq/dr with damped per-site
    potentials (cpp:791-827).

Design notes:
  * The reference carries a second "polar" copy of the induced dipoles
    (AMOEBA heritage, where p-scale != d-scale exclusions). In MB-pol both
    copies see identical fields and identical updates from identical initial
    values, so mu_polar == mu identically; we store one array and fold the
    duplicated terms (e.g. scip2 = 2 mu_i . mu_j) into the formulas. This
    halves SCF cost; equivalence is asserted in tests against the
    reference's golden energies/forces.
  * All O(N^2) loops become dense masked [N, N] tensor ops; the SCF
    iteration is matmul-shaped (field = S3 @ mu + contraction with the
    precomputed displacement tensor).
  * Forces use the reference's explicit formulas (valid at SCF convergence)
    rather than autodiff through the iteration.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from mbpol_openmm_plugin_tpu.ops.gamma import gammq34

from mbpol_openmm_plugin_tpu import data as _data
from mbpol_openmm_plugin_tpu.utils import units

# Thole parameter indices (MBPolElectrostaticsForce.h:323)
TCC, TCD, TDD, TDDOH, TDDHH = 0, 1, 2, 3, 4

_POLAR_SOR = 0.55
_GAMMA_3_4 = 1.2254167024651776451290983034  # Gamma(3/4)


@dataclasses.dataclass(frozen=True)
class ElecParams:
    """Static per-particle electrostatics parameters (numpy, shapes the jit)."""
    thole: np.ndarray            # [5] TCC,TCD,TDD,TDDOH,TDDHH
    damping: np.ndarray          # [N] damping factors
    polarity: np.ndarray         # [N] polarizabilities (nm^3)
    mol_index: np.ndarray        # [N]
    atom_type: np.ndarray        # [N] 0=O,1=H,2=M
    charges: np.ndarray          # [N] input charges (used when no redistribution)
    include_charge_redistribution: bool = True
    target_epsilon: float = 1e-7   # Force API default (MBPolElectrostaticsForce.cpp:44)
    max_iterations: int = 200
    # 'sor' (reference semantics) | 'diis' (accelerated convergence) |
    # 'aspc' (Kolafa always-stable predictor-corrector: one damped
    # iteration per step from a history predictor; MD trajectories only)
    scf_method: str = 'sor'
    aspc_k: int = 3                # ASPC predictor order (scf_method='aspc')
    # corrector depth: SOR iterations applied to the predictor before the
    # omega-mix (CP2K ASPC convention). 1 = Kolafa's single damped
    # corrector; each extra iteration costs one dipole-field evaluation
    # (~2-3% of a step) and shrinks the closure's force lag - the term
    # that dominates long-horizon f32 NVE drift (integrator-rounding
    # compensation alone leaves the drift unchanged).
    aspc_n_corr: int = 1
    # Lowest SCF target honored at f32 (None = env/1e-4 default; see
    # _f32_eps_floor - the typed knob for the round-4 dissipation finding)
    scf_eps_floor: Optional[float] = None
    # water site indices for charge redistribution (None for 3-site systems)
    o_index: Optional[np.ndarray] = None
    h1_index: Optional[np.ndarray] = None
    h2_index: Optional[np.ndarray] = None
    m_index: Optional[np.ndarray] = None

    @classmethod
    def for_system(cls, system, **kw):
        """Parameters for a standard OHHM water System (XML values)."""
        ff = _data.load('forcefield')
        if system.n_ions:
            raise NotImplementedError('electrostatics with ions (parity with reference)')
        per_site = np.stack([ff['atom_O'], ff['atom_H'], ff['atom_H'], ff['atom_M']])
        n = system.n_waters
        vals = np.tile(per_site, (n, 1))
        return cls(
            thole=ff['thole'], damping=vals[:, 1], polarity=vals[:, 2],
            mol_index=system.mol_index, atom_type=np.minimum(system.atom_class, 2),
            charges=vals[:, 0],
            o_index=system.o_index, h1_index=system.h1_index,
            h2_index=system.h2_index, m_index=system.m_index, **kw)


# ----------------------------------------------------------------------
# Thole damping factors
# ----------------------------------------------------------------------

def thole_scales(u, gamma, orders=(1, 3, 5, 7)):
    """Damping-only scale factors (justScale=True in the reference).

    Args:
      u: r / damp with damp = (A_i A_j)^(1/6).
      gamma: Thole gamma for the interaction type.
    Returns dict order -> scale.  (getAndScaleInverseRs, cpp:309-330)
    """
    ratio = u ** 4
    ex = jnp.exp(-gamma * ratio)
    out = {}
    s3 = 1.0 - ex
    if 1 in orders:
        out[1] = s3 + gamma ** 0.25 * u * _GAMMA_3_4 * gammq34(gamma * ratio)
    if 3 in orders:
        out[3] = s3
    s5 = s3 - (4.0 / 3.0) * gamma * ex * ratio
    if 5 in orders:
        out[5] = s5
    if 7 in orders:
        out[7] = s5 - (4.0 / 15.0) * gamma * (4.0 * gamma * ratio - 1.0) * ex * ratio
    return out


def _pair_tensors(params: ElecParams, positions, periodic_delta=None, mesh=None):
    """Common dense [N,N] geometry/scale tensors.

    Returns dict with delta (r_j - r_i), r, masks and Thole gamma matrices.
    When a device mesh is given, the row (i) dimension is sharded over its
    'dp' axis so the O(N^2) work and the SCF matmuls partition across chips.
    """
    n = len(params.damping)
    delta = positions[None, :, :] - positions[:, None, :]
    if periodic_delta is not None:
        delta = periodic_delta(delta)
    if mesh is not None:
        from mbpol_openmm_plugin_tpu.parallel import mesh as M
        delta = M.constrain(delta, M.row_sharded(mesh))
    r2 = jnp.sum(delta * delta, axis=-1)
    # The [N,N] masks/damping/gamma tensors are derived on-device from [N]
    # vectors - embedding them as host constants would put O(N^2) literals
    # into the HLO (hundreds of MB at N=8192).
    idx = jnp.arange(n)
    notself = idx[:, None] != idx[None, :]
    r = jnp.sqrt(jnp.where(notself, r2, 1.0))

    # damp = (A_i A_j)^(1/6); precompute per-particle A^(1/6) host-side
    d16 = jnp.asarray(np.asarray(params.damping, np.float64) ** (1.0 / 6.0),
                      positions.dtype)
    u = r / (d16[:, None] * d16[None, :])

    mol = jnp.asarray(params.mol_index)
    same_mol = mol[:, None] == mol[None, :]
    diff_mol = (~same_mol) & notself

    # TDD gamma selection (cpp:290-307)
    is_o = jnp.asarray(params.atom_type == 0)
    one_is_o = is_o[:, None] | is_o[None, :]
    th = params.thole
    dt = positions.dtype
    gamma_dd = jnp.where(same_mol,
                         jnp.where(one_is_o, jnp.asarray(th[TDDOH], dt),
                                   jnp.asarray(th[TDDHH], dt)),
                         jnp.asarray(th[TDD], dt))

    return dict(delta=delta, r=r, u=u, notself=notself,
                same_mol=same_mol, diff_mol=diff_mol, gamma_dd=gamma_dd)


# ----------------------------------------------------------------------
# Geometry-dependent water charges (TTM4-F / Partridge-Schwenke DMS)
# ----------------------------------------------------------------------

_GAMMA_M = 0.426706882
_DMS = dict(ath0=1.82400520401572996557, costhe=-0.24780227221366464506,
            reoh=0.958649, b1D=1.0, a=0.2999, b=-0.6932,
            c0=1.0099, c1=-0.1801, c2=0.0892, bohr_a=0.52917721092)


def _water_charges_one(o, h1, h2, dtype):
    """Charges (qH1, qH2, qM) for one water; positions in nm.
    Mirrors computeWaterCharge (cpp:2793-2992); qO is identically 0."""
    d = _data.load('dms')
    k = _DMS
    roh1 = (h1 - o) * units.NM_TO_ANGSTROM
    roh2 = (h2 - o) * units.NM_TO_ANGSTROM
    d1 = jnp.sqrt(jnp.sum(roh1 * roh1))
    d2 = jnp.sqrt(jnp.sum(roh2 * roh2))
    costh = jnp.sum(roh1 * roh2) / (d1 * d2)

    efac = jnp.exp(-k['b1D'] * ((d1 - k['reoh']) ** 2 + (d2 - k['reoh']) ** 2))
    x1 = (d1 - k['reoh']) / k['reoh']
    x2 = (d2 - k['reoh']) / k['reoh']
    x3 = costh - k['costhe']

    # powers by iterated multiplication, NOT x ** arange(15): the power-rule
    # gradient of the constant column is 0 * x**(-1) = NaN exactly at x == 0,
    # and x1/x2 cross zero every OH vibration (see models/one_body._vander;
    # here the NaN would enter through the dq/dr jacfwd).
    from mbpol_openmm_plugin_tpu.models.one_body import _vander
    v1 = _vander(x1, dtype, n=15)
    v2 = _vander(x2, dtype, n=15)
    v3 = _vander(x3, dtype, n=15)

    i0, i1, i2 = d['idxD0'][1:] - 1, d['idxD1'][1:] - 1, d['idxD2'][1:] - 1
    coef = jnp.asarray(d['coefD'][1:], dtype)
    p1 = jnp.sum(coef * v1[i0] * v2[i1] * v3[i2])
    p2 = jnp.sum(coef * v1[i1] * v2[i0] * v3[i2])

    pl1 = costh
    pl2 = 0.5 * (3.0 * pl1 * pl1 - 1.0)
    pc0 = k['a'] * (d1 ** k['b'] + d2 ** k['b']) * (k['c0'] + pl1 * k['c1'] + pl2 * k['c2'])

    coefD0 = float(_data.load('dms')['coefD'][0])
    q_h1 = coefD0 + p1 * efac + pc0 * k['bohr_a']
    q_h2 = coefD0 + p2 * efac + pc0 * k['bohr_a']

    gamma1 = 1.0 - _GAMMA_M
    g2div1 = (_GAMMA_M / 2.0) / gamma1
    charge_h1 = q_h1 + g2div1 * (q_h1 + q_h2)
    charge_h2 = q_h2 + g2div1 * (q_h1 + q_h2)
    charge_m = -(q_h1 + q_h2) / gamma1
    return jnp.stack([charge_h1, charge_h2, charge_m])


def water_charges_and_derivatives(pos_w):
    """Charges and dq/dr tensors for a batch of waters.

    Args:
      pos_w: [nmol, 3, 3] positions (O,H1,H2) in nm.
    Returns:
      charges: [nmol, 3] (qH1, qH2, qM); qO == 0.
      dq: [nmol, 3 (atom O,H1,H2), 3 (charge H1,H2,M), 3 (xyz)] in e/nm.
    The derivative is the exact Jacobian of the charge expression (the
    reference's hand-derived chain rule, cpp:2994-3076, computes the same
    object; golden parity asserted in tests).
    """
    dtype = pos_w.dtype

    def charges_fn(flat):
        o, h1, h2 = flat[0], flat[1], flat[2]
        return _water_charges_one(o, h1, h2, dtype)

    q = jax.vmap(charges_fn)(pos_w)
    jac = jax.vmap(jax.jacfwd(charges_fn))(pos_w)      # [nmol, 3q, 3atom, 3xyz]
    dq = jnp.transpose(jac, (0, 2, 1, 3))              # [nmol, atom, charge, xyz]
    return q, dq


def assemble_charges(params: ElecParams, positions):
    """Per-particle charge vector and dq/dr tensors for the full system."""
    n = len(params.damping)
    dtype = positions.dtype
    if not params.include_charge_redistribution:
        return jnp.asarray(params.charges, dtype), None
    nmol = len(params.o_index)
    contiguous = bool(np.array_equal(params.o_index, 4 * np.arange(nmol)))
    if contiguous and 4 * nmol == n:
        pos_w = positions.reshape(nmol, 4, 3)[:, :3]
        q_w, dq_w = water_charges_and_derivatives(pos_w)
        zero = jnp.zeros((nmol, 1), dtype)
        charges = jnp.concatenate([zero, q_w], axis=1).reshape(-1)
        return charges, dq_w
    idx = np.stack([params.o_index, params.h1_index, params.h2_index], axis=1)
    pos_w = positions[idx]
    q_w, dq_w = water_charges_and_derivatives(pos_w)
    charges = jnp.zeros(n, dtype)
    charges = charges.at[params.h1_index].set(q_w[:, 0])
    charges = charges.at[params.h2_index].set(q_w[:, 1])
    charges = charges.at[params.m_index].set(q_w[:, 2])
    return charges, dq_w


# ----------------------------------------------------------------------
# Induced-dipole SCF
# ----------------------------------------------------------------------

def _dipole_field(mu, s3, s5, delta):
    """Field at i from dipoles at j: sum_j s3_ij mu_j + s5_ij (mu_j . D_ij) D_ij
    with D = delta (r_j - r_i). s3/s5 carry signs and r powers."""
    f = s3 @ mu
    proj = jnp.einsum('ijd,jd->ij', delta, mu)
    f = f + jnp.einsum('ij,ijd->id', s5 * proj, delta)
    return f


def _f32_eps_floor(override=None):
    """Lowest SCF convergence target honored at float32.

    The historical clamp was 1e-4 (round 2): the convergence metric
    (polarSOR * debye * sqrt(|dmu|^2/N), ~Debye units) was assumed to hit
    the f32 noise floor there. But the f32 SOR loop at eps 1e-4 is
    strongly DISSIPATIVE in NVE (water256: the lagging dipoles do
    negative work every step), and the metric's
    actual f32 resolution is ~|mu| * 2^-24 ~ 3e-8 D, so far tighter
    targets are representable. The floor stays overridable rather than
    hard-wired: the typed config field (MBPolConfig.scf_eps_floor ->
    ElecParams.scf_eps_floor, passed here as `override`) is the
    production control; the MBPOL_F32_SCF_EPS_FLOOR env var remains as a
    tooling override when no typed value is set. Default keeps the
    historical 1e-4 - the f32 loop may plateau-abort below ~1e-6, so
    tightening is an explicit choice, e.g. the NVE drift study.
    """
    if override is not None:
        return float(override)
    import os
    return float(os.environ.get('MBPOL_F32_SCF_EPS_FLOOR', 1e-4))


def scf_induced_dipoles_diis(efield_alpha, alpha, s3, s5, delta, target_epsilon,
                             max_iterations, extra_field=None, mu0=None,
                             depth=5, eps_floor=None):
    """DIIS/Anderson-accelerated SCF (the reference's CUDA platform uses DIIS
    for the same reason, multipoleInducedField.cu:374-482 - but solves the
    small system on the host; here everything stays on device).

    Fixed-point map g(mu) = alpha * (E_fixed + T mu); residual r = g(mu) - mu.
    Each iteration extrapolates over the last `depth` (g, r) pairs by solving
    the constrained least-squares system  [B 1; 1 0][c; l] = [0; 1] with
    B_ij = <r_i, r_j> (+ Tikhonov regularization), then mu <- sum c_i g_i.
    Convergence metric matches the reference (polarSOR * debye *
    sqrt(|r|^2/N)), so `converged` means the same thing as the SOR path.
    """
    n = efield_alpha.shape[0]
    dtype = efield_alpha.dtype
    big = jnp.asarray(jnp.finfo(dtype).max / 4, dtype)
    if dtype == jnp.float32:
        target_epsilon = max(target_epsilon, _f32_eps_floor(eps_floor))

    def gmap(mu):
        field = _dipole_field(mu, s3, s5, delta)
        if extra_field is not None:
            field = field + extra_field(mu)
        return efield_alpha + field * alpha[:, None]

    K = depth
    M = K - 1   # Anderson mixing dimension (differences vs the newest slot)

    def chol_solve(A, b):
        """Unrolled Cholesky solve for a tiny static SPD system: a few scalar
        ops fused into the loop body instead of a linear-algebra library
        call per SCF iteration."""
        L = [[None] * M for _ in range(M)]
        for i in range(M):
            for j in range(i + 1):
                s = A[i, j]
                for k in range(j):
                    s = s - L[i][k] * L[j][k]
                if i == j:
                    L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
                else:
                    L[i][j] = s / L[j][j]
        y = [None] * M
        for i in range(M):
            s = b[i]
            for k in range(i):
                s = s - L[i][k] * y[k]
            y[i] = s / L[i][i]
        x = [None] * M
        for i in reversed(range(M)):
            s = y[i]
            for k in range(i + 1, M):
                s = s - L[k][i] * x[k]
            x[i] = s / L[i][i]
        return jnp.stack(x)

    def body(carry):
        mu, gs, rs, it, _, done, conv = carry
        g = gmap(mu)
        r = g - mu
        eps = _POLAR_SOR * units.DEBYE * jnp.sqrt(jnp.sum(r * r) / n)
        gs = jnp.roll(gs, 1, axis=0).at[0].set(g)
        rs = jnp.roll(rs, 1, axis=0).at[0].set(r)
        m = jnp.minimum(it, M)                       # older slots available
        valid = jnp.arange(M) < m                    # slots 1..M vs slot 0
        # Anderson type-II: minimize || r0 + D theta ||, D_i = r_{i+1} - r_0
        D = rs[1:] - rs[0]                           # [M, N, 3]
        D = jnp.where(valid[:, None, None], D, 0.0)
        Df = D.reshape(M, -1)
        A = Df @ Df.T
        reg = 1e-8 * (jnp.trace(A) + jnp.asarray(1e-30, dtype))
        A = A + reg * jnp.eye(M, dtype=dtype) \
            + jnp.diag(jnp.where(valid, 0.0, 1.0).astype(dtype))
        b = -(Df @ rs[0].reshape(-1))
        theta = jnp.where(valid, chol_solve(A, b), 0.0)
        mu_new = gs[0] + jnp.einsum('k,knd->nd', theta, gs[1:] - gs[0])
        converged = eps < target_epsilon
        done = converged | (it + 1 >= max_iterations)
        return (mu_new, gs, rs, it + 1, eps, done, converged)

    def cond(carry):
        return ~carry[5]

    mu0 = efield_alpha if mu0 is None else mu0
    gs0 = jnp.zeros((K,) + mu0.shape, dtype)
    rs0 = jnp.zeros((K,) + mu0.shape, dtype)
    mu, _, _, iters, eps, _, converged = jax.lax.while_loop(
        cond, body, (mu0, gs0, rs0, jnp.zeros((), jnp.int32),
                     big, jnp.zeros((), bool), jnp.zeros((), bool)))
    return mu, dict(iterations=iters, epsilon=eps, converged=converged)


def scf_induced_dipoles(efield_alpha, alpha, s3, s5, delta, target_epsilon,
                        max_iterations, extra_field=None, mu0=None,
                        eps_floor=None):
    """SOR fixed-point iteration for the induced dipoles.

    Args:
      efield_alpha: [N,3] polarity * fixed field (initial dipoles).
      alpha: [N] polarizabilities.
      s3, s5: [N,N] precomputed damped factors (cluster: s3 = -scale3_dd/r^3,
        s5 = 3 scale5_dd/r^5; PME direct adds Ewald terms).
      extra_field: optional callable mu -> [N,3] additional field (PME
        reciprocal + self terms).
    Returns:
      (mu, diagnostics dict with iterations/epsilon/converged).
    Mirrors convergeInduceDipoles (cpp:557-616): SOR 0.55, epsilon =
    polarSOR*debye*sqrt(sum|dmu|^2/N), stop on convergence, divergence
    (epsilon increase) or max iterations.
    """
    n = efield_alpha.shape[0]
    dtype = efield_alpha.dtype
    big = jnp.asarray(jnp.finfo(dtype).max / 4, dtype)
    if dtype == jnp.float32:
        # the Force-API default target (1e-7, float64-era) is below float32
        # resolution of the convergence metric; clamp to an achievable floor
        # (the reference kernel's own default is 1e-3,
        # MBPolReferenceKernels.cpp:133)
        target_epsilon = max(target_epsilon, _f32_eps_floor(eps_floor))

    def one_iter(mu):
        field = _dipole_field(mu, s3, s5, delta)
        if extra_field is not None:
            field = field + extra_field(mu)
        new = efield_alpha + field * alpha[:, None]
        dmu = new - mu
        mu2 = mu + _POLAR_SOR * dmu
        eps = _POLAR_SOR * units.DEBYE * jnp.sqrt(jnp.sum(dmu * dmu) / n)
        return mu2, eps

    def cond(c):
        return ~c[3]

    def body(c):
        mu, prev_eps, it, _, _ = c
        mu2, eps = one_iter(mu)
        converged = eps < target_epsilon
        done = converged | (prev_eps < eps) | (it + 1 >= max_iterations)
        return (mu2, eps, it + 1, done, converged)

    if mu0 is None:
        mu0 = efield_alpha       # reference initialization (cpp:422-436)
    mu, eps, iters, _, converged = jax.lax.while_loop(
        cond, body, (mu0, big, jnp.zeros((), jnp.int32),
                     jnp.zeros((), bool), jnp.zeros((), bool)))
    return mu, dict(iterations=iters, epsilon=eps, converged=converged)


def aspc_omega(k):
    """Kolafa ASPC relaxation weight omega = (k+2)/(2k+3) for predictor
    order k (J. Comput. Chem. 25, 335 (2004), eq. 18)."""
    return (k + 2.0) / (2.0 * k + 3.0)


def aspc_predictor_coefficients(k):
    """Kolafa ASPC predictor coefficients B_j (J. Comput. Chem. 25, 335
    (2004)) over the last k+2 corrected dipole sets, newest first:

        B_j = (-1)^(j+1) * j * C(2k+4, k+2-j) / C(2k+2, k+1),  j = 1..k+2

    (closed form; reproduces the paper's Table I rows exactly for k = 0..3,
    pinned in tests/test_aspc.py). Each row sums to 1, so a history
    initialized by tiling one converged dipole set degenerates to the plain
    warm start for the first steps. Orders above ~6 add no accuracy in f32:
    the alternating coefficients grow as 4^k, so the extrapolation's
    cancellation noise overtakes the truncation-error gain."""
    if not 0 <= int(k) == k:
        raise ValueError(f'ASPC predictor order must be a non-negative '
                         f'integer, got {k!r}')
    from math import comb
    denom = comb(2 * k + 2, k + 1)
    return np.asarray([(-1) ** (j + 1) * j * comb(2 * k + 4, k + 2 - j)
                       / denom for j in range(1, k + 3)], np.float64)


def scf_induced_dipoles_aspc(efield_alpha, alpha, s3, s5, delta, target_epsilon,
                             max_iterations, extra_field=None, mu0=None,
                             omega=5.0 / 9.0, n_corr=1, eps_floor=None):
    """Always-stable predictor-corrector (Kolafa ASPC) dipole closure.

    Exactly ONE damped SCF iteration applied to the caller-supplied predictor
    mu0 (a B_j-weighted extrapolation of the previous corrected dipoles):
    mu_{t+1} = mu0 + omega * (scf_map(mu0) - mu0), optimal omega =
    (k+2)/(2k+3). Stability comes from approximate time reversibility of the
    predictor/corrector pair, NOT from iterating to self-consistency - a
    plain extrapolated warm start fed into the convergence loop is unstable
    (measured; see bench.py) while this closure is drift-free in NVE.

    Without a predictor (mu0=None, e.g. the cold-start evaluation or any
    one-shot energy call) ASPC is undefined along-trajectory semantics, so
    fall back to the fully converged SOR loop.

    Role analog: the CUDA platform's DIIS (multipoleInducedField.cu:374-482)
    - cutting per-step SCF cost; semantics beyond the reference, which
    always iterates to target_epsilon (cpp:557-616).
    """
    if mu0 is None:
        return scf_induced_dipoles(efield_alpha, alpha, s3, s5, delta,
                                   target_epsilon, max_iterations,
                                   extra_field=extra_field,
                                   eps_floor=eps_floor)
    n = efield_alpha.shape[0]

    # The corrector must be THIS MODEL'S convergent self-consistency
    # iteration - the SOR-damped step (polarSOR * dmu), not the bare Picard
    # map mu -> alpha*E(mu): the Thole-damped water polarization map has
    # spectral radius > 1 (measured 1.12 on thermalized water256; that is
    # precisely why the reference iterates with SOR 0.55,
    # MBPolReferenceElectrostaticsForce.cpp:516-531). A Picard corrector
    # makes the ASPC companion matrix unstable - forces grow ~1.5x/step
    # and the trajectory NaNs within ~60 steps (measured).
    #
    # n_corr > 1 (CP2K convention: n SOR iterations on the predictor, THEN
    # the omega-mix with the predictor) shrinks the dipole lag - the
    # force-closure error that dominates long-horizon f32 NVE drift.
    # n_corr = 1 reduces exactly to Kolafa's mu0 + omega*polarSOR*dmu.
    def one_sor(mu):
        field = _dipole_field(mu, s3, s5, delta)
        if extra_field is not None:
            field = field + extra_field(mu)
        dmu = efield_alpha + field * alpha[:, None] - mu
        return mu + _POLAR_SOR * dmu, dmu

    mu, dmu = one_sor(mu0)
    for _ in range(int(n_corr) - 1):     # static unroll; n_corr is small
        mu, dmu = one_sor(mu)
    mu = omega * mu + (1.0 - omega) * mu0
    # epsilon in the reference's units. No convergence decision is made in
    # ASPC mode, but the health flag must be able to fire (r3 advisor: a
    # hardcoded converged=True hid every in-trajectory instability from
    # report-boundary checks): a healthy ASPC predictor residual sits
    # within ~an order of magnitude of the converged-SOR target, while the
    # documented instabilities (Picard corrector, extrapolated warm start)
    # grow ~1.5x/step - they cross 1000x target within ~20 steps, long
    # before the NaN. The generous factor keeps normal operation (residual
    # above target by design) from tripping Simulation.step's RuntimeError.
    eps = _POLAR_SOR * units.DEBYE * jnp.sqrt(jnp.sum(dmu * dmu) / n)
    healthy = eps < 1e3 * jnp.maximum(target_epsilon, 1e-8)
    return mu, dict(iterations=jnp.ones((), jnp.int32), epsilon=eps,
                    converged=healthy)


def make_scf(params):
    """SCF solver for params.scf_method ('sor' | 'diis' | 'aspc')."""
    floor = getattr(params, 'scf_eps_floor', None)
    if params.scf_method == 'diis':
        return functools.partial(scf_induced_dipoles_diis, eps_floor=floor)
    if params.scf_method == 'aspc':
        return functools.partial(scf_induced_dipoles_aspc,
                                 omega=aspc_omega(params.aspc_k),
                                 n_corr=getattr(params, 'aspc_n_corr', 1),
                                 eps_floor=floor)
    if params.scf_method != 'sor':
        raise ValueError(f'unknown scf_method {params.scf_method!r}')
    return functools.partial(scf_induced_dipoles, eps_floor=floor)


# ----------------------------------------------------------------------
# Cluster (NoCutoff) energy and forces
# ----------------------------------------------------------------------

def cluster_electrostatics(params: ElecParams, positions, mesh=None, mu0=None):
    """Energy (kJ/mol), forces (kJ/mol/nm) and SCF diagnostics.

    positions: [N, 3] nm, including M sites (already placed).
    """
    dtype = positions.dtype
    f = units.ELECTRIC
    t = _pair_tensors(params, positions, mesh=mesh)
    delta, r, u = t['delta'], t['r'], t['u']
    notself, diff_mol = t['notself'], t['diff_mol']

    charges, dq_w = assemble_charges(params, positions)
    alpha = jnp.asarray(params.polarity, dtype)
    th = params.thole

    inv_r = jnp.where(notself, 1.0 / r, 0.0)
    rr1 = inv_r
    rr3 = inv_r ** 3
    rr5 = 3.0 * inv_r ** 5
    rr7 = 15.0 * inv_r ** 7

    s_cc = thole_scales(u, th[TCC], orders=(1, 3))
    s_cd = thole_scales(u, th[TCD], orders=(3, 5))
    s_dd = thole_scales(u, t['gamma_dd'], orders=(3, 5, 7))

    # fixed field (cpp:361-420): damped charge field, same-water excluded
    k3 = jnp.where(diff_mol, rr3 * s_cc[3], 0.0)
    efield = -jnp.einsum('ij,j,ijd->id', k3, charges, delta)

    # SCF (TDD damping, no exclusions, cpp:534-555)
    s3 = jnp.where(notself, -rr3 * s_dd[3], 0.0)
    s5 = jnp.where(notself, rr5 * s_dd[5], 0.0)
    scf = make_scf(params)
    mu, diag = scf(
        efield * alpha[:, None], alpha, s3, s5, delta,
        params.target_epsilon, params.max_iterations, mu0=mu0)

    # ---- energy (cpp:725-732) ----
    mu_dot_d_i = jnp.einsum('id,ijd->ij', mu, delta)        # mu_i . (r_j - r_i)
    mu_dot_d_j = jnp.einsum('jd,ijd->ij', mu, delta)        # mu_j . (r_j - r_i)
    qq = charges[:, None] * charges[None, :]
    gl0 = jnp.where(diff_mol, qq, 0.0)
    gli0 = jnp.where(diff_mol,
                     charges[None, :] * mu_dot_d_i - charges[:, None] * mu_dot_d_j, 0.0)
    e_pair = rr1 * gl0 * s_cc[1] + 0.5 * rr3 * gli0 * s_cd[3]
    energy = 0.5 * f * jnp.sum(jnp.where(notself, e_pair, 0.0))

    # ---- pair forces (cpp:740-770), mu_polar folded in ----
    gf0 = rr3 * gl0 * s_cc[3]
    mumu = mu @ mu.T
    gfi0 = (rr5 * gli0 * s_cd[5]
            + rr5 * mumu * s_dd[5]
            - rr7 * (mu_dot_d_i * mu_dot_d_j) * s_dd[7])
    coeff = jnp.where(notself, gf0 + gfi0, 0.0)
    force_pair = jnp.einsum('ij,ijd->id', coeff, delta)

    w5 = jnp.where(notself, rr5 * s_dd[5], 0.0)
    force_pair = force_pair + jnp.einsum('ij,ij,id->id', w5, mu_dot_d_j, mu) \
                            + jnp.einsum('ij,jd->id', w5 * mu_dot_d_i, mu)

    # (q_i mu_j - q_j mu_i) rr3 s3cd summed over j (cpp:763-770)
    w3 = jnp.where(diff_mol, rr3 * s_cd[3], 0.0)
    force_pair = force_pair + charges[:, None] * (w3 @ mu) - mu * (w3 @ charges)[:, None]

    forces = -f * force_pair

    # ---- charge-derivative forces (cpp:791-827) ----
    if params.include_charge_redistribution and dq_w is not None:
        site_idx = np.stack([params.h1_index, params.h2_index, params.m_index], axis=1)
        # damped potentials at every particle j due to all K not in mol(j)
        # using TCC gamma and justScale orders 1/3 (getAndScaleInverseRs13justScaleTCC)
        sc = thole_scales(u, th[TCC], orders=(1, 3))
        phi1 = jnp.einsum('ij,j->i', jnp.where(diff_mol, sc[1] * rr1, 0.0), charges)
        phimu = jnp.einsum('ij,ij->i', jnp.where(diff_mol, sc[3] * rr3, 0.0), -mu_dot_d_j)
        phi = phi1 + phimu
        nmol = len(params.o_index)
        if bool(np.array_equal(params.o_index, 4 * np.arange(nmol))):
            phi_sites = phi.reshape(nmol, 4)[:, 1:]     # H1, H2, M slots
            f_atoms = -f * jnp.einsum('masd,ms->mad', dq_w, phi_sites)
            pad = jnp.zeros((nmol, 1, 3), phi.dtype)
            forces = forces + jnp.concatenate([f_atoms, pad], axis=1).reshape(-1, 3)
        else:
            phi_sites = phi[site_idx]
            f_atoms = -f * jnp.einsum('masd,ms->mad', dq_w, phi_sites)
            atom_idx = np.stack([params.o_index, params.h1_index, params.h2_index], axis=1)
            forces = forces.at[atom_idx.reshape(-1)].add(f_atoms.reshape(-1, 3))

    return energy, forces, dict(**diag, charges=charges, induced_dipoles=mu)


def system_moments(params: ElecParams, positions, masses):
    """Net charge, dipole and quadrupole moments including induced dipoles,
    in the reference's output convention (13-vector: charge, dipole[3] in
    Debye, traceless quadrupole[9] in Debye*A;
    calculateMBPolSystemElectrostaticsMoments, cpp:923-1021)."""
    energy, forces, diag = cluster_electrostatics(params, positions)
    charges, mu = diag['charges'], diag['induced_dipoles']
    m = jnp.asarray(masses, positions.dtype)
    com = jnp.sum(m[:, None] * positions, axis=0) / jnp.sum(m)
    local = positions - com

    netchg = jnp.sum(charges)
    dpl = jnp.sum(local * charges[:, None] + mu, axis=0)

    def quad(a, b):
        return jnp.sum(local[:, a] * local[:, b] * charges
                       + local[:, a] * mu[:, b] + local[:, b] * mu[:, a])

    xx, yy, zz = quad(0, 0), quad(1, 1), quad(2, 2)
    xy, xz, yz = quad(0, 1), quad(0, 2), quad(1, 2)
    qave = (xx + yy + zz) / 3.0
    debye = 4.80321
    out = jnp.zeros(13, positions.dtype)
    out = out.at[0].set(netchg)
    out = out.at[1:4].set(dpl * 10.0 * debye)
    q = jnp.array([0.5 * (xx - qave), 0.5 * xy, 0.5 * xz,
                   0.5 * xy, 0.5 * (yy - qave), 0.5 * yz,
                   0.5 * xz, 0.5 * yz, 0.5 * (zz - qave)]) * (100.0 * 3.0 * debye)
    out = out.at[4:13].set(q)
    return out


def electrostatic_potential_on_grid(params: ElecParams, positions, grid_points):
    """Electrostatic potential at arbitrary points from charges + induced
    dipoles (calculateElectrostaticPotential, cpp:1023-1086). Returns
    kJ/mol/e values, [n_grid]."""
    energy, forces, diag = cluster_electrostatics(params, positions)
    charges, mu = diag['charges'], diag['induced_dipoles']
    delta = positions[None, :, :] - grid_points[:, None, :]      # particle - grid
    r2 = jnp.sum(delta * delta, axis=-1)
    r = jnp.sqrt(r2)
    pot = charges[None, :] / r
    pot = pot - jnp.einsum('jd,gjd->gj', mu, delta) / (r2 * r)
    return units.ELECTRIC * jnp.sum(pot, axis=1)
