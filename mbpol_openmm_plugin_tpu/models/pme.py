"""PME electrostatics: periodic many-body polarization.

Reference algorithm (MBPolReferencePmeElectrostaticsForce,
MBPolReferenceElectrostaticsForce.cpp:1095-2777):
  - order-5 B-spline charge spreading onto a 3D grid, forward FFT,
    reciprocal convolution with B-spline moduli and exp(-pi^2 m^2/alpha^2),
    backward FFT, potential + derivative read-back at the atom sites,
  - direct-space Ewald pair terms (erfc-damped bn0..bn3) combined with the
    Thole-damped correction factors; same-water pairs keep only the
    reciprocal-correction part (scale factors zeroed, cpp:2605-2613),
  - induced-dipole SCF with direct + reciprocal + self field contributions,
  - self energy, and charge-derivative forces from the accumulated per-site
    potential (direct + recip fixed + recip induced + self) contracted with
    dq/dr (cpp:2767-2773).

Design notes:
  * charge/dipole spreading and potential read-back are dense matmuls over
    separable one-hot spline matrices (_spline_matrices).
  * the FFT is jnp.fft (cuFFT on a GPU); the backward transform follows the
    unnormalized-sum convention of the reference's fftpack (ifftn * Ntot).
  * the vestigial "polar" dipole copy is folded out (mu_polar == mu, see
    models/electrostatics.py); the reference's re/im spreading trick for the
    two dipole sets degenerates to a single real grid.
  * only the charge rows of the multipole tables are evaluated (MB-pol
    carries no permanent dipoles/quadrupoles; the reference's k<10 loops
    with uninitialized multipole[1..9] reduce to the k=0 charge terms).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from mbpol_openmm_plugin_tpu.models import electrostatics as elec
from mbpol_openmm_plugin_tpu.ops.bspline import ORDER, bspline5, bspline_moduli
from mbpol_openmm_plugin_tpu.utils import units

_SQRT_PI = np.sqrt(np.pi)


@dataclasses.dataclass(frozen=True)
class PmeSetup:
    """Static PME configuration."""
    alpha: float                 # Ewald splitting parameter, 1/nm
    grid: tuple                  # (nx, ny, nz)
    cutoff: float                # direct-space cutoff, nm
    box: tuple                   # (lx, ly, lz) nm

    @classmethod
    def from_config(cls, system, config):
        """Auto-derive alpha/grid from the Ewald error tolerance, following
        OpenMM's NonbondedForceImpl::calcPMEParameters (used by the reference
        kernel when unset, MBPolReferenceKernels.cpp:186-197)."""
        tol = config.ewald_error_tolerance
        cutoff = config.cutoff
        box = tuple(float(b) for b in system.box)
        alpha = config.ewald_alpha
        if alpha is None:
            alpha = np.sqrt(-np.log(2.0 * tol)) / cutoff
        grid = config.pme_grid
        if grid is None:
            grid = tuple(int(np.ceil(2.0 * alpha * b / (3.0 * tol ** 0.2)))
                         for b in box)
        return cls(alpha=float(alpha), grid=tuple(grid), cutoff=float(cutoff), box=box)


# ----------------------------------------------------------------------
# Grid machinery
# ----------------------------------------------------------------------

_NDERIV = 3   # spline value + 1st + 2nd derivative (all that charges need)


def _spline_matrices(setup: PmeSetup, positions, box=None, mesh=None):
    """Separable one-hot spline matrices.

    Returns (Sx [N, nx, 3], Sy [N, ny, 3], Sz [N, nz, 3]) with
    S[n, g, d] = d-th derivative coefficient of atom n's order-5 B-spline at
    grid line g (zero outside the atom's 5-point support; periodic wrap).

    This turns both charge/dipole spreading and potential read-back into
    dense matmuls.

    Under a `mesh` the site dimension carries a 'dp' sharding constraint,
    which shards the whole reciprocal grid pipeline: spreading contracts
    the sharded site dim (per-device partial grids + one psum of the tiny
    [nx,ny,nz] grid), the convolution runs replicated (noise-level
    cost), and read-back is row-parallel in the sites with no collective.
    """
    dims = jnp.asarray(setup.grid)
    box = jnp.asarray(setup.box if box is None else box, positions.dtype)
    pos = positions - jnp.floor(positions / box + 0.5) * box
    w = pos / box                                 # in [-0.5, 0.5)
    fr = dims * (w + 0.5)
    ifr = jnp.floor(fr)
    wfrac = fr - ifr
    igrid = jnp.mod(ifr.astype(jnp.int32) - (ORDER - 1), dims)
    theta = bspline5(wfrac)[..., :_NDERIV]        # [N, 3, 5, 3]

    out = []
    off = np.arange(ORDER)
    for axis, nax in enumerate(setup.grid):
        lines = jnp.mod(igrid[:, axis:axis + 1] + off[None], nax)     # [N, 5]
        onehot = (lines[:, :, None] ==
                  jnp.arange(nax)[None, None, :]).astype(positions.dtype)
        out.append(jnp.einsum('nkg,nkd->ngd', onehot, theta[:, axis]))
    if mesh is not None:
        from mbpol_openmm_plugin_tpu.parallel import mesh as M
        out = [M.constrain(a, M.row_sharded(mesh)) for a in out]
    return tuple(out)


# The separable formulation materializes [chunk, ny, nz] (spread) and
# [chunk, 3, ny, nz] (readback) temporaries. Single-shot at water256
# (~MBs) they are free; at 32k sites x 106^2 grid lines they are 1.5-4.4
# GB each and exhaust device memory, so above this element budget the site
# dimension is chunked under an accumulating scan (spread) / lax.map
# (readback). Budget 2^26 f32 elements = 256 MB per temporary.
_SEP_CHUNK_ELEMS = 1 << 26


def _sep_chunk(n, per_site_elems):
    import math
    if n * per_site_elems <= _SEP_CHUNK_ELEMS:
        return n
    c = max(_SEP_CHUNK_ELEMS // per_site_elems, 256)
    return min(int(c), n)


def _pad_rows(a, rows):
    if a.shape[0] == rows:
        return a
    return jnp.zeros((rows,) + a.shape[1:], a.dtype).at[:a.shape[0]].set(a)


def _spread_separable(setup, wx, sy, sz):
    """grid[g,h,k] = sum_n wx[n,g] sy[n,h] sz[n,k] as two matmuls
    (site-chunked above the temp-memory budget; padded rows are zero in
    wx, so they contribute nothing)."""
    nx, ny, nz = setup.grid
    n = wx.shape[0]
    c = _sep_chunk(n, ny * nz)
    if c >= n:
        a = jnp.einsum('nh,nk->nhk', sy, sz).reshape(n, ny * nz)
        return (wx.T @ a).reshape(nx, ny, nz)
    k = -(-n // c)
    wx3 = _pad_rows(wx, k * c).reshape(k, c, nx)
    sy3 = _pad_rows(sy, k * c).reshape(k, c, ny)
    sz3 = _pad_rows(sz, k * c).reshape(k, c, nz)

    def body(acc, args):
        wxc, syc, szc = args
        a = jnp.einsum('nh,nk->nhk', syc, szc).reshape(c, ny * nz)
        return acc + (wxc.T @ a).reshape(nx, ny, nz), None

    grid, _ = jax.lax.scan(body, jnp.zeros((nx, ny, nz), wx.dtype),
                           (wx3, sy3, sz3))
    return grid


def _readback_separable(grid, Sx, Sy, Sz):
    """P[n,a,b,c] = sum_{ghk} grid[g,h,k] Sx[n,g,a] Sy[n,h,b] Sz[n,k,c],
    a,b,c < 3 (value/1st/2nd fractional derivatives). Three batched
    matmuls, site-chunked above the temp-memory budget."""
    n = Sx.shape[0]
    nx, ny, nz = grid.shape
    g2 = grid.reshape(nx, ny * nz)

    def block(Sxc, Syc, Szc):
        m = Sxc.shape[0]
        t1 = (Sxc.transpose(0, 2, 1).reshape(m * _NDERIV, nx) @ g2)
        t1 = t1.reshape(m, _NDERIV, ny, nz)
        t2 = jnp.einsum('nahk,nhb->nabk', t1, Syc)
        return jnp.einsum('nabk,nkc->nabc', t2, Szc)

    c = _sep_chunk(n, _NDERIV * ny * nz)
    if c >= n:
        return block(Sx, Sy, Sz)
    k = -(-n // c)
    Sx3 = _pad_rows(Sx, k * c).reshape(k, c, nx, _NDERIV)
    Sy3 = _pad_rows(Sy, k * c).reshape(k, c, ny, _NDERIV)
    Sz3 = _pad_rows(Sz, k * c).reshape(k, c, nz, _NDERIV)
    out = jax.lax.map(lambda a: block(*a), (Sx3, Sy3, Sz3))
    return out.reshape(k * c, _NDERIV, _NDERIV, _NDERIV)[:n]


def _readback_phi10(grid, Sx, Sy, Sz):
    """phi10[n,q] = sum_{ghk} grid[g,h,k] Sx[n,g,a_q] Sy[n,h,b_q] Sz[n,k,c_q]
    for the 10 needed (a,b,c) derivative components (_PHI_COMP layout).

    Performance-critical formulation: the P-tensor form
    (_readback_separable + _phi10) lowers its h/k contractions to per-site
    batched [27,27]@[27,3] matmuls - thousands of tiny, padded matmuls.
    Here the z contraction is three well-shaped [n, nz] @ [nz, nx*ny]
    matmuls and the y/x contractions are elementwise multiply-reduces.
    Site-chunked above the temp-memory budget like the other separable
    pieces."""
    n = Sx.shape[0]
    nx, ny, nz = grid.shape
    gz = grid.reshape(nx * ny, nz).T                      # [nz, nx*ny]
    pairs = sorted({(b, c) for _, b, c in _PHI_COMP})

    def block(Sxc, Syc, Szc):
        m = Sxc.shape[0]
        t1 = [(Szc[:, :, c] @ gz).reshape(m, nx, ny) for c in range(_NDERIV)]
        t2 = {(b, c): jnp.sum(t1[c] * Syc[:, None, :, b], axis=-1)
              for (b, c) in pairs}
        return jnp.stack([jnp.sum(t2[(b, c)] * Sxc[:, :, a], axis=-1)
                          for a, b, c in _PHI_COMP], axis=-1)

    c = _sep_chunk(n, _NDERIV * nx * ny)
    if c >= n:
        return block(Sx, Sy, Sz)
    k = -(-n // c)
    Sx3 = _pad_rows(Sx, k * c).reshape(k, c, nx, _NDERIV)
    Sy3 = _pad_rows(Sy, k * c).reshape(k, c, ny, _NDERIV)
    Sz3 = _pad_rows(Sz, k * c).reshape(k, c, nz, _NDERIV)
    out = jax.lax.map(lambda a: block(*a), (Sx3, Sy3, Sz3))
    return out.reshape(k * c, len(_PHI_COMP))[:n]


def _convolve(setup: PmeSetup, grid, dtype, box=None):
    """Forward FFT, reciprocal eterm multiply, backward (unnormalized) FFT.
    (performMBPolReciprocalConvolution, cpp:1676-1713). The eterm is a cheap
    elementwise function of the (possibly traced) box, so NPT volume moves
    work without recompilation."""
    nx, ny, nz = setup.grid
    et = _eterm(setup, grid.dtype if box is None else None, box)
    ntot = nx * ny * nz
    gk = jnp.fft.fftn(grid)
    gk = gk * et
    # real input, real symmetric kernel -> real result (unnormalized backward)
    return jnp.real(jnp.fft.ifftn(gk) * ntot)


@functools.lru_cache(maxsize=None)
def _eterm_static(setup: PmeSetup):
    """(m-vector grids and B-spline modulus product; box-independent.)"""
    nx, ny, nz = setup.grid
    mods = bspline_moduli(setup.grid)
    def mvec(k, n):
        k = np.arange(n)
        return np.where(k < (n + 1) // 2, k, k - n).astype(np.float64)
    mx, my, mz = mvec(None, nx), mvec(None, ny), mvec(None, nz)
    b = mods[0][:, None, None] * mods[1][None, :, None] * mods[2][None, None, :]
    # return 1/b: near the Nyquist modes of an odd-order spline the zeta
    # correction makes b huge (~1e51 for the 3D product), which overflows a
    # float32 cast to inf; the reciprocal instead underflows cleanly to 0,
    # the correct eterm limit for those modes
    return mx, my, mz, 1.0 / b


def _eterm(setup: PmeSetup, dtype=None, box=None):
    mx, my, mz, binv = _eterm_static(setup)
    box = np.asarray(setup.box) if box is None else box
    alpha = setup.alpha
    mhx = jnp.asarray(mx) / box[0]
    mhy = jnp.asarray(my) / box[1]
    mhz = jnp.asarray(mz) / box[2]
    m2 = (mhx[:, None, None] ** 2 + mhy[None, :, None] ** 2
          + mhz[None, None, :] ** 2)
    expfac = np.pi * np.pi / (alpha * alpha)
    scale = 1.0 / (np.pi * box[0] * box[1] * box[2])
    m2safe = jnp.where(m2 > 0, m2, 1.0)
    et = scale * jnp.exp(-expfac * m2safe) / m2safe * jnp.asarray(binv)
    return jnp.where(m2 > 0, et, 0.0)


# phi component layout of the reference (cpp:1800-1819):
# 0:000 1:100 2:010 3:001 4:200 5:020 6:002 7:110 8:101 9:011
_PHI_COMP = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (2, 0, 0),
             (0, 2, 0), (0, 0, 2), (1, 1, 0), (1, 0, 1), (0, 1, 1)]


def _phi10(P):
    return jnp.stack([P[:, a, b, c] for a, b, c in _PHI_COMP], axis=-1)


# Hessian component indices into phi10, per force dim (deriv1/2/3 tables)
_HESS = np.array([[4, 7, 8], [7, 5, 9], [8, 9, 6]])


# ----------------------------------------------------------------------
# Main evaluation
# ----------------------------------------------------------------------

def _bn_factors(alpha, r, inv_r, orders=4):
    """Ewald real-space bn0..bn3 (ewaldScalingReal, cpp:219-259)."""
    ralpha = alpha * r
    bn = [jax.scipy.special.erfc(ralpha) * inv_r]
    alsq2 = 2.0 * alpha * alpha
    alsq2n = 1.0 / (_SQRT_PI * alpha)
    exp2a = jnp.exp(-(ralpha * ralpha))
    inv_r2 = inv_r * inv_r
    for n in range(1, orders):
        alsq2n = alsq2n * alsq2
        bn.append((float(2 * n - 1) * bn[-1] + alsq2n * exp2a) * inv_r2)
    return bn


def pme_electrostatics(params: elec.ElecParams, setup: PmeSetup, positions,
                       mesh=None, mu0=None, box=None):
    """PME energy (kJ/mol), forces (kJ/mol/nm), diagnostics.

    positions: [N,3] nm with M sites placed. `mesh` row-shards the dense
    direct-space tensors across the 'dp' axis (see parallel/mesh.py).
    """
    dtype = positions.dtype
    f_elec = units.ELECTRIC
    alpha = setup.alpha
    n = len(params.damping)
    box = np.asarray(setup.box) if box is None else box
    pscale = jnp.asarray(np.asarray(setup.grid), dtype) / jnp.asarray(box, dtype)

    charges, dq_w = elec.assemble_charges(params, positions)
    alpha_pol = jnp.asarray(params.polarity, dtype)
    th = params.thole

    with jax.named_scope('elec_direct'):
        # ---- pair tensors (minimum image, cutoff) ----
        t = elec._pair_tensors(params, positions,
                               periodic_delta=lambda d: d - jnp.floor(
                                   d / jnp.asarray(box, dtype) + 0.5) * jnp.asarray(box, dtype),
                               mesh=mesh)
        delta, r, u = t['delta'], t['r'], t['u']
        notself, same_mol = t['notself'], t['same_mol']
        r2 = r * r
        within = notself & (r2 <= setup.cutoff * setup.cutoff)

        inv_r = jnp.where(notself, 1.0 / r, 0.0)
        rr1 = inv_r
        rr3 = inv_r ** 3
        rr5 = 3.0 * inv_r ** 5
        rr7 = 15.0 * inv_r ** 7
        bn0, bn1, bn2, bn3 = [jnp.where(within, b, 0.0)
                              for b in _bn_factors(alpha, r, inv_r)]
        rr1c = jnp.where(within, rr1, 0.0)
        rr3c = jnp.where(within, rr3, 0.0)
        rr5c = jnp.where(within, rr5, 0.0)
        rr7c = jnp.where(within, rr7, 0.0)

        s_cc = elec.thole_scales(u, th[elec.TCC], orders=(1, 3))
        s_cd = elec.thole_scales(u, th[elec.TCD], orders=(3, 5))
        s_dd = elec.thole_scales(u, t['gamma_dd'], orders=(3, 5, 7))

    # ---- grid machinery (separable spline matrices; matmuls only) ----
    Sx, Sy, Sz = _spline_matrices(setup, positions, box=box, mesh=mesh)
    sx0, sy0, sz0 = Sx[..., 0], Sy[..., 0], Sz[..., 0]
    sx1, sy1, sz1 = Sx[..., 1], Sy[..., 1], Sz[..., 1]

    def fixed_grid_phi():
        grid = _spread_separable(setup, charges[:, None] * sx0, sy0, sz0)
        conv = _convolve(setup, grid, dtype, box=box)
        return _readback_phi10(conv, Sx, Sy, Sz)

    phi = fixed_grid_phi()                                # [N,10]

    # ---- fixed field: reciprocal + direct + (no self for charges) ----
    efield = -pscale[None, :] * phi[:, 1:4]               # recordFixedElectrostaticsField
    with jax.named_scope('elec_direct'):
        # direct space (calculateFixedElectrostaticsFieldPairIxn PME, cpp:1342-1407)
        # Cross-water damping correction sign FIXED vs the reference
        # (cpp:1386-1388, marked "FIXME verify this" there): the reference
        # uses kdir = bn1 - (s3-1)*rr3, i.e. bn1 + (1-s3)*rr3, which makes
        # the SCF's fixed-field OPERATOR disagree with the energy's q-mu
        # coupling (bn1 - rr3*(1-s3cd), e_pair below) - a force/energy
        # inconsistency of ~3% of the total electrostatic force at
        # water256 (first order in mu, concentrated on Thole-damped
        # H-bond pairs) that heats f32 NVE. With the
        # sign fixed the PME fixed field also matches the cluster field
        # (lambda3*rr3) in the alpha->0 huge-box limit, which the
        # reference's own formula does not for damped pairs. Same-water
        # pairs keep the full-removal limit bn1 - rr3 (s := 0 here; the
        # reference encodes the same limit via its s3 := 2 hack).
        s3cc_field = jnp.where(same_mol, 0.0, s_cc[3])
        kdir = bn1 - (1.0 - s3cc_field) * rr3c
        kdir = jnp.where(within, kdir, 0.0)
        efield = efield - jnp.einsum('ij,j,ijd->id', kdir, charges, delta)

        # SCF dipole-dipole prefactors
        s3_dir = jnp.where(within, (1.0 - s_dd[3]) * rr3c - bn1, 0.0)   # preFactor1
        s5_dir = jnp.where(within, bn2 - (1.0 - s_dd[5]) * rr5c, 0.0)   # preFactor2
    self_term = (4.0 / 3.0) * alpha ** 3 / _SQRT_PI

    def mu_recip_phi(mu):
        """Reciprocal-space phi10 of the dipole grid. The three derivative
        sources spread as ONE concatenated matmul (same FLOPs, one launch)."""
        smu = mu * pscale[None, :]
        wx = jnp.concatenate([smu[:, 0:1] * sx1, smu[:, 1:2] * sx0,
                              smu[:, 2:3] * sx0], axis=0)
        sy = jnp.concatenate([sy0, sy1, sy0], axis=0)
        sz = jnp.concatenate([sz0, sz0, sz1], axis=0)
        grid = _spread_separable(setup, wx, sy, sz)
        conv = _convolve(setup, grid, dtype, box=box)
        return _readback_phi10(conv, Sx, Sy, Sz)

    def extra_field(mu):
        phid = mu_recip_phi(mu)
        return -pscale[None, :] * phid[:, 1:4] + self_term * mu

    scf = elec.make_scf(params)
    mu, diag = scf(
        efield * alpha_pol[:, None], alpha_pol, s3_dir, s5_dir, delta,
        params.target_epsilon, params.max_iterations, extra_field=extra_field,
        mu0=mu0)

    with jax.named_scope('elec_direct'):
        # ---- direct-space energy/forces/potential ----
        mu_dot_d_i = jnp.einsum('id,ijd->ij', mu, delta)
        mu_dot_d_j = jnp.einsum('jd,ijd->ij', mu, delta)
        qq = charges[:, None] * charges[None, :]
        gli1 = charges[None, :] * mu_dot_d_i - charges[:, None] * mu_dot_d_j
        mumu = mu @ mu.T

        s1cc_e = jnp.where(same_mol, 0.0, s_cc[1])
        s3cd_e = jnp.where(same_mol, 0.0, s_cd[3])
        s3cc_f = jnp.where(same_mol, 0.0, s_cc[3])
        s5cd_f = jnp.where(same_mol, 0.0, s_cd[5])

        e_pair = (bn0 - rr1c * (1.0 - s1cc_e)) * qq \
            + 0.5 * (bn1 - rr3c * (1.0 - s3cd_e)) * gli1
        e_direct = 0.5 * jnp.sum(jnp.where(within, e_pair, 0.0))

        coeff = (bn1 - (1.0 - s3cc_f) * rr3c) * qq \
            + (bn2 - rr5c * (1.0 - s5cd_f)) * gli1 \
            + (bn2 - rr5c * (1.0 - s_dd[5])) * mumu \
            - (bn3 - rr7c * (1.0 - s_dd[7])) * (mu_dot_d_i * mu_dot_d_j)
        coeff = jnp.where(within, coeff, 0.0)
        force_pair = jnp.einsum('ij,ijd->id', coeff, delta)

        w5 = jnp.where(within, bn2 - rr5c * (1.0 - s_dd[5]), 0.0)
        force_pair = force_pair + mu * jnp.sum(w5 * mu_dot_d_j, axis=1)[:, None] \
                                + (w5 * mu_dot_d_i) @ mu
        w3 = jnp.where(within, bn1 - rr3c * (1.0 - s3cd_e), 0.0)
        force_pair = force_pair + charges[:, None] * (w3 @ mu) - mu * (w3 @ charges)[:, None]

        forces = -f_elec * force_pair

        # per-site potential, direct part (cpp:2622-2626)
        k1 = jnp.where(within, bn0 - rr1c * (1.0 - s1cc_e), 0.0)
        k3 = jnp.where(within, bn1 - rr3c * (1.0 - s3cd_e), 0.0)
        pot = k1 @ charges - jnp.sum(k3 * mu_dot_d_j, axis=1)

    # ---- reciprocal fixed (cpp:2113-2181) ----
    e_recip_fixed = 0.5 * jnp.sum(charges * phi[:, 0])
    forces = forces - f_elec * (charges[:, None] * phi[:, 1:4] * pscale[None, :])
    pot = pot + phi[:, 0]

    # ---- reciprocal induced (cpp:2186-2265) ----
    phid = mu_recip_phi(mu)
    e_recip_ind = 0.5 * jnp.sum((mu * pscale[None, :]) * phi[:, 1:4])
    hess_fixed = phi[:, _HESS]                       # [N, 3(d), 3(k)]
    hess_ind = phid[:, _HESS]
    smu = mu * pscale[None, :]
    f_ind = 2.0 * jnp.einsum('ndk,nk->nd', hess_fixed + hess_ind, smu)
    f_ind = f_ind + 2.0 * charges[:, None] * phid[:, 1:4]
    forces = forces - 0.5 * f_elec * pscale[None, :] * f_ind
    pot = pot + phid[:, 0]      # 0.5 * phidp[0] with phidp = 2*phid

    # ---- self (cpp:2472-2508) ----
    e_self = -(alpha / _SQRT_PI) * jnp.sum(charges * charges)
    pot = pot + charges * (-2.0 * alpha / _SQRT_PI)

    # ---- charge-derivative forces (cpp:2767-2773) ----
    if params.include_charge_redistribution and dq_w is not None:
        nmol = len(params.o_index)
        if bool(np.array_equal(params.o_index, 4 * np.arange(nmol))):
            phi_sites = pot.reshape(nmol, 4)[:, 1:]
            f_atoms = -f_elec * jnp.einsum('masd,ms->mad', dq_w, phi_sites)
            pad = jnp.zeros((nmol, 1, 3), pot.dtype)
            forces = forces + jnp.concatenate([f_atoms, pad], axis=1).reshape(-1, 3)
        else:
            site_idx = np.stack([params.h1_index, params.h2_index, params.m_index], axis=1)
            phi_sites = pot[site_idx]
            f_atoms = -f_elec * jnp.einsum('masd,ms->mad', dq_w, phi_sites)
            atom_idx = np.stack([params.o_index, params.h1_index, params.h2_index], axis=1)
            forces = forces.at[atom_idx.reshape(-1)].add(f_atoms.reshape(-1, 3))

    energy = f_elec * (e_direct + e_recip_fixed + e_recip_ind + e_self)
    # per-site accumulated potential (direct + recip fixed + recip induced
    # + self), the quantity contracted with dq/dr for the charge-derivative
    # forces (cpp:2767-2773) - exposed for the dE/dq_s = phi_s consistency
    # probe (tools/force_consistency.py) and potential diagnostics
    return energy, forces, dict(**diag, charges=charges, induced_dipoles=mu,
                                site_potential=pot)
