"""Multi-device capacity planning: the one place that answers "what does an
(n_devices, N)-water run look like" before any device executes.

The padded-list capacities are trace-time constants (static shapes), so a
sharded run must size them up front: per-device pair/triplet batch rows,
the molecule-pair lists, the PME grid, and the dominant per-device memory
terms. MBPol's
`tune_capacities` does this for a live potential from real positions; the
planner does the same arithmetic standalone - analytic density bounds when
no positions exist yet, exact native voxel-hash counts when they do - and
`apply()` pushes the result into a constructed potential so a multi-chip
run starts at the tuned operating point instead of the conservative
analytic fallback.

Role vs the reference: the CUDA platform sizes its triplet buffers with a
fixed heuristic + overflow re-try (maxNeighborPairs = 150*numParticles/3,
CudaMBPolKernels.cpp:1787); here sizing is explicit, reported, and chosen
before compilation because XLA shapes are static.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from mbpol_openmm_plugin_tpu.ops import neighbors


def _round_up(n, k):
    return ((n + k - 1) // k) * k


@dataclasses.dataclass
class CapacityPlan:
    """Static shape parameters for an (n_devices, n_waters) run."""
    n_waters: int
    n_devices: int
    box: tuple
    elec_mode: str
    disp_mode: str
    # padded-list capacities (global; each a multiple of n_devices)
    pair_cap: int
    trip_cap: int
    # compacted evaluation buffers, sized at the PHYSICAL cutoffs (no skin;
    # tune_capacities semantics - r3 advisor: planning them at the
    # skin-inflated list capacities oversized every compacted PIP batch)
    pair_eval_cap: int
    trip_eval_cap: int
    nlist_k_max: int
    nlist_kt: Optional[int]
    elec_pair_cap: Optional[int]          # sparse mode
    disp_pair_cap: Optional[int]          # pairs mode (non-shared)
    pme_grid: Optional[tuple]
    exact: bool                           # counts from positions vs analytic
    mem_per_device_mb: float

    def per_device(self):
        nd = self.n_devices
        out = dict(pair_rows=self.pair_cap // nd,
                   triplet_rows=self.trip_cap // nd,
                   sites=_round_up(4 * self.n_waters, nd) // nd)
        if self.elec_pair_cap:
            out['elec_pair_rows'] = self.elec_pair_cap // nd
        return out

    def describe(self):
        lines = [
            f'plan: water{self.n_waters} on {self.n_devices} device(s), '
            f'box {tuple(round(float(b), 3) for b in self.box)} nm '
            f'({"exact counts" if self.exact else "analytic bounds"})',
            f'  electrostatics mode: {self.elec_mode}   dispersion: '
            f'{self.disp_mode}   PME grid: {self.pme_grid}',
            f'  pair capacity {self.pair_cap}  triplet capacity '
            f'{self.trip_cap}  (k_max {self.nlist_k_max}, kt {self.nlist_kt})',
            f'  eval buffers (physical cutoffs): pairs {self.pair_eval_cap} '
            f' triplets {self.trip_eval_cap}',
        ]
        if self.elec_pair_cap:
            lines.append(f'  elec molecule-pair capacity {self.elec_pair_cap}')
        lines.append('  per device: ' + '  '.join(
            f'{k}={v}' for k, v in self.per_device().items()))
        lines.append(f'  est. working set ~{self.mem_per_device_mb:.0f} '
                     'MB/device (f32 elec+PIP+PME dominant terms)')
        return '\n'.join(lines)

    def apply(self, pot):
        """DEPRECATED: build the potential with the plan instead -
        ``MBPol(system, config, mesh=mesh, plan=plan)``. This shim
        constructs that potential for you (it does NOT mutate `pot`);
        use the return value."""
        import warnings
        warnings.warn(
            'CapacityPlan.apply(pot) is deprecated; pass the plan to the '
            'constructor: MBPol(system, config, mesh=mesh, plan=plan)',
            DeprecationWarning, stacklevel=2)
        return type(pot)(pot.system, pot.config, mesh=pot.mesh, plan=self)


def plan_capacities(n_waters, box, n_devices=1, config=None, positions=None,
                    margin=1.15):
    """Size every static shape for an (n_devices, n_waters) run.

    positions: optional [4*n_waters, 3] nm array - when given, pair/triplet
    counts come from the native O(N) voxel hash at these positions
    (tune_capacities semantics: margin * actual + slack); otherwise from
    the analytic density bounds (neighbors.pair_capacity/triplet_capacity,
    conservative by design).
    """
    from mbpol_openmm_plugin_tpu.models.potential import (
        MBPolConfig, electrostatics_mode_for)
    cfg = config or MBPolConfig(nonbonded_method='PME', cutoff=0.9,
                                nlist_skin=0.02)
    box = np.asarray(box, np.float64)
    skin = cfg.nlist_skin
    f = cfg.neighbor_capacity_factor
    exact = positions is not None

    if exact:
        from mbpol_openmm_plugin_tpu.ops import native
        o = np.asarray(positions).reshape(-1, 3)[0::4]
        o = o - np.floor(o / box) * box
        _, n_p = native.pair_list(o, box, cfg.cutoff_2b + skin)
        trips_np, n_t = native.triplet_list(o, box, cfg.cutoff_3b + skin)
        pair_cap = max(int(margin * n_p) + 16, 64)
        trip_cap = max(int(margin * n_t) + 32, 128)
        pairs3, _ = native.pair_list(o, box, cfg.cutoff_3b + skin)
        max_nbr = (int(np.bincount(pairs3.ravel(), minlength=n_waters).max())
                   if len(pairs3) else 0)
        # per-center factors scale with margin like the global caps
        # (tune_capacities semantics; see models/potential.py)
        f_k = max(1.3, float(margin))
        f_kt = max(1.4, float(margin))
        k_max = min(max(int(np.ceil(f_k * max_nbr)) + 2, 8),
                    max(n_waters - 1, 1))
        max_ct = (int(np.bincount(trips_np[:, 1], minlength=n_waters).max())
                  if len(trips_np) else 0)
        kt = min(int(np.ceil(f_kt * max_ct)) + 8, k_max * (k_max - 1) // 2)
        # compacted eval buffers: physical cutoffs (per-step compaction)
        # or cutoff + skin/2 (rebuild-time compaction)
        ce_half = 0.5 * skin if cfg.compact_eval == 'rebuild' else 0.0
        _, n_pe = native.pair_list(o, box, cfg.cutoff_2b + ce_half)
        _, n_te = native.triplet_list(o, box, cfg.cutoff_3b + ce_half)
        pair_eval_cap = min(max(int(margin * n_pe) + 16, 64), pair_cap)
        trip_eval_cap = min(max(int(margin * n_te) + 32, 128), trip_cap)
    else:
        pair_cap = neighbors.pair_capacity(n_waters, box,
                                           cfg.cutoff_2b + skin, factor=f)
        trip_cap = neighbors.triplet_capacity(n_waters, box,
                                              cfg.cutoff_3b + skin, factor=f)
        k_max = neighbors.max_neighbors(n_waters, box, cfg.cutoff_3b + skin)
        kt = None
        ce_half = 0.5 * skin if cfg.compact_eval == 'rebuild' else 0.0
        pair_eval_cap = min(neighbors.pair_capacity(
            n_waters, box, cfg.cutoff_2b + ce_half, factor=f), pair_cap)
        trip_eval_cap = min(neighbors.triplet_capacity(
            n_waters, box, cfg.cutoff_3b + ce_half, factor=f), trip_cap)
    pair_cap = _round_up(pair_cap, n_devices)
    trip_cap = _round_up(trip_cap, n_devices)
    pair_eval_cap = _round_up(pair_eval_cap, n_devices)
    trip_eval_cap = _round_up(trip_eval_cap, n_devices)

    # electrostatics mode (MBPol.__init__ policy)
    is_pme = cfg.nonbonded_method == 'PME'
    mode = electrostatics_mode_for(cfg, n_waters)
    dmode = cfg.dispersion_mode
    if dmode == 'auto':
        dmode = 'pairs' if mode == 'sparse' else 'dense'

    elec_pair_cap = disp_pair_cap = None
    n_sites = 4 * n_waters
    if mode == 'sparse' or dmode == 'pairs':
        from mbpol_openmm_plugin_tpu.models import pme_sparse
        cut = cfg.cutoff + pme_sparse.PAIR_MARGIN + skin
        if exact:
            from mbpol_openmm_plugin_tpu.ops import native
            _, n_e = native.pair_list(o, box, cut)
            cap = max(int(margin * n_e) + 16, 64)
        else:
            cap = neighbors.pair_capacity(n_waters, box, cut, factor=f)
        cap = _round_up(cap, n_devices)
        if mode == 'sparse':
            elec_pair_cap = cap      # shared with the dispersion pair list
        else:
            disp_pair_cap = cap
    pme_grid = None
    if is_pme:
        if cfg.pme_grid is not None:
            pme_grid = tuple(cfg.pme_grid)
        else:
            # PmeSetup.from_config formula (OpenMM calcPMEParameters,
            # MBPolReferenceKernels.cpp:186-197)
            tol = cfg.ewald_error_tolerance
            alpha = cfg.ewald_alpha or float(
                np.sqrt(-np.log(2.0 * tol)) / cfg.cutoff)
            pme_grid = tuple(int(np.ceil(2.0 * alpha * b
                                         / (3.0 * tol ** 0.2)))
                             for b in box)

    # dominant per-device working-set terms, f32 (coarse roofline input):
    # dense elec: (npad/nd) x npad x 3 scale tensors
    # PIPs: pair rows x 528 basis + triplet rows x 703 basis (+ quadratic
    # factor intermediates ~4x); PME: site-spline matrices (n_sites x grid
    # dim per axis) + 2 complex grids
    mb = 0.0
    npad_s = _round_up(n_sites, n_devices)
    if mode == 'dense':
        mb += (npad_s // n_devices) * npad_s * 4 * 3 / 1e6
    elif elec_pair_cap:
        mb += elec_pair_cap // n_devices * 9 * 16 * 4 / 1e6
    mb += (pair_cap // n_devices) * 528 * 4 * 4 / 1e6
    mb += (trip_cap // n_devices) * 703 * 4 * 4 / 1e6
    if pme_grid:
        nx, ny, nz = pme_grid
        mb += 2 * nx * ny * nz * 8 / 1e6
        mb += 3 * (n_sites // n_devices) * max(pme_grid) * 4 * 2 / 1e6

    return CapacityPlan(
        n_waters=int(n_waters), n_devices=int(n_devices),
        box=tuple(float(b) for b in box), elec_mode=mode, disp_mode=dmode,
        pair_cap=int(pair_cap), trip_cap=int(trip_cap),
        pair_eval_cap=int(pair_eval_cap), trip_eval_cap=int(trip_eval_cap),
        nlist_k_max=int(k_max), nlist_kt=None if kt is None else int(kt),
        elec_pair_cap=elec_pair_cap, disp_pair_cap=disp_pair_cap,
        pme_grid=pme_grid, exact=exact,
        mem_per_device_mb=float(mb))
