"""The full MB-pol potential: assembly of all five force terms.

Replaces the reference's OpenMM System + per-force kernel dispatch
(MBPolReferenceKernels.cpp) with a single jittable function: positions of the
real atoms in, per-term energies and total forces out. Virtual M sites are
placed inside the function, so autodiff distributes their forces to the
parent atoms exactly like OpenMM's virtual-site force redistribution; the
explicitly-computed electrostatic forces are redistributed with the same
average3 weights.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mbpol_openmm_plugin_tpu import data as _data
from mbpol_openmm_plugin_tpu.models import electrostatics as elec
from mbpol_openmm_plugin_tpu.models import pme as pme_mod
from mbpol_openmm_plugin_tpu.models import dispersion as disp_mod
from mbpol_openmm_plugin_tpu.models.dispersion import (dispersion_energy,
                                                       dispersion_energy_pairs)
from mbpol_openmm_plugin_tpu.models.one_body import one_body_energy
from mbpol_openmm_plugin_tpu.models.three_body import three_body_energy
from mbpol_openmm_plugin_tpu.models.two_body import two_body_energy
from mbpol_openmm_plugin_tpu.ops import neighbors
from mbpol_openmm_plugin_tpu.system import (System, compute_virtual_sites,
                                            make_molecules_whole, water_positions)


@dataclasses.dataclass(frozen=True)
class MBPolConfig:
    """Static evaluation options (shapes the jitted computation).

    nonbonded_method: 'NoCutoff' (cluster) or 'PME'.
    cutoff: nonbonded cutoff in nm (dispersion truncation + PME direct space).
    """
    nonbonded_method: str = 'NoCutoff'
    cutoff: float = 0.9
    cutoff_2b: float = 0.65          # XML cutoff_nm (mbpol.xml:31)
    cutoff_3b: float = 0.45          # XML cutoff_nm (mbpol.xml:34)
    use_neighbor_lists: Optional[bool] = None   # default: n_waters > 24
    neighbor_capacity_factor: float = 1.5
    # extra margin added to the list cutoffs (Verlet skin). The 2b switch and
    # 3b switch-product vanish beyond their physical cutoffs, so lists built
    # with a skin give bit-identical energies while staying valid for many
    # steps - enabling list reuse across an MD chunk. 0 = reference behavior
    # (rebuild from exact cutoffs every evaluation).
    nlist_skin: float = 0.0
    # Shrink the skin-inflated PIP batches before evaluation (exact:
    # dropped entries have zero switch weight):
    #   True      - compact EVERY step to the physical cutoffs. Pays an
    #               argsort every step - only worth it for very large
    #               skins.
    #   'rebuild' - compact once per LIST BUILD to cutoff + skin/2
    #               (exact under the displacement rebuild trigger: pair
    #               distances drift <= skin/2 between rebuilds). The sort
    #               amortizes over the rebuild interval (~free) while the
    #               dominant 3B batch shrinks ~(1 - ((c+s/2)/(c+s))^6).
    #               With a FIXED rebuild interval (nlist_rebuild_interval
    #               = k) the caller must size the skin so k steps of O
    #               drift stay under skin/4 (half the plain-list budget);
    #               the displacement-triggered 'auto' mode needs nothing.
    #   None/False - evaluate the full skin-inflated lists.
    compact_eval: Optional[object] = None
    # 'complete' (full switch-product support) or 'reference' (bit-parity
    # with ReferenceThreeNeighborList.cpp:215-225 ascending-chain
    # enumeration, which misses some two-edge triplets; ops/neighbors.py).
    # Only meaningful with neighbor lists; compaction is disabled for
    # 'reference' (its enumeration is order-dependent, not geometric).
    triplet_semantics: str = 'complete'
    include_charge_redistribution: bool = True
    ewald_error_tolerance: float = 1e-4
    ewald_alpha: Optional[float] = None      # derived from tolerance if None
    pme_grid: Optional[tuple] = None         # derived from tolerance if None
    target_epsilon: float = 1e-7
    max_iterations: int = 200
    # 'sor' (reference semantics) | 'diis' (accelerated convergence) |
    # 'aspc' (Kolafa always-stable predictor-corrector: one damped SCF
    # iteration per MD step from a dipole-history predictor; cold starts
    # and one-shot evaluations still converge fully)
    scf_method: str = 'sor'
    aspc_k: int = 3                  # ASPC predictor order (scf_method='aspc')
    # ASPC corrector depth: SOR iterations on the predictor before the
    # omega-mix. 1 = Kolafa's single corrector; deeper correctors shrink
    # the dipole-lag NVE drift at ~one field evaluation per extra
    # iteration (A/B harness: tools/nve_drift.py)
    aspc_n_corr: int = 1
    thole: Optional[tuple] = None    # override [TCC,TCD,TDD,TDDOH,TDDHH]; default XML values
    # 'dense' ([N,N] tensors, exact at any cutoff), 'sparse' (molecule-pair
    # list direct space, O(N) memory - production boxes), or 'auto' (dense
    # up to DENSE_ELEC_MAX_WATERS, sparse above for PME)
    electrostatics_mode: str = 'auto'
    # 'dense' ([N,N] site-pair grid, exact, cheap below the electrostatics
    # dense limit), 'pairs' (molecule-pair list over 3x3 real-site blocks,
    # O(N) memory - the large-N path; water-only, periodic), or 'auto'
    # (pairs whenever electrostatics resolved to the sparse large-N mode
    # on a water-only periodic system; dense otherwise)
    dispersion_mode: str = 'auto'
    # OpenMM-style C2 switching of the dispersion tail over
    # [cutoff - width, cutoff]. 0 = reference parity (plain truncation -
    # which is a DISCONTINUOUS force field at the cutoff sphere; most of
    # the non-electrostatic NVE drift at water256). OpenMM's
    # CustomNonbondedForce exposes the same option
    # (setUseSwitchingFunction); forces stay consistent automatically
    # (autodiff of the switched energy).
    dispersion_switch_width: float = 0.0
    # Lowest SCF convergence target honored at float32 (None = the
    # historical 1e-4, overridable via MBPOL_F32_SCF_EPS_FLOOR for
    # tooling). Physics-affecting: the f32 SOR loop at eps 1e-4 is
    # strongly dissipative in NVE (water256); the typed field is the
    # production way to tighten it (models/electrostatics._f32_eps_floor).
    scf_eps_floor: Optional[float] = None
    # Flat-bottom spherical restraint about the instantaneous oxygen
    # centroid (models/restraint.py): zero inside `restraint_radius` (nm),
    # harmonic (k in kJ/mol/nm^2) outside. Cluster (NoCutoff) systems
    # only - the role OpenMM's CustomExternalForce plays for the
    # reference's cluster users; keeps hot REMD rungs from evaporating.
    restraint_radius: Optional[float] = None
    restraint_k: float = 1000.0
    terms: tuple = ('electrostatics', 'one_body', 'two_body', 'three_body', 'dispersion')

    @classmethod
    def for_dynamics(cls, **overrides):
        """The production MD operating point (from NVE drift runs).

        Single-point defaults above are strict reference parity; dynamics
        wants the energy-conserving variants, each chosen from water256
        f32 NVE drift runs (tools/nve_drift.py, 10-50 ps windows):

        - dispersion_switch_width=0.1: C2-switch the dispersion tail over
          [cutoff-0.1, cutoff]. The reference's plain truncation is a
          discontinuous force field at the cutoff sphere, a large source
          of NVE heating. (Same option OpenMM exposes on
          CustomNonbondedForce; single-point energy shifts +3.0 kcal/mol
          at water256, inside every golden band.)
        - scf_method='aspc': the Kolafa predictor-corrector closure -
          near-conservative AND faster than the loosely-converged SOR
          loop, which is strongly dissipative at the f32 eps floor 1e-4.
        - target_epsilon=1e-3: the reference kernel's own default
          (MBPolReferenceKernels.cpp:133) for the cold-start converges.
        - nlist_skin=0.02: displacement-triggered list reuse (exact).

        The two biggest conservation fixes need no flags - the PME
        fixed-field operator fix and the HIGHEST PIP gradient contraction
        are unconditional defaults (see models/pme.py, ops/polyeval.py).
        """
        base = dict(nonbonded_method='PME', cutoff=0.9,
                    target_epsilon=1e-3, max_iterations=200,
                    scf_method='aspc', aspc_k=3, aspc_n_corr=1,
                    nlist_skin=0.02, dispersion_switch_width=0.1)
        base.update(overrides)
        return cls(**base)


def with_scf_method(pot: 'MBPol', method: str, aspc_k: Optional[int] = None,
                    aspc_n_corr: Optional[int] = None):
    """A new MBPol over the same topology/shapes with a different SCF
    closure ('sor' | 'diis' | 'aspc'). Single-point evaluations are
    physics-identical (every method converges a cold start to the same
    fixed point within target_epsilon; ASPC's one-corrector semantics only
    applies along-trajectory with a dipole-history predictor) - so this is
    safe for retargeting a potential's DYNAMICS operating point. Tuned
    capacities, PME setup and neighbor machinery carry over; only the
    (persistent-cache-assisted) XLA re-trace is paid."""
    if pot.elec_params is None:
        return pot
    new = object.__new__(MBPol)
    new.__dict__.update(pot.__dict__)
    changes = dict(scf_method=method)
    if aspc_k is not None:
        changes['aspc_k'] = int(aspc_k)
    if aspc_n_corr is not None:
        changes['aspc_n_corr'] = int(aspc_n_corr)
    new.config = dataclasses.replace(pot.config, **changes)
    new.elec_params = dataclasses.replace(pot.elec_params, **changes)
    new.__dict__.pop('_nl_jit', None)
    new._energy_forces = jax.jit(new._energy_forces_impl)
    new._energy_forces_warm = jax.jit(new._energy_forces_impl)
    return new


def inherit_capacities(src: 'MBPol', dst: 'MBPol'):
    """Copy tuned padded-list capacities and static shape parameters from
    one MBPol to another over the same topology (term-subset splits for
    r-RESPA / ring-polymer contraction). A fresh MBPol falls back to the
    conservative analytic bounds and wastes 2-3x on oversized pair/triplet
    batches; inheriting keeps every derived potential at the parent's
    tune_capacities operating point. Refreshes dst's jit wrappers (the
    capacities are trace-time constants)."""
    for attr in ('pair_cap', 'trip_cap', 'pair_eval_cap', 'trip_eval_cap',
                 'elec_pair_cap', 'disp_pair_cap',
                 'nlist_k_max', 'nlist_kt'):
        if hasattr(src, attr):
            setattr(dst, attr, getattr(src, attr))
    dst._energy_forces = jax.jit(dst._energy_forces_impl)
    dst._energy_forces_warm = jax.jit(dst._energy_forces_impl)
    return dst


# Largest water count evaluated with dense [N,N] direct-space
# electrostatics under electrostatics_mode='auto'. The XLA dense path keeps
# ~35 [N,N] tensors live; above this size the molecule-pair sparse path
# (models/pme_sparse.py, O(N) memory) takes over.
DENSE_ELEC_MAX_WATERS = 512


def electrostatics_mode_for(config: MBPolConfig, n_waters: int) -> str:
    """Resolve config.electrostatics_mode from the system size alone:
    'auto' is dense up to DENSE_ELEC_MAX_WATERS waters, and 'sparse' above
    it when the system is periodic (PME)."""
    mode = config.electrostatics_mode
    if mode == 'auto':
        return ('sparse' if config.nonbonded_method == 'PME'
                and n_waters > DENSE_ELEC_MAX_WATERS else 'dense')
    if mode not in ('dense', 'sparse'):
        raise ValueError(f"electrostatics_mode must be 'auto', 'dense' or "
                         f"'sparse', got {mode!r}")
    return mode


class MBPol:
    """MB-pol potential for a fixed topology.

    Typical use:
        pot = MBPol(system, MBPolConfig(nonbonded_method='PME'))
        energy, forces, breakdown = pot.energy_forces(positions)
    `positions` are [natoms, 3] nm including M-site slots (their values are
    overwritten by virtual-site placement).
    """

    def __init__(self, system: System, config: MBPolConfig = MBPolConfig(),
                 mesh=None, plan=None):
        if config.nonbonded_method not in ('NoCutoff', 'PME'):
            raise ValueError(config.nonbonded_method)
        if config.nonbonded_method == 'PME' and not system.periodic:
            raise ValueError('PME requires a periodic box')
        if config.restraint_radius is not None and system.periodic:
            # the instantaneous-centroid restraint is ill-defined under
            # PBC (molecules are imaged independently)
            raise ValueError('restraint_radius is a cluster (non-periodic) '
                             'feature')
        self.system = system
        self.config = config
        self.mesh = mesh
        if 'electrostatics' in config.terms and system.n_ions:
            # Fail at the door, not deep in the first evaluation: the
            # parameter file defines no electrostatics parameters for ions
            # (mbpol.xml:22-27 has water types only; Cl- appears only in the
            # dispersion C6/d6 tables) so an ion-containing system can run
            # dispersion/1b/2b/3b but not polarizable electrostatics -
            # PARITY.md documents the deliberate reference parity.
            raise ValueError(
                'MB-pol electrostatics supports water-only systems (the '
                'force field defines no ion electrostatics parameters, '
                'mbpol.xml:22-27). Drop "electrostatics" from '
                'MBPolConfig.terms to evaluate the remaining terms on '
                'ion-containing systems.')
        if 'electrostatics' in config.terms:
            self.elec_params = elec.ElecParams.for_system(
                system,
                include_charge_redistribution=config.include_charge_redistribution,
                target_epsilon=config.target_epsilon,
                max_iterations=config.max_iterations,
                scf_method=config.scf_method,
                aspc_k=config.aspc_k,
                aspc_n_corr=config.aspc_n_corr,
                scf_eps_floor=config.scf_eps_floor)
            if config.thole is not None:
                self.elec_params = dataclasses.replace(
                    self.elec_params, thole=np.asarray(config.thole))
        else:
            self.elec_params = None
        if config.nonbonded_method == 'PME' and self.elec_params is not None:
            self.pme = pme_mod.PmeSetup.from_config(system, config)
        else:
            self.pme = None
        self.elec_mode = electrostatics_mode_for(config, system.n_waters)
        if self.elec_mode == 'sparse':
            if self.pme is None:
                raise ValueError('sparse electrostatics requires PME')
            from mbpol_openmm_plugin_tpu.models import pme_sparse
            cut = config.cutoff + pme_sparse.PAIR_MARGIN + config.nlist_skin
            self.elec_pair_cap = neighbors.pair_capacity(
                system.n_waters, system.box, cut,
                factor=config.neighbor_capacity_factor)
            if mesh is not None:
                from mbpol_openmm_plugin_tpu.parallel import mesh as M
                self.elec_pair_cap = M.round_up(self.elec_pair_cap,
                                                mesh.devices.size)
        use_nl = config.use_neighbor_lists
        self.use_neighbor_lists = system.n_waters > 24 if use_nl is None else use_nl
        # compact_eval: False | True (per-step compaction to the physical
        # cutoffs - exact but pays an argsort EVERY step) |
        # 'rebuild' (compaction at list-build time to cutoff + skin/2 -
        # exact under the displacement rebuild trigger, since any pair
        # distance drifts by at most skin/2 between rebuilds, and FREE
        # per step: the skin-inflated 3B batch shrinks ~20-30% with the
        # sort amortized over the rebuild interval).
        ce = False if config.compact_eval is None else config.compact_eval
        if not (self.use_neighbor_lists
                and config.triplet_semantics == 'complete'):
            ce = False
        if ce not in (False, True, 'rebuild'):
            raise ValueError(f'compact_eval must be False, True or '
                             f"'rebuild', got {ce!r}")
        self.compact_eval = ce
        dmode = config.dispersion_mode
        if dmode == 'auto':
            # the dense [N,N] site-pair grid is the next memory wall after
            # sparse electrostatics + site-chunked PME grids; switch to the
            # molecule-pair path exactly when electrostatics itself left
            # the dense regime
            dmode = ('pairs' if self.elec_mode == 'sparse'
                     and system.periodic and system.n_ions == 0
                     and 'dispersion' in config.terms else 'dense')
        if dmode not in ('dense', 'pairs'):
            raise ValueError(f'unknown dispersion_mode {dmode!r}')
        if dmode == 'pairs':
            if not system.periodic or system.n_ions:
                raise ValueError("dispersion_mode='pairs' requires a "
                                 'periodic water-only system')
            # one radius for the capacity estimate, the runtime build and
            # the retune (and identical to the sparse-elec list radius,
            # which shares the build - pme_sparse imports PAIR_MARGIN)
            self.disp_pair_cut = (config.cutoff + disp_mod.PAIR_MARGIN
                                  + config.nlist_skin)
            if self.elec_mode == 'sparse':
                self.disp_pair_cap = None     # share the elec pair list
            else:
                self.disp_pair_cap = neighbors.pair_capacity(
                    system.n_waters, system.box, self.disp_pair_cut,
                    factor=config.neighbor_capacity_factor)
                if mesh is not None:
                    from mbpol_openmm_plugin_tpu.parallel import mesh as M
                    self.disp_pair_cap = M.round_up(self.disp_pair_cap,
                                                    mesh.devices.size)
        self.disp_mode = dmode
        # on-device triplet-build shape parameters (tune_capacities sets
        # tighter values from measured neighbor counts; None = analytic)
        self.nlist_k_max = None
        self.nlist_kt = None
        if self.use_neighbor_lists:
            box = system.box
            f = config.neighbor_capacity_factor
            self.pair_cap = neighbors.pair_capacity(system.n_waters, box,
                                                    config.cutoff_2b + config.nlist_skin,
                                                    factor=f)
            self.trip_cap = neighbors.triplet_capacity(system.n_waters, box,
                                                       config.cutoff_3b + config.nlist_skin,
                                                       factor=f)
            # compacted evaluation buffers: physical cutoffs for per-step
            # compaction; cutoff + skin/2 for rebuild-time compaction
            ce_half = (0.5 * config.nlist_skin
                       if self.compact_eval == 'rebuild' else 0.0)
            self.pair_eval_cap = neighbors.pair_capacity(
                system.n_waters, box, config.cutoff_2b + ce_half, factor=f)
            self.trip_eval_cap = neighbors.triplet_capacity(
                system.n_waters, box, config.cutoff_3b + ce_half, factor=f)
            if mesh is not None:
                from mbpol_openmm_plugin_tpu.parallel import mesh as M
                ndev = mesh.devices.size
                self.pair_cap = M.round_up(self.pair_cap, ndev)
                self.trip_cap = M.round_up(self.trip_cap, ndev)
                self.pair_eval_cap = M.round_up(self.pair_eval_cap, ndev)
                self.trip_eval_cap = M.round_up(self.trip_eval_cap, ndev)
        if plan is not None:
            # parallel.plan.CapacityPlan: every static capacity sized up
            # front for an (n_devices, N) run - the public path (the old
            # CapacityPlan.apply() mutated these attributes post hoc)
            self._apply_plan(plan)
        self._energy_forces = jax.jit(self._energy_forces_impl)
        self._energy_forces_warm = jax.jit(self._energy_forces_impl)

    def _apply_plan(self, plan):
        """Adopt a parallel.plan.CapacityPlan's static shapes (constructor
        path; runs before the jit wrappers are built)."""
        nd = 1 if self.mesh is None else self.mesh.devices.size
        if nd != plan.n_devices:
            raise ValueError(f'plan is for {plan.n_devices} devices, '
                             f'potential mesh has {nd}')
        if self.system.n_waters != plan.n_waters:
            raise ValueError('plan/potential water count mismatch')
        if not self.use_neighbor_lists:
            return                       # dense small-system path: nothing
        self.pair_cap = plan.pair_cap    # to size beyond the defaults
        self.trip_cap = plan.trip_cap
        if self.compact_eval and self.config.nlist_skin > 0:
            # physical-cutoff eval buffers (tune_capacities semantics)
            self.pair_eval_cap = getattr(plan, 'pair_eval_cap', None) \
                or plan.pair_cap
            self.trip_eval_cap = getattr(plan, 'trip_eval_cap', None) \
                or plan.trip_cap
        else:
            self.pair_eval_cap, self.trip_eval_cap = (self.pair_cap,
                                                      self.trip_cap)
        self.nlist_k_max = plan.nlist_k_max
        self.nlist_kt = plan.nlist_kt
        if plan.elec_pair_cap and self.elec_mode == 'sparse':
            self.elec_pair_cap = plan.elec_pair_cap
        if plan.disp_pair_cap and self.disp_mode == 'pairs' \
                and self.disp_pair_cap is not None:
            self.disp_pair_cap = plan.disp_pair_cap

    # ------------------------------------------------------------------
    def _neighbor_lists(self, positions, box=None):
        """Padded pair/triplet lists from current O positions (rebuilt every
        evaluation unless prebuilt lists are passed in; diag carries overflow
        counts). Lists use cutoff + nlist_skin."""
        sys_ = self.system
        o_pos = positions[sys_.o_index]
        box = sys_.box if box is None else box
        skin = self.config.nlist_skin
        pairs, pmask, n_p = neighbors.pair_list(o_pos, box,
                                                self.config.cutoff_2b + skin,
                                                self.pair_cap)
        # k_max/kt must be static (shapes); tuned by tune_capacities from
        # actual neighbor counts, else the analytic construction-box bound
        k_max = self.nlist_k_max
        if k_max is None:
            k_max = neighbors.max_neighbors(sys_.n_waters, sys_.box,
                                            self.config.cutoff_3b + skin)
        trips, tmask, n_t = neighbors.triplet_list(
            o_pos, box, self.config.cutoff_3b + skin, self.trip_cap,
            k_max=k_max, kt=self.nlist_kt,
            semantics=self.config.triplet_semantics)
        pair_ovf = n_p > self.pair_cap
        trip_ovf = n_t > self.trip_cap
        if self.compact_eval == 'rebuild':
            # Build-time compaction to cutoff + skin/2: exact - between
            # rebuilds the displacement trigger (2*max_disp > skin/2)
            # bounds every pair-distance change by skin/2, so anything
            # contributing at evaluation time was inside cutoff + skin/2
            # at build time. Same reasoning shrinks the rmin early-exit
            # bound downward. Compaction overflow folds into the standard
            # fatal flags (a truncated list silently drops interactions).
            half = 0.5 * skin
            b = box if sys_.periodic else None
            rmin = 0.2 - half     # 2 A reference early-exit, drift-safe
            pairs, pmask, n_pc = neighbors.compact_pairs(
                o_pos, b, pairs, pmask, self.config.cutoff_2b + half,
                rmin, self.pair_eval_cap)
            trips, tmask, n_tc = neighbors.compact_triplets(
                o_pos, b, trips, tmask, self.config.cutoff_3b + half,
                rmin, self.trip_eval_cap)
            pair_ovf = pair_ovf | (n_pc > self.pair_eval_cap)
            trip_ovf = trip_ovf | (n_tc > self.trip_eval_cap)
        if self.mesh is not None:
            from mbpol_openmm_plugin_tpu.parallel import mesh as M
            rs = M.row_sharded(self.mesh)
            pairs, pmask = M.constrain(pairs, rs), M.constrain(pmask, rs)
            trips, tmask = M.constrain(trips, rs), M.constrain(tmask, rs)
        diag = dict(n_pairs=n_p, n_triplets=n_t,
                    pair_overflow=pair_ovf,
                    triplet_overflow=trip_ovf)
        return (pairs, pmask), (trips, tmask), diag

    def _compact_lists(self, positions, nlists, box=None):
        """Per-step compaction of the (possibly skin-inflated) lists to the
        entries inside the physical cutoffs (ops/neighbors.compact_*). Exact:
        dropped entries carry zero switch weight or sit in the r < 2 A
        early-exit region. Index-only - no gradients flow through it."""
        sys_ = self.system
        (pairs, pmask), (trips, tmask) = nlists
        o_pos = jax.lax.stop_gradient(positions[sys_.o_index])
        b = (sys_.box if box is None else box) if sys_.periodic else None
        rmin = 0.2   # nm; 2 A early-exit of the reference 2b/3b physics
        pairs_c, pmask_c, n_p = neighbors.compact_pairs(
            o_pos, b, pairs, pmask, self.config.cutoff_2b, rmin,
            self.pair_eval_cap)
        trips_c, tmask_c, n_t = neighbors.compact_triplets(
            o_pos, b, trips, tmask, self.config.cutoff_3b, rmin,
            self.trip_eval_cap)
        if self.mesh is not None:
            from mbpol_openmm_plugin_tpu.parallel import mesh as M
            rs = M.row_sharded(self.mesh)
            pairs_c, pmask_c = M.constrain(pairs_c, rs), M.constrain(pmask_c, rs)
            trips_c, tmask_c = M.constrain(trips_c, rs), M.constrain(tmask_c, rs)
        diag = dict(n_pairs_active=n_p, n_triplets_active=n_t,
                    pair_eval_overflow=n_p > self.pair_eval_cap,
                    triplet_eval_overflow=n_t > self.trip_eval_cap)
        return ((pairs_c, pmask_c), (trips_c, tmask_c)), diag

    def _smooth_terms(self, positions, nlists=None, box=None, disp_pairs=None):
        """Closed-form terms (1b/2b/3b/dispersion); differentiable.
        disp_pairs: optional (mol_pairs, mask) for the O(N) dispersion path
        (disp_mode='pairs'); None evaluates the dense pair grid."""
        cfg = self.config
        sys_ = self.system
        pos = compute_virtual_sites(sys_, positions)
        parts = {}
        if 'one_body' in cfg.terms:
            wpos = water_positions(sys_, pos)
            if self.mesh is not None:
                # molecule batch over 'dp' (psum on the total); the pair/
                # triplet terms shard through their list constraints below
                from mbpol_openmm_plugin_tpu.parallel import mesh as M
                wpos = M.constrain(wpos, M.row_sharded(self.mesh))
            parts['one_body'] = jnp.sum(one_body_energy(wpos))
        pl = tl = None
        if nlists is not None:
            pl, tl = nlists
        if 'two_body' in cfg.terms:
            parts['two_body'] = (two_body_energy(sys_, pos, pl[0], pl[1], box=box)
                                 if pl is not None
                                 else two_body_energy(sys_, pos, box=box))
        if 'three_body' in cfg.terms:
            parts['three_body'] = (three_body_energy(sys_, pos, tl[0], tl[1], box=box)
                                   if tl is not None
                                   else three_body_energy(sys_, pos, box=box))
        if 'dispersion' in cfg.terms:
            sw = cfg.dispersion_switch_width
            if disp_pairs is not None:
                parts['dispersion'] = dispersion_energy_pairs(
                    sys_, pos, disp_pairs[0], disp_pairs[1],
                    cutoff=cfg.cutoff, box=box, mesh=self.mesh,
                    switch_width=sw)
            else:
                parts['dispersion'] = dispersion_energy(
                    sys_, pos, cutoff=cfg.cutoff, box=box, mesh=self.mesh,
                    switch_width=sw)
        if cfg.restraint_radius is not None:
            from mbpol_openmm_plugin_tpu.models.restraint import \
                flat_bottom_energy
            parts['restraint'] = flat_bottom_energy(
                pos[sys_.o_index], cfg.restraint_radius, cfg.restraint_k)
        return parts

    def _energy_forces_impl(self, positions, mu0=None, nlists=None, box=None):
        """mu0: optional induced-dipole warm start (diag['induced_dipoles']
        of a previous nearby evaluation). Cuts SCF iterations in MD; the
        converged fixed point - and hence the physics - is unchanged within
        target_epsilon. Default (None) reproduces the reference's cold-start
        initialization each call.

        nlists: optional prebuilt ((pairs, pmask), (trips, tmask)) from
        `build_neighbor_lists` - valid for any superset of the physical
        lists (energies are exact; see nlist_skin)."""
        sys_ = self.system
        positions = make_molecules_whole(sys_, positions, box=box)

        nl_diag = {}
        if nlists is None and self.use_neighbor_lists:
            pl, tl, nl_diag = self._neighbor_lists(positions, box=box)
            nlists = (pl, tl)

        if nlists is not None and self.compact_eval is True:
            # per-step mode only; 'rebuild' lists arrive already compacted
            nlists, c_diag = self._compact_lists(positions, nlists, box=box)
            nl_diag = dict(nl_diag, **c_diag)

        disp_pairs = None
        if self.disp_mode == 'pairs' and 'dispersion' in self.config.terms:
            # molecule-pair list at cutoff + PAIR_MARGIN (+ skin); shared
            # with sparse electrostatics below (identical radius and cap)
            cap = (self.elec_pair_cap if self.disp_pair_cap is None
                   else self.disp_pair_cap)
            mp_d, mp_mask_d, n_mp_d = neighbors.pair_list(
                positions[sys_.o_index],
                sys_.box if box is None else box, self.disp_pair_cut, cap)
            nl_diag = dict(nl_diag, disp_pair_overflow=n_mp_d > cap)
            disp_pairs = (mp_d, mp_mask_d)

        def smooth_total(p):
            parts = self._smooth_terms(p, nlists, box=box,
                                       disp_pairs=disp_pairs)
            total = functools.reduce(jnp.add, parts.values()) if parts \
                else jnp.zeros((), p.dtype)
            return total, parts

        (e_smooth, parts), grad = jax.value_and_grad(smooth_total, has_aux=True)(positions)
        forces = -grad
        diag = dict(nl_diag)

        if self.elec_params is not None:
            pos_v = compute_virtual_sites(sys_, positions)
            if self.pme is not None and self.elec_mode == 'sparse':
                from mbpol_openmm_plugin_tpu.models import pme_sparse
                if disp_pairs is not None:
                    # same radius (PAIR_MARGIN values match) and capacity:
                    # reuse the dispersion list instead of rebuilding
                    mp, mp_mask = disp_pairs
                    diag['elec_pair_overflow'] = nl_diag['disp_pair_overflow']
                else:
                    cut = self.config.cutoff + pme_sparse.PAIR_MARGIN + self.config.nlist_skin
                    mp, mp_mask, n_mp = neighbors.pair_list(
                        pos_v[sys_.o_index],
                        sys_.box if box is None else box, cut, self.elec_pair_cap)
                    diag['elec_pair_overflow'] = n_mp > self.elec_pair_cap
                e_elec, f_elec, ediag = pme_sparse.pme_electrostatics_sparse(
                    self.elec_params, self.pme, pos_v, mp, mp_mask, mu0=mu0,
                    box=box, mesh=self.mesh)
            elif self.pme is not None:
                e_elec, f_elec, ediag = pme_mod.pme_electrostatics(
                    self.elec_params, self.pme, pos_v, mesh=self.mesh, mu0=mu0,
                    box=box)
            else:
                e_elec, f_elec, ediag = elec.cluster_electrostatics(
                    self.elec_params, pos_v, mesh=self.mesh, mu0=mu0)
            diag.update(ediag)
            parts = dict(parts, electrostatics=e_elec)
            # redistribute M-site forces to parents (average3 weights)
            ff = _data.load('forcefield')
            w = ff['vsite_weights']
            from mbpol_openmm_plugin_tpu.system import _contiguous_waters
            if _contiguous_waters(sys_) and sys_.n_ions == 0:
                f4 = f_elec.reshape(sys_.n_waters, 4, 3)
                f_m = f4[:, 3]
                f4 = jnp.stack([f4[:, 0] + w[0] * f_m,
                                f4[:, 1] + w[1] * f_m,
                                f4[:, 2] + w[2] * f_m,
                                jnp.zeros_like(f_m)], axis=1)
                f_elec = f4.reshape(-1, 3)
            else:
                f_m = f_elec[sys_.m_index]
                f_elec = f_elec.at[sys_.m_index].set(0.0)
                f_elec = f_elec.at[sys_.o_index].add(w[0] * f_m)
                f_elec = f_elec.at[sys_.h1_index].add(w[1] * f_m)
                f_elec = f_elec.at[sys_.h2_index].add(w[2] * f_m)
            forces = forces + f_elec
            e_smooth = e_smooth + e_elec

        return e_smooth, forces, parts, diag

    # ------------------------------------------------------------------
    def tune_capacities(self, positions, margin=1.15):
        """Size the padded pair/triplet lists from the actual neighbor counts
        of a representative configuration (native O(N) voxel hash), with a
        safety margin for density fluctuations. Must be called before the
        first jitted evaluation (changes static shapes). Overflow during MD
        is still detected via diag['pair_overflow'/'triplet_overflow']."""
        if not self.use_neighbor_lists:
            return self
        import jax.numpy as jnp

        from mbpol_openmm_plugin_tpu.ops import native
        from mbpol_openmm_plugin_tpu.system import make_molecules_whole
        # jit the (tiny) imaging computation: eager jnp ops each dispatch a
        # separate program to the device
        pos = jax.jit(lambda p: make_molecules_whole(self.system, p))(
            jnp.asarray(positions))
        o = np.asarray(pos[self.system.o_index])
        box = self.system.box
        skin = self.config.nlist_skin
        pairs_np, n_p = native.pair_list(o, box, self.config.cutoff_2b + skin)
        trips_np, n_t = native.triplet_list(o, box, self.config.cutoff_3b + skin)
        self.pair_cap = max(int(margin * n_p) + 16, 64)
        self.trip_cap = max(int(margin * n_t) + 32, 128)
        # tuned per-center shape parameters for the on-device triplet build
        # (ops/neighbors.triplet_list two-stage selection): the dominant
        # cost is the [n, K, K] candidate block and its [n, K*K] stage-1
        # sort, so sizing K from the ACTUAL 3b-cutoff neighbor counts
        # (analytic bound K=46 vs measured ~20 at water256 density) halves
        # the build. Truncation by either bound is caught on device and
        # folded into triplet_overflow (always fatal in the MD drivers).
        n_w = self.system.n_waters
        pairs3, _ = native.pair_list(o, box, self.config.cutoff_3b + skin)
        if len(pairs3):
            max_nbr = int(np.bincount(pairs3.ravel(), minlength=n_w).max())
        else:
            max_nbr = 0
        # The per-center factors must scale with `margin` like the global
        # caps do: a caller asking for long-run headroom (margin 1.6) got
        # the same fixed 1.3x/1.4x per-center bounds as the default, and a
        # 50 ps 320 K run overflowed k_max on a density fluctuation ~10 ps
        # in while the global caps still had room (measured round 4,
        # tools/nve_drift.py).
        f_k = max(1.3, float(margin))
        f_kt = max(1.4, float(margin))
        self.nlist_k_max = min(max(int(np.ceil(f_k * max_nbr)) + 2, 8),
                               max(n_w - 1, 1))
        if len(trips_np):
            max_ct = int(np.bincount(trips_np[:, 1], minlength=n_w).max())
        else:
            max_ct = 0
        self.nlist_kt = min(int(np.ceil(f_kt * max_ct)) + 8,
                            self.nlist_k_max * (self.nlist_k_max - 1) // 2)
        if self.compact_eval and skin > 0:
            ce_half = 0.5 * skin if self.compact_eval == 'rebuild' else 0.0
            _, n_pe = native.pair_list(o, box, self.config.cutoff_2b + ce_half)
            _, n_te = native.triplet_list(o, box,
                                          self.config.cutoff_3b + ce_half)
            self.pair_eval_cap = min(max(int(margin * n_pe) + 16, 64), self.pair_cap)
            self.trip_eval_cap = min(max(int(margin * n_te) + 32, 128), self.trip_cap)
        else:
            self.pair_eval_cap, self.trip_eval_cap = self.pair_cap, self.trip_cap
        if getattr(self, 'elec_mode', 'dense') == 'sparse':
            from mbpol_openmm_plugin_tpu.models import pme_sparse
            cut = self.config.cutoff + pme_sparse.PAIR_MARGIN + skin
            _, n_e = native.pair_list(o, box, cut)
            self.elec_pair_cap = max(int(margin * n_e) + 16, 64)
        if getattr(self, 'disp_mode', 'dense') == 'pairs' \
                and self.disp_pair_cap is not None:
            _, n_d = native.pair_list(o, box, self.disp_pair_cut)
            self.disp_pair_cap = max(int(margin * n_d) + 16, 64)
        if self.mesh is not None:
            from mbpol_openmm_plugin_tpu.parallel import mesh as M
            ndev = self.mesh.devices.size
            self.pair_cap = M.round_up(self.pair_cap, ndev)
            self.trip_cap = M.round_up(self.trip_cap, ndev)
            self.pair_eval_cap = M.round_up(self.pair_eval_cap, ndev)
            self.trip_eval_cap = M.round_up(self.trip_eval_cap, ndev)
            if getattr(self, 'elec_mode', 'dense') == 'sparse':
                self.elec_pair_cap = M.round_up(self.elec_pair_cap, ndev)
            if getattr(self, 'disp_mode', 'dense') == 'pairs' \
                    and self.disp_pair_cap is not None:
                self.disp_pair_cap = M.round_up(self.disp_pair_cap, ndev)
        self._energy_forces = jax.jit(self._energy_forces_impl)
        self._energy_forces_warm = jax.jit(self._energy_forces_impl)
        return self

    def build_neighbor_lists(self, positions, use_native=None):
        """List build for reuse across an MD chunk (pair with nlist_skin > 0
        so the lists stay valid between rebuilds).

        Optionally runs the native C++ voxel hash on the host (O(N) work,
        but each call costs several device<->host round trips, so the
        default is the jitted on-device build; set MBPOL_NATIVE_NLIST=1 to
        opt in).
        Falls back to the jitted builder when the native library can't be
        built."""
        if use_native is None:
            use_native = os.environ.get('MBPOL_NATIVE_NLIST', '0') == '1'
        if use_native:
            try:
                return self._build_neighbor_lists_native(positions)
            except Exception:
                pass
        if not hasattr(self, '_nl_jit'):
            self._nl_jit = jax.jit(lambda p: self._neighbor_lists(
                make_molecules_whole(self.system, p)))
        pl, tl, diag = self._nl_jit(positions)
        return (pl, tl), diag

    def _build_neighbor_lists_native(self, positions):
        from mbpol_openmm_plugin_tpu.ops import native
        sys_ = self.system
        pos = np.asarray(make_molecules_whole(sys_, jnp.asarray(positions)))
        o = pos[sys_.o_index]
        box = sys_.box
        skin = self.config.nlist_skin
        dtype = jnp.asarray(positions).dtype

        pairs_np, n_p = native.pair_list(o, box, self.config.cutoff_2b + skin,
                                         capacity=self.pair_cap)
        trips_np, n_t = native.triplet_list(o, box, self.config.cutoff_3b + skin,
                                            capacity=self.trip_cap)
        pairs = np.zeros((self.pair_cap, 2), np.int32)
        pairs[:len(pairs_np)] = pairs_np
        trips = np.zeros((self.trip_cap, 3), np.int32)
        trips[:len(trips_np)] = trips_np
        pmask = np.arange(self.pair_cap) < n_p
        tmask = np.arange(self.trip_cap) < n_t
        out = ((jnp.asarray(pairs), jnp.asarray(pmask)),
               (jnp.asarray(trips), jnp.asarray(tmask)))
        diag = dict(n_pairs=n_p, n_triplets=n_t,
                    pair_overflow=n_p > self.pair_cap,
                    triplet_overflow=n_t > self.trip_cap)
        return out, diag

    def with_updated_params(self, thole=None, charges=None, damping=None,
                            polarity=None, target_epsilon=None,
                            max_iterations=None,
                            include_charge_redistribution=None):
        """updateParametersInContext parity (MBPolElectrostaticsForce.h:281,
        MBPolReferenceKernels.cpp:101-118): a new MBPol with mutated
        electrostatics parameters for the SAME topology. Static shapes -
        neighbor/pair capacities, PME setup and tuned list sizes - carry
        over, so only the (persistent-cache-assisted) XLA re-trace is paid;
        a particle-count mismatch raises like the reference's kernel check.

        Array arguments: per-particle [N] charges/damping/polarity, [5]
        thole. Scalars: target_epsilon, max_iterations,
        include_charge_redistribution.
        """
        if self.elec_params is None:
            raise ValueError('potential has no electrostatics term')
        ep = self.elec_params
        n = len(ep.damping)
        changes = {}
        for name, val in (('thole', thole), ('charges', charges),
                          ('damping', damping), ('polarity', polarity)):
            if val is not None:
                val = np.asarray(val, np.float64)
                want = 5 if name == 'thole' else n
                if val.shape != (want,):
                    raise ValueError(
                        f'{name} must have shape ({want},), got {val.shape} '
                        '(particle count must match the existing system, as '
                        'in updateParametersInContext)')
                changes[name] = val
        if target_epsilon is not None:
            changes['target_epsilon'] = float(target_epsilon)
        if max_iterations is not None:
            changes['max_iterations'] = int(max_iterations)
        if include_charge_redistribution is not None:
            changes['include_charge_redistribution'] = bool(include_charge_redistribution)
        new = object.__new__(MBPol)
        new.__dict__.update(self.__dict__)
        new.elec_params = dataclasses.replace(ep, **changes)
        if include_charge_redistribution is not None or thole is not None:
            cfg_changes = {}
            if include_charge_redistribution is not None:
                cfg_changes['include_charge_redistribution'] = bool(include_charge_redistribution)
            if thole is not None:
                cfg_changes['thole'] = tuple(np.asarray(thole, np.float64))
            new.config = dataclasses.replace(self.config, **cfg_changes)
        new.__dict__.pop('_nl_jit', None)
        new._energy_forces = jax.jit(new._energy_forces_impl)
        new._energy_forces_warm = jax.jit(new._energy_forces_impl)
        return new

    def energy_forces(self, positions, mu0=None):
        """Returns (total energy kJ/mol, forces kJ/mol/nm [natoms,3],
        per-term energy dict, diagnostics dict). Pass a previous
        diag['induced_dipoles'] as mu0 to warm-start the SCF."""
        if mu0 is None:
            return self._energy_forces(positions)
        return self._energy_forces_warm(positions, mu0)

    def energy(self, positions):
        return self._energy_forces(positions)[0]
