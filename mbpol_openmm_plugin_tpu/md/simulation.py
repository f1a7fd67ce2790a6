"""Simulation driver: whole-trajectory chunks under lax.scan, on device.

Mirrors the capabilities the reference gets from OpenMM's app layer
(app.Simulation + reporters, python/example_nvt_nve.py, bin/mbpol_builder):
Verlet / Langevin stepping, Andersen thermostat, Monte-Carlo barostat,
minimization, state reporting and checkpointing - but as pure-functional
steps scanned on the accelerator, with reporter data returned as stacked
arrays every chunk instead of host callbacks in the inner loop.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mbpol_openmm_plugin_tpu.md import integrators as I
from mbpol_openmm_plugin_tpu.models import electrostatics as elec
from mbpol_openmm_plugin_tpu.models.potential import MBPol
from mbpol_openmm_plugin_tpu.utils import units


_SCF_AUTO_LOGGED = False


def _log_scf_auto_swap():
    """One-time notice that scf='auto' replaced the potential's SOR loop
    with the ASPC closure for the trajectory (r3 advisor finding: the
    semantic swap was silent). Suppressed after the first Simulation in a
    process - fleets of REMD/worker instances should not spam."""
    global _SCF_AUTO_LOGGED
    if not _SCF_AUTO_LOGGED:
        _SCF_AUTO_LOGGED = True
        import logging
        logging.getLogger('mbpol_openmm_plugin_tpu').info(
            "scf='auto': trajectory uses the Kolafa ASPC dipole closure "
            "(near-conservative in NVE) instead of the potential's "
            "loosely-converged SOR loop; pass SimulationConfig(scf='keep') "
            "for reference SOR semantics along the trajectory")


def health_flag(diag):
    """Scalar health flag from a diagnostics dict (SCF convergence, padded
    list overflow). Mirrors the reference's throw-on-bad-state checks
    (induced-dipole non-convergence throws, cpp:888-894; CUDA's neighbor
    overflow re-try, CudaMBPolKernels.cpp:1787) as a returned flag instead
    of an in-jit exception."""
    ok = jnp.ones((), bool)
    if 'converged' in diag:
        ok = ok & diag['converged']
    # any padded-capacity overflow flag is fatal (pair/triplet lists,
    # elec molecule pairs, elec tile pairs, dispersion pairs, ...)
    for k, v in diag.items():
        if k.endswith('_overflow'):
            ok = ok & ~v
    return ok


@dataclasses.dataclass
class SimulationConfig:
    dt: float = 0.0002                  # ps (0.2 fs, cluster default of the reference examples)
    temperature: Optional[float] = None  # K; None = NVE
    thermostat: str = 'andersen'         # 'andersen' | 'langevin' | 'none'
    collision_frequency: float = 50.0    # 1/ps (Andersen)
    friction: float = 1.0                # 1/ps (Langevin)
    barostat_pressure: Optional[float] = None   # bar; None = no barostat
    barostat_interval: int = 25
    # SCF warm start: seed each step's induced-dipole iteration with the
    # previous step's dipoles (same converged fixed point, fewer iterations).
    scf_warm_start: bool = True
    # Dynamics SCF closure:
    #   'auto' (default) - if the potential carries the reference-default
    #     SOR loop, derive an ASPC variant for the trajectory: the loosely
    #     converged SOR loop is measurably DISSIPATIVE in NVE (-109 kJ/mol
    #     per 1000 steps / 0.2 ps at water256, bench r2) while the Kolafa
    #     predictor-corrector closure is near-conservative (+10 kJ/mol) AND
    #     faster. Single-point evaluations (set_positions, report-boundary
    #     health checks, minimization) still converge fully - identical
    #     physics to the SOR potential within target_epsilon.
    #   'keep' - run the potential's own scf_method unchanged (reference
    #     SOR semantics along the trajectory; expect the drift above).
    scf: str = 'auto'
    # Neighbor-list rebuild policy inside a chunk:
    #   k >= 1  - rebuild every k steps (k = 1 rebuilds every evaluation,
    #             matching the reference's rebuild-every-call; k > 1 requires
    #             nlist_skin sized to cover k steps of O drift to stay exact);
    #   'auto'  - on-device displacement-triggered: the scan carries the
    #             lists + their build positions and a lax.cond rebuilds when
    #             twice the max O displacement since the last build exceeds
    #             half the skin. Exact list validity at every step, zero host
    #             syncs, no interval tuning (the headline bench.py policy);
    #             requires nlist_skin > 0.
    nlist_rebuild_interval: object = 1
    # COM-motion removal (OpenMM CMMotionRemover parity): every k steps the
    # mass-weighted center-of-mass velocity is subtracted inside the scan
    # (f32 force rounding otherwise accumulates COM drift over long NVE
    # runs). 0 disables; 1 matches OpenMM's default frequency. The app
    # layer enables it when the force list carries the cm_motion tag.
    cm_motion_interval: int = 0
    # r-RESPA multiple timestepping (OpenMM MTSIntegrator role): dt becomes
    # the OUTER step for the expensive intermolecular terms (PIPs,
    # polarization/PME, dispersion); the cheap Partridge-Schwenke monomer
    # term - whose OH stretch pins MB-pol's 0.2 fs timestep - runs at
    # dt/respa_inner. 1 = single-timestep integration (default).
    respa_inner: int = 1
    # three-level r-RESPA: respa_mid > 1 puts the terms named in
    # respa_slow_terms (default the three-body PIP - ~45% of an MB-pol
    # evaluation, varying on intermolecular timescales) alone on the OUTER
    # dt rung; the remaining intermolecular terms (2b/dispersion/
    # polarization-PME) run at dt/respa_mid and the monomer term at
    # dt/(respa_mid*respa_inner). Velocity-Verlet (+ optional Andersen)
    # only. respa_mid = 1 keeps the two-level split above.
    respa_mid: int = 1
    respa_slow_terms: tuple = ('three_body',)
    # Which rung carries the polarization/PME term under three-level
    # r-RESPA:
    #   'mid'   - reference split (2b + dispersion + electrostatics at
    #             dt/respa_mid). The ASPC closure then advances at the
    #             MID cadence where its error - and the dissipative
    #             dipole-lag drift - grows steeply
    #             (tools/respa_drift.py measures it).
    #   'inner' - electrostatics joins the monomer term on the FAST rung
    #             (dt/(respa_mid*respa_inner) = the base 0.2 fs step), so
    #             the ASPC closure runs at exactly the single-step cadence
    #             (its low-drift regime) while the 3B/2B savings remain.
    #             Costs one SCF+PME per base step (like single-step);
    #             the speedup comes from 3B at 1/(mid*inner) and
    #             2b+dispersion at 1/mid cadence.
    respa_polarization_rung: str = 'mid'


class Simulation:
    """Minimal MD driver over an MBPol potential."""

    def __init__(self, potential: MBPol,
                 config: Optional[SimulationConfig] = None, seed: int = 0):
        self.potential = potential
        self.system = potential.system
        # fresh default per instance (a shared mutable dataclass default
        # would leak caller mutations into every later Simulation)
        self.config = config if config is not None else SimulationConfig()
        if self.config.scf not in ('auto', 'keep'):
            raise ValueError(f"SimulationConfig.scf must be 'auto' or "
                             f"'keep', got {self.config.scf!r}")
        if (self.config.scf == 'auto' and potential.elec_params is not None
                and potential.config.scf_method == 'sor'):
            # conservative-dynamics default: swap the dissipative
            # loosely-converged SOR loop for the ASPC closure along the
            # trajectory (see SimulationConfig.scf); reference SOR
            # semantics stay available with scf='keep'. The swap is
            # surfaced once per process (r3 advisor): it changes
            # along-trajectory semantics vs the reference default.
            from mbpol_openmm_plugin_tpu.models.potential import \
                with_scf_method
            # Under three-level r-RESPA the ASPC predictor runs at the MID
            # cadence (dt * respa_inner) where its closure error - and the
            # dissipative dipole-lag drift - grows steeply with the step
            # (Kolafa error ~ dt^(k+2)); a deeper corrector shrinks that
            # drift severalfold (tools/respa_drift.py measures it). The
            # auto default deepens the corrector to 2 for RESPA runs;
            # single-step keeps n_corr from the potential config.
            n_corr = None
            if (self.config.respa_mid > 1
                    and self.config.respa_polarization_rung != 'inner'):
                # mid-rung polarization only: at the MID cadence the
                # deeper corrector is what keeps the closure drift in
                # check. With respa_polarization_rung='inner' the ASPC
                # closure advances at the base step - the single-step
                # regime, where the potential's configured depth already
                # suffices and the extra corrector would cost ~33% of
                # every fast-rung evaluation.
                n_corr = max(getattr(potential.config, 'aspc_n_corr', 1), 2)
            self.potential = with_scf_method(potential, 'aspc',
                                             aspc_n_corr=n_corr)
            _log_scf_auto_swap()
        self._key = jax.random.PRNGKey(seed)
        self.state: Optional[I.MDState] = None
        # adaptive barostat move size (scale, attempted, accepted) -
        # OpenMM MonteCarloBarostatImpl acceptance adaptation; carried
        # across chunks, initialized lazily from the first box
        self._baro = None
        self._step_chunk = jax.jit(self._step_chunk_impl, static_argnames=('n_steps',))
        # r-RESPA fast/slow splits, built lazily on first use
        self._respa = None
        self._respa3 = None

    # ------------------------------------------------------------------
    def set_positions(self, positions, box=None):
        pos = jnp.asarray(positions)
        e, f, _, _ = self.potential.energy_forces(pos)
        box = self.system.box if box is None else box
        self.state = I.MDState(
            positions=pos, velocities=jnp.zeros_like(pos), forces=f,
            potential_energy=e,
            box=jnp.asarray(box if box is not None else np.zeros(3), pos.dtype),
            step=jnp.zeros((), jnp.int32), rng=self._key)

    def set_velocities_to_temperature(self, temperature_k):
        key, sub = jax.random.split(self.state.rng)
        v = I.maxwell_boltzmann_velocities(self.system, temperature_k, sub,
                                           self.state.positions.dtype)
        self.state = dataclasses.replace(self.state, velocities=v, rng=key)

    # ------------------------------------------------------------------
    def _energy_forces(self, positions):
        e, f, _, _ = self.potential._energy_forces(positions)
        return e, f

    def _health(self, diag):
        return health_flag(diag)

    def _auto_rebuild(self, nl_carry, p, box, pot=None):
        """Displacement-triggered on-device list rebuild: lax.cond reruns the
        jittable build when twice the max O displacement since the last build
        exceeds half the skin (the lists key on O-O distances only, so O
        drift bounds their staleness) - exact validity every step, zero host
        syncs. nl_carry = (nlists, build_positions, overflow_flag); a padded
        capacity overflow at a mid-chunk rebuild ORs into the carried flag,
        surfaced at report boundaries (a truncated list silently drops
        interactions, so it must not be visible only when the end-of-chunk
        health re-build happens to reproduce it). The build needs no
        molecule imaging: _neighbor_lists reads only O positions, which
        make_molecules_whole never moves (it re-images H/M around O)."""
        pot = pot or self.potential
        nl, pb, ovf = nl_carry
        o_idx = np.asarray(self.system.o_index)
        skin = pot.config.nlist_skin

        def rebuild():
            pl, tl, d = pot._neighbor_lists(p, box=box)
            return (pl, tl), p, ovf | d['pair_overflow'] | d['triplet_overflow']

        disp = jnp.max(jnp.linalg.norm(p[o_idx] - pb[o_idx], axis=-1))
        return jax.lax.cond(2.0 * disp > 0.5 * skin, rebuild,
                            lambda: (nl, pb, ovf))

    def _one_step(self, state, mu=None, nlists=None, nl_carry=None):
        cfg = self.config
        # with a barostat the box is dynamic state; otherwise it is static
        box = state.box if cfg.barostat_pressure is not None else None

        aux = [mu, jnp.ones((), bool), nl_carry]

        def ef2(p):
            nl = nlists
            if nl_carry is not None:
                aux[2] = self._auto_rebuild(nl_carry, p, box)
                nl = aux[2][0]
            e, f, parts, diag = self.potential._energy_forces_impl(
                p, mu if cfg.scf_warm_start else None, nlists=nl, box=box)
            aux[0] = diag.get('induced_dipoles')
            aux[1] = self._health(diag)
            return e, f

        if cfg.temperature is not None and cfg.thermostat == 'langevin':
            state = I.langevin_step(self.system, ef2, state,
                                    cfg.dt, cfg.temperature, cfg.friction)
        else:
            state = I.velocity_verlet_step(self.system, ef2, state, cfg.dt)
            if cfg.temperature is not None and cfg.thermostat == 'andersen':
                state = I.andersen_thermostat(self.system, state, cfg.dt,
                                              cfg.temperature, cfg.collision_frequency)
        state = self._maybe_remove_cm(state)
        return state, aux[0], aux[1], aux[2]

    def _maybe_remove_cm(self, state):
        """CMMotionRemover application at cm_motion_interval (OpenMM checks
        step % frequency == 0; interval 1 skips the cond)."""
        k = int(self.config.cm_motion_interval)
        if not k:
            return state
        v = state.velocities
        if k == 1:
            v = I.remove_cm_motion(self.system, v)
        else:
            v = jax.lax.cond(state.step % k == 0,
                             lambda: I.remove_cm_motion(self.system, v),
                             lambda: v)
        return dataclasses.replace(state, velocities=v)

    def _respa_split(self):
        """(ef_fast, pot_slow) for r-RESPA, built once. Fast = the one-body
        monomer term; slow = everything else on its own MBPol instance
        (tuned capacities inherited) - the same split ring-polymer
        contraction uses (md/rpmd.mbpol_intra_inter_split)."""
        if self._respa is None:
            from mbpol_openmm_plugin_tpu.md.rpmd import mbpol_intra_inter_split
            ef_intra, ef_inter = mbpol_intra_inter_split(self.potential)
            self._respa = (ef_intra, ef_inter._potential)
        return self._respa

    def _respa_split3(self):
        """(ef_fast, pot_mid, pot_slow, pot_inter) for three-level r-RESPA:
        fast = monomer term, slow = respa_slow_terms (default three_body),
        mid = the remaining intermolecular terms. pot_inter (all
        intermolecular terms) builds the shared pair+triplet lists once per
        rebuild; mid/slow evaluations receive them via nlists=. Tuned
        capacities inherit from the parent potential."""
        if self._respa3 is None:
            import dataclasses as _dc

            from mbpol_openmm_plugin_tpu.md.rpmd import mbpol_intra_inter_split
            from mbpol_openmm_plugin_tpu.models.potential import (
                MBPol, inherit_capacities)
            ef_intra, ef_inter = mbpol_intra_inter_split(self.potential)
            pot_inter = ef_inter._potential
            slow_terms = tuple(t for t in pot_inter.config.terms
                               if t in self.config.respa_slow_terms)
            mid_terms = tuple(t for t in pot_inter.config.terms
                              if t not in slow_terms)
            pot_fast = None
            if (self.config.respa_polarization_rung == 'inner'
                    and 'electrostatics' in mid_terms):
                # polarization joins the fast rung: fast = monomer +
                # electrostatics on one potential (the ASPC closure then
                # advances at the base step), mid = the remaining
                # intermolecular terms
                mid_terms = tuple(t for t in mid_terms
                                  if t != 'electrostatics')
                fast_terms = ('one_body', 'electrostatics')
                pot_fast = inherit_capacities(self.potential, MBPol(
                    self.system,
                    _dc.replace(pot_inter.config, terms=fast_terms),
                    mesh=self.potential.mesh))
            if not slow_terms or not mid_terms:
                raise ValueError(
                    f'respa_mid > 1 needs a non-trivial term split; got '
                    f'slow={slow_terms} mid={mid_terms} from '
                    f'respa_slow_terms={self.config.respa_slow_terms}')
            pot_mid = inherit_capacities(self.potential, MBPol(
                self.system, _dc.replace(pot_inter.config, terms=mid_terms),
                mesh=self.potential.mesh))
            pot_slow = inherit_capacities(self.potential, MBPol(
                self.system, _dc.replace(pot_inter.config, terms=slow_terms),
                mesh=self.potential.mesh))
            self._respa3 = (ef_intra, pot_mid, pot_slow, pot_inter,
                            pot_fast)
        return self._respa3

    def _one_step_respa(self, state, mu, f_slow, nlists=None, nl_carry=None):
        """One r-RESPA outer step.
        Returns (state', mu', f_slow', health, nl_carry')."""
        cfg = self.config
        ef_intra, pot_slow = self._respa_split()
        box = state.box if cfg.barostat_pressure is not None else None

        aux = [mu, jnp.ones((), bool), nl_carry]

        def ef_slow(p):
            nl = nlists
            if nl_carry is not None:
                aux[2] = self._auto_rebuild(nl_carry, p, box, pot=pot_slow)
                nl = aux[2][0]
            e, f, parts, diag = pot_slow._energy_forces_impl(
                p, mu if cfg.scf_warm_start else None, nlists=nl, box=box)
            aux[0] = diag.get('induced_dipoles')
            aux[1] = self._health(diag)
            return e, f

        def ef_fast(p):
            return ef_intra(p, box)

        if cfg.temperature is not None and cfg.thermostat == 'langevin':
            state, f_slow, _ = I.respa_langevin_step(
                self.system, ef_fast, ef_slow, state, f_slow, cfg.dt,
                cfg.respa_inner, cfg.temperature, cfg.friction)
        else:
            state, f_slow, _ = I.respa_velocity_verlet_step(
                self.system, ef_fast, ef_slow, state, f_slow, cfg.dt,
                cfg.respa_inner)
            if cfg.temperature is not None and cfg.thermostat == 'andersen':
                state = I.andersen_thermostat(self.system, state, cfg.dt,
                                              cfg.temperature,
                                              cfg.collision_frequency)
        state = self._maybe_remove_cm(state)
        return state, aux[0], f_slow, aux[1], aux[2]

    def _one_step_respa3(self, state, mu, f_mid, f_slow, nlists=None,
                         nl_carry=None, B=None, f_fast=None):
        """One three-level r-RESPA outer step (respa_mid middle sub-steps,
        respa_inner monomer steps each). mu is the ASPC dipole-history
        stack [h, natoms, 3] when B (predictor coefficients) is given,
        else plain warm-start dipoles (or None); the predictor/corrector
        update runs INSIDE each middle evaluation - the polarization lives
        on the middle rung, so its closure advances at dt/respa_mid.
        With respa_polarization_rung='inner' the fast rung is stateful
        (ASPC history advances per base step) and `f_fast` must be the
        carried fast forces at state.positions.
        Returns (state', mu', f_mid', f_slow', health, nl_carry',
        f_fast')."""
        cfg = self.config
        ef_intra, pot_mid, pot_slow, _, pot_fast = self._respa_split3()
        polar_inner = pot_fast is not None
        box = state.box if cfg.barostat_pressure is not None else None

        aux = [mu, jnp.ones((), bool), nl_carry]

        def _aspc_mu0():
            m = aux[0]
            if m is None or not cfg.scf_warm_start:
                return None
            return jnp.einsum('h,hnd->nd', B, m) if B is not None else m

        def _aspc_update(diag):
            m = aux[0]
            mu_new = diag.get('induced_dipoles')
            if m is not None and mu_new is not None:
                aux[0] = (jnp.roll(m, 1, axis=0).at[0].set(mu_new)
                          if B is not None else mu_new)
            aux[1] = aux[1] & self._health(diag)

        def ef_mid(p):
            nl = nlists
            if aux[2] is not None:
                aux[2] = self._auto_rebuild(aux[2], p, box, pot=pot_mid)
                nl = aux[2][0]
            if polar_inner:
                # no electrostatics on this rung; the ASPC history lives
                # in ef_fast
                e, f, parts, diag = pot_mid._energy_forces_impl(
                    p, nlists=nl, box=box)
                aux[1] = aux[1] & self._health(diag)
                return e, f
            e, f, parts, diag = pot_mid._energy_forces_impl(
                p, _aspc_mu0(), nlists=nl, box=box)
            _aspc_update(diag)
            return e, f

        def ef_slow(p):
            # runs at the same positions as the last middle evaluation, so
            # the carried lists are already validated for p
            nl = aux[2][0] if aux[2] is not None else nlists
            e, f, parts, diag = pot_slow._energy_forces_impl(
                p, nlists=nl, box=box)
            aux[1] = aux[1] & self._health(diag)
            return e, f

        if polar_inner:
            # polarization on the base-step rung: the ASPC closure
            # advances at dt/(respa_mid*respa_inner) - the single-step
            # cadence and its low-drift regime
            # (respa_polarization_rung='inner'); requires the unrolled
            # inner loop so this closure can thread its aux state.
            # The fast forces are CARRIED across outer steps (f_fast):
            # re-evaluating at the step boundary with the ASPC predictor
            # yields forces that differ from the previous final half-kick
            # (corrected dipoles, same positions) - a per-outer-step
            # force discontinuity that heats NVE strongly. With
            # the carry, every ef_fast call is an inner-loop evaluation
            # at a fresh position and advances the history - uniform
            # dti cadence, no duplicates. A group-boundary seed (no
            # history advance) is computed in scan_group; None here
            # (direct callers without a carry) falls back to one seed
            # evaluation that must not advance the history either.
            seeded = [f_fast is not None]

            def ef_fast(p):
                e, f, parts, diag = pot_fast._energy_forces_impl(
                    p, _aspc_mu0(), box=box)
                if seeded[0]:
                    _aspc_update(diag)
                else:
                    aux[1] = aux[1] & self._health(diag)
                seeded[0] = True
                return e, f
        else:
            f_fast = None  # stateless monomer term: re-evaluation is exact

            def ef_fast(p):
                return ef_intra(p, box)

        if cfg.temperature is not None and cfg.thermostat == 'langevin':
            raise NotImplementedError(
                'respa_mid > 1 supports velocity-Verlet (+ Andersen) only; '
                'use the two-level respa_inner split with langevin')
        state, f_mid, f_slow, f_fast_out = I.respa3_velocity_verlet_step(
            self.system, ef_fast, ef_mid, ef_slow, state, f_mid, f_slow,
            cfg.dt, cfg.respa_mid, cfg.respa_inner,
            unroll_inner=polar_inner, f_fast=f_fast)
        if cfg.temperature is not None and cfg.thermostat == 'andersen':
            state = I.andersen_thermostat(self.system, state, cfg.dt,
                                          cfg.temperature,
                                          cfg.collision_frequency)
        state = self._maybe_remove_cm(state)
        return (state, aux[0], f_mid, f_slow, aux[1], aux[2],
                f_fast_out if polar_inner else None)

    def _step_chunk_impl(self, state, baro, n_steps):
        cfg = self.config
        use_nl = self.potential.use_neighbor_lists
        auto_nl = use_nl and cfg.nlist_rebuild_interval == 'auto'
        if auto_nl and not self.potential.config.nlist_skin > 0:
            raise ValueError(
                "nlist_rebuild_interval='auto' requires nlist_skin > 0 "
                "(the displacement trigger compares O drift against the skin)")
        if cfg.nlist_rebuild_interval == 'auto' and not use_nl:
            # nothing to rebuild on a dense (<=24 water) potential; treat
            # 'auto' as a no-op instead of crashing in the int() coercion
            reuse = 1
        else:
            reuse = 1 if auto_nl else max(int(cfg.nlist_rebuild_interval), 1)
        warm = cfg.scf_warm_start and self.potential.elec_params is not None
        # ASPC closure (potential scf_method='aspc'): the scan carries the
        # last k+2 corrected dipole sets and feeds the B_j-weighted
        # predictor into the single SOR-damped corrector each step; see
        # models/electrostatics.scf_induced_dipoles_aspc.
        aspc = warm and self.potential.config.scf_method == 'aspc'
        B = (jnp.asarray(elec.aspc_predictor_coefficients(
                 self.potential.config.aspc_k), state.positions.dtype)
             if aspc else None)

        respa3 = int(cfg.respa_mid) > 1
        respa = (not respa3) and int(cfg.respa_inner) > 1
        pot_nl = (self._respa_split3()[3] if respa3
                  else self._respa_split()[1] if respa else self.potential)

        def scan_group(state, mu, n):
            nlists = None
            nlc = None
            ovf0 = jnp.zeros((), bool)
            box = state.box if cfg.barostat_pressure is not None else None
            if auto_nl:
                # entry build; the scan carries (lists, build positions,
                # overflow flag) and each step's evaluation rebuilds on
                # displacement (lax.cond). Build overflow - entry or any
                # mid-chunk rebuild - rides the carry to the report boundary.
                pl, tl, d = pot_nl._neighbor_lists(state.positions, box=box)
                ovf0 = d['pair_overflow'] | d['triplet_overflow']
                nlc = ((pl, tl), state.positions, ovf0)
            elif use_nl and reuse > 1:
                pl, tl, d = pot_nl._neighbor_lists(state.positions, box=box)
                ovf0 = d['pair_overflow'] | d['triplet_overflow']
                nlists = (pl, tl)

            f_slow = None
            f_mid = None
            f_fast = None
            if respa3:
                # mid + slow forces at the group's entry positions (also
                # refreshed after a barostat volume move rescaled everything).
                # Under ASPC the seed is the SAME B_j-weighted extrapolation
                # the in-scan evaluations use (r3 advisor: mu[0] gave the
                # carried forces a different dipole convention at every
                # group boundary).
                _, pot_mid, pot_slow, _, pot_fast3 = self._respa_split3()
                mu_seed = (jnp.einsum('h,hnd->nd', B, mu)
                           if (aspc and mu is not None) else mu)
                nl_arg = nlc[0] if auto_nl else nlists
                _, f_mid, _, _ = pot_mid._energy_forces_impl(
                    state.positions,
                    (mu_seed if (warm and pot_fast3 is None) else None),
                    nlists=nl_arg, box=box)
                _, f_slow, _, _ = pot_slow._energy_forces_impl(
                    state.positions, nlists=nl_arg, box=box)
                if pot_fast3 is not None:
                    # inner-rung polarization: seed the carried fast
                    # forces with the SAME predictor convention as the
                    # in-scan evaluations; the seed does NOT advance the
                    # dipole history (it is at the same position as the
                    # previous group's last inner evaluation)
                    _, f_fast, _, _ = pot_fast3._energy_forces_impl(
                        state.positions, mu_seed if warm else None,
                        box=box)
            elif respa:
                # slow forces at the group's entry positions (also refreshes
                # them after a barostat volume move rescaled everything);
                # ASPC seed convention matches the in-scan predictor (above)
                mu_seed = (jnp.einsum('h,hnd->nd', B, mu)
                           if (aspc and mu is not None) else mu)
                _, f_slow, _, _ = self._respa_split()[1]._energy_forces_impl(
                    state.positions, mu_seed if warm else None,
                    nlists=nlc[0] if auto_nl else nlists, box=box)

            def body(carry, _):
                # HOT PATH: the only per-step scan output is the potential
                # energy. Per-step health flags or kinetic energy emitted
                # from inside the scan can break XLA's overlap of the step
                # (anything derived from the SCF while_loop or an extra
                # reduction). The
                # unused health value below is dead-code-eliminated by XLA;
                # health is instead checked at report boundaries (step()).
                s, m, fm, fs, nc, ff = carry
                if respa3:
                    # the ASPC predictor/corrector runs inside each middle
                    # evaluation (_one_step_respa3), so the history carry
                    # updates respa_mid times per outer step; with
                    # polarization on the inner rung it updates per base
                    # step and the fast forces ride the carry (ff)
                    s, m, fm, fs, _ok, nc, ff = self._one_step_respa3(
                        s, m, fm, fs, nlists, nc, B=B if aspc else None,
                        f_fast=ff)
                elif aspc:
                    mu0 = jnp.einsum('h,hnd->nd', B, m)
                    if respa:
                        s, mu_new, fs, _ok, nc = self._one_step_respa(
                            s, mu0, fs, nlists, nc)
                    else:
                        s, mu_new, _ok, nc = self._one_step(s, mu0, nlists, nc)
                    m = jnp.roll(m, 1, axis=0).at[0].set(mu_new)
                elif respa:
                    s, mu_new, fs, _ok, nc = self._one_step_respa(
                        s, m, fs, nlists, nc)
                    # cold runs carry mu=None; keep the scan carry structure
                    m = mu_new if warm else None
                else:
                    s, mu_new, _ok, nc = self._one_step(s, m, nlists, nc)
                    m = mu_new if warm else None
                return (s, m, fm, fs, nc, ff), s.potential_energy

            (state, mu, _, _, nlc_out, _), pes = jax.lax.scan(
                body, (state, mu, f_mid, f_slow, nlc, f_fast), None,
                length=n)
            ovf = nlc_out[2] if auto_nl else ovf0
            return state, mu, pes, ovf

        mu = None
        if warm:
            n = self.system.n_atoms
            mu = jnp.zeros((n, 3), state.positions.dtype)
            # seed from a cold-start evaluation of the current positions
            _, _, _, diag0 = self.potential._energy_forces_impl(state.positions)
            mu = diag0.get('induced_dipoles', mu)
            if aspc:
                mu = jnp.tile(mu[None], (len(elec.aspc_predictor_coefficients(
                    self.potential.config.aspc_k)), 1, 1))

        is_baro = (cfg.barostat_pressure is not None and cfg.temperature is not None
                   and self.system.periodic)
        group = reuse if reuse > 1 else (cfg.barostat_interval if is_baro else n_steps)
        if is_baro:
            group = min(group, cfg.barostat_interval)

            def energy_at(p, box):
                # trial energy at the rescaled box: the box is a traced input
                # of the potential (min-images, PME eterm/scales); the PME
                # grid dimensions and alpha stay at their construction values,
                # valid for small volume fluctuations.
                e, _, _, _ = self.potential._energy_forces_impl(p, box=box)
                return e

        n_groups = n_steps // group if group > 0 else 0
        if n_groups > 4 and n_steps % group == 0:
            # one traced group body (inner scan [+ barostat volume move]),
            # scanned n_steps/group times - the compiled graph size stays
            # independent of the report interval (PIMD _chunk_impl
            # semantics). The unrolled loop below otherwise emits one copy
            # of the group graph PER GROUP: a 5000-step NPT chunk at
            # barostat_interval=25 produced ~33 MB of MLIR and stalled
            # compilation (measured round 3).
            def gbody(carry, _):
                s, m, b, ov = carry
                s, m, pe, o = scan_group(s, m, group)
                if is_baro:
                    s, b = I.monte_carlo_barostat_move_adaptive(
                        self.system, energy_at, s, cfg.temperature,
                        cfg.barostat_pressure, b)
                return (s, m, b, ov | o), pe

            (state, mu, baro, nl_ovf), pes_g = jax.lax.scan(
                gbody, (state, mu, baro, jnp.zeros((), bool)), None,
                length=n_groups)
            ke_end = I.kinetic_energy(self.system, state.velocities)
            return state, baro, pes_g.reshape(-1), ke_end, nl_ovf

        pes = []
        done = 0
        nl_ovf = jnp.zeros((), bool)
        while done < n_steps:
            n = min(group, n_steps - done)
            state, mu, pe, ovf = scan_group(state, mu, n)
            nl_ovf = nl_ovf | ovf
            if is_baro:
                state, baro = I.monte_carlo_barostat_move_adaptive(
                    self.system, energy_at, state, cfg.temperature,
                    cfg.barostat_pressure, baro)
            pes.append(pe)
            done += n
        ke_end = I.kinetic_energy(self.system, state.velocities)
        return state, baro, jnp.concatenate(pes), ke_end, nl_ovf

    def step(self, n_steps, report_interval=None, check_health=True):
        """Advance n_steps. Returns a dict of per-report-interval metrics
        (potential/kinetic/total energy in kJ/mol, temperature in K).

        With check_health=True, raises RuntimeError at report boundaries if
        the SCF failed to converge or a padded neighbor list overflowed
        (the reference throws in-kernel, cpp:888-894)."""
        report_interval = report_interval or n_steps
        pes, kes, steps = [], [], []
        if (self.config.barostat_pressure is not None
                and self.config.temperature is not None
                and self.system.periodic and self._baro is None):
            self._baro = I.barostat_scale_init(self.state.box,
                                               self.state.positions.dtype)
        remaining = n_steps
        while remaining > 0:
            chunk = min(report_interval, remaining)
            self.state, self._baro, pe, ke, nl_ovf = self._step_chunk(
                self.state, self._baro, chunk)
            if check_health:
                # The hot scan emits only per-step PE (in-scan health flags
                # would cost time EVERY step - see _step_chunk_impl);
                # instead pay ONE diagnostic evaluation per report boundary
                # (~a single step's cost, amortized over the interval) plus
                # a NaN check on the PE trace, which catches mid-chunk
                # explosions because NaN propagates to every later step. The
                # carried nl_ovf flag additionally catches a TRANSIENT list
                # overflow at a mid-chunk rebuild that the end-of-chunk
                # re-build might not reproduce.
                pe_host = np.asarray(pe)
                nan_step = (int(np.argmax(np.isnan(pe_host)))
                            if np.isnan(pe_host).any() else None)
                _, _, _, diag = self.potential._energy_forces(self.state.positions)
                if bool(np.asarray(nl_ovf)):
                    raise RuntimeError(
                        'neighbor-list overflow during a chunk rebuild by '
                        f'step {int(self.state.step)}: raise the capacities '
                        'with tune_capacities or the capacity factor')
                if nan_step is not None or not bool(self._health(diag)):
                    at = (int(self.state.step) - chunk + nan_step
                          if nan_step is not None else int(self.state.step))
                    raise RuntimeError(
                        'simulation health check failed at step %d: %s' %
                        (at,
                         {k: diag[k] for k in ('converged', 'iterations', 'epsilon',
                                               'pair_overflow', 'triplet_overflow',
                                               'pair_eval_overflow', 'triplet_eval_overflow')
                          if k in diag}))
            pes.append(float(pe[-1]))
            kes.append(float(ke))
            steps.append(int(self.state.step))
            remaining -= chunk
        ndof = 3 * int(np.sum(np.asarray(self.system.masses) > 0))
        pes = np.asarray(pes)
        kes = np.asarray(kes)
        return dict(step=np.asarray(steps), potential_energy=pes, kinetic_energy=kes,
                    total_energy=pes + kes,
                    temperature=2.0 * kes / (ndof * units.BOLTZMANN_KJ_MOL_K))

    # ------------------------------------------------------------------
    def minimize_energy(self, max_iterations=200, tolerance=10.0,
                        method='lbfgs'):
        """Local energy minimization (OpenMM LocalEnergyMinimizer parity:
        L-BFGS, tolerance = RMS force in kJ/mol/nm). The whole minimization
        is one on-device while_loop (md/minimize.py); method='descent' keeps
        the previous backtracking steepest descent."""
        pos = self.state.positions if self.state is not None else None
        assert pos is not None, 'call set_positions first'

        if method == 'lbfgs':
            from mbpol_openmm_plugin_tpu.md.minimize import lbfgs_minimize

            def eg(p):
                e, f = self._energy_forces(p)
                return e, -f

            cache = getattr(self, '_minimize_jit', {})
            key = (max_iterations, float(tolerance))
            if key not in cache:
                cache[key] = jax.jit(
                    lambda p: lbfgs_minimize(eg, p,
                                             max_iterations=max_iterations,
                                             tolerance=tolerance))
                self._minimize_jit = cache
            pos, _, _ = cache[key](pos)
        else:
            def cond(c):
                pos, step_size, it, e = c
                return (it < max_iterations) & (step_size > 1e-10)

            def body(c):
                pos, step_size, it, e = c
                e0, f = self._energy_forces(pos)
                fnorm = jnp.max(jnp.abs(f)) + 1e-30
                trial = pos + step_size / fnorm * f
                e1, _ = self._energy_forces(trial)
                better = e1 < e0
                pos = jnp.where(better, trial, pos)
                step_size = jnp.where(better, step_size * 1.2, step_size * 0.5)
                return (pos, step_size, it + 1, jnp.where(better, e1, e0))

            init = (pos, jnp.asarray(0.01, pos.dtype), jnp.zeros((), jnp.int32),
                    jnp.asarray(np.inf, pos.dtype))
            pos, _, _, _ = jax.lax.while_loop(cond, body, init)
        e, f, _, _ = self.potential.energy_forces(pos)
        self.state = dataclasses.replace(self.state, positions=pos, forces=f,
                                         potential_energy=e)

    # ------------------------------------------------------------------
    def checkpoint(self):
        """Serializable snapshot of the dynamic state (pytree of arrays)."""
        s = self.state
        ck = dict(positions=np.asarray(s.positions), velocities=np.asarray(s.velocities),
                  forces=np.asarray(s.forces), box=np.asarray(s.box),
                  potential_energy=np.asarray(s.potential_energy),
                  step=np.asarray(s.step), rng=np.asarray(s.rng))
        if self._baro is not None:
            # adaptive barostat move state rides along so NPT resume is
            # bitwise deterministic
            ck['baro_scale'] = np.asarray(self._baro[0])
            ck['baro_attempted'] = np.asarray(self._baro[1])
            ck['baro_accepted'] = np.asarray(self._baro[2])
        return ck

    def load_checkpoint(self, ck):
        self.state = I.MDState(
            positions=jnp.asarray(ck['positions']), velocities=jnp.asarray(ck['velocities']),
            forces=jnp.asarray(ck['forces']), potential_energy=jnp.asarray(ck['potential_energy']),
            box=jnp.asarray(ck['box']), step=jnp.asarray(ck['step']),
            rng=jnp.asarray(ck['rng']))
        if 'baro_scale' in ck:
            self._baro = (jnp.asarray(ck['baro_scale']),
                          jnp.asarray(ck['baro_attempted']),
                          jnp.asarray(ck['baro_accepted']))

    def save_checkpoint(self, path):
        np.savez(path, **self.checkpoint())

    def load_checkpoint_file(self, path):
        with np.load(path) as z:
            self.load_checkpoint({k: z[k] for k in z.files})
