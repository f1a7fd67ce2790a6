"""Integrators and thermostats/barostats, as pure on-device functions.

The reference delegates time stepping to OpenMM (Verlet integrator, Andersen
thermostat as a Force, MonteCarlo barostat; SURVEY 3.4). Here the whole MD
step is a pure function on an `MDState` pytree, so trajectories run under
`lax.scan` entirely on device.

Units: nm, ps, amu, kJ/mol (OpenMM internal). Velocities nm/ps.
Virtual M sites carry zero mass: they are skipped in the update (their
positions are recomputed by the potential each step, and the potential
returns zero force rows for them after redistribution).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from mbpol_openmm_plugin_tpu.system import System
from mbpol_openmm_plugin_tpu.utils import units


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MDState:
    positions: jnp.ndarray        # [natoms, 3] nm
    velocities: jnp.ndarray       # [natoms, 3] nm/ps
    forces: jnp.ndarray           # [natoms, 3] kJ/mol/nm (at current positions)
    potential_energy: jnp.ndarray
    box: jnp.ndarray              # [3] nm
    step: jnp.ndarray             # int32
    rng: jnp.ndarray              # PRNG key


def _inv_masses(system: System, dtype):
    m = np.asarray(system.masses)
    inv = np.where(m > 0, 1.0 / np.where(m > 0, m, 1.0), 0.0)
    return jnp.asarray(inv, dtype)[:, None]


def kinetic_energy(system: System, velocities):
    m = jnp.asarray(system.masses, velocities.dtype)
    return 0.5 * jnp.sum(m[:, None] * velocities * velocities)


def temperature(system: System, velocities):
    """Instantaneous temperature from kinetic energy (3 dof per real atom;
    M sites excluded)."""
    ndof = 3 * int(np.sum(np.asarray(system.masses) > 0))
    return 2.0 * kinetic_energy(system, velocities) / (ndof * units.BOLTZMANN_KJ_MOL_K)


def maxwell_boltzmann_velocities(system: System, temperature_k, key, dtype=jnp.float64):
    m = np.asarray(system.masses)
    sigma = np.sqrt(units.BOLTZMANN_KJ_MOL_K * temperature_k /
                    np.where(m > 0, m, 1.0))
    sigma = np.where(m > 0, sigma, 0.0)
    v = jax.random.normal(key, (len(m), 3), dtype) * jnp.asarray(sigma, dtype)[:, None]
    return v


def velocity_verlet_step(system: System, energy_forces_fn, state: MDState, dt):
    """One velocity-Verlet step. energy_forces_fn: positions -> (E, F)."""
    inv_m = _inv_masses(system, state.positions.dtype)
    v_half = state.velocities + 0.5 * dt * state.forces * inv_m
    pos = state.positions + dt * v_half
    energy, forces = energy_forces_fn(pos)
    v_new = v_half + 0.5 * dt * forces * inv_m
    return dataclasses.replace(
        state, positions=pos, velocities=v_new, forces=forces,
        potential_energy=energy, step=state.step + 1)


def respa_velocity_verlet_step(system: System, ef_fast, ef_slow,
                               state: MDState, f_slow, dt, n_inner: int):
    """One r-RESPA (Tuckerman-Berne-Martyna) multiple-timestep step.

    The outer step `dt` kicks with the SLOW forces (2b/3b PIPs,
    polarization/PME, dispersion - the expensive terms); `n_inner`
    velocity-Verlet sub-steps at dt/n_inner integrate the FAST forces (the
    Partridge-Schwenke monomer term, whose ~3700 cm^-1 OH stretch is what
    pins MB-pol's timestep at 0.2 fs while costing ~1% of an evaluation).
    Symplectic splitting: exp(dt/2 L_slow) [exp(dt_i/2 L_fast) exp(dt_i L_r)
    exp(dt_i/2 L_fast)]^n exp(dt/2 L_slow).

    The reference integrates with OpenMM's single-timestep Verlet (SURVEY
    3.4); this is the OpenMM MTSIntegrator role, on device (the inner loop
    is a lax.scan, the whole step stays one pure function on device).

    `f_slow` must be the slow forces at state.positions (carried across
    steps so each step costs ONE slow evaluation). Returns
    (state', f_slow', f_fast') with state'.forces = total forces and
    state'.potential_energy = full (fast + slow) PE at the new positions.
    """
    inv_m = _inv_masses(system, state.positions.dtype)
    dti = dt / n_inner
    v = state.velocities + 0.5 * dt * f_slow * inv_m
    _, f_fast = ef_fast(state.positions)

    def inner(carry, _):
        pos, v, f_fast = carry
        v = v + 0.5 * dti * f_fast * inv_m
        pos = pos + dti * v
        e_fast, f_fast = ef_fast(pos)
        v = v + 0.5 * dti * f_fast * inv_m
        return (pos, v, f_fast), e_fast

    (pos, v, f_fast), e_fasts = jax.lax.scan(
        inner, (state.positions, v, f_fast), None, length=n_inner)
    e_slow, f_slow = ef_slow(pos)
    v = v + 0.5 * dt * f_slow * inv_m
    state = dataclasses.replace(
        state, positions=pos, velocities=v, forces=f_slow + f_fast,
        potential_energy=e_slow + e_fasts[-1], step=state.step + 1)
    return state, f_slow, f_fast


def respa3_velocity_verlet_step(system: System, ef_fast, ef_mid, ef_slow,
                                state: MDState, f_mid, f_slow, dt,
                                n_mid: int, n_inner: int,
                                unroll_inner: bool = False,
                                f_fast=None):
    """One three-level r-RESPA step (Tuckerman-Berne-Martyna splitting).

    The outer step `dt` kicks with the SLOWEST forces (by default the
    three-body PIP term - ~45% of an MB-pol evaluation, varying on
    intermolecular timescales); `n_mid` middle sub-steps at dt/n_mid kick
    with the MID forces (2b + dispersion + polarization/PME); each middle
    sub-step runs `n_inner` velocity-Verlet steps at dt/(n_mid*n_inner)
    on the FAST forces (the Partridge-Schwenke monomer term whose
    ~3700 cm^-1 OH stretch pins the base timestep). Symplectic:
    exp(dt/2 L_s) [exp(dtm/2 L_m) [VV_fast]^n_i exp(dtm/2 L_m)]^n_m
    exp(dt/2 L_s). This is the standard next level beyond the reference's
    single-timestep Verlet (SURVEY 3.4): the recip/3-body terms already
    live on separate code paths there
    (MBPolReferencePmeElectrostaticsForce.cpp:2113-2265 vs :2510-2716).

    `f_mid`/`f_slow` must be those forces at state.positions (carried
    across steps: one slow + n_mid mid evaluations per outer step).
    `f_fast`, when given, must likewise be the fast forces at
    state.positions; carrying it is REQUIRED for a stateful ef_fast
    (polarization on the inner rung): re-evaluating at the step boundary
    with the ASPC *predictor* produces forces that differ from the
    previous step's final half-kick (computed with the *corrected*
    dipoles at the same positions), a per-outer-step force discontinuity
    that destroys the splitting's time symmetry (strong NVE heating with
    the re-evaluation vs the carried forces below). When None,
    the fast forces are re-evaluated (exact for the stateless monomer
    term). Returns (state', f_mid', f_slow', f_fast') with state'.forces
    the total and potential_energy the full fast+mid+slow PE at the new
    positions."""
    inv_m = _inv_masses(system, state.positions.dtype)
    dtm = dt / n_mid
    dti = dtm / n_inner
    v = state.velocities + 0.5 * dt * f_slow * inv_m
    if f_fast is None:
        _, f_fast = ef_fast(state.positions)
    pos = state.positions

    def inner(c, _):
        pos, v, f_fast = c
        v = v + 0.5 * dti * f_fast * inv_m
        pos = pos + dti * v
        e_fast, f_fast = ef_fast(pos)
        v = v + 0.5 * dti * f_fast * inv_m
        return (pos, v, f_fast), e_fast

    # the middle loop is a static Python unroll (n_mid is small, 2-3), NOT
    # a lax.scan: ef_mid closures from the Simulation driver thread
    # trace-time aux state (SCF dipole history, health flags, the
    # displacement-triggered list-rebuild carry) through Python mutation,
    # which is only sound when every call happens sequentially in the same
    # trace - a scanned body would capture stale tracers
    # unroll_inner=True additionally unrolls the INNER velocity-Verlet
    # loop (n_mid*n_inner total fast evaluations per outer step), which
    # lets ef_fast itself carry trace-time aux state - required when the
    # polarization (ASPC dipole history) lives on the fast rung
    # (SimulationConfig.respa_polarization_rung='inner', the
    # energy-conserving RESPA operating point)
    e_fast_last = None
    e_mid = None
    for _ in range(n_mid):
        v = v + 0.5 * dtm * f_mid * inv_m
        if unroll_inner:
            for _i in range(n_inner):
                c, e_fast_last = inner((pos, v, f_fast), None)
                pos, v, f_fast = c
        else:
            (pos, v, f_fast), e_fasts = jax.lax.scan(
                inner, (pos, v, f_fast), None, length=n_inner)
            e_fast_last = e_fasts[-1]
        e_mid, f_mid = ef_mid(pos)
        v = v + 0.5 * dtm * f_mid * inv_m
    e_slow, f_slow = ef_slow(pos)
    v = v + 0.5 * dt * f_slow * inv_m
    state = dataclasses.replace(
        state, positions=pos, velocities=v,
        forces=f_fast + f_mid + f_slow,
        potential_energy=e_fast_last + e_mid + e_slow,
        step=state.step + 1)
    return state, f_mid, f_slow, f_fast


def respa_langevin_step(system: System, ef_fast, ef_slow, state: MDState,
                        f_slow, dt, n_inner: int, temperature_k, friction):
    """BAOAB-RESPA Langevin step: outer half-kicks with the slow forces
    around `n_inner` BAOAB sub-steps driven by the fast forces (the OpenMM
    MTSLangevinIntegrator role). The O-step runs per inner sub-step with
    the sub-step friction factor, so the n_inner=1 limit is plain BAOAB
    with the force splitting."""
    inv_m = _inv_masses(system, state.positions.dtype)
    m = jnp.asarray(system.masses, state.positions.dtype)[:, None]
    kT = units.BOLTZMANN_KJ_MOL_K * temperature_k
    dti = dt / n_inner
    c1 = jnp.exp(-friction * dti)
    c2 = jnp.sqrt((1.0 - c1 * c1) * kT)
    key, knoise = jax.random.split(state.rng)

    v = state.velocities + 0.5 * dt * f_slow * inv_m
    _, f_fast = ef_fast(state.positions)

    def inner(carry, k):
        pos, v, f_fast = carry
        v = v + 0.5 * dti * f_fast * inv_m
        pos = pos + 0.5 * dti * v
        noise = jax.random.normal(k, v.shape, v.dtype)
        v = c1 * v + jnp.where(m > 0, c2 * jnp.sqrt(inv_m) * noise, 0.0)
        pos = pos + 0.5 * dti * v
        e_fast, f_fast = ef_fast(pos)
        v = v + 0.5 * dti * f_fast * inv_m
        return (pos, v, f_fast), e_fast

    (pos, v, f_fast), e_fasts = jax.lax.scan(
        inner, (state.positions, v, f_fast),
        jax.random.split(knoise, n_inner))
    e_slow, f_slow = ef_slow(pos)
    v = v + 0.5 * dt * f_slow * inv_m
    state = dataclasses.replace(
        state, positions=pos, velocities=v, forces=f_slow + f_fast,
        potential_energy=e_slow + e_fasts[-1], step=state.step + 1, rng=key)
    return state, f_slow, f_fast


def remove_cm_motion(system: System, velocities):
    """OpenMM CMMotionRemover semantics: subtract the mass-weighted
    center-of-mass velocity from every massful particle (massless M sites
    keep their zero velocities). The reference force list includes
    CMMotionRemover (python/tests/TestReferenceMBPolTwoBodyForce.py:28-39,
    force order elec/one/two/three/CMMotionRemover/CustomDispersion); here
    it is a pure function applied inside the scan every
    `cm_motion_interval` steps - without it, f32 force rounding accumulates
    a slow COM drift over long NVE runs."""
    m = jnp.asarray(system.masses, velocities.dtype)[:, None]
    v_cm = jnp.sum(m * velocities, axis=0) / jnp.sum(m)
    return jnp.where(m > 0, velocities - v_cm, velocities)


def andersen_thermostat(system: System, state: MDState, dt, temperature_k,
                        collision_frequency):
    """Andersen thermostat: each (real) atom's velocity is resampled from the
    Maxwell-Boltzmann distribution with probability freq*dt per step."""
    key, k1, k2 = jax.random.split(state.rng, 3)
    m = np.asarray(system.masses)
    p_collide = 1.0 - np.exp(-collision_frequency * dt)
    hit = jax.random.uniform(k1, (len(m),)) < p_collide
    v_new = maxwell_boltzmann_velocities(system, temperature_k, k2,
                                         state.velocities.dtype)
    v = jnp.where((hit & (m > 0))[:, None], v_new, state.velocities)
    return dataclasses.replace(state, velocities=v, rng=key)


def langevin_step(system: System, energy_forces_fn, state: MDState, dt,
                  temperature_k, friction):
    """BAOAB Langevin step (Leimkuhler-Matthews)."""
    inv_m = _inv_masses(system, state.positions.dtype)
    m = jnp.asarray(system.masses, state.positions.dtype)[:, None]
    kT = units.BOLTZMANN_KJ_MOL_K * temperature_k
    c1 = jnp.exp(-friction * dt)
    c2 = jnp.sqrt((1.0 - c1 * c1) * kT)
    key, knoise = jax.random.split(state.rng)

    v = state.velocities + 0.5 * dt * state.forces * inv_m
    pos = state.positions + 0.5 * dt * v
    noise = jax.random.normal(knoise, v.shape, v.dtype)
    sigma = c2 * jnp.sqrt(inv_m)
    v = c1 * v + jnp.where(m > 0, sigma * noise, 0.0)
    pos = pos + 0.5 * dt * v
    energy, forces = energy_forces_fn(pos)
    v = v + 0.5 * dt * forces * inv_m
    return dataclasses.replace(
        state, positions=pos, velocities=v, forces=forces,
        potential_energy=energy, step=state.step + 1, rng=key)


def monte_carlo_barostat_move(system: System, energy_fn, state: MDState,
                              temperature_k, pressure_bar, scale_state):
    """One MC volume move (OpenMM MonteCarloBarostat semantics): isotropic
    rescale of molecule centroids, Metropolis acceptance on
    dU + P dV - N kT ln(V'/V). Returns (state, new scale_state).

    scale_state: (volume_scale_nm3,) adaptive move size.
    """
    kT = units.BOLTZMANN_KJ_MOL_K * temperature_k
    # pressure in bar -> kJ/mol/nm^3: 1 bar = 0.0602214... kJ/mol/nm^3
    p_int = pressure_bar * 0.0602214076
    key, k1, k2 = jax.random.split(state.rng, 3)
    vol = state.box[0] * state.box[1] * state.box[2]
    dv = (jax.random.uniform(k1) * 2.0 - 1.0) * scale_state
    new_vol = vol + dv
    length_scale = (new_vol / vol) ** (1.0 / 3.0)

    # rescale molecule centroids, keep intramolecular geometry rigid
    mol = system.mol_index
    nmol = int(mol.max()) + 1
    m = jnp.asarray(system.masses, state.positions.dtype)
    mw = (m[:, None] * state.positions)
    mol_mass = jax.ops.segment_sum(m, mol, nmol)
    centroid = jax.ops.segment_sum(mw, mol, nmol) / mol_mass[:, None]
    shift = centroid * (length_scale - 1.0)
    pos_new = state.positions + shift[mol]
    box_new = state.box * length_scale

    # BOTH sides of the Metropolis weight from the SAME energy function:
    # state.potential_energy comes from the trajectory's SCF closure (with
    # scf='auto' dynamics that is one ASPC corrector), while energy_fn is
    # a cold-start fully-converged evaluation. Mixing the two conventions
    # puts their systematic offset into w - measured round 3: every move
    # rejected, the adaptive scale collapsed, and a 50 ps water256 NPT run
    # froze at constant volume. One extra converged evaluation per
    # barostat_interval (~4% at interval 25) buys an unbiased weight.
    e_new = energy_fn(pos_new, box_new)
    e_old = energy_fn(state.positions, state.box)
    n_mol = nmol
    w = e_new - e_old + p_int * dv - n_mol * kT * jnp.log(new_vol / vol)
    accept = (w <= 0) | (jax.random.uniform(k2) < jnp.exp(-w / kT))

    pos = jnp.where(accept, pos_new, state.positions)
    box = jnp.where(accept, box_new, state.box)
    e = jnp.where(accept, e_new, e_old)
    state = dataclasses.replace(state, positions=pos, box=box,
                                potential_energy=e, rng=key)
    return state, accept


def barostat_scale_init(box, dtype=None):
    """Initial adaptive volume-move state: (scale_nm3, attempted, accepted).
    OpenMM MonteCarloBarostatImpl convention: scale starts at 1% of V."""
    box = jnp.asarray(box)
    dtype = dtype or box.dtype
    vol = box[0] * box[1] * box[2]
    return (jnp.asarray(0.01 * vol, dtype), jnp.zeros((), jnp.int32),
            jnp.zeros((), jnp.int32))


def barostat_scale_update(baro, accept, volume):
    """OpenMM MonteCarloBarostatImpl.cpp acceptance adaptation: every >=10
    attempts, shrink the move size /1.1 when the acceptance fraction is
    below 0.25, grow it x1.1 (capped at 0.3 V) above 0.75 - counters reset
    only when an adjustment fires. Pure jnp, scan-carry friendly."""
    scale, att, acc = baro
    att = att + 1
    acc = acc + accept.astype(jnp.int32)
    attf = att.astype(scale.dtype)
    accf = acc.astype(scale.dtype)
    low = accf < 0.25 * attf
    high = accf > 0.75 * attf
    fire = (att >= 10) & (low | high)
    new_scale = jnp.where(low, scale / 1.1,
                          jnp.minimum(scale * 1.1, 0.3 * volume))
    scale = jnp.where(fire, new_scale, scale)
    att = jnp.where(fire, 0, att)
    acc = jnp.where(fire, 0, acc)
    return (scale, att, acc)


def monte_carlo_barostat_move_adaptive(system: System, energy_fn,
                                       state: MDState, temperature_k,
                                       pressure_bar, baro):
    """`monte_carlo_barostat_move` with OpenMM's adaptive move sizing:
    baro = (scale_nm3, attempted, accepted) from `barostat_scale_init`.
    Returns (state, baro')."""
    state, accept = monte_carlo_barostat_move(system, energy_fn, state,
                                              temperature_k, pressure_bar,
                                              baro[0])
    vol = state.box[0] * state.box[1] * state.box[2]
    return state, barostat_scale_update(baro, accept, vol)
