"""Thermostatted ring-polymer MD (PIMD / T-RPMD) on device.

The reference cites path-integral MD as the method MB-pol is used with
(README.md:13) but ships no PIMD machinery - it delegates to external
drivers. Here the framework provides it natively, built from the pieces
the framework already has: the bead-replicated potential is a `vmap`
over a leading bead axis (md/replicas.py), the exact free ring-polymer
evolution is a pair of static [n, n] normal-mode matmuls (no FFT needed
at PIMD bead counts), and the whole step is a pure
function on an `MDState` pytree (bead-leading shapes) that runs under
`lax.scan` like the classical integrators.

Algorithm: PILE thermostat (Ceriotti, Parrinello, Markland, Manolopoulos,
J. Chem. Phys. 133, 124104 (2010)) in the BAOAB splitting:
half force kick -> half exact free-RP evolution (normal modes) -> full
OU thermostat step (mode-matched friction gamma_k = 2 omega_k; centroid
gamma_0 = 1/tau0, or 0 for Hamiltonian/NVE RPMD) -> half free-RP
evolution -> half force kick. One potential evaluation per step.

Conventions: the ring-polymer Hamiltonian
  H_n = sum_i p_i^2/2m + sum_i 1/2 m omega_n^2 (q_i - q_{i+1})^2 + sum_i V(q_i)
is sampled at beta_n = beta/n (mode momenta at variance m * n*kB*T),
with omega_n = n*kB*T/hbar. Units: nm, ps, amu, kJ/mol (OpenMM internal,
matching md/integrators.py); hbar = 0.063508 kJ/mol*ps.

Virtual M sites carry zero mass: their momenta stay exactly zero (zero
force rows from the potential, inv_m = 0 in the drift), and their
positions are recomputed by the potential each evaluation.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from mbpol_openmm_plugin_tpu.md.integrators import MDState, _inv_masses
from mbpol_openmm_plugin_tpu.system import System
from mbpol_openmm_plugin_tpu.utils import units

# hbar * N_A in kJ/mol * ps (CODATA hbar = 1.054571817e-34 J s):
# * N_A (-> J s/mol), / 1000 (-> kJ), / 1e-12 (s -> ps) = 0.0635077993
HBAR_KJMOL_PS = 1.054571817e-34 * 6.02214076e23 / 1000.0 / 1e-12


def normal_mode_matrix(n_beads):
    """Orthonormal cyclic normal-mode transform C [n, n]: P_k = C @ p.

    Row 0 is the centroid, rows 1..n/2 cosine modes (incl. the Nyquist row
    for even n), the rest sine modes. C @ C.T = I exactly.
    """
    n = n_beads
    j = np.arange(n)
    C = np.zeros((n, n))
    C[0] = np.sqrt(1.0 / n)
    for k in range(1, n // 2 + 1):
        if 2 * k == n:
            C[k] = np.sqrt(1.0 / n) * (-1.0) ** j
        else:
            C[k] = np.sqrt(2.0 / n) * np.cos(2.0 * np.pi * k * j / n)
    for k in range(n // 2 + 1, n):
        C[k] = np.sqrt(2.0 / n) * np.sin(2.0 * np.pi * (n - k) * j / n)
    return C


def normal_mode_frequencies(n_beads, temperature_k):
    """omega_k = 2 omega_n sin(pi k~ / n) [1/ps], ordered to match
    normal_mode_matrix rows; omega_0 = 0 (centroid)."""
    kT = units.BOLTZMANN_KJ_MOL_K * temperature_k
    omega_n = n_beads * kT / HBAR_KJMOL_PS
    k = np.arange(n_beads)
    k_t = np.minimum(k, n_beads - k)
    return 2.0 * omega_n * np.sin(np.pi * k_t / n_beads)


def contraction_matrix(n_beads, n_contracted):
    """Ring-polymer contraction transform T [n_c, n] (Markland &
    Manolopoulos, J. Chem. Phys. 129, 024105 (2008)): truncate the
    normal-mode expansion to the n_c lowest-frequency modes and resample
    onto an n_c-bead ring, T = sqrt(n_c/n) C_c^T S C with S matching
    (k, cos/sin) rows. Exact identity at n_c == n; otherwise n_c must be
    odd so the kept mode set is unambiguous (no Nyquist splitting).

    Properties (tested): T @ (all-equal beads) = the same point (row sums
    n_c/n x n / n_c ... i.e. centroid preserved), and potentials linear
    in position are contracted exactly.
    """
    n, nc = int(n_beads), int(n_contracted)
    if nc == n:
        return np.eye(n)
    if not (1 <= nc < n) or nc % 2 == 0:
        raise ValueError(
            f'n_contracted={nc} must be odd and in [1, n_beads={n}]')
    C = normal_mode_matrix(n)
    Cc = normal_mode_matrix(nc)
    rows_c, rows_full = [0], [0]
    for k in range(1, nc // 2 + 1):
        rows_c += [k, nc - k]          # cos k, sin k of the small ring
        rows_full += [k, n - k]        # cos k, sin k of the full ring
    return np.sqrt(nc / n) * (Cc[rows_c].T @ C[rows_full])


def contracted_energy_forces(ef_inter, ef_intra, n_beads, n_contracted):
    """RPC evaluation: returns batched ef(q [n, natoms, 3]) -> (e [n],
    f [n, natoms, 3]) where the expensive intermolecular potential is
    evaluated on n_c contracted beads, E_inter = (n/n_c) sum_a V(q'_a),
    and the cheap intramolecular potential on all n beads. Forces on the
    full beads via the transpose transform, F += (n/n_c) T^T F'.
    The intermolecular energy is distributed evenly over the per-bead
    energy vector so sum(e) is the exact RPC potential (the conserved
    ring_polymer_hamiltonian uses the sum)."""
    n, nc = int(n_beads), int(n_contracted)
    T = contraction_matrix(n, nc)
    scale = n / nc
    b_inter = jax.vmap(ef_inter)
    b_intra = jax.vmap(ef_intra)

    def ef(q):
        Tj = jnp.asarray(T, q.dtype)
        qc = jnp.tensordot(Tj, q, axes=(1, 0))
        e_c, f_c = b_inter(qc)
        e_i, f_i = b_intra(q)
        f = f_i + scale * jnp.tensordot(Tj.T, f_c, axes=(1, 0))
        e = e_i + (scale / n) * jnp.sum(e_c)
        return e, f

    return ef


def spring_energy(system: System, positions, temperature_k):
    """Ring-polymer spring energy sum_i 1/2 m omega_n^2 |q_i - q_{i+1}|^2
    (cyclic, kJ/mol). positions: [n_beads, natoms, 3]."""
    n = positions.shape[0]
    kT = units.BOLTZMANN_KJ_MOL_K * temperature_k
    omega_n = n * kT / HBAR_KJMOL_PS
    m = jnp.asarray(np.asarray(system.masses), positions.dtype)[None, :, None]
    d = positions - jnp.roll(positions, -1, axis=0)
    return 0.5 * omega_n ** 2 * jnp.sum(m * d * d)


def kinetic_energy_virial(system: System, positions, forces, temperature_k):
    """Centroid-virial quantum kinetic-energy estimator (kJ/mol):
    KE = 3N/(2 beta) - 1/(2n) sum_i (q_i - q_c) . F_i."""
    n = positions.shape[0]
    kT = units.BOLTZMANN_KJ_MOL_K * temperature_k
    n_real = int(np.sum(np.asarray(system.masses) > 0))
    qc = jnp.mean(positions, axis=0, keepdims=True)
    return (1.5 * n_real * kT
            - 0.5 / n * jnp.sum((positions - qc) * forces))


def kinetic_energy_primitive(system: System, positions, temperature_k):
    """Primitive quantum kinetic-energy estimator (kJ/mol):
    KE = 3 N n/(2 beta) - E_spring."""
    n = positions.shape[0]
    kT = units.BOLTZMANN_KJ_MOL_K * temperature_k
    n_real = int(np.sum(np.asarray(system.masses) > 0))
    return 1.5 * n_real * n * kT - spring_energy(system, positions,
                                                 temperature_k)


def ring_polymer_hamiltonian(system: System, state: MDState, temperature_k):
    """Conserved quantity of the gamma = 0 (NVE) RPMD flow:
    sum_beads (classical KE + V) + E_spring."""
    m = jnp.asarray(np.asarray(system.masses),
                    state.velocities.dtype)[None, :, None]
    ke = 0.5 * jnp.sum(m * state.velocities * state.velocities)
    return (ke + spring_energy(system, state.positions, temperature_k)
            + jnp.sum(state.potential_energy))


def initial_state(system: System, positions, n_beads, temperature_k, key,
                  box=None, spread=0.0):
    """Bead-leading MDState: beads start at `positions` (optionally with a
    small Gaussian spread on real atoms) and zero velocities (the PILE
    thermostat equilibrates the modes).

    box: display/bookkeeping only and must equal system.box - RPMD has no
    barostat, and the potential evaluations (make_rpmd_potential_step,
    PIMDSimulation) run at the STATIC system.box; accepting a different
    value here would silently evaluate wrong periodic physics."""
    if box is not None:
        if system.box is None:
            raise ValueError('box given but the System is non-periodic; '
                             'pass box at System construction')
        if not np.allclose(np.asarray(box), np.asarray(system.box)):
            raise ValueError(f'box {box} != system.box {system.box}; RPMD '
                             'evaluates at the static system.box')
    dtype = positions.dtype
    pos = jnp.broadcast_to(positions[None], (n_beads,) + positions.shape)
    key, k1 = jax.random.split(key)
    if spread > 0.0:
        real = (np.asarray(system.masses) > 0)[None, :, None]
        pos = pos + jnp.where(
            real, spread * jax.random.normal(k1, pos.shape, dtype), 0.0)
    return MDState(
        positions=pos,
        velocities=jnp.zeros_like(pos),
        forces=jnp.zeros_like(pos),
        potential_energy=jnp.zeros((n_beads,), dtype),
        box=jnp.asarray(system.box if box is None else box, dtype)
        if (system.periodic or box is not None) else jnp.zeros((3,), dtype),
        step=jnp.zeros((), jnp.int32),
        rng=key)


def make_rpmd_step(system: System, energy_forces_fn, n_beads, dt,
                   temperature_k, tau0=None, thermostat='pile', mesh=None,
                   batched=False, with_aux=False, with_box=False):
    """Returns a jittable `step(state) -> state` doing one BAOAB step.

    energy_forces_fn: positions [natoms, 3] -> (E, F) for ONE bead; it is
    vmapped over the bead axis here (each bead's SCF converges
    independently; md/replicas.py semantics).
    tau0: centroid thermostat time constant in ps (PILE-L). None or 0 ->
    gamma_0 = 0: the centroid is Hamiltonian (T-RPMD).
    thermostat: 'pile' (internal modes at gamma_k = 2 omega_k) for
    sampling, or 'none' (every gamma = 0, the O step is the identity) for
    Hamiltonian/NVE RPMD dynamics - that flow conserves
    ring_polymer_hamiltonian.
    mesh: optional `jax.sharding.Mesh` with a 'dp' axis. Beads are
    embarrassingly parallel in the potential evaluation (the dominant
    cost), so the bead axis is sharded over 'dp': each device evaluates
    n/n_devices beads' full MB-pol forces; the tiny [n, n] normal-mode
    matmuls contract the sharded axis and XLA inserts the
    collectives. The trajectory is bitwise independent of the mesh
    (noise is drawn from the replicated key at full bead shape).
    """
    n = int(n_beads)
    if mesh is not None:
        n_dev = mesh.shape['dp']
        if n % n_dev:
            raise ValueError(
                f'n_beads={n} not divisible by mesh dp={n_dev}')
        from jax.sharding import NamedSharding, PartitionSpec
        bead_sharding = NamedSharding(mesh, PartitionSpec('dp'))

        def shard_beads(x):
            return jax.lax.with_sharding_constraint(x, bead_sharding)
    else:
        def shard_beads(x):
            return x
    kT = units.BOLTZMANN_KJ_MOL_K * temperature_k
    C = normal_mode_matrix(n)
    omega = normal_mode_frequencies(n, temperature_k)

    if thermostat not in ('pile', 'none'):
        raise ValueError(thermostat)
    if thermostat == 'none':
        gamma = np.zeros(n)
    else:
        gamma = 2.0 * omega
        gamma[0] = (1.0 / tau0) if tau0 else 0.0
    c1 = np.exp(-gamma * dt)
    c2 = np.sqrt(np.maximum(1.0 - c1 * c1, 0.0))

    # exact free-RP half-step: theta = omega dt/2
    th = omega * (0.5 * dt)
    cos_h = np.cos(th)
    # sin(theta)/omega with the omega -> 0 limit dt/2 (centroid drift)
    sin_over_omega = np.where(omega > 0.0,
                              np.sin(th) / np.where(omega > 0.0, omega, 1.0),
                              0.5 * dt)
    msin = np.where(omega > 0.0, omega * np.sin(th), 0.0)

    masses = np.asarray(system.masses)
    # batched=True: energy_forces_fn already maps [n, natoms, 3] ->
    # ([n], [n, natoms, 3]) (e.g. contracted_energy_forces)
    # with_aux=True: energy_forces_fn maps (q, aux) -> (e, f, aux') and the
    # returned step maps (state, aux) -> (state, aux') - used to thread
    # SCF warm-start dipoles through the scan (the fixed point, and hence
    # the physics, is unchanged; only the iteration count drops)
    # with_box=True: the fn takes the (dynamic) box as its LAST argument
    # and step() feeds state.box through - the NPT path, where the box is
    # trajectory state (rpmd_barostat_move) rather than a static constant
    if batched:
        batched_ef = energy_forces_fn
    else:
        in_axes = (0,) + ((0,) if with_aux else ()) + \
            ((None,) if with_box else ())
        batched_ef = jax.vmap(energy_forces_fn, in_axes=in_axes)

    def step(state: MDState, aux=None):
        dtype = state.positions.dtype
        m = jnp.asarray(masses, dtype)[None, :, None]
        inv_m = _inv_masses(system, dtype)[None]          # [1, natoms, 1]
        Cj = jnp.asarray(C, dtype)
        c1j = jnp.asarray(c1, dtype)[:, None, None]
        c2j = jnp.asarray(c2, dtype)[:, None, None]
        cosj = jnp.asarray(cos_h, dtype)[:, None, None]
        soj = jnp.asarray(sin_over_omega, dtype)[:, None, None]
        msj = jnp.asarray(msin, dtype)[:, None, None]

        p = shard_beads(state.velocities) * m
        # B: half kick (M sites have zero force rows -> p stays 0)
        p = p + 0.5 * dt * shard_beads(state.forces)

        # to normal modes
        P = jnp.tensordot(Cj, p, axes=(1, 0))
        Q = jnp.tensordot(Cj, state.positions, axes=(1, 0))

        def a_half(P, Q):
            # exact free ring polymer: rotation in (P, m omega Q) per mode
            # (sin_over_omega carries the omega -> 0 centroid drift limit);
            # massless M sites are frozen - the potential replaces them
            Pn = jnp.where(m > 0, cosj * P - m * msj * Q, P)
            Qn = jnp.where(m > 0, soj * inv_m * P + cosj * Q, Q)
            return Pn, Qn

        P, Q = a_half(P, Q)

        # O: OU thermostat on mode momenta, variance m * n kT (beta_n)
        key, knoise = jax.random.split(state.rng)
        xi = jax.random.normal(knoise, P.shape, dtype)
        sigma = jnp.sqrt(m * (n * kT))
        P = c1j * P + jnp.where(m > 0, c2j * sigma * xi, 0.0)

        P, Q = a_half(P, Q)

        # back to beads (bead-sharded over the mesh: the per-bead force
        # evaluation below is the dominant cost and fully parallel)
        p = shard_beads(jnp.tensordot(Cj.T, P, axes=(1, 0)))
        q = shard_beads(jnp.tensordot(Cj.T, Q, axes=(1, 0)))

        box_args = (state.box,) if with_box else ()
        if with_aux:
            # bead-leading aux (e.g. per-bead warm-start dipoles) follows
            # the bead sharding; with a mesh the batched fn's aux is
            # always bead-leading (mesh + contraction is rejected
            # upstream), and without one shard_beads is the identity
            aux = jax.tree_util.tree_map(shard_beads, aux)
            e, f, aux = batched_ef(q, aux, *box_args)
        else:
            e, f = batched_ef(q, *box_args)
        f = shard_beads(f)
        p = p + 0.5 * dt * f
        new = dataclasses.replace(
            state, positions=q, velocities=p * inv_m, forces=f,
            potential_energy=e, step=state.step + 1, rng=key)
        return (new, aux) if with_aux else new

    return step


def rpmd_barostat_move(system: System, bead_energy_fn, state: MDState,
                       temperature_k, pressure_bar, scale_nm3=None):
    """One MC volume move on the ring polymer (centroid scaling NPT).

    Each molecule's beads are rigidly translated so the molecule's
    ring-polymer centroid scales isotropically with the box; intra-bead
    geometry AND the ring-spring energy are invariant (the shift is
    identical on every bead), so the Metropolis weight is

        w = mean_b dU_b + P dV - N_mol kT ln(V'/V)

    (beta_n sum_b dU_b = beta mean_b dU_b). This reduces exactly to
    integrators.monte_carlo_barostat_move (OpenMM MonteCarloBarostat
    semantics, openmmapi Force surface) at n_beads = 1.

    bead_energy_fn(q, box) -> per-bead potential energies in the SAME
    convention as the step function's `potential_energy` (for ring-polymer
    contraction that is intra_b + (scale/n) sum_c U_inter,c - the mean
    over beads is the effective RPC potential either way).
    scale_nm3: volume move size; default 1% of the current volume.
    Returns (state', accepted)."""
    kT = units.BOLTZMANN_KJ_MOL_K * temperature_k
    p_int = pressure_bar * 0.0602214076   # bar -> kJ/mol/nm^3
    key, k1, k2 = jax.random.split(state.rng, 3)
    vol = state.box[0] * state.box[1] * state.box[2]
    if scale_nm3 is None:
        scale_nm3 = 0.01 * vol
    dv = (jax.random.uniform(k1) * 2.0 - 1.0) * scale_nm3
    new_vol = vol + dv
    s = (new_vol / vol) ** (1.0 / 3.0)

    mol = jnp.asarray(system.mol_index)
    nmol = int(np.asarray(system.mol_index).max()) + 1
    m = jnp.asarray(system.masses, state.positions.dtype)
    mol_mass = jax.ops.segment_sum(m, mol, nmol)
    # ring-polymer molecular centroid: mass-weighted over atoms, mean over
    # beads (massless M-sites contribute nothing but ride the shift)
    mw = m[None, :, None] * state.positions                  # [n, na, 3]
    cent_b = jax.vmap(lambda x: jax.ops.segment_sum(x, mol, nmol))(mw)
    centroid = jnp.mean(cent_b, axis=0) / mol_mass[:, None]  # [nmol, 3]
    shift = centroid * (s - 1.0)
    pos_new = state.positions + shift[mol][None]
    box_new = state.box * s

    # both sides of the weight from the same bead_energy_fn - the carried
    # potential_energy may come from a different SCF convention than the
    # trial evaluation (integrators.monte_carlo_barostat_move rationale)
    e_new = bead_energy_fn(pos_new, box_new)
    e_old = bead_energy_fn(state.positions, state.box)
    w = (jnp.mean(e_new - e_old) + p_int * dv
         - nmol * kT * jnp.log(new_vol / vol))
    accept = (w <= 0) | (jax.random.uniform(k2) < jnp.exp(-w / kT))

    pos = jnp.where(accept, pos_new, state.positions)
    box = jnp.where(accept, box_new, state.box)
    e = jnp.where(accept, e_new, e_old)
    state = dataclasses.replace(state, positions=pos, box=box,
                                potential_energy=e, rng=key)
    return state, accept


def make_rpmd_potential_step(potential, n_beads, dt, temperature_k,
                             tau0=None, thermostat='pile', mesh=None):
    """RPMD step over an `MBPol` potential (bead forces via the full jitted
    evaluation; returns the jittable step fn). With `mesh`, beads are
    sharded over the 'dp' axis (see make_rpmd_step)."""

    def ef(pos):
        e, f, parts, diag = potential._energy_forces_impl(pos)
        return e, f

    return make_rpmd_step(potential.system, ef, n_beads, dt, temperature_k,
                          tau0=tau0, thermostat=thermostat, mesh=mesh)


def mbpol_intra_inter_split(potential):
    """Splits an `MBPol` potential for ring-polymer contraction:
    intra = the one-body Partridge-Schwenke monomer term (fast-varying,
    evaluated on every bead), inter = everything else (2b/3b PIPs,
    dispersion, polarization/PME - the expensive part, evaluated on the
    contracted beads). Returns (ef_intra, ef_inter), each
    positions [natoms, 3] -> (E, F)."""
    import dataclasses as _dc

    from mbpol_openmm_plugin_tpu.models.one_body import one_body_energy
    from mbpol_openmm_plugin_tpu.models.potential import MBPol
    from mbpol_openmm_plugin_tpu.system import (make_molecules_whole,
                                                water_positions)

    sys_ = potential.system
    cfg = potential.config
    has_one_body = 'one_body' in cfg.terms
    inter_terms = tuple(t for t in cfg.terms if t != 'one_body')
    pot_inter = (MBPol(sys_, _dc.replace(cfg, terms=inter_terms),
                       mesh=potential.mesh)
                 if has_one_body else potential)
    if pot_inter is not potential:
        # inherit the parent's tuned padded-list capacities (tune_capacities
        # state; a fresh MBPol would fall back to the conservative analytic
        # bounds and waste 2-3x on oversized pair/triplet batches)
        from mbpol_openmm_plugin_tpu.models.potential import inherit_capacities
        inherit_capacities(potential, pot_inter)

    def e_intra(p, box=None):
        # image hydrogens next to their O exactly like the full potential
        # (_energy_forces_impl) so split-across-boundary inputs don't read
        # as huge monomer distortions; box=None -> the system's static box
        p = make_molecules_whole(sys_, p, box=box)
        return jnp.sum(one_body_energy(water_positions(sys_, p)))

    if has_one_body:
        def ef_intra(p, box=None):
            e, g = jax.value_and_grad(e_intra)(p, box)
            return e, -g
    else:
        # the parent excludes one_body: the intra channel is empty (the
        # full term set is evaluated on the contracted beads), keeping the
        # n_contracted == n_beads exactness contract
        def ef_intra(p, box=None):
            return jnp.zeros((), p.dtype), jnp.zeros_like(p)

    def ef_inter(p, box=None):
        e, f, parts, diag = pot_inter._energy_forces_impl(p, box=box)
        return e, f

    ef_inter._potential = pot_inter     # for warm-start plumbing
    return ef_intra, ef_inter


def make_rpmd_contracted_potential_step(potential, n_beads, n_contracted,
                                        dt, temperature_k, tau0=None,
                                        thermostat='pile'):
    """RPMD step with ring-polymer contraction over an `MBPol` potential:
    the one-body monomer term runs on all n beads, the intermolecular
    terms (PIPs, dispersion, polarization) on n_contracted beads - an
    ~n/n_c cost cut for the dominant terms at PIMD bead counts.
    n_contracted must be odd (or equal n_beads, which is exact)."""
    ef_intra, ef_inter = mbpol_intra_inter_split(potential)
    ef = contracted_energy_forces(ef_inter, ef_intra, n_beads, n_contracted)
    return make_rpmd_step(potential.system, ef, n_beads, dt, temperature_k,
                          tau0=tau0, thermostat=thermostat, batched=True)


class PIMDSimulation:
    """PIMD driver over an `MBPol` potential, mirroring `md.Simulation`'s
    surface (chunked on-device stepping, health checks, checkpointing) for
    ring-polymer dynamics. Reported observables are the quantum estimators:
    bead-mean potential <V>, centroid-virial kinetic energy, and their sum
    (the quantum total-energy estimator <E> = KE_cv + <V>)."""

    def __init__(self, potential, n_beads, dt=1e-4, temperature=300.0,
                 tau0=0.1, thermostat='pile', contraction=None, seed=0,
                 mesh=None, scf_warm_start=True, barostat_pressure=None,
                 barostat_interval=25, nlist_rebuild_interval=1,
                 scf='auto'):
        if scf not in ('auto', 'keep'):
            raise ValueError(f"scf must be 'auto' or 'keep', got {scf!r}")
        if (scf == 'auto' and scf_warm_start
                and potential.elec_params is not None
                and potential.config.scf_method == 'sor'):
            # md.Simulation semantics: the dynamics default is the Kolafa
            # ASPC closure (one damped corrector on a B_j-extrapolated
            # predictor) instead of the loosely-converged SOR loop - same
            # fixed point, ~half the per-step SCF cost, near-conservative
            # where SOR is measurably dissipative. scf='keep' preserves
            # the potential's own method along the trajectory.
            from mbpol_openmm_plugin_tpu.models.potential import \
                with_scf_method
            potential = with_scf_method(potential, 'aspc')
        self.potential = potential
        self.system = potential.system
        self.n_beads = int(n_beads)
        self.dt = float(dt)
        self.temperature = float(temperature)
        self.contraction = contraction
        self._key = jax.random.PRNGKey(seed)
        # nlist_rebuild_interval > 1: build the padded pair/triplet lists
        # for the evaluated bead set once every k steps inside the scan
        # instead of inside every per-bead evaluation (REMD nlist_reuse
        # semantics: exact while nlist_skin/2 covers one interval's
        # per-bead drift; per-bead overflow is checked and always fatal).
        # The on-device list build costs more than the MD step itself
        # (measured ~6 ms vs ~4 ms at water256), so the default
        # per-evaluation rebuild dominates bulk PIMD cost.
        self._nl_every = max(int(nlist_rebuild_interval), 1)
        self._nl_reuse = self._nl_every > 1
        if self._nl_reuse:
            if not potential.use_neighbor_lists:
                raise ValueError('nlist_rebuild_interval > 1 needs a '
                                 'neighbor-list potential (bulk systems)')
            if potential.config.nlist_skin <= 0:
                raise ValueError('nlist_rebuild_interval > 1 requires '
                                 'nlist_skin > 0 to stay exact across the '
                                 'reuse interval')
            if barostat_pressure is not None:
                raise ValueError('nlist_rebuild_interval > 1 is '
                                 'unsupported under NPT (the box is '
                                 'trajectory state; lists must follow it)')
        # NPT: MC volume moves on the ring polymer every barostat_interval
        # steps (rpmd_barostat_move: centroid scaling, spring-invariant).
        # The box becomes trajectory state, so the per-bead evaluations
        # take it as a traced argument, exactly like the classical NPT
        # driver.
        self._npt = barostat_pressure is not None
        if self._npt:
            if not potential.system.periodic:
                raise ValueError('barostat_pressure requires a periodic '
                                 'system (PME box)')
            self.barostat_pressure = float(barostat_pressure)
            self.barostat_interval = max(int(barostat_interval), 1)
        # SCF warm start: thread per-bead induced dipoles through the scan
        # (same fixed point, fewer iterations - md.Simulation semantics,
        # cf. SimulationConfig.scf_warm_start). Under 'aspc' the threaded
        # payload is instead the Kolafa dipole HISTORY stack (the last k+2
        # corrected sets, leading axis h): the predictor is the B_j-
        # weighted extrapolation and each evaluation runs exactly one
        # damped corrector (models/electrostatics.scf_induced_dipoles_aspc)
        # - feeding plain last-step dipoles into that corrector is the
        # measured-unstable configuration, hence the two distinct modes.
        _has_elec = potential.elec_params is not None
        self._aspc = (scf_warm_start and _has_elec
                      and potential.config.scf_method == 'aspc')
        self._warm = (scf_warm_start and _has_elec
                      and potential.config.scf_method != 'aspc')
        if self._aspc:
            from mbpol_openmm_plugin_tpu.models.electrostatics import \
                aspc_predictor_coefficients
            _B = aspc_predictor_coefficients(potential.config.aspc_k)
            self._hist_len = len(_B)

            def _predict(h):
                # B_j-weighted predictor over the history axis (works for
                # [h, nc, na, 3] batched and [h, na, 3] per-bead payloads)
                return jnp.tensordot(jnp.asarray(_B, h.dtype), h,
                                     axes=(0, 0))

            def _push(h, mu_new):
                return jnp.roll(h, 1, axis=0).at[0].set(mu_new)
        else:
            self._hist_len = None

            def _predict(m):
                return m

            def _push(m, mu_new):
                return mu_new
        self._mu_predict, self._mu_push = _predict, _push
        # both modes thread a dipole payload through the scan carry
        use_mu = self._warm or self._aspc
        self._use_mu = use_mu
        if contraction:
            if mesh is not None:
                raise ValueError(
                    'mesh + contraction is unsupported: the contracted '
                    'bead set is small and runs unsharded - drop mesh or '
                    'contraction')
            # one split, one contracted evaluation: reused by the step AND
            # by set_positions seeding (avoids a duplicate inter-MBPol and
            # a second identical jit compile)
            ef_intra, ef_inter = mbpol_intra_inter_split(potential)
            self._ef_all = contracted_energy_forces(
                ef_inter, ef_intra, n_beads, contraction)
            pot_inter = ef_inter._potential
            n, nc = int(n_beads), int(contraction)
            Tm = contraction_matrix(n, nc)
            scale = n / nc

            def combine(q, e_c, f_c, e_i, f_i):
                Tj = jnp.asarray(Tm, q.dtype)
                f = f_i + scale * jnp.tensordot(Tj.T, f_c, axes=(1, 0))
                e = e_i + (scale / n) * jnp.sum(e_c)
                return e, f

            def to_contracted(q):
                return jnp.tensordot(jnp.asarray(Tm, q.dtype), q,
                                     axes=(1, 0))

            self._eval_pot = pot_inter
            self._to_eval = to_contracted
            if self._nl_reuse:
                b_intra = jax.vmap(ef_intra, in_axes=(0, None))
                if use_mu:
                    def inter_nl(p, mu0, nl):
                        e, f, parts, diag = pot_inter._energy_forces_impl(
                            p, mu0, nlists=nl)
                        return e, f, diag.get('induced_dipoles', mu0)
                    b_inter_nl = jax.vmap(inter_nl)

                    # aux = (mu-payload, nl, over); the payload is
                    # [nc, na, 3] warm-start dipoles or the [h, nc, na, 3]
                    # ASPC history (predict/push are identity under warm)
                    def ef_aux(q, aux):
                        m, nl, ov = aux
                        qc = to_contracted(q)
                        e_c, f_c, mu_new = b_inter_nl(qc, _predict(m), nl)
                        e_i, f_i = b_intra(q, None)
                        e, f = combine(q, e_c, f_c, e_i, f_i)
                        return e, f, (_push(m, mu_new), nl, ov)

                    self._mu_beads = nc
                else:
                    def inter_nl(p, nl):
                        e, f, parts, diag = pot_inter._energy_forces_impl(
                            p, nlists=nl)
                        return e, f
                    b_inter_nl = jax.vmap(inter_nl)

                    def ef_aux(q, aux):   # aux = (None, nl, over)
                        _, nl, ov = aux
                        qc = to_contracted(q)
                        e_c, f_c = b_inter_nl(qc, nl)
                        e_i, f_i = b_intra(q, None)
                        e, f = combine(q, e_c, f_c, e_i, f_i)
                        return e, f, (None, nl, ov)

                self._step = make_rpmd_step(
                    potential.system, ef_aux, n_beads, dt, temperature,
                    tau0=tau0, thermostat=thermostat, batched=True,
                    with_aux=True)
            elif use_mu:
                def inter_one(p, mu0, box=None):
                    e, f, parts, diag = pot_inter._energy_forces_impl(
                        p, mu0, box=box)
                    return e, f, diag.get('induced_dipoles', mu0)
                b_intra = jax.vmap(ef_intra, in_axes=(0, None))
                b_inter = jax.vmap(inter_one, in_axes=(0, 0, None))

                def ef_aux(q, m, box=None):   # m: [nc,na,3] or [h,nc,na,3]
                    qc = to_contracted(q)
                    e_c, f_c, mu_new = b_inter(qc, _predict(m), box)
                    e_i, f_i = b_intra(q, box)
                    e, f = combine(q, e_c, f_c, e_i, f_i)
                    return e, f, _push(m, mu_new)

                self._mu_beads = nc
                if self._npt:
                    self._ef_box = ef_aux
                self._step = make_rpmd_step(
                    potential.system, ef_aux, n_beads, dt, temperature,
                    tau0=tau0, thermostat=thermostat, batched=True,
                    with_aux=True, with_box=self._npt)
            else:
                if self._npt:
                    def inter_e(p, box):
                        e, f, parts, diag = pot_inter._energy_forces_impl(
                            p, box=box)
                        return e, f
                    b_intra = jax.vmap(ef_intra, in_axes=(0, None))
                    b_inter = jax.vmap(inter_e, in_axes=(0, None))

                    def ef_box(q, box):
                        qc = to_contracted(q)
                        e_c, f_c = b_inter(qc, box)
                        e_i, f_i = b_intra(q, box)
                        return combine(q, e_c, f_c, e_i, f_i)

                    self._ef_box = ef_box
                    self._step = make_rpmd_step(
                        potential.system, ef_box, n_beads, dt,
                        temperature, tau0=tau0, thermostat=thermostat,
                        batched=True, with_box=True)
                else:
                    self._step = make_rpmd_step(
                        potential.system, self._ef_all, n_beads, dt,
                        temperature, tau0=tau0, thermostat=thermostat,
                        batched=True)
        else:
            def ef_all(q):
                def one(p):
                    e, f, parts, diag = potential._energy_forces_impl(p)
                    return e, f
                return jax.vmap(one)(q)
            self._ef_all = ef_all
            self._eval_pot = potential
            self._to_eval = lambda q: q
            if self._nl_reuse:
                # per-bead lists ride the aux carry; vmapped by
                # make_rpmd_step's (0, 0) in_axes (bead-leading aux) - the
                # mu payload is per-bead [na, 3] dipoles or the per-bead
                # [h, na, 3] ASPC history
                if use_mu:
                    def one_aux(p, aux):
                        m, nl, ov = aux
                        mu0 = _predict(m)
                        e, f, parts, diag = potential._energy_forces_impl(
                            p, mu0, nlists=nl)
                        return e, f, (_push(m, diag.get('induced_dipoles',
                                                        mu0)),
                                      nl, ov)
                    self._mu_beads = self.n_beads
                else:
                    def one_aux(p, aux):
                        _, nl, ov = aux
                        e, f, parts, diag = potential._energy_forces_impl(
                            p, nlists=nl)
                        return e, f, (None, nl, ov)
                self._step = make_rpmd_step(
                    potential.system, one_aux, n_beads, dt, temperature,
                    tau0=tau0, thermostat=thermostat, mesh=mesh,
                    with_aux=True)
            elif use_mu:
                def one_aux(p, m, box=None):
                    mu0 = _predict(m)
                    e, f, parts, diag = potential._energy_forces_impl(
                        p, mu0, box=box)
                    return e, f, _push(m, diag.get('induced_dipoles', mu0))

                self._mu_beads = self.n_beads
                if self._npt:
                    self._ef_box = jax.vmap(one_aux, in_axes=(0, 0, None))
                    self._step = make_rpmd_step(
                        potential.system, self._ef_box, n_beads, dt,
                        temperature, tau0=tau0, thermostat=thermostat,
                        mesh=mesh, batched=True, with_aux=True,
                        with_box=True)
                else:
                    self._step = make_rpmd_step(
                        potential.system, one_aux, n_beads, dt,
                        temperature, tau0=tau0, thermostat=thermostat,
                        mesh=mesh, with_aux=True)
            elif self._npt:
                def one_box(p, box):
                    e, f, parts, diag = potential._energy_forces_impl(
                        p, box=box)
                    return e, f
                self._ef_box = jax.vmap(one_box, in_axes=(0, None))
                self._step = make_rpmd_step(
                    potential.system, self._ef_box, n_beads, dt,
                    temperature, tau0=tau0, thermostat=thermostat,
                    mesh=mesh, batched=True, with_box=True)
            else:
                self._step = make_rpmd_potential_step(
                    potential, n_beads, dt, temperature, tau0=tau0,
                    thermostat=thermostat, mesh=mesh)
        if self._nl_reuse:
            def _one_build(p):
                pl, tl, diag = self._eval_pot._neighbor_lists(p)
                ov = jnp.zeros((), bool)
                for kk, v in diag.items():
                    if kk.endswith('_overflow'):
                        ov = ov | v
                return (pl, tl), ov
            # per-evaluated-bead lists + overflow flags (bead-leading)
            self._nl_builder = jax.vmap(_one_build)
        self._nl = None
        self._nl_over = None
        self.state = None
        self._mu = None
        self._baro_state = None   # adaptive (scale, attempted, accepted)
        self._chunk = jax.jit(self._chunk_impl, static_argnames=('n',))

    def _mu_init(self, dtype, mu_seed=None):
        """Initial dipole payload: [mu_beads, na, 3] warm-start dipoles,
        or the ASPC history stack - [h, nc, na, 3] on the batched
        contraction paths (history leading, consumed by _mu_predict before
        the bead vmap) and [nb, h, na, 3] per-bead otherwise (bead leading
        for make_rpmd_step's aux vmap)."""
        na = self.system.n_atoms
        mu = (jnp.zeros((na, 3), dtype) if mu_seed is None
              else jnp.asarray(mu_seed, dtype))
        if self._aspc:
            if self.contraction:
                return jnp.tile(mu[None, None],
                                (self._hist_len, self._mu_beads, 1, 1))
            return jnp.tile(mu[None, None],
                            (self._mu_beads, self._hist_len, 1, 1))
        return jnp.tile(mu[None], (self._mu_beads, 1, 1))

    def _reseed_mu(self, dtype):
        """Seed the dipole payload for the CURRENT self.state positions.
        Warm start: zeros (they converge to the same fixed point; only the
        first step pays extra SCF iterations). ASPC: the history must start
        AT the fixed point - the single damped corrector only tracks it;
        from a zero history it would relax over tens of steps with
        transiently wrong forces (r3 advisor: the load_checkpoint
        missing-'mu' fallback took the zero path). One fully-converged
        cold-start evaluation of bead 0 seeds every history slot - a
        constant history degenerates the predictor to that value (the B_j
        sum to 1)."""
        if self._warm:
            self._mu = self._mu_init(dtype)
        elif self._aspc:
            if self._npt:
                seed_eval = jax.jit(
                    lambda p, b: self._eval_pot._energy_forces_impl(
                        p, box=b)[3])
                diag0 = seed_eval(self._to_eval(self.state.positions)[0],
                                  self.state.box)
            else:
                _, _, _, diag0 = self._eval_pot._energy_forces(
                    self._to_eval(self.state.positions)[0])
            self._mu = self._mu_init(dtype, diag0.get('induced_dipoles'))

    def set_positions(self, positions, box=None, spread=0.0):
        pos = jnp.asarray(positions)
        self.state = initial_state(self.system, pos, self.n_beads,
                                   self.temperature, self._key, box=box,
                                   spread=spread)
        self._nl = None          # reuse lists are reseeded lazily by step()
        self._reseed_mu(pos.dtype)
        if self._npt:
            from mbpol_openmm_plugin_tpu.md.integrators import \
                barostat_scale_init
            self._baro_state = barostat_scale_init(self.state.box,
                                                   pos.dtype)
            # seed through the box-aware path (set_positions may override
            # the static system box)
            if self._use_mu:
                e, f, _ = jax.jit(self._ef_box)(
                    self.state.positions, self._mu, self.state.box)
            else:
                e, f = jax.jit(self._ef_box)(self.state.positions,
                                             self.state.box)
        else:
            e, f = jax.jit(self._ef_all)(self.state.positions)
        self.state = dataclasses.replace(self.state, forces=f,
                                         potential_energy=e)

    def _scan_steps(self, state, mu, k):
        if self._nl_reuse:
            # mu is the full aux tuple (mu-or-None, nlists, overflow);
            # the lists are rebuilt every _nl_every steps from the
            # evaluated bead set (i == 0 included, so every chunk starts
            # fresh regardless of what happened between chunks)
            def body(carry, i):
                s, a = carry
                m, nl, ov = a

                def rebuild(args):
                    _nl0, ov0 = args
                    nl2, ov2 = self._nl_builder(self._to_eval(s.positions))
                    return nl2, ov0 | ov2

                nl, ov = jax.lax.cond(i % self._nl_every == 0,
                                      rebuild, lambda args: args, (nl, ov))
                s, a = self._step(s, (m, nl, ov))
                ke = kinetic_energy_virial(self.system, s.positions,
                                           s.forces, self.temperature)
                return (s, a), (jnp.sum(s.potential_energy), ke)

            (state, mu), out = jax.lax.scan(body, (state, mu),
                                            jnp.arange(k))
            return state, mu, out
        if self._use_mu:
            def body(carry, _):
                s, m = carry
                s, m = self._step(s, m)
                ke = kinetic_energy_virial(self.system, s.positions,
                                           s.forces, self.temperature)
                return (s, m), (jnp.sum(s.potential_energy), ke)

            (state, mu), out = jax.lax.scan(body, (state, mu), None,
                                            length=k)
            return state, mu, out

        def body(s, _):
            s = self._step(s)
            ke = kinetic_energy_virial(self.system, s.positions, s.forces,
                                       self.temperature)
            return s, (jnp.sum(s.potential_energy), ke)

        state, out = jax.lax.scan(body, state, None, length=k)
        return state, mu, out

    def _baro_move(self, state, mu, baro):
        from mbpol_openmm_plugin_tpu.md.integrators import \
            barostat_scale_update
        if self._use_mu:
            def e_fn(q, box):
                return self._ef_box(q, mu, box)[0]
        else:
            def e_fn(q, box):
                return self._ef_box(q, box)[0]
        state, accept = rpmd_barostat_move(
            self.system, e_fn, state, self.temperature,
            self.barostat_pressure, scale_nm3=baro[0])
        vol = state.box[0] * state.box[1] * state.box[2]
        return state, barostat_scale_update(baro, accept, vol)

    def _chunk_impl(self, state, mu, baro, n):
        if not self._npt:
            state, mu, out = self._scan_steps(state, mu, n)
            return state, mu, baro, out
        bi = self.barostat_interval
        if n <= bi:
            state, mu, out = self._scan_steps(state, mu, n)
            state, baro = self._baro_move(state, mu, baro)
            return state, mu, baro, out
        if n % bi == 0:
            # one traced group body (inner scan + volume move), scanned
            # n/bi times - keeps the compiled graph size independent of
            # the report interval
            def gbody(carry, _):
                s, m, b = carry
                s, m, out = self._scan_steps(s, m, bi)
                s, b = self._baro_move(s, m, b)
                return (s, m, b), out

            (state, mu, baro), outs = jax.lax.scan(
                gbody, (state, mu, baro), None, length=n // bi)
            out = jax.tree_util.tree_map(
                lambda x: x.reshape((-1,) + x.shape[2:]), outs)
            return state, mu, baro, out
        # ragged chunk: unrolled groups (pick report intervals that are
        # multiples of barostat_interval to avoid the duplicate traces)
        outs, done = [], 0
        while done < n:
            k = min(bi, n - done)
            state, mu, out = self._scan_steps(state, mu, k)
            state, baro = self._baro_move(state, mu, baro)
            done += k
            outs.append(out)
        out = jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate([jnp.atleast_1d(x) for x in xs]),
            *outs)
        return state, mu, baro, out

    def step(self, n_steps, report_interval=None, check_health=True,
             frame_callback=None, report_pressure=False):
        """Advance n_steps; returns per-report-interval quantum estimators
        (kJ/mol). With check_health, raises RuntimeError on NaN (NaN
        propagates through the PE trace, locating the failing step) or on
        SCF non-convergence / neighbor-list overflow at the report
        boundary - one diagnostic evaluation of bead 0, the same
        report-boundary scheme as md.Simulation.step.

        frame_callback(step, centroid_nm, box): called at each report
        boundary with the bead-centroid positions (virtual M-sites
        recomputed, [natoms, 3] nm) - wire a trajectory writer here
        (app.PIMDCentroidWriter adapts the classical PDB/NetCDF
        reporters).

        report_pressure (periodic systems): adds a 'pressure' column
        (bar) - the instantaneous quantum virial pressure
        md/pressure.rpmd_virial_pressure at each report boundary (one
        extra jvp evaluation per report, like the classical
        StateDataReporter(pressure=True))."""
        report_interval = report_interval or n_steps
        rows = dict(step=[], potential_energy=[], kinetic_virial=[],
                    total_energy=[])
        if self._npt:
            rows['volume'] = []
        if report_pressure:
            if not self.system.periodic:
                raise ValueError('report_pressure needs a periodic system')
            if self.contraction:
                # the sampled (and barostatted) ensemble uses the
                # CONTRACTED effective potential; the estimator below
                # differentiates the full potential - a different
                # ensemble, so the reported pressure would be
                # systematically offset even at perfect equilibrium
                raise ValueError(
                    'report_pressure with ring-polymer contraction is '
                    'unsupported: the virial estimator must match the '
                    'contracted effective potential - run uncontracted '
                    'or compute the pressure offline')
            from mbpol_openmm_plugin_tpu.md.pressure import \
                rpmd_virial_pressure
            rows['pressure'] = []
        remaining = n_steps
        while remaining > 0:
            k = min(report_interval, remaining)
            if self._nl_reuse:
                if self._nl is None:
                    # shape seed for the scan carry (set_positions /
                    # checkpoint resume); contents are rebuilt at i == 0
                    self._nl, self._nl_over = jax.jit(
                        lambda q: self._nl_builder(self._to_eval(q)))(
                            self.state.positions)
                mu_arg = (self._mu, self._nl, self._nl_over)
            else:
                mu_arg = self._mu
            self.state, mu_out, self._baro_state, (pes, kes) = \
                self._chunk(self.state, mu_arg, self._baro_state, n=k)
            if self._nl_reuse:
                self._mu, self._nl, self._nl_over = mu_out
                # a padded-list overflow during a reuse interval truncates
                # interactions silently - fatal regardless of check_health
                if bool(np.asarray(self._nl_over).any()):
                    raise RuntimeError(
                        'PIMD neighbor-list overflow during an '
                        'nlist_rebuild_interval block: raise the '
                        'capacities with tune_capacities or rebuild '
                        'every step')
            else:
                self._mu = mu_out
            pe_host = np.asarray(pes)
            if check_health and np.isnan(pe_host).any():
                at = int(self.state.step) - k + int(np.argmax(np.isnan(pe_host)))
                raise RuntimeError(f'PIMD health check failed: NaN potential '
                                   f'energy at step {at}')
            if check_health:
                if self._npt:
                    # the box is trajectory state: the diagnostic eval must
                    # image/list with the current box, not the static one
                    if not hasattr(self, '_health_eval'):
                        self._health_eval = jax.jit(
                            lambda p, box: self.potential.
                            _energy_forces_impl(p, box=box))
                    _, _, _, diag = self._health_eval(
                        self.state.positions[0], self.state.box)
                else:
                    _, _, _, diag = self.potential._energy_forces(
                        self.state.positions[0])
                # 'converged' plus every padded-capacity overflow flag
                # (pair/triplet/elec-pair/elec-tile/dispersion-pair lists)
                bad = {kk: diag[kk] for kk in diag
                       if kk == 'converged' or kk.endswith('_overflow')}
                ok = bool(diag.get('converged', True))
                for kk, v in bad.items():
                    if kk != 'converged':
                        ok = ok and not bool(v)
                if not ok:
                    raise RuntimeError(
                        'PIMD health check failed at step '
                        f'{int(self.state.step)}: {bad}')
            pe_mean = float(pe_host[-1]) / self.n_beads
            ke = float(np.asarray(kes)[-1])
            rows['step'].append(int(self.state.step))
            rows['potential_energy'].append(pe_mean)
            rows['kinetic_virial'].append(ke)
            rows['total_energy'].append(pe_mean + ke)
            if self._npt:
                b = np.asarray(self.state.box)
                rows['volume'].append(float(b[0] * b[1] * b[2]))
            if report_pressure:
                rows['pressure'].append(float(rpmd_virial_pressure(
                    self.potential, self.state.positions, self.temperature,
                    box=self.state.box)))
            if frame_callback is not None:
                from mbpol_openmm_plugin_tpu.system import \
                    compute_virtual_sites
                centroid = compute_virtual_sites(
                    self.system, jnp.mean(self.state.positions, axis=0))
                frame_callback(int(self.state.step), np.asarray(centroid),
                               np.asarray(self.state.box))
            remaining -= k
        return {k: np.asarray(v) for k, v in rows.items()}

    # -- checkpointing (pytree snapshot, md.Simulation parity) -------------
    def checkpoint(self):
        s = self.state
        ck = dict(positions=np.asarray(s.positions),
                  velocities=np.asarray(s.velocities),
                  forces=np.asarray(s.forces), box=np.asarray(s.box),
                  potential_energy=np.asarray(s.potential_energy),
                  step=np.asarray(s.step), rng=np.asarray(s.rng))
        if self._mu is not None:
            # warm-start dipoles ride along so resume is bitwise
            # deterministic (they converge to the same fixed point either
            # way, but only within target_epsilon)
            ck['mu'] = np.asarray(self._mu)
        if self._baro_state is not None:
            ck['baro_scale'] = np.asarray(self._baro_state[0])
            ck['baro_attempted'] = np.asarray(self._baro_state[1])
            ck['baro_accepted'] = np.asarray(self._baro_state[2])
        return ck

    def load_checkpoint(self, ck):
        self.state = MDState(
            positions=jnp.asarray(ck['positions']),
            velocities=jnp.asarray(ck['velocities']),
            forces=jnp.asarray(ck['forces']),
            potential_energy=jnp.asarray(ck['potential_energy']),
            box=jnp.asarray(ck['box']), step=jnp.asarray(ck['step']),
            rng=jnp.asarray(ck['rng']))
        self._nl = None          # reuse lists are reseeded lazily by step()
        if self._use_mu:
            if 'mu' in ck:
                self._mu = jnp.asarray(ck['mu'])
            else:
                # checkpoint predates the dipole payload: reseed exactly as
                # set_positions does (converged evaluation under ASPC, not
                # a zero history - r3 advisor finding)
                self._reseed_mu(self.state.positions.dtype)
        if self._npt:
            if 'baro_scale' in ck:
                self._baro_state = (jnp.asarray(ck['baro_scale']),
                                    jnp.asarray(ck['baro_attempted']),
                                    jnp.asarray(ck['baro_accepted']))
            else:
                from mbpol_openmm_plugin_tpu.md.integrators import \
                    barostat_scale_init
                self._baro_state = barostat_scale_init(
                    self.state.box, self.state.positions.dtype)

    def save_checkpoint(self, path):
        np.savez(path, **self.checkpoint())

    def load_checkpoint_file(self, path):
        with np.load(path) as z:
            self.load_checkpoint({k: z[k] for k in z.files})
