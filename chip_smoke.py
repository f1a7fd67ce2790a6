#!/usr/bin/env python
"""Smoke run of the MB-pol main path on an NVIDIA GPU.

    python chip_smoke.py                # one GPU, every phase below
    python chip_smoke.py --four-cards   # four GPUs: the sharded paths only

Phases, in one process; any failure exits non-zero:

1. device   - JAX must find a GPU (no fallback to the CPU). Prints the
              nvidia-smi name and power limit, device kind, JAX version
              and the XLA flags in effect.
2. goldens  - the reference's golden energies, evaluated in float32 on
              the card (water3 cluster per term; water3/14/50/256 PME).
3. compare  - water256 per-term energies and forces in float32 on the card
              against this repository's float64 CPU path, computed in a
              CPU-only child process (float64 is process-global in JAX, so
              it cannot be switched on in the card's process).
4. main     - water256 PME through the app layer (PDB -> ForceField ->
              Simulation -> StateDataReporter); md.Simulation NVE with
              MBPolConfig.for_dynamics(); water14 PIMD and REMD.
5. memory   - memory_analysis() of the jitted MD chunk and the device's
              peak bytes in use.

--four-cards runs only: the water256 potential on a 4-device 'dp' mesh
against one device, 8-bead PIMD with beads sharded over the four devices
and a 4-replica REMD ladder with replicas sharded over them, each against
its unsharded run.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import argparse
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tests'))

import fixtures  # noqa: E402
from mbpol_openmm_plugin_tpu.utils import units  # noqa: E402

WATER256_BOX = 19.3996888399961804 / 10.0
KCAL = units.KJ_PER_MOL_TO_KCAL_PER_MOL
TERMS = ('one_body', 'two_body', 'three_body', 'dispersion', 'electrostatics')

# (label, fixture, box nm or None for a cluster, term or 'total', golden
# kcal/mol, tolerance). Cluster water3 per-term goldens are the full-model
# float64 values of this repository's CPU path; the PME totals are the
# reference's integration goldens. Tolerances are the float32 floor: the
# PIP fits cancel ~6 orders of magnitude (sum|c*mono| ~ 2.6e6 for
# ~6 kcal/mol answers on close dimers), so any float32 evaluation carries a
# few tenths of kcal/mol there - the reference needs float64 for the same
# reason.
GOLDENS = (
    ('water3 cluster total', 'water3', None, 'total', -8.78894096, 0.5),
    ('water3 electrostatics', 'water3', None, 'electrostatics',
     -15.83911354, 0.05),
    ('water3 two-body', 'water3', None, 'two_body', 12.86498179, 0.5),
    ('water3 three-body', 'water3', None, 'three_body', 0.15651942, 0.05),
    ('water3 one-body', 'water3', None, 'one_body', 0.88255743, 0.01),
    ('water3 dispersion', 'water3', None, 'dispersion', -6.85388606, 0.01),
    ('water3 PME total', 'water3', 1.9, 'total', -8.92353, 0.5),
    ('water14 PME total', 'water14', 1.8, 'total', -60.0, 1.0),
    ('water50 PME total', 'water50', 1.8, 'total', -244.37507, 1.0),
    ('water256 PME total', 'water256_integration_test', WATER256_BOX,
     'total', -2270.88890, 20.0),
)

# float32-on-the-card vs float64-on-the-CPU tolerances for the compare
# phase (water256; energies kcal/mol, forces kJ/mol/nm over the real atoms,
# |F| reaches ~1400). Each term's error is float32 rounding plus summation
# order: the PIP terms carry a per-pair/per-triplet rounding floor
# (~0.02 kcal/mol per close dimer) summed over thousands of entries, and
# electrostatics adds the SCF, which stops at the float32 convergence floor
# (eps 1e-4) instead of 1e-8. The bounds are about 3x the float32-vs-
# float64 differences of the same code on XLA:CPU (two-body |dE| 2.1,
# three-body 1.2, electrostatics 0.25, total 3.1 kcal/mol; largest force
# error 4.5 kJ/mol/nm, in the two-body term), leaving room for the GPU's
# own summation order.
COMPARE_TOL = {
    # term: (|dE| kcal/mol, max |dF| kJ/mol/nm, RMS |dF| kJ/mol/nm)
    'one_body': (0.01, 0.2, 0.05),
    'two_body': (6.0, 15.0, 3.5),
    'three_body': (4.0, 2.5, 0.5),
    'dispersion': (0.01, 0.01, 0.002),
    'electrostatics': (1.0, 1.5, 0.4),
    'total': (10.0, 15.0, 3.5),
}


def log(*a):
    print(*a, flush=True)


class Failures(list):
    def check(self, label, ok, detail):
        log('%-44s %s  %s' % (label, detail, 'PASS' if ok else 'FAIL'))
        if not ok:
            self.append(label)


# ----------------------------------------------------------------------
# 1. device
# ----------------------------------------------------------------------
def gpu_devices():
    """The GPUs JAX sees; exits non-zero when it sees none (a CPU run
    must not pass for a GPU run)."""
    import jax
    devs = jax.devices()
    if devs[0].platform != 'gpu':
        raise SystemExit('chip_smoke: JAX found no GPU (platform %r)'
                         % devs[0].platform)
    return devs


def describe_device(devs):
    import jax
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        log('nvidia-smi:', line.strip())
    log('device_kind:', devs[0].device_kind, ' count:', len(devs))
    log('jax:', jax.__version__, ' XLA_FLAGS:',
        repr(os.environ.get('XLA_FLAGS', '')),
        ' default_matmul_precision:', jax.config.jax_default_matmul_precision)


# ----------------------------------------------------------------------
# 2. goldens
# ----------------------------------------------------------------------
def _potential(name, box, dtype, terms=None, mesh=None, **cfg):
    import jax.numpy as jnp
    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
    sys_, pos = fixtures.load_system(name, box=None if box is None
                                     else [box] * 3)
    kw = dict(nonbonded_method='NoCutoff' if box is None else 'PME',
              cutoff=0.9, target_epsilon=1e-4)
    if name.startswith('water256'):
        kw.update(nlist_skin=0.02, max_iterations=200)
    if terms is not None:
        kw['terms'] = tuple(terms)
    kw.update(cfg)
    pot = MBPol(sys_, MBPolConfig(**kw), mesh=mesh)
    return pot, jnp.asarray(pos, dtype)


def golden_phase(goldens=GOLDENS):
    """Evaluate each golden system once in float32 (on the default device)
    and check every listed term. Returns the list of failed labels."""
    import jax
    import jax.numpy as jnp
    fails = Failures()
    cache = {}
    for label, name, box, term, golden, tol in goldens:
        if (name, box) not in cache:
            pot, pos = _potential(name, box, jnp.float32)
            t0 = time.perf_counter()
            e, f, parts, diag = pot.energy_forces(pos)
            jax.block_until_ready(f)
            dt = time.perf_counter() - t0
            ok = (bool(diag.get('converged', True))
                  and bool(np.isfinite(np.asarray(f)).all()))
            fails.check('%s eval (%.2f s incl. compile)' % (name, dt), ok,
                        'converged+finite')
            vals = {k: float(v) * KCAL for k, v in parts.items()}
            vals['total'] = float(e) * KCAL
            cache[(name, box)] = vals
        v = cache[(name, box)][term]
        fails.check(label, abs(v - golden) <= tol,
                    '%12.5f  golden %12.5f  |d| %8.5f  tol %g'
                    % (v, golden, abs(v - golden), tol))
    return fails


# ----------------------------------------------------------------------
# 3. compare with the float64 CPU path
# ----------------------------------------------------------------------
def term_energies_forces(name, box, dtype):
    """Per-term energy (kcal/mol) and forces (kJ/mol/nm, real atoms only)
    plus their sum, one potential per term."""
    import jax
    out = {}
    for term in TERMS:
        pot, pos = _potential(name, box, dtype, terms=(term,),
                              target_epsilon=1e-8)
        e, f, _, diag = pot.energy_forces(pos)
        jax.block_until_ready(f)
        if not bool(diag.get('converged', True)):
            raise RuntimeError(f'{name} {term}: SCF did not converge')
        real = np.asarray(pot.system.masses) > 0
        out[term] = (float(e) * KCAL, np.asarray(f, np.float64)[real])
    out['total'] = (sum(v[0] for v in out.values()),
                    sum(v[1] for v in out.values()))
    return out


def start_f64_reference(name, box):
    """Start the float64 CPU reference in a child that never opens the
    card (JAX_PLATFORMS=cpu); collect it with finish_f64_reference."""
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    env.pop('XLA_PYTHON_CLIENT_MEM_FRACTION', None)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--f64-reference', name,
         repr(box)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_f64_reference(proc, timeout=1200):
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError('float64 reference child failed:\n' + err[-4000:])
    line = [ln for ln in out.splitlines() if ln.startswith('F64REF ')][-1]
    d = json.loads(line[len('F64REF '):])
    return {k: (v[0], np.asarray(v[1])) for k, v in d.items()}


def f64_reference_main(name, box):
    import jax
    jax.config.update('jax_enable_x64', True)
    ref = term_energies_forces(name, box, np.float64)
    print('F64REF ' + json.dumps({k: [e, f.tolist()]
                                  for k, (e, f) in ref.items()}))


def compare_phase(name, box, ref, tol=COMPARE_TOL):
    """float32 on the default device vs the float64 reference `ref`."""
    import jax.numpy as jnp
    got = term_energies_forces(name, box, jnp.float32)
    fails = Failures()
    for term in TERMS + ('total',):
        e32, f32 = got[term]
        e64, f64 = ref[term]
        de = abs(e32 - e64)
        dfn = np.linalg.norm(f32 - f64, axis=-1)
        dmax, drms = float(dfn.max()), float(np.sqrt(np.mean(dfn ** 2)))
        te, tmax, trms = tol[term]
        fails.check(
            '%s %s f32 vs f64' % (name, term),
            de <= te and dmax <= tmax and drms <= trms,
            '|dE| %.5f (tol %g) kcal/mol  max|dF| %.5f (tol %g)  '
            'rms|dF| %.5f (tol %g) kJ/mol/nm  [E64 %.5f]'
            % (de, te, dmax, tmax, drms, trms, e64))
    return fails


# ----------------------------------------------------------------------
# 4. main path
# ----------------------------------------------------------------------
def app_layer_phase(n_steps=100):
    """water256 PME through the OpenMM-style app layer, PDB written in
    process from the bulk fixture."""
    from mbpol_openmm_plugin_tpu import app
    from mbpol_openmm_plugin_tpu.app import unit
    from mbpol_openmm_plugin_tpu.app.pdbfile import (Atom, Topology,
                                                     write_pdb_frame)
    d = fixtures.load('water256_bulk')
    atoms = [Atom(i, str(n), str(rn), int(ri)) for i, (n, rn, ri) in
             enumerate(zip(d['names'], d['resnames'], d['resids']))]
    buf = io.StringIO()
    write_pdb_frame(buf, Topology(atoms), d['positions'])
    buf.seek(0)
    pdb = app.PDBFile(buf)
    pdb.topology.setUnitCellDimensions((WATER256_BOX,) * 3 * unit.nanometer)
    ff = app.ForceField(app.mbpol_xml_path())
    system = ff.createSystem(pdb.topology, nonbondedMethod=app.PME,
                             nonbondedCutoff=0.9 * unit.nanometers,
                             ewaldErrorTolerance=1e-4)
    system.addForce(app.AndersenThermostat(300 * unit.kelvin,
                                           1. / unit.picoseconds))
    sim = app.Simulation(pdb.topology, system,
                         app.VerletIntegrator(0.5 * unit.femtoseconds))
    sim.context.setPositions(pdb.positions)
    sim.context.computeVirtualSites()
    sim.context.setVelocitiesToTemperature(300 * unit.kelvin)
    sim.reporters.append(app.StateDataReporter(
        sys.stdout, n_steps // 2, step=True, potentialEnergy=True,
        kineticEnergy=True, totalEnergy=True, temperature=True, speed=True,
        separator='\t'))
    t0 = time.perf_counter()
    sim.step(n_steps)
    dt = time.perf_counter() - t0
    pe = sim.context.getState(getEnergy=True).getPotentialEnergy()
    pe = float(getattr(pe, '_value', pe))
    fails = Failures()
    fails.check('app water256 NVT %d steps (%.1f s incl. compile)'
                % (n_steps, dt), bool(np.isfinite(pe)),
                'PE %.2f kJ/mol' % pe)
    return fails


def md_phase(n_steps=1000, chunk=250):
    """md.Simulation NVE at 0.2 fs with the production recipe
    (MBPolConfig.for_dynamics, displacement-triggered list rebuilds) from
    the water256 integration fixture. Returns (failures, compiled chunk)."""
    import jax
    import jax.numpy as jnp
    from mbpol_openmm_plugin_tpu.md.simulation import (Simulation,
                                                       SimulationConfig)
    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
    fails = Failures()
    sys_, pos = fixtures.load_system('water256_integration_test',
                                     [WATER256_BOX] * 3)
    pos = jnp.asarray(pos, jnp.float32)
    pot = MBPol(sys_, MBPolConfig.for_dynamics())
    pot.tune_capacities(pos)
    _, _, _, diag = pot.energy_forces(pos)
    fails.check('water256 cold-start SCF', bool(diag['converged']),
                'iterations %d' % int(diag['iterations']))
    sim = Simulation(pot, SimulationConfig(dt=2e-4,
                                           nlist_rebuild_interval='auto'),
                     seed=0)
    sim.set_positions(pos)
    sim.set_velocities_to_temperature(300.0)

    t0 = time.perf_counter()
    lowered = sim._step_chunk.lower(sim.state, sim._baro, n_steps=chunk)
    t1 = time.perf_counter()
    compiled = lowered.compile()
    t2 = time.perf_counter()
    log('md chunk (%d steps): trace+lower %.2f s, compile %.2f s'
        % (chunk, t1 - t0, t2 - t1))

    t0 = time.perf_counter()
    warm = sim.step(chunk, report_interval=chunk)     # dispatch warm-up
    log('md warm-up chunk: %.2f s (jit dispatch, persistent-cache compile '
        'hit and %d steps)' % (time.perf_counter() - t0, chunk))
    t0 = time.perf_counter()
    out = sim.step(n_steps, report_interval=chunk)    # raises on overflow,
    jax.block_until_ready(sim.state.positions)        # NaN or SCF failure
    run_s = time.perf_counter() - t0
    te = np.concatenate([warm['total_energy'], out['total_energy']])
    ok = bool(np.isfinite(te).all()
              and np.isfinite(np.asarray(sim.state.positions)).all())
    fails.check('water256 NVE %d steps finite, no overflow' % n_steps, ok,
                'T_end %.1f K' % float(out['temperature'][-1]))
    ps = (n_steps + chunk) * 2e-4
    ndof = 3 * int(np.sum(np.asarray(sys_.masses) > 0))
    drift = (te[-1] - te[0]) / ps
    log('md NVE: %.1f steps/s over %d steps (%.3f s run); total-energy '
        'drift %+.3f kJ/mol/ps = %+.1f K/ns over %.2f ps (information)'
        % (n_steps / run_s, n_steps, run_s, drift,
           drift * 2.0 / (ndof * units.BOLTZMANN_KJ_MOL_K) * 1e3, ps))
    return fails, compiled


def pimd_phase():
    """water14 cluster, 4 beads contracted to the centroid: 20 PILE steps
    stay finite and the centroid-virial quantum kinetic energy exceeds
    classical equipartition (zero-point motion)."""
    import jax.numpy as jnp
    from mbpol_openmm_plugin_tpu.md import rpmd
    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu.system import compute_virtual_sites
    sys14, pos14 = fixtures.load_system('water14_cluster', None)
    pos14 = compute_virtual_sites(sys14, jnp.asarray(pos14, jnp.float32))
    pot14 = MBPol(sys14, MBPolConfig(nonbonded_method='NoCutoff',
                                     target_epsilon=1e-4))
    psim = rpmd.PIMDSimulation(pot14, n_beads=4, dt=1e-4, temperature=150.0,
                               tau0=0.05, contraction=1, seed=0)
    psim.set_positions(pos14, spread=0.002)
    pm = psim.step(20)
    ke_q = float(pm['kinetic_virial'][-1])
    ke_cl = 1.5 * 3 * 14 * units.BOLTZMANN_KJ_MOL_K * 150.0
    fails = Failures()
    fails.check('water14 PIMD 4-bead contracted (20 steps)',
                bool(np.isfinite(pm['total_energy']).all()) and ke_q > ke_cl,
                'KE_q %.1f > classical %.1f kJ/mol' % (ke_q, ke_cl))
    return fails, pot14, pos14


def remd_phase(pot14, pos14):
    """water14 2-replica ladder, 3 exchange blocks: finite energies and a
    well-formed acceptance record."""
    from mbpol_openmm_plugin_tpu.md import remd
    rx = remd.REMDSimulation(pot14, temperatures=[200.0, 350.0],
                             config=remd.REMDConfig(dt=2e-4,
                                                    exchange_interval=5),
                             seed=0)
    rx.set_positions(pos14)
    rx.set_velocities_to_temperature()
    rout = rx.run(3)
    fails = Failures()
    fails.check('water14 REMD 2-replica (3 blocks)',
                bool(np.isfinite(rout['potential_energy']).all())
                and rout['acceptance'].shape == (1,),
                'PE %.1f / %.1f kJ/mol  acc %.2f'
                % (float(rout['potential_energy'][-1, 0]),
                   float(rout['potential_energy'][-1, 1]),
                   float(rout['acceptance'][0])))
    return fails


def memory_phase(compiled, device):
    ma = compiled.memory_analysis()
    fields = ('argument_size_in_bytes', 'output_size_in_bytes',
              'temp_size_in_bytes', 'generated_code_size_in_bytes',
              'alias_size_in_bytes')
    log('md chunk memory_analysis: ' + '  '.join(
        '%s=%d' % (k, getattr(ma, k)) for k in fields if hasattr(ma, k)))
    stats = device.memory_stats() or {}
    log('device peak_bytes_in_use: %d (%.1f MiB)'
        % (stats.get('peak_bytes_in_use', -1),
           stats.get('peak_bytes_in_use', -1) / 2 ** 20))


# ----------------------------------------------------------------------
# --four-cards
# ----------------------------------------------------------------------
# Sharded vs one-device tolerances (float32). Sums over the 'dp' axis are
# reduced across devices in another order than on one device, the sharded
# PIP batches go through matmuls of other shapes (other accumulation
# orders, which the PIP fits' cancellation amplifies), and the SCF stops at
# the float32 floor (eps 1e-4), where one SOR iteration more or less moves
# a water14 energy by ~1e-4 relative, so the runs agree to rounding and
# SCF tolerance, not bitwise. The force bound is the float32 floor itself:
# on one H100 the float32 water256 forces sit up to 4.4 kJ/mol/nm from the
# float64 ones (compare phase), so two float32 evaluations that round
# differently may differ by that much. (On 4 virtual CPU devices: water256
# E rel 1.0e-5, max|dF| 0.004; PIMD max|dx| 4e-7 nm, PE rel 3e-4. On four
# H100s: E rel 2.1e-7, max|dF| 1.76; PE rel 4.7e-4 PIMD, 1.4e-3 REMD.)
FOUR_CARD_E_RTOL = 5e-5         # water256 potential energy, relative
FOUR_CARD_F_ATOL = 5.0          # water256 forces, kJ/mol/nm (|F| ~ 1e3)
FOUR_CARD_POS_ATOL = 1e-5       # PIMD / REMD positions after the run, nm
FOUR_CARD_PE_RTOL = 2e-3        # PIMD / REMD potential energies


def _shard_devices(x):
    return sorted({s.device.id for s in x.addressable_shards
                   if s.data.size})


def four_card_phase(n_dev=4):
    import jax
    import jax.numpy as jnp
    from mbpol_openmm_plugin_tpu.md import remd, rpmd
    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu.parallel import mesh as M
    from mbpol_openmm_plugin_tpu.system import compute_virtual_sites
    fails = Failures()
    if len(jax.devices()) < n_dev:
        raise SystemExit('chip_smoke --four-cards: %d devices, need %d'
                         % (len(jax.devices()), n_dev))
    mesh = M.make_mesh(n_dev)

    # water256 potential: 'dp' mesh vs one device
    pot1, pos = _potential('water256_integration_test', WATER256_BOX,
                           jnp.float32)
    pot1.tune_capacities(pos)
    e1, f1, _, _ = pot1.energy_forces(pos)
    potm, _ = _potential('water256_integration_test', WATER256_BOX,
                         jnp.float32, mesh=mesh)
    potm.tune_capacities(pos)
    with mesh:
        (pl, _), (tl, _) = potm.build_neighbor_lists(pos)[0]
        em, fm, _, diag = potm.energy_forces(pos)
        jax.block_until_ready(fm)
    rel = abs(float(em) - float(e1)) / abs(float(e1))
    df = float(np.abs(np.asarray(fm) - np.asarray(f1)).max())
    fails.check('water256 %d-device mesh vs 1 device' % n_dev,
                bool(diag['converged']) and rel < FOUR_CARD_E_RTOL
                and df < FOUR_CARD_F_ATOL,
                'E rel err %.2e (tol %g)  max|dF| %.4f (tol %g) kJ/mol/nm'
                % (rel, FOUR_CARD_E_RTOL, df, FOUR_CARD_F_ATOL))
    devs = _shard_devices(pl), _shard_devices(tl)
    fails.check('water256 pair/triplet lists on %d devices' % n_dev,
                all(len(d) == n_dev for d in devs),
                'pair shards on %s, triplet shards on %s' % devs)

    # 8-bead PIMD, beads sharded over the mesh vs unsharded
    sys14, pos14 = fixtures.load_system('water14_cluster', None)
    pos14 = compute_virtual_sites(sys14, jnp.asarray(pos14, jnp.float32))
    pot14 = MBPol(sys14, MBPolConfig(nonbonded_method='NoCutoff',
                                     target_epsilon=1e-4))
    runs = {}
    for m in (None, mesh):
        psim = rpmd.PIMDSimulation(pot14, n_beads=8, dt=1e-4,
                                   temperature=150.0, tau0=0.05, seed=0,
                                   mesh=m)
        psim.set_positions(pos14, spread=0.002)
        pm = psim.step(10)
        runs[m is not None] = (np.asarray(psim.state.positions),
                               np.asarray(pm['potential_energy']),
                               _shard_devices(psim.state.positions))
    dpos = float(np.abs(runs[True][0] - runs[False][0]).max())
    dpe = float(np.max(np.abs(runs[True][1] - runs[False][1])
                       / np.abs(runs[False][1])))
    fails.check('water14 PIMD 8 beads sharded vs unsharded',
                dpos < FOUR_CARD_POS_ATOL and dpe < FOUR_CARD_PE_RTOL
                and len(runs[True][2]) == n_dev,
                'max|dx| %.2e nm (tol %g)  PE rel %.2e (tol %g)  beads on %s'
                % (dpos, FOUR_CARD_POS_ATOL, dpe, FOUR_CARD_PE_RTOL,
                   runs[True][2]))

    # 4-replica REMD ladder, replicas sharded over the mesh vs unsharded
    runs = {}
    for m in (None, mesh):
        rx = remd.REMDSimulation(
            pot14, temperatures=remd.geometric_ladder(200.0, 350.0, 4),
            config=remd.REMDConfig(dt=2e-4, exchange_interval=5), seed=0,
            mesh=m)
        rx.set_positions(pos14)
        rx.set_velocities_to_temperature()
        rout = rx.run(3)
        runs[m is not None] = (np.asarray(rx.state.positions),
                               np.asarray(rout['potential_energy']),
                               _shard_devices(rx.state.positions))
    dpos = float(np.abs(runs[True][0] - runs[False][0]).max())
    dpe = float(np.max(np.abs(runs[True][1] - runs[False][1])
                       / np.abs(runs[False][1])))
    fails.check('water14 REMD 4 replicas sharded vs unsharded',
                dpos < FOUR_CARD_POS_ATOL and dpe < FOUR_CARD_PE_RTOL
                and len(runs[True][2]) == n_dev,
                'max|dx| %.2e nm (tol %g)  PE rel %.2e (tol %g)  replicas '
                'on %s' % (dpos, FOUR_CARD_POS_ATOL, dpe, FOUR_CARD_PE_RTOL,
                           runs[True][2]))
    peaks = [(d.memory_stats() or {}).get('peak_bytes_in_use', 0)
             for d in jax.devices()[:n_dev]]
    fails.check('peak bytes in use on each device', all(p > 0 for p in peaks),
                ' '.join('%.1fMiB' % (p / 2 ** 20) for p in peaks))
    return fails


# ----------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--four-cards', action='store_true',
                    help='run only the 4-GPU sharded paths against 1 GPU')
    ap.add_argument('--f64-reference', nargs=2, metavar=('FIXTURE', 'BOX'),
                    help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.f64_reference:
        name, box = a.f64_reference
        f64_reference_main(name, None if box == 'None' else float(box))
        return 0

    from mbpol_openmm_plugin_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    devs = gpu_devices()
    describe_device(devs)
    t_start = time.perf_counter()
    if a.four_cards:
        fails = four_card_phase(4)
    else:
        # the float64 CPU reference runs in a child alongside the card
        ref_proc = start_f64_reference('water256_integration_test',
                                       WATER256_BOX)
        fails = Failures()
        try:
            log('--- goldens (float32 on %s)' % devs[0].device_kind)
            fails += golden_phase()
            log('--- main path')
            fails += app_layer_phase()
            md_fails, compiled = md_phase()
            fails += md_fails
            pf, pot14, pos14 = pimd_phase()
            fails += pf
            fails += remd_phase(pot14, pos14)
            log('--- memory')
            memory_phase(compiled, devs[0])
            log('--- compare water256 with the float64 CPU path')
            ref = finish_f64_reference(ref_proc)
            fails += compare_phase('water256_integration_test',
                                   WATER256_BOX, ref)
        finally:
            if ref_proc.poll() is None:
                ref_proc.kill()
                ref_proc.wait()
    log('wall %.1f s' % (time.perf_counter() - t_start))
    if fails:
        log('FAILED: %s' % fails)
        return 1
    print(json.dumps({'ok': True, 'device': {
        'platform': devs[0].platform, 'kind': devs[0].device_kind,
        'count': len(devs)}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
