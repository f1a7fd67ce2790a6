#!/usr/bin/env python
"""Multi-device scaling harness: a spatially sharded large water box on
several GPUs, or a correctness run on a virtual CPU mesh.

Builds water{2048|4096|8192} by replicating the water256 bulk fixture,
sizes every padded capacity with parallel/plan.py (exact native counts),
constructs the mesh-sharded potential (molecule-pair sparse
electrostatics and dispersion, site-sharded PME), and runs one full
evaluation plus a short MD scan, printing per-step wall time and the
capacity plan.

Usage:
    # virtual 8-device CPU mesh (correctness, float64):
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/multichip_scaling.py 2048 8
    # GPUs (float32): n_devices <= len(jax.devices())
    python examples/multichip_scaling.py 8192 4
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'tests'))

import numpy as np
import jax

if os.environ.get('JAX_PLATFORMS'):
    jax.config.update('jax_platforms', os.environ['JAX_PLATFORMS'])
from mbpol_openmm_plugin_tpu.utils.cache import enable_compile_cache
enable_compile_cache()
jax.config.update('jax_default_matmul_precision', 'highest')
import jax.numpy as jnp

import fixtures
from mbpol_openmm_plugin_tpu.md import integrators as I
from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu.parallel import mesh as M
from mbpol_openmm_plugin_tpu.parallel.plan import plan_capacities
from mbpol_openmm_plugin_tpu.system import System, compute_virtual_sites

N_WATERS = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
N_DEV = int(sys.argv[2]) if len(sys.argv) > 2 else min(len(jax.devices()), 8)
N_STEPS = int(os.environ.get('SCALING_STEPS', 3))

reps = {512: (2, 1, 1), 1024: (2, 2, 1), 2048: (2, 2, 2), 4096: (2, 2, 4),
        6912: (3, 3, 3), 8192: (2, 4, 4), 16384: (4, 4, 4)}[N_WATERS]
fix = fixtures.load('water256_integration_test')
b = 19.3996888399961804 / 10.0
pos_np = np.concatenate([fix['positions'] + np.array([i * b, j * b, k * b])
                         for i in range(reps[0]) for j in range(reps[1])
                         for k in range(reps[2])])
box = [reps[0] * b, reps[1] * b, reps[2] * b]
sys_ = System.waters(N_WATERS, box=box)
# float32 on accelerators; float64 on the CPU, where it is the
# validation reference
dtype = jnp.float64 if jax.devices()[0].platform == 'cpu' else jnp.float32
pos = compute_virtual_sites(sys_, jnp.asarray(pos_np, dtype))

cfg = MBPolConfig(nonbonded_method='PME', cutoff=0.9, target_epsilon=1e-3,
                  max_iterations=200, nlist_skin=0.02)

# --- capacity plan (exact counts from the replicated positions) ---------
plan = plan_capacities(N_WATERS, box, n_devices=N_DEV, config=cfg,
                       positions=np.asarray(pos))
print(plan.describe(), flush=True)

mesh = M.make_mesh(N_DEV)
pot = MBPol(sys_, cfg, mesh=mesh, plan=plan)

with mesh:
    t0 = time.time()
    e, f, parts, diag = pot.energy_forces(pos)
    jax.block_until_ready(f)
    print(f'compile+eval {time.time() - t0:.1f} s', flush=True)
    e_kcal = float(e) / 4.184
    per256 = e_kcal / (N_WATERS / 256)
    print(f'E = {e_kcal:.2f} kcal/mol ({per256:.2f} per water256 cell; '
          f'fixture cell total -2261.7)', flush=True)
    bad = {k: bool(diag[k]) for k in diag if k.endswith('_overflow')
           and bool(diag[k])}
    assert not bad, f'capacity plan overflowed: {bad}'
    assert bool(diag['converged'])

    # short MD scan: warm throughput with prebuilt lists + warm dipoles
    mu = diag['induced_dipoles']
    nl, _ = pot.build_neighbor_lists(pos)
    masses = np.asarray(sys_.masses)
    inv_m = jnp.asarray(np.where(masses > 0, 1.0 / np.where(masses > 0,
                                                            masses, 1.0),
                                 0.0), dtype)[:, None]

    def step(carry, _):
        st, mu = carry
        v_half = st.velocities + 0.5 * 2e-4 * st.forces * inv_m
        p = st.positions + 2e-4 * v_half
        e, f, parts, d = pot._energy_forces_impl(p, mu, nlists=nl)
        import dataclasses
        st = dataclasses.replace(st, positions=p,
                                 velocities=v_half + 0.5 * 2e-4 * f * inv_m,
                                 forces=f, potential_energy=e,
                                 step=st.step + 1)
        return (st, d['induced_dipoles']), e

    st0 = I.MDState(positions=pos, velocities=jnp.zeros_like(pos), forces=f,
                    potential_energy=e, box=jnp.asarray(box, dtype),
                    step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))
    scan = jax.jit(lambda c: jax.lax.scan(step, c, None, length=N_STEPS))
    t0 = time.time()
    (st, _), es = scan((st0, mu))
    jax.block_until_ready(es)
    t_compile = time.time() - t0
    t0 = time.time()
    (st, _), es = scan((st0, mu))
    jax.block_until_ready(es)
    dt_ms = (time.time() - t0) / N_STEPS * 1e3
    print(f'MD scan: {dt_ms:.1f} ms/step over {N_DEV} device(s) '
          f'(compile {t_compile:.1f} s); energies finite: '
          f'{bool(np.isfinite(np.asarray(es)).all())}', flush=True)
