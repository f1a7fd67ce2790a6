"""Replica-batched force evaluation (PIMD-style beads).

The reference mentions PIMD only as science context (README.md:13); this
framework makes bead/replica parallelism a one-liner: vmap the potential
over a leading replica axis. Used for path-integral beads, ensemble MD, or
batched free-energy evaluations (BASELINE config 5).
"""
import jax
import jax.numpy as jnp

from mbpol_openmm_plugin_tpu.models.potential import MBPol


def replica_energy_forces(potential: MBPol):
    """Returns fn(positions [R, natoms, 3]) -> (E [R], F [R, natoms, 3]).

    Each replica's SCF converges independently (while_loop under vmap is
    batched by XLA). Diagnostics are per-replica.
    """

    def single(p):
        e, f, parts, diag = potential._energy_forces_impl(p)
        return e, f, diag['converged'] if 'converged' in diag else jnp.ones((), bool)

    batched = jax.vmap(single)

    @jax.jit
    def fn(positions):
        e, f, conv = batched(positions)
        return e, f, conv

    return fn
