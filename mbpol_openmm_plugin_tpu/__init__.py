"""MB-pol water potential framework in JAX.

A ground-up JAX/XLA re-design of the MB-pol many-body water model
(capabilities of gmedders/mbpol_openmm_plugin): explicit one-body monomer
distortion (Partridge-Schwenke PES), short-range two-body and three-body
permutationally-invariant polynomial corrections, TT6-damped dispersion and
Thole-damped many-body polarization with PME for periodic electrostatics.

Internal unit system follows OpenMM: lengths in nm, energies in kJ/mol,
masses in amu, charges in units of e. Helpers for kcal/mol conversions live
in `units`.

Layout
------
- ``data``     extracted MB-pol parameter tables (see tools/extract_*.py)
- ``params``   frozen parameter pytrees + mbpol.xml loading
- ``models``   the force terms (one_body, two_body, three_body, dispersion,
               electrostatics, pme) and the full ``MBPolPotential``
- ``ops``      building blocks: data-driven polynomial evaluation,
               neighbor lists, B-splines, incomplete gamma
- ``md``       integrators, simulation loop (lax.scan), reporters, checkpoints
- ``app``      OpenMM-app-compatible layer: PDB reading, ForceField,
               mbpol_builder-style script generation
- ``parallel`` jax.sharding mesh utilities + sharded force evaluation
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# MB-pol's fitted polynomial coefficients cancel by ~4 orders of magnitude.
# On a GPU the default float32 matmul precision lets XLA use TF32 (about 10
# mantissa bits), which corrupts energies by O(100 kcal/mol) and forces
# badly enough to break NVE conservation. Force full float32 matmuls
# process-wide (opt out with MBPOL_NO_PRECISION_OVERRIDE=1; the PIP
# contractions additionally pin HIGHEST explicitly).
if not _os.environ.get('MBPOL_NO_PRECISION_OVERRIDE'):
    _jax.config.update('jax_default_matmul_precision', 'highest')

from mbpol_openmm_plugin_tpu.utils import units  # noqa: F401
