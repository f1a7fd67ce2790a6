"""Choice of the direct-space electrostatics path (models/potential.py):
decided from the system size alone, the same on every backend."""
import pytest

from mbpol_openmm_plugin_tpu.models.potential import (DENSE_ELEC_MAX_WATERS,
                                                      MBPol, MBPolConfig,
                                                      electrostatics_mode_for)
from mbpol_openmm_plugin_tpu.parallel.plan import plan_capacities
from mbpol_openmm_plugin_tpu.system import System


@pytest.mark.parametrize('method,n_waters,want', [
    ('PME', 256, 'dense'),
    ('PME', DENSE_ELEC_MAX_WATERS, 'dense'),
    ('PME', DENSE_ELEC_MAX_WATERS + 1, 'sparse'),
    ('NoCutoff', 4 * DENSE_ELEC_MAX_WATERS, 'dense'),
])
def test_auto_mode_from_water_count(method, n_waters, want):
    cfg = MBPolConfig(nonbonded_method=method)
    assert electrostatics_mode_for(cfg, n_waters) == want


@pytest.mark.parametrize('mode', ['block', 'tiles'])
def test_unknown_mode_raises(mode):
    """'block' (the removed block-sparse kernel path) and any other unknown
    mode fail at construction instead of falling back to another path."""
    sys_ = System.waters(8, box=[1.0, 1.0, 1.0])
    with pytest.raises(ValueError, match='electrostatics_mode'):
        MBPol(sys_, MBPolConfig(nonbonded_method='PME', cutoff=0.45,
                                electrostatics_mode=mode))


def test_plan_follows_potential_policy():
    """The capacity planner resolves 'auto' exactly like MBPol: dense with
    no molecule-pair lists at water256, sparse with the shared pair list
    above the dense limit."""
    box = [1.94] * 3
    small = plan_capacities(256, box)
    assert (small.elec_mode, small.disp_mode) == ('dense', 'dense')
    assert small.elec_pair_cap is None
    big = plan_capacities(2048, [3.88] * 3, n_devices=4)
    assert (big.elec_mode, big.disp_mode) == ('sparse', 'pairs')
    assert big.elec_pair_cap and big.elec_pair_cap % 4 == 0
