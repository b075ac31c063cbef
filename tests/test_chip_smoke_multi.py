"""`chip_smoke.py --multi` at 16^3 on 4 of conftest's 8 virtual CPU devices:
the sharded flagship value+grad against one device, and one MCLMC step on a
(chains, mesh) = (2, 2) mesh."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def test_phase_multi_16():
    out = chip_smoke.phase_multi(final=16, sampler_final=16, n_dev=4)
    assert out["logp_rel"] <= chip_smoke.LOGP_RTOL
    assert out["grad_rel_l2"] <= chip_smoke.GRAD_RL2
