"""`chip_smoke.py`'s sampler phase (MCLMC init + thinned samples) at 16^3 on
the CPU."""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench  # noqa: E402
import chip_smoke  # noqa: E402


def test_phase_sampler_16():
    logd = chip_smoke.phase_sampler(bench.flagship(16), n_samples=2,
                                    thinning=1)
    assert logd.shape == (2,) and np.all(np.isfinite(logd))
