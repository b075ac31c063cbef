"""Golden-bundle regression of the full forward model.

A fixed white-noise realization is pushed through the PRODUCTION pipeline
(init -> 2LPT / BullFrog-10 N-body -> 3rd-order Lagrangian bias -> RSD ->
window paint) and the painted galaxy meshes + multipoles are committed in
`tests/golden/golden_32.npz`.  The test regenerates them and asserts
transfer ~ 1 / coherence ~ 1 / matching multipoles — the hermetic
counterpart of the reference's matched-product checks against external
FastPM runs and 576^3 reference registers
(`/root/reference/tests_old/test_fastpm.py:113-169`,
`/root/reference/tests/test_register_ref.py:1-86`).

Any convention drift — growth normalization, paint jacobian, RSD units,
bias operator scaling — moves transfer/multipoles at O(change) and fails
here, even if every internal self-consistency test still passes.  The
white mesh is stored IN the bundle (not re-drawn from a key) so the test
is robust to RNG implementation changes.

Regenerate deliberately with:  python tests/test_golden_bundle.py --regen
"""
import sys
from pathlib import Path

import numpy as np
import pytest

GOLDEN = Path(__file__).parent / "golden" / "golden_32.npz"
FINAL = 32
BOX = 1000.0
A_OBS = 0.5
ELLS = (0, 2, 4)

FID_UPDATES = {"b1": 0.5, "b2": 0.3, "bs2": -0.2, "b3": 0.1, "bds2": 0.1,
               "bs3": -0.05, "bn2": 0.05, "bnpar": 0.2}


def make_model(evolution):
    from montecosmo_tpu import FieldLevelModel, default_config

    conf = dict(default_config)
    conf.update(final_shape=3 * (FINAL,), cell_length=BOX / FINAL,
                evolution=evolution, lpt_order=2, a_obs=A_OBS,
                curved_sky=False, box_center=(0.0, 0.0, 2000.0),
                ap_auto=None, lik_type="quad_gauss", precond="real")
    return FieldLevelModel(**conf)


def render(evolution, white):
    from jax import numpy as jnp

    model = make_model(evolution)
    params = model.reparam(dict(model.fiduc) | FID_UPDATES, inv=True)
    params["white_mesh_"] = jnp.asarray(white)
    pred = model.predict(seed=1, samples=params, hide_base=False,
                         hide_det=False, hide_samp=False)
    return np.asarray(pred["gxy_mesh"])


def multipoles(mesh):
    from montecosmo_tpu.metrics import spectrum

    k, p = spectrum(mesh - 1.0, box_size=3 * (BOX,), ells=ELLS,
                    los=(0.0, 0.0, 1.0), include_corners=False)
    return np.asarray(k), np.stack([np.asarray(pl) for pl in p])


def _regen():
    rng = np.random.default_rng(2026)
    white = rng.standard_normal(
        np.asarray(make_model("lpt").init_shape)).astype(np.float32)
    out = {"white": white}
    for evo in ("lpt", "nbody"):
        gxy = render(evo, white)
        k, p = multipoles(gxy)
        out[f"gxy_{evo}"] = gxy.astype(np.float32)
        out[f"k_{evo}"] = k
        out[f"p_{evo}"] = p
    GOLDEN.parent.mkdir(exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size/1e3:.0f} kB)")


@pytest.mark.parametrize("evo", ["lpt", "nbody"])
def test_golden_forward(evo):
    from montecosmo_tpu.metrics import powtranscoh

    assert GOLDEN.exists(), "golden bundle missing - run with --regen"
    g = np.load(GOLDEN)
    gxy = render(evo, g["white"])
    ref = g[f"gxy_{evo}"]

    # field-level agreement: transfer/coherence vs the committed product
    _, _, trans, coh = (np.asarray(x) for x in powtranscoh(
        gxy - 1.0, ref - 1.0, box_size=3 * (BOX,), include_corners=False))
    np.testing.assert_allclose(trans, 1.0, atol=2e-3)
    assert coh.min() > 1 - 1e-5, coh.min()

    # and the committed multipoles (monopole/quadrupole/hexadecapole)
    k, p = multipoles(gxy)
    np.testing.assert_allclose(k, g[f"k_{evo}"], rtol=1e-6)
    np.testing.assert_allclose(p, g[f"p_{evo}"], rtol=5e-3,
                               atol=2e-3 * np.abs(g[f"p_{evo}"][0]).max())


if __name__ == "__main__":
    if "--regen" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
        _regen()
