"""f32-vs-f64 fidelity regression.

The framework runs float32 where the reference runs float64
(`/root/reference/run/infer.py:76`). This pins the measured precision cost
of the flagship forward/logpdf/gradient at a small mesh: same white noise,
same observation, f64 computed under `jax.experimental.enable_x64` in the
same process. Tolerances are ~10x the measured 16^3 values.

Pitfall encoded here (cost one discarded study): never compare SAMPLED
observations across precisions — different random streams differ by shot
noise. Compare deterministic sites; share one observation array.
"""
import numpy as np
import pytest

import jax
from jax import numpy as jnp, random as jr

from montecosmo_tpu import FieldLevelModel, default_config


def _build(final=16):
    conf = dict(default_config)
    conf.update(final_shape=3 * (final,), cell_length=1000.0 / final,
                evolution="lpt", lpt_order=2, a_obs=0.5, curved_sky=False,
                box_center=(0.0, 0.0, 1500.0), lik_type="quad_gauss",
                precond="kaiser")
    return FieldLevelModel(**conf)


def _eval(white32, obs_np):
    """(logp, grad_flat, gxy) of the flagship model at the fiducial point,
    in the ambient default precision."""
    model = _build()
    params = model.reparam(dict(model.fiduc), inv=True)
    params = {k: jnp.asarray(np.asarray(v, np.float64),
                             jnp.result_type(float))
              for k, v in params.items()}
    params["white_mesh_"] = jnp.asarray(white32, jnp.result_type(float))

    pred = model.predict(seed=1, samples=params, hide_base=False,
                         hide_det=False, hide_samp=False)
    gxy = np.asarray(pred["gxy_mesh"], np.float64)

    obs = {"count_mesh": jnp.asarray(obs_np, jnp.result_type(float))}
    logp, grads = jax.jit(jax.value_and_grad(
        lambda p: model.logpdf({**p, **obs})))(params)
    gflat = np.concatenate([np.asarray(v, np.float64).ravel()
                            for _, v in sorted(grads.items())])
    return float(logp), gflat, gxy


from contextlib import contextmanager


@contextmanager
def enable_x64():
    """Toggle the x64 flag for traces inside the block (the
    jax.experimental.enable_x64 context was removed upstream; the flag is
    part of the trace context, so new jits re-trace at the new precision)."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.filterwarnings("ignore")
def test_f32_matches_f64():
    white32 = np.asarray(jr.normal(jr.key(0), _build().init_shape,
                                   dtype=jnp.float32))

    # observation drawn ONCE (f32 path), shared bit-for-bit
    model = _build()
    params = model.reparam(dict(model.fiduc), inv=True)
    params["white_mesh_"] = jnp.asarray(white32)
    obs_np = np.asarray(model.predict(
        seed=1, samples=params, hide_base=False, hide_det=False,
        hide_samp=False)["count_mesh"], np.float64)

    lp32, g32, gxy32 = _eval(white32, obs_np)
    with enable_x64():
        lp64, g64, gxy64 = _eval(white32, obs_np)

    # measured at 16^3: rel dlogp 3e-8, grad cos 1-3e-8, grad rel 2e-4,
    # gxy rms rel 4e-6 (CPU)
    assert abs(lp32 - lp64) / abs(lp64) < 5e-6, (lp32, lp64)
    cos = float(g32 @ g64 / (np.linalg.norm(g32) * np.linalg.norm(g64)))
    assert cos > 1.0 - 1e-5, cos
    assert np.linalg.norm(g32 - g64) / np.linalg.norm(g64) < 2e-2
    rms = np.sqrt(np.mean((gxy32 - gxy64) ** 2) / np.mean(gxy64 ** 2))
    assert rms < 1e-3, rms
