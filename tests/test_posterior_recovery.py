"""Nightly posterior-recovery integration test: a small self-predicted
campaign must recover (Omega_m, sigma8, b1) within wide credible bounds.

Mirrors the reference's end-to-end usage (run/infer.py 3-phase pipeline);
budgets sized for ~15 min on CPU.  Run with: pytest -m nightly.
"""
import numpy as np
import pytest
import jax
from jax import numpy as jnp, random as jr

from montecosmo_tpu import FieldLevelModel, default_config


@pytest.mark.nightly
def test_posterior_recovers_fiducial(tmp_path):
    from montecosmo_tpu.samplers.mclmc import get_mclmc_run, get_mclmc_warmup
    from montecosmo_tpu.parallel import map_chains

    conf = dict(default_config)
    conf.update(final_shape=(16, 16, 16), cell_length=25.0, evolution="lpt",
                lpt_order=1, a_obs=0.5, curved_sky=False,
                box_center=(0.0, 0.0, 1000.0), lik_type="quad_gauss",
                precond="kaiser", init_oversamp=1.0, evol_oversamp=1.0,
                ptcl_oversamp=1.0, paint_oversamp=1.0)
    model = FieldLevelModel(**conf)

    # self-predicted truth at the fiducial point
    truth = model.reparam(dict(model.fiduc), inv=True)
    truth["white_mesh_"] = jr.normal(jr.key(7), model.init_shape)
    pred = model.predict(seed=8, samples=truth, hide_base=False,
                        hide_det=False, hide_samp=False)
    model.count_mesh = pred["count_mesh"]
    model.substitute({"count_mesh": pred["count_mesh"]})
    model.block()

    n_chains = 2
    start = jax.jit(jax.vmap(model.kaiser_post))(jr.split(jr.key(9), n_chains))

    warm = map_chains(get_mclmc_warmup(model.logpdf, n_steps=300,
                                       desired_energy_var=1e-5,
                                       diagonal_preconditioning=True),
                      n_chains)
    state, config = warm(jr.split(jr.key(10), n_chains), start)

    run = map_chains(get_mclmc_run(model.logpdf, n_samples=96, thinning=8,
                                   progress_bar=False), n_chains)
    state, samples = run(jr.split(jr.key(11), n_chains), state, config)

    post = {}
    for name in ("Omega_m", "sigma8", "b1"):
        x = np.asarray(samples[name + "_"]).reshape(-1)
        x = np.asarray(jax.vmap(
            lambda v, n=name: model.reparam({n + "_": v})[n])(jnp.asarray(x)))
        post[name] = x
        true_val = float(np.asarray(model.fiduc[name]))
        lo, hi = np.quantile(x, [0.005, 0.995])
        # truth inside the ACTUAL 99% interval — no widening
        assert lo <= true_val <= hi, (
            f"{name}: truth {true_val} outside 99% interval [{lo}, {hi}]")
        assert np.isfinite(x).all()

    # committed evidence: corner plot of the recovered posterior
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from pathlib import Path
        from montecosmo_tpu.plot import corner_plot
        from montecosmo_tpu.chains import Chains

        sel = Chains({k: v.reshape(1, -1) for k, v in post.items()})
        corner_plot(sel, markers={k: float(np.asarray(model.fiduc[k]))
                                  for k in post})
        out = Path(__file__).parent.parent / "results" / "posterior_recovery.png"
        out.parent.mkdir(exist_ok=True)
        plt.savefig(out, dpi=200)
        plt.close()
    except Exception as e:  # plot is evidence, not the assertion
        print(f"corner plot skipped: {type(e).__name__}: {e}")
