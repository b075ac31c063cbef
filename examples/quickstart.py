"""Minimal end-to-end quickstart: field-level inference on a synthetic mock.

Runs the full 3-phase pipeline (field warmup -> full warmup -> sampling) on
CPU at toy scale, then writes a corner plot and chain diagnostics — the
shortest path from `git clone` to a posterior.

    python examples/quickstart.py                  # 16^3, ~5 min on CPU
    python examples/quickstart.py --final 32       # config-1 scale, longer

Outputs land in --save (default results/quickstart, gitignored):
    triangle.png   corner plot of the scalar posteriors (truth markers)
    field_warm.png initial-field warmup diagnostics
    chains/        raw + consolidated chains (HDF5)

Parity: the reference ships this as `intro/` notebooks; this is the runnable
script equivalent (reference intro/JaxPM_demo_sampling.ipynb).
"""
import argparse
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--final", type=int, default=16,
                    help="final mesh size per side (16 quick, 32 config-1)")
    ap.add_argument("--save", default="results/quickstart")
    ap.add_argument("--n-chains", type=int, default=2)
    ap.add_argument("--n-steps", type=int, default=64,
                    help="warmup steps per phase")
    ap.add_argument("--n-samples", type=int, default=16,
                    help="kept samples per run (2 runs)")
    ap.add_argument("--platform", default="cpu",
                    help="jax platform (cpu|cuda); CPU is the quick path")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", args.platform)
    import numpy as np
    from jax import numpy as jnp, random as jr

    from montecosmo_tpu import FieldLevelModel, default_config
    from montecosmo_tpu.script import (
        field_warmup, full_run, full_warmup, make_chains, plot_field_warmup,
    )
    from montecosmo_tpu.utils.cache import enable_compile_cache
    from montecosmo_tpu.utils.io import h5save

    save_dir = Path(args.save)
    chains_dir = save_dir / "chains"
    chains_dir.mkdir(parents=True, exist_ok=True)
    enable_compile_cache()

    # ---------------------------------------------------------------- model
    # config-1 scale: 2LPT evolution, Lagrangian bias, quadratic-Gaussian
    # likelihood, flat sky at fixed scale factor (the simplest full model)
    n = args.final
    conf = dict(default_config)
    conf.update(final_shape=3 * (n,), cell_length=640.0 / n,
                evolution="lpt", lpt_order=2, a_obs=0.5, curved_sky=False,
                box_center=(0.0, 0.0, 1500.0), ap_auto=None,
                lik_type="quad_gauss", precond="kaiser", n_rbins=1,
                init_oversamp=1.0, evol_oversamp=1.0, ptcl_oversamp=1.0,
                paint_oversamp=1.0)
    model = FieldLevelModel(**conf)
    print(model)

    # ------------------------------------------------------- synthetic data
    print("\nSelf-predicting synthetic data from the fiducial cosmology...")
    model.white_mesh = jr.normal(jr.key(42), model.init_shape)
    pred = model.predict(samples=model.fiduc | {"white_mesh": model.white_mesh},
                         hide_base=False, hide_samp=False, from_base=True)
    model.count_mesh = pred["count_mesh"]
    del pred
    model.save(save_dir / "model.yaml")

    fid = model.fiduc | {"white_mesh": jnp.asarray(model.white_mesh)} \
        | model.obs_data()
    lp = jax.jit(lambda d: model.logpdf(model.reparam(d, inv=True)))(fid)
    print("logpdf of fiducial:", lp)
    assert np.isfinite(float(lp))
    model.recenter_logpdf(
        jax.jit(lambda d: model.reparam(d, inv=True))(fid))

    # observe the count mesh + the latents this toy posterior does not probe
    # well, inferring (white_mesh, Omega_m, sigma8, b1, b2, bs2, bn2, ngbars)
    obs_names = ["count_mesh", "powspec", "alpha_iso", "alpha_ap",
                 "b3", "bds2", "bs3", "bn2", "bnpar",
                 "fNL_bpd2", "fNL_bps2", "fNL_bn2p",
                 "s_e", "s_ed", "s_e2", "s_ep"]
    obs = {k: fid[k] for k in obs_names if k in fid}
    h5save(save_dir / "obs.h5", obs)
    print("Inferring:", sorted(set(fid) - set(obs)))

    # ------------------------------------------------------------ inference
    state, config, params_start = field_warmup(
        model, chains_dir, n_steps=args.n_steps, desired_energy_var=1e-6,
        n_chains=args.n_chains)
    plot_field_warmup(model, params_start, state, save_dir)

    state, config = full_warmup(
        model, obs, state, chains_dir, n_steps=args.n_steps,
        desired_energy_var=1e-6, n_chains=args.n_chains, tune_mass=True)

    full_run(model, state, config, chains_dir, n_samples=args.n_samples,
             n_runs=2, n_chains=args.n_chains, thinning=4)

    # ------------------------------------------------------- postprocessing
    make_chains(save_dir, start=1, end=2)
    print(f"\nDone. Corner plot: {save_dir / 'triangle.png'}")


if __name__ == "__main__":
    main()
