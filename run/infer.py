#!/usr/bin/env python
"""Field-level inference campaign on a registered mock.

Parity: reference `run/infer.py` — the same 3-phase pipeline (field warmup,
full warmup, full run) with file-based idempotent resume, provenance capture
and persistent compilation cache, driven by argparse instead of editing
__main__ blocks.

Usage:
  python run/infer.py --register registered/register_synthetic_*.h5 \
      --evolution lpt --lik-type quad_gauss --self-data --n-chains 4
"""
import argparse
import os
import shutil
import subprocess
import sys
from datetime import datetime
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def infer(register, png_type=None, lik_type="quad_gauss", evolution="lpt",
          self_data=False, fnl=0.0, expe="", overwrite=False, obs_names=(),
          n_chains=4, tune_mass=True, n_steps_field=2**12, dev_field=1e-5,
          n_steps_full=2**13, dev_full=1e-7, n_samples=None, n_runs=8,
          thinning=64, scale_fid_fac=1.0, save_root="results",
          sampler="mclmc", observable="field", recenter=True):
    import jax
    from jax import devices as jdevices, numpy as jnp

    from montecosmo_tpu import FieldLevelModel, default_config
    from montecosmo_tpu.script import (
        field_warmup, full_run, full_warmup, make_chains, plot_field_warmup,
    )
    from montecosmo_tpu.utils.cache import enable_compile_cache
    from montecosmo_tpu.utils.io import h5load, h5save

    # -------------------------------------------------- fiducial and model
    fiduc = {
        "b1": 1.0, "b2": 0.0, "bs2": 0.0, "b3": 0.0, "bds2": 0.0, "bs3": 0.0,
        "bn2": 0.0, "bnpar": 0.0,
        "fNL": fnl, "fNL_bp": 0.0, "fNL_bpd": 0.0, "fNL_bpd2": 0.0,
        "fNL_bps2": 0.0, "fNL_bn2p": 0.0,
        "s_e": 1.0, "s_k2e": 0.0, "s_kmu2e": 0.0,
        "s_ed": 0.0, "s_e2": 0.0, "s_ep": 0.0,
        "alpha_iso": 1.0, "alpha_ap": 1.0,
    }
    latents = FieldLevelModel.new_latents_from_loc(
        default_config["latents"], fiduc, update_prior=True)
    for name in fiduc:
        latents[name] = latents[name] | {
            "scale_fid": latents[name]["scale_fid"] * scale_fid_fac}

    model = FieldLevelModel(**default_config | {
        "evolution": evolution, "lik_type": lik_type, "png_type": png_type,
        "observable": observable,
        "register": str(register), "latents": latents, "n_rbins": 1})

    # -------------------------------------------------- save dir + provenance
    mesh_length = int(round(np.prod(model.final_shape) ** (1 / 3)))
    tag = Path(register).stem.replace("register_", "")
    folder = (f"{tag}_{evolution}_{mesh_length}_fNL{fnl:.0f}"
              + (f"_{sampler}" if sampler != "mclmc" else "")
              + (f"_{observable}" if observable != "field" else "")
              + ("_fourier" if lik_type == "fourier_gauss" else "")
              + ("_self" if self_data else "") + (f"_{expe}" if expe else ""))
    save_dir = Path(save_root) / folder
    chains_dir = save_dir / "chains"
    chains_dir.mkdir(parents=True, exist_ok=True)

    print(f"SAVE DIR: {save_dir}")
    log = open(save_dir / "run.out", "a", buffering=1)
    sys.stdout = sys.stderr = log
    print(f"Started on {os.environ.get('HOSTNAME')} at "
          f"{datetime.now().astimezone().isoformat()}")
    shutil.copy(__file__, save_dir / Path(__file__).name)
    commit = subprocess.run(
        ["git", "-C", str(Path(__file__).resolve().parent), "rev-parse", "HEAD"],
        capture_output=True, text=True).stdout.strip()
    print(f"montecosmo_tpu commit: {commit}")
    print("\n", jdevices())

    # persistent compilation cache: the first compile takes minutes
    print("compile cache:", enable_compile_cache())

    print(model)

    obs_site = "powspec" if model.observable == "powspec" else "count_mesh"
    if self_data:
        cached = {}
        if (save_dir / "obs.h5").exists() and not overwrite:
            cached = h5load(save_dir / "obs.h5")
        if obs_site in cached:
            # retried attempts reuse the synthetic observation
            print("\nLoading cached synthetic data...")
            if obs_site == "powspec":
                model.powspec_data = jnp.asarray(cached["powspec"])
            else:
                model.count_mesh = jnp.asarray(cached["count_mesh"])
        else:
            print("\nSelf-predicting synthetic data from the fiducial loc...")
            pred = model.predict(
                samples=model.fiduc | {"white_mesh": model.white_mesh},
                hide_base=False, hide_samp=False, from_base=True)
            if obs_site == "powspec":
                model.powspec_data = pred["powspec"]
            else:
                model.count_mesh = pred["count_mesh"]
            del pred

    model.save(save_dir / "model.yaml")
    _fid = model.fiduc | {"white_mesh": jnp.asarray(model.white_mesh)} \
        | model.obs_data()
    logpdf_fid = jax.jit(
        lambda d: model.logpdf(model.reparam(d, inv=True)))(_fid)
    print("logpdf of fiduc:", logpdf_fid, "\n")
    if not np.isfinite(float(logpdf_fid)):
        raise ValueError("fiducial logpdf is infinite or nan")

    if recenter:
        # recentre the logpdf at the fiducial: samplers difference log-
        # densities per step, and at 64^3+ the f32 quantization of the
        # O(1e6) raw total (~0.5) swamps the energy-change signal (the first
        # ess64 campaign's tuner collapsed the step size 1000x chasing it).
        # Constant shift only — posterior, gradients, and chains unchanged.
        zp = model.recenter_logpdf(
            jax.jit(lambda d: model.reparam(d, inv=True))(_fid))
        print(f"logpdf recentred at fiducial ({len(zp)} site zero-points)\n")

    # -------------------------------------------------- inference
    params = model.fiduc | {"white_mesh": model.white_mesh} | model.obs_data()
    obs = {k: params[k] for k in obs_names if k in params}
    h5save(save_dir / "obs.h5", obs)
    print(f"Inferring: {sorted(set(params) - set(obs))}")
    if n_samples is None:
        n_samples = 128 * 64 // mesh_length
    print(f"n_samples: {n_samples}, n_runs: {n_runs}, n_chains: {n_chains}, "
          f"tune_mass: {tune_mass}")

    if "white_mesh" not in obs:
        state, config, params_start = field_warmup(
            model, chains_dir, n_steps=n_steps_field,
            desired_energy_var=dev_field, n_chains=n_chains,
            overwrite=overwrite)
        plot_field_warmup(model, params_start, state, save_dir)
    else:
        state = None

    state, config = full_warmup(
        model, obs, state, chains_dir, n_steps=n_steps_full,
        desired_energy_var=dev_full, n_chains=n_chains, tune_mass=tune_mass,
        overwrite=overwrite, sampler=sampler)

    full_run(model, state, config, chains_dir, n_samples=n_samples,
             n_runs=n_runs, n_chains=n_chains, thinning=thinning,
             overwrite=overwrite, sampler=sampler)

    make_chains(save_dir, start=1, end=100)
    print(f"Finished at {datetime.now().astimezone().isoformat()}")


DEFAULT_OBS = [
    "count_mesh", "powspec", "alpha_iso", "alpha_ap", "Omega_m", "sigma8",
    "b3", "bds2", "bs3", "bn2", "bnpar",
    "fNL_bpd2", "fNL_bps2", "fNL_bn2p", "s_e", "s_ed", "s_e2", "s_ep",
]


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--register", required=True)
    ap.add_argument("--png-type", default=None, choices=[None, "fNL", "bias"])
    ap.add_argument("--lik-type", default="quad_gauss")
    ap.add_argument("--evolution", default="lpt",
                    choices=["kaiser", "lpt", "nbody"])
    ap.add_argument("--self-data", action="store_true")
    ap.add_argument("--fnl", type=float, default=0.0)
    ap.add_argument("--expe", default="")
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--obs", nargs="*", default=None,
                    help="base latents to observe (others are inferred)")
    ap.add_argument("--n-chains", type=int, default=4)
    ap.add_argument("--no-tune-mass", action="store_true")
    ap.add_argument("--n-steps-field", type=int, default=2**12)
    ap.add_argument("--n-steps-full", type=int, default=2**13)
    ap.add_argument("--n-samples", type=int, default=None)
    ap.add_argument("--n-runs", type=int, default=8)
    ap.add_argument("--thinning", type=int, default=64)
    ap.add_argument("--observable", default="field",
                    choices=["field", "powspec"])
    ap.add_argument("--sampler", default="mclmc",
                    choices=["mclmc", "mams", "nuts"],
                    help="phase-2/3 sampler (phase 1 stays MCLMC)")
    ap.add_argument("--save-root", default="results")
    ap.add_argument("--no-recenter", action="store_true",
                    help="disable the f32 logpdf recentring (constant "
                         "zero-point shift set at the fiducial)")
    ap.add_argument("--spatial-mesh", type=int, default=0,
                    help="shard the model spatially over this many devices "
                         "(parallel.context.mesh_context around the whole "
                         "campaign); 0 = single-device")
    ap.add_argument("--distributed", action="store_true",
                    help="initialize the multi-process jax.distributed "
                         "runtime (cluster layout detected from the "
                         "environment, e.g. SLURM)")
    ap.add_argument("--platform", default=None,
                    help="jax platform override (e.g. cpu), same as the "
                         "JAX_PLATFORMS environment variable")
    args = ap.parse_args()

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    if args.distributed:
        from montecosmo_tpu.parallel.cluster import (
            init_distributed, process_summary)
        init_distributed()
        print(process_summary())

    if args.obs is not None and not args.obs:
        # an empty --obs (e.g. an unexported shell variable expanding to
        # nothing) would silently infer EVERYTHING, observation included
        ap.error("--obs given with no site names; omit the flag for defaults")
    obs_names = list(args.obs) if args.obs is not None else list(DEFAULT_OBS)
    if args.lik_type == "fourier_gauss":
        obs_names += ["s_ed", "s_e2", "s_ep"]
    else:
        obs_names += ["s_k2e", "s_kmu2e"]
    if args.png_type == "fNL":
        obs_names += ["fNL_bp", "fNL_bpd"]
    if args.png_type is None:
        obs_names += ["fNL", "fNL_bp", "fNL_bpd", "fNL_bpd2", "fNL_bps2",
                      "fNL_bn2p"]

    if args.spatial_mesh > 1:
        import numpy as _np
        import jax as _jax
        from jax.sharding import Mesh as _Mesh
        from montecosmo_tpu.parallel.context import mesh_context as _mc
        # one combined dp x sp mesh: as many chain rows as devices allow
        # (chains axis data-parallel over rows, each chain's field sharded
        # over the 'mesh' axis — map_chains threads the chain axis through
        # the shard_map islands via spmd_axis_name, one partitioned program)
        _rows = max(1, min(args.n_chains,
                           len(_jax.devices()) // args.spatial_mesh))
        while args.n_chains % _rows:
            _rows -= 1
        _devs = _np.asarray(_jax.devices()[:_rows * args.spatial_mesh])
        _ctx = _mc(_Mesh(_devs.reshape(_rows, -1), ("chains", "mesh")))
    else:
        from contextlib import nullcontext
        _ctx = nullcontext()

    with _ctx:
        run_infer(args, obs_names)


def run_infer(args, obs_names):
    infer(args.register, png_type=args.png_type, lik_type=args.lik_type,
          evolution=args.evolution, self_data=args.self_data, fnl=args.fnl,
          expe=args.expe, overwrite=args.overwrite,
          obs_names=sorted(set(obs_names)), n_chains=args.n_chains,
          tune_mass=not args.no_tune_mass, n_steps_field=args.n_steps_field,
          n_steps_full=args.n_steps_full, n_samples=args.n_samples,
          n_runs=args.n_runs, thinning=args.thinning,
          save_root=args.save_root, sampler=args.sampler,
          observable=args.observable, recenter=not args.no_recenter)


if __name__ == "__main__":
    main()
