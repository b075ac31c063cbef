"""ESS/hour report from a campaign directory's chains.

Usage: python run/ess_report.py <save_dir> [campaign_wall_seconds] [--platform cpu]

With no wall time given, phase timers are parsed from <save_dir>/run.out:
sampling ESS/hour uses the summed "[phase] full_run" lines, total-campaign
ESS/hour the sum of every phase line.

Computes the multivariate/per-parameter effective sample size of the
cosmological + bias scalars over the saved runs (all chains pooled the
Gelman way: ESS summed over chains from the per-chain autocorrelation),
and divides by the sampling wall time.
"""
import argparse
import glob
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("save_dir")
    ap.add_argument("wall_s", type=float, nargs="?", default=None)
    ap.add_argument("--platform", default="cpu")
    args = ap.parse_args()

    if args.wall_s is None:
        import re
        out = open(f"{args.save_dir}/run.out").read()
        phases = re.findall(r"\[phase\] (\w+): ([0-9.]+)s", out)
        run_s = sum(float(v) for k, v in phases if k == "full_run")
        total_s = sum(float(v) for k, v in phases)
        assert run_s > 0, "no [phase] full_run lines in run.out"
        print(f"phases: {dict((k, 0) for k, _ in phases).keys()} "
              f"run={run_s:.0f}s total={total_s:.0f}s")
        args.wall_s = run_s
        args.total_s = total_s
    else:
        args.total_s = None

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from jax import numpy as jnp
    from montecosmo_tpu.metrics import effective_sample_size
    from montecosmo_tpu.utils.io import h5load

    files = sorted(glob.glob(f"{args.save_dir}/chains/run_*.h5"))
    files = [f for f in files
             if not any(s in f for s in ("last_state", "partial", "pstate",
                                         ".tmp"))]
    assert files, f"no runs in {args.save_dir}"
    runs = [h5load(f) for f in files]

    report = {}
    for key in ("Omega_m", "sigma8", "b1", "b2", "bs2", "ngbars"):
        k_ = key + "_"
        if k_ not in runs[0]:
            continue
        x = np.concatenate([np.asarray(r[k_]) for r in runs], axis=1)
        x = x.reshape(x.shape[0], -1)  # (chains, samples)
        ess = float(np.asarray(effective_sample_size(jnp.asarray(x))))
        report[key] = ess
        # frozen-chain guard: a per-chain sd orders of magnitude below the
        # cross-chain spread means the sampler barely moved (ESS ~ n_chains
        # then measures chain COUNT, not mixing) — seen when the MCLMC
        # tuner collapsed the step size (f32 logpdf noise, see
        # FieldLevelModel.recenter_logpdf)
        within = x.std(axis=1).mean()
        between = x.mean(axis=1).std() + 1e-30
        if x.shape[0] > 1 and within < 1e-3 * between:
            print(f"  WARNING {key}: chains look FROZEN "
                  f"(within-chain sd {within:.2e} << between-chain "
                  f"{between:.2e}); ESS/hour below is meaningless")

    hours = args.wall_s / 3600.0
    print(f"runs: {len(files)}, chains x samples: {x.shape}, "
          f"wall: {args.wall_s:.0f} s")
    for k, v in report.items():
        print(f"  {k:8s}: ESS {v:8.1f}  -> {v / hours:8.1f} ESS/hour")
    worst = min(report.values())
    print(f"worst-parameter ESS/hour: {worst / hours:.1f}")
    if args.total_s:
        th = args.total_s / 3600.0
        print(f"incl. warmup ({args.total_s:.0f} s): "
              f"worst-parameter ESS/hour: {worst / th:.1f}")


if __name__ == "__main__":
    main()
