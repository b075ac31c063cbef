"""f32 vs f64 fidelity of the flagship field-level model.

The reference runs float64 everywhere (`/root/reference/run/infer.py:76`);
this framework runs float32. This script quantifies what that costs:
same 64^3 flagship config (2LPT + Lagrangian bias + RSD, quad-Gaussian
likelihood), same white-noise realization, computed once in f32 and once in
f64 (x64-enabled process), both on CPU so the ONLY difference is precision.

Usage (from the repository root; outputs under results/, which git ignores):
  python run/f32_fidelity.py run  --x64 0 --out results/fid32.npz [--final 64]
  python run/f32_fidelity.py run  --x64 1 --out results/fid64.npz [--final 64]
  python run/f32_fidelity.py compare results/fid32.npz results/fid64.npz

Reported:
  * fiducial joint logpdf absolute + relative delta (and vs the recentred
    zero-point, the quantity campaigns actually consume);
  * gradient cosine similarity + relative L2 error (the MCLMC/NUTS drift);
  * predicted-observable power spectrum relative error per k-bin;
  * white->count forward-map field-level rms relative error.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def run(args):
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    from jax import numpy as jnp, random as jr

    from montecosmo_tpu import FieldLevelModel, default_config
    from montecosmo_tpu.metrics import spectrum

    conf = dict(default_config)
    conf.update(final_shape=3 * (args.final,),
                cell_length=1000.0 / args.final, evolution="lpt", lpt_order=2,
                a_obs=0.5, curved_sky=False, box_center=(0.0, 0.0, 1500.0),
                lik_type="quad_gauss", precond="kaiser")
    model = FieldLevelModel(**conf)

    params = model.reparam(dict(model.fiduc), inv=True)
    # the SAME realization bit-for-bit in both runs: draw in f32, upcast
    white32 = np.asarray(jr.normal(jr.key(0), model.init_shape,
                                   dtype=jnp.float32))
    params["white_mesh_"] = jnp.asarray(white32)

    # DETERMINISTIC forward map for the field/spectrum comparison: the
    # predicted galaxy intensity mesh gxy_mesh, not the Poisson/likelihood
    # DRAW of count_mesh — sampled observations differ between precisions
    # by shot noise (different random streams), which is not a fidelity
    # signal (first version of this script measured exactly that).
    pred = model.predict(seed=1, samples=params, hide_base=False,
                         hide_det=False, hide_samp=False)
    gxy = np.asarray(pred["gxy_mesh"], np.float64)

    # ONE observation shared bit-for-bit across both runs: the f32 process
    # writes the cache; the f64 process reuses it.
    obs_cache = Path(args.obs_cache)
    obs_cache.parent.mkdir(parents=True, exist_ok=True)
    if obs_cache.exists():
        count = np.load(obs_cache)
    else:
        count = np.asarray(pred["count_mesh"], np.float64)
        np.save(obs_cache, count)
    obs = {"count_mesh": jnp.asarray(count, jnp.result_type(float))}

    logp, grads = jax.jit(jax.value_and_grad(
        lambda p: model.logpdf({**p, **obs})))(params)
    grads = {k: np.asarray(v, np.float64) for k, v in grads.items()}
    gflat = np.concatenate([g.ravel() for k, g in sorted(grads.items())])

    kmean, pk = jax.jit(lambda m: spectrum(
        m, box_size=model.box_size, kedges=None))(jnp.asarray(
            gxy, jnp.result_type(float)))

    np.savez(args.out, logp=np.float64(logp), gflat=gflat,
             count=gxy, kmean=np.asarray(kmean), pk=np.asarray(pk, np.float64),
             x64=args.x64, final=args.final)
    print(f"{'f64' if args.x64 else 'f32'} logpdf = {float(logp):.10e} "
          f"-> {args.out}")


def compare(args):
    a, b = np.load(args.a), np.load(args.b)
    assert int(a["x64"]) == 0 and int(b["x64"]) == 1, "give f32 then f64"
    lp32, lp64 = float(a["logp"]), float(b["logp"])
    g32, g64 = a["gflat"], b["gflat"]
    cos = float(g32 @ g64 / (np.linalg.norm(g32) * np.linalg.norm(g64)))
    grel = float(np.linalg.norm(g32 - g64) / np.linalg.norm(g64))
    crel = float(np.sqrt(np.mean((a["count"] - b["count"]) ** 2))
                 / np.sqrt(np.mean(b["count"] ** 2)))
    # drop empty/denormal bins (0-mode shells divide to garbage)
    good = b["pk"] > 1e-12 * b["pk"].max()
    prel = np.abs(a["pk"][good] / b["pk"][good] - 1.0)

    print(f"final mesh           : {int(a['final'])}^3")
    print(f"logpdf f32 / f64     : {lp32:.10e} / {lp64:.10e}")
    print(f"|dlogp|              : {abs(lp32 - lp64):.3e} "
          f"(rel {abs(lp32 - lp64) / abs(lp64):.3e})")
    print(f"grad cosine          : {cos:.9f}")
    print(f"grad rel L2          : {grel:.3e}")
    print(f"forward gxy rms rel  : {crel:.3e}")
    print(f"gxy P(k) rel err     : median {np.median(prel):.3e}  "
          f"max {prel.max():.3e}")
    return dict(dlogp=abs(lp32 - lp64), dlogp_rel=abs(lp32 - lp64) / abs(lp64),
                grad_cos=cos, grad_rel=grel, count_rel=crel,
                pk_rel_max=float(prel.max()))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--x64", type=int, default=0)
    r.add_argument("--out", required=True)
    r.add_argument("--final", type=int, default=64)
    r.add_argument("--obs-cache", default="results/fid_obs.npy")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args()
    (run if args.cmd == "run" else compare)(args)
