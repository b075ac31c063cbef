"""Accuracy report: transfer/coherence of the forward model across
integrators, resolutions, and precisions (roadmap item 5).

Compares, at matched white-noise seeds:
  1. BullFrog N-body (10 steps) vs 2LPT        — integrator systematic
  2. evol_oversamp 1.75 vs 2.25                — resolution convergence
  3. float32 vs float64                        — precision floor (a child
                                                 process with x64, on the CPU
                                                 so that it never shares the
                                                 card with this process)

Run (from the repository root): python run/accuracy_report.py [--final 32]
[--platform cpu|cuda].  Writes a text report to stdout; the shared white
noise and the f64 field go to results/accuracy/ (gitignored).
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

OUT = Path("results/accuracy")
WHITE_NPY, F64_NPY = OUT / "white.npy", OUT / "gxy_f64.npy"


def gxy_and_ptc(final, evolution, evol_oversamp, seed=0, n_steps=10,
                white_npy=None):
    import jax
    from jax import numpy as jnp, random as jr

    from montecosmo_tpu import FieldLevelModel, default_config
    from montecosmo_tpu.metrics import powtranscoh

    conf = dict(default_config)
    conf.update(final_shape=3 * (final,), cell_length=1000.0 / final,
                evolution=evolution, lpt_order=2, nbody_n_steps=n_steps,
                a_obs=0.5, curved_sky=False, box_center=(0.0, 0.0, 1500.0),
                lik_type="quad_gauss", precond="kaiser",
                evol_oversamp=evol_oversamp, ptcl_oversamp=evol_oversamp,
                paint_oversamp=evol_oversamp)
    m = FieldLevelModel(**conf)
    params = m.reparam(dict(m.fiduc), inv=True)
    if white_npy is not None:
        params["white_mesh_"] = jnp.asarray(np.load(white_npy))
    else:
        w = jr.normal(jr.key(seed), m.init_shape)
        OUT.mkdir(parents=True, exist_ok=True)
        np.save(WHITE_NPY, np.asarray(w, np.float32))
        params["white_mesh_"] = w
    pred = m.predict(seed=seed + 1, samples=params, hide_base=False,
                     hide_det=False, hide_samp=False)
    # gxy_mesh is paint-resolution; compare at the common final resolution
    from montecosmo_tpu.ops.hermitian import chreshape, r2chshape
    g = jax.jit(lambda x: jnp.fft.irfftn(chreshape(
        jnp.fft.rfftn(x), r2chshape(m.final_shape))))(
        jnp.asarray(pred["gxy_mesh"]))
    return np.asarray(g), m


def ptc(a, b, box_size):
    from jax import numpy as jnp
    from montecosmo_tpu.metrics import powtranscoh
    k, pa, trans, coh = powtranscoh(jnp.asarray(a), jnp.asarray(b),
                                    box_size=box_size)
    return np.asarray(k), np.asarray(trans), np.asarray(coh)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--final", type=int, default=32)
    ap.add_argument("--platform", default="cpu")
    ap.add_argument("--f64-child", action="store_true")
    args = ap.parse_args()

    import jax
    if args.f64_child:
        jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_platforms", args.platform)

    if args.f64_child:
        # SAME f32 white-noise realization (x64 RNG draws different bits)
        g, m = gxy_and_ptc(args.final, "lpt", 1.75, white_npy=WHITE_NPY)
        np.save(F64_NPY, g.astype(np.float64))
        return

    final = args.final
    g_lpt, m = gxy_and_ptc(final, "lpt", 1.75)
    box = m.box_size

    print(f"# Accuracy report at {final}^3 final (box {box[0]:.0f} Mpc/h)\n")

    g_nb, _ = gxy_and_ptc(final, "nbody", 1.75)
    k, t, c = ptc(g_nb, g_lpt, box)
    sel = k < 0.8 * np.pi * final / box[0]
    print("1. BullFrog(10) vs 2LPT:")
    print(f"   transfer range [{t[sel].min():.4f}, {t[sel].max():.4f}], "
          f"coherence min {c[sel].min():.4f} (k < 0.8 k_nyq)")

    g_hi, _ = gxy_and_ptc(final, "lpt", 2.25)
    k, t, c = ptc(g_lpt, g_hi, box)
    print("2. evol_oversamp 1.75 vs 2.25 (2LPT):")
    print(f"   transfer within {np.abs(t[sel] - 1).max():.4f} of 1, "
          f"coherence min {c[sel].min():.5f}")

    # 4. adaptive Tsit5 (validation integrator) vs production BullFrog:
    # ops-level, same linear mesh, painted to matter density at a_obs
    from jax import numpy as jnp, random as jr
    from montecosmo_tpu.models.bricks import regular_pos, white2lin, white_noise
    from montecosmo_tpu.ops.background import Background
    from montecosmo_tpu.ops.paint import paint
    from montecosmo_tpu.ops.pm import nbody_bf, nbody_tsit5

    @jax.jit
    def matter_pair(key):
        shape, a_obs = 3 * (final,), 0.5
        bg = Background.create(m.cosmo_fid)
        lin = white2lin(m.cosmo_fid, white_noise(key, shape, box), shape, box)
        pos0 = regular_pos(shape)
        pos_bf, _ = nbody_bf(bg, lin, pos0, a1=a_obs, n_steps=10)
        pos_ad, _ = nbody_tsit5(bg, lin, pos0, 0.05, a_obs, tol=1e-3)
        return (paint(pos_bf[-1], shape, order=2),
                paint(pos_ad[-1], shape, order=2))

    d_bf, d_ad = matter_pair(jr.key(7))
    k, t, c = ptc(np.asarray(d_ad), np.asarray(d_bf), box)
    print("4. Tsit5(tol=1e-3, adaptive) vs BullFrog(10) matter:")
    print(f"   transfer range [{t[sel].min():.4f}, {t[sel].max():.4f}], "
          f"coherence min {c[sel].min():.5f}")

    # f64 child process (clean x64 config) on the CPU: this process already
    # holds the card when --platform is the GPU
    r = subprocess.run([sys.executable, __file__, "--final", str(final),
                        "--platform", "cpu", "--f64-child"],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"f64 child failed: {r.stderr[-2000:]}")
    g64 = np.load(F64_NPY)
    k, t, c = ptc(g_lpt.astype(np.float64), g64, box)
    print("3. float32 vs float64 (2LPT):")
    print(f"   transfer within {np.abs(t[sel] - 1).max():.2e} of 1, "
          f"coherence min {c[sel].min():.8f}")


if __name__ == "__main__":
    main()
