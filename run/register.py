#!/usr/bin/env python
"""Register a particle catalog (or a synthetic mock) into an inference-ready
HDF5 register file: geometry, painted count/selection/mask meshes, fiducial
cosmology, tabulated linear power, and whitened initial conditions.

Parity: reference `run/register.py` — the cut-sky/full-sky registration
pipeline, with the NERSC-specific readers (fitsio/asdf/abacusnbody) replaced
by generic loaders plus a hermetic synthetic-mock generator (a 2LPT
realization painted through the same NUFFT pipeline), so registration is
testable without survey data.

Usage:
  python run/register.py synthetic --cell-budget 32768 --out registered/
  python run/register.py fullsky --pos catalog.npy --box-size 2000 ...
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def compute_lin_kpow(cosmo, kmin=1e-4, kmax=1e1, n_interp=256):
    """(k, P(k)/sigma8^2) at z=0 as a (2, n_interp) array, so the model
    recovers P(k) by scaling with the sampled sigma8."""
    from montecosmo_tpu.ops.power import lin_power

    ks, pows = lin_power(cosmo._replace(sigma8=1.0))
    return np.stack((np.asarray(ks), np.asarray(pows)))


def build_init(init_shape, cosmo, box_size, real_ic=None, seed=42,
               lin_kpow=None):
    """Init dict: lin_kpow + whitened ICs (real mesh whitened via lin2white,
    or a synthetic unit-power draw as `white_fake`)."""
    from jax import numpy as jnp

    from montecosmo_tpu.models.bricks import lin2white, white_noise
    from montecosmo_tpu.ops.hermitian import chreshape, r2chshape

    if lin_kpow is None:
        lin_kpow = compute_lin_kpow(cosmo)
    init = {"lin_kpow": lin_kpow}
    if real_ic is not None:
        fmesh = jnp.fft.rfftn(jnp.asarray(real_ic))
        fmesh = chreshape(fmesh, r2chshape(init_shape))
        from montecosmo_tpu.utils.io import to_np
        init["white_mesh"] = to_np(
            lin2white(cosmo, fmesh, init_shape, box_size, kpow=lin_kpow))
    else:
        from montecosmo_tpu.utils.io import to_np
        init["white_fake"] = to_np(white_noise(seed, init_shape, box_size))
    return init


def synthetic_mock(cosmo, box_size=640.0, n_ptcl=32, a_obs=0.5, seed=0):
    """Generate a 2LPT particle mock with velocities (for catalog RSD)."""
    from jax import numpy as jnp, random as jr

    from montecosmo_tpu.models.bricks import regular_pos, white2lin, white_noise
    from montecosmo_tpu.ops.background import Background, Esqr
    from montecosmo_tpu.ops.pm import lpt

    import jax
    from jax import random as jr

    shape = 3 * (n_ptcl,)
    box = np.full(3, box_size)
    pos0 = regular_pos(shape)

    # one jitted graph end to end instead of per-op eager dispatch
    @jax.jit
    def make(key):
        bg = Background.create(cosmo)
        white = white_noise(key, shape, box)
        lin = white2lin(cosmo, white, shape, box)
        dpos, vel = lpt(bg, lin, pos0, a=a_obs, lpt_order=2, read_order=1)
        import jax.numpy as jnp
        return (pos0 + dpos) % n_ptcl, vel, jnp.fft.irfftn(lin), bg.a2g(a_obs) * bg.a2f(a_obs)

    posc, vel, lin_real, gf = make(jr.key(seed))
    bg = Background.create(cosmo)
    pos = np.asarray(posc) * (box_size / n_ptcl)
    # growth-time velocity -> peculiar km/s: v = a H D f * dq_phys
    E = float(np.sqrt(Esqr(cosmo, a_obs)))
    to_kms = a_obs * 100.0 * E * float(gf)
    vel_kms = np.asarray(vel) * (box_size / n_ptcl) * to_kms
    return {"pos": pos, "vel": vel_kms}, np.asarray(lin_real)


def register(args):
    from montecosmo_tpu.models.model import FieldLevelModel
    from montecosmo_tpu.ops.background import AbacusSummit0, get_cosmology
    from montecosmo_tpu.ops.hermitian import scale_shape
    from montecosmo_tpu.utils.io import h5save

    if getattr(args, "cosmoprimo", None):
        # Boltzmann-grade fiducial P(k) + cosmology loc (optional dependency)
        from run.catalogs import lin_kpow_cosmoprimo
        args._lin_kpow, loc = lin_kpow_cosmoprimo(args.cosmoprimo)
        cosmo = get_cosmology(**loc)
    else:
        args._lin_kpow = None
        cosmo = AbacusSummit0()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    if args.mode == "synthetic":
        data, real_ic = synthetic_mock(cosmo, box_size=args.box_size,
                                       n_ptcl=args.n_ptcl, a_obs=args.a_obs,
                                       seed=args.seed)
        box_size = np.full(3, args.box_size)
        tag = f"synthetic_z{1/args.a_obs - 1:.3f}"
        reg = FieldLevelModel.register_catalog(
            cell_budget=args.cell_budget, cosmo_fid=cosmo, data=data,
            a_obs=args.a_obs, los=(0.0, 0.0, 1.0), box_size=box_size,
            box_center=(0.0, 0.0, 0.0), padding=args.padding,
            init_oversamp=args.init_oversamp, paint_oversamp=args.paint_oversamp)
    elif args.mode == "fullsky":
        from run.catalogs import load_box_catalog, load_ic_mesh

        data = load_box_catalog(args.pos, pos_cols=args.pos_cols.split(","),
                                vel_cols=args.vel_cols.split(",") if args.vel_cols
                                else None)
        if args.vel:  # separate velocity file (.npy)
            data["vel"] = np.load(args.vel)
        real_ic = load_ic_mesh(args.ic, args.ic_growth) if args.ic else None
        box_size = np.full(3, args.box_size)
        tag = Path(args.pos).stem
        reg = FieldLevelModel.register_catalog(
            cell_budget=args.cell_budget, cosmo_fid=cosmo, data=data,
            a_obs=args.a_obs, los=(0.0, 0.0, 1.0), box_size=box_size,
            box_center=(0.0, 0.0, 0.0), padding=args.padding,
            init_oversamp=args.init_oversamp, paint_oversamp=args.paint_oversamp)
    elif args.mode == "cutsky":
        from run.catalogs import load_cutsky_catalog

        data = load_cutsky_catalog(args.data)
        random = load_cutsky_catalog(args.random)
        real_ic = None
        tag = Path(args.data).stem
        reg = FieldLevelModel.register_catalog(
            cell_budget=args.cell_budget, cosmo_fid=cosmo, data=data,
            random=random, padding=args.padding,
            init_oversamp=args.init_oversamp, paint_oversamp=args.paint_oversamp)
    else:
        raise ValueError(args.mode)

    final_shape = reg["count_mesh"].shape
    init_shape = scale_shape(final_shape, reg["init_oversamp"])
    box = np.multiply(final_shape, reg["cell_length"])
    reg |= build_init(init_shape, cosmo, box, real_ic=real_ic, seed=args.seed,
                      lin_kpow=args._lin_kpow)

    mesh_len = int(round(np.prod(final_shape) ** (1 / 3)))
    path = out / f"register_{tag}_b{mesh_len}_p{args.padding:g}.h5"
    h5save(path, reg)
    print(f"registered {reg['n_tracers']:.0f} tracers at {final_shape} -> {path}")
    return path


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="mode", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--cell-budget", type=float, default=32**3)
    common.add_argument("--padding", type=float, default=0.0)
    common.add_argument("--init-oversamp", type=float, default=1.5)
    common.add_argument("--paint-oversamp", type=float, default=1.75)
    common.add_argument("--a-obs", type=float, default=0.5)
    common.add_argument("--seed", type=int, default=42)
    common.add_argument("--out", type=str, default="registered")
    common.add_argument("--platform", type=str, default=None,
                        help="jax platform override (e.g. cpu)")
    common.add_argument("--cosmoprimo", type=str, default=None,
                        help="optional cosmoprimo fiducial factory name (e.g. "
                             "AbacusSummit) for Boltzmann-grade lin P(k); "
                             "requires the cosmoprimo package")

    syn = sub.add_parser("synthetic", parents=[common])
    syn.add_argument("--box-size", type=float, default=640.0)
    syn.add_argument("--n-ptcl", type=int, default=64)

    full = sub.add_parser("fullsky", parents=[common])
    full.add_argument("--pos", required=True,
                      help="positions: .npy (n,3) [Mpc/h], or tabular "
                           ".fits/.npz/.h5 (see --pos-cols), or Abacus .asdf")
    full.add_argument("--pos-cols", default="x,y,z",
                      help="position column names in tabular catalogs")
    full.add_argument("--vel-cols", default=None,
                      help="velocity column names in tabular catalogs "
                           "(e.g. vx,vy,vz) [km/s]")
    full.add_argument("--vel", help=".npy (n, 3) peculiar velocities [km/s]")
    full.add_argument("--ic", help="real-space linear IC mesh: .npy or "
                                   "AbacusSummit ic_dens .asdf")
    full.add_argument("--ic-growth", type=int, default=None,
                      help="GrowthTable index for .asdf ICs")
    full.add_argument("--box-size", type=float, required=True)

    cut = sub.add_parser("cutsky", parents=[common])
    cut.add_argument("--data", required=True,
                     help=".fits/.npz/.h5 with RA/DEC/Z[/WEIGHT]")
    cut.add_argument("--random", required=True,
                     help=".fits/.npz/.h5 with RA/DEC/Z[/WEIGHT]")

    args = ap.parse_args()
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    register(args)


if __name__ == "__main__":
    main()
