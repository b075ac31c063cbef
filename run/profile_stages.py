"""Stage-level device timing of the bench.py eval: forward and forward+VJP
cost of each pipeline brick at the 64^3-final production config.

Run (from the repository root, on the GPU):
    PYTHONPATH=. python run/profile_stages.py [final]
"""
import sys
import time

import numpy as np
import jax
from jax import numpy as jnp, random as jr

from montecosmo_tpu.utils.cache import enable_compile_cache

enable_compile_cache(min_compile_secs=5)


def timeit(fn, *args, n=10):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3


def grad_of(fn, *args):
    """forward+VJP with a fixed cotangent probe — the reverse-mode unit."""
    def loss(*a):
        out = fn(*a)
        return sum(jnp.real(jnp.vdot(x, x)) for x in jax.tree.leaves(out))
    return jax.jit(jax.grad(loss, argnums=tuple(range(len(args)))))


def main(final=64):
    from montecosmo_tpu import FieldLevelModel, default_config
    from montecosmo_tpu.models.bricks import (
        lagrangian_bias, regular_pos, rsd, white2lin,
    )
    from montecosmo_tpu.ops.background import Background
    from montecosmo_tpu.ops.hermitian import chreshape, r2chshape, rg2cgh
    from montecosmo_tpu.ops.paint import nufft
    from montecosmo_tpu.ops.pm import lpt

    conf = dict(default_config)
    conf.update(final_shape=3 * (final,), cell_length=500.0 * 2 / final,
                evolution="lpt", lpt_order=2, a_obs=0.5, curved_sky=False,
                box_center=(0.0, 0.0, 1500.0), lik_type="quad_gauss",
                precond="kaiser")
    m = FieldLevelModel(**conf)
    bg = Background.create(m.cosmo_fid)
    print(f"shapes: init={m.init_shape} evol={m.evol_shape} "
          f"ptcl={m.ptcl_shape} paint={m.paint_shape} "
          f"lattice={m.paint_lattice} sites={m.evol_sites}", flush=True)

    white = jr.normal(jr.key(0), m.init_shape)
    bias = {k: jnp.float32(v) for k, v in
            dict(b1=1.0, b2=0.1, bs2=0.1, b3=0.0, bds2=0.0, bs3=0.0,
                 bn2=0.0, bnpar=0.0).items()}
    png = {k: jnp.float32(0.0) for k in
           ("fNL_bp", "fNL_bpd", "fNL_bpd2", "fNL_bps2", "fNL_bn2p")}

    # stage 1: white -> linear (init) -> evol reshape
    norm = np.prod(np.divide(m.init_shape, m.box_size)) ** 0.5
    f_lin = jax.jit(lambda w: chreshape(
        white2lin(m.cosmo_fid, rg2cgh(w) * norm, m.init_shape, m.box_size,
                  m.lin_kpow),
        r2chshape(m.evol_shape)))
    init_mesh = f_lin(white)
    print(f"white2lin fwd       : {timeit(f_lin, white):8.2f} ms", flush=True)
    print(f"white2lin grad      : {timeit(grad_of(f_lin, white), white):8.2f} ms",
          flush=True)

    pos = jax.jit(lambda: regular_pos(m.evol_shape, m.ptcl_shape))()
    a = jnp.float32(0.6)

    # stage 2: Lagrangian bias weights
    f_lb = jax.jit(lambda im, b: lagrangian_bias(
        m.cosmo_fid, pos, a, m.box_size, im, b, png, kpow=m.lin_kpow,
        read_order=1, bg=bg, sites_shape=m.evol_sites)[0])
    print(f"lagr_bias fwd       : {timeit(f_lb, init_mesh, bias):8.2f} ms",
          flush=True)
    print(f"lagr_bias grad      : "
          f"{timeit(grad_of(f_lb, init_mesh, bias), init_mesh, bias):8.2f} ms",
          flush=True)

    # stage 3: 2LPT
    f_lpt = jax.jit(lambda im: lpt(bg, im, pos=pos, a=a, lpt_order=2,
                                   read_order=1, sites_shape=m.evol_sites))
    print(f"2LPT fwd            : {timeit(f_lpt, init_mesh):8.2f} ms", flush=True)
    print(f"2LPT grad           : "
          f"{timeit(grad_of(f_lpt, init_mesh), init_mesh):8.2f} ms", flush=True)

    dpos, vel = f_lpt(init_mesh)
    # displaced positions in INIT units (the model's nufft convention)
    ppos = jax.jit(lambda p, d: (p + d) * jnp.float32(
        m.init_shape[0] / m.evol_shape[0]))(pos, dpos)
    w = f_lb(init_mesh, bias)

    # stage 4: nufft paint (window route of a mesh context vs scatter)
    win_disp, win_lat = m._sharded_window or (m.max_disp, None)
    for tag, lat in (("window", win_lat), ("scatter", None)):
        f_pt = jax.jit(lambda p, w, lat=lat: nufft(
            p, m.init_shape, tuple(m.paint_shape), weights=w, paint_order=2,
            interlace_order=2, lattice_shape=lat, max_disp=win_disp,
            clip=True))
        print(f"nufft {tag:7s} fwd   : {timeit(f_pt, ppos, w):8.2f} ms",
              flush=True)
        print(f"nufft {tag:7s} grad  : "
              f"{timeit(grad_of(f_pt, ppos, w), ppos, w):8.2f} ms", flush=True)

    # stage 5: full eval for reference
    import bench
    step, params = bench.build(final)
    print(f"FULL eval+grad      : {timeit(step, params, n=5):8.2f} ms",
          flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 64)
