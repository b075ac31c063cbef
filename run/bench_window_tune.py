"""Tune paint_window: group tiling, max_disp, precision, batch_size.

Value+grad timings (block_until_ready) at the 64^3-final production layout.
Run (from the repository root, on the GPU):
    PYTHONPATH=. python run/bench_window_tune.py
"""
import time

import numpy as np
import jax
from jax import lax, numpy as jnp, random as jr

from montecosmo_tpu.ops.paint_window import paint_window
from montecosmo_tpu.utils.cache import enable_compile_cache

enable_compile_cache(min_compile_secs=5)


def timeit(fn, *args, n=5):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3


def main():
    shape = lat = (112, 112, 112)
    P = 112 ** 3

    @jax.jit
    def make():
        lattice = jnp.stack(
            jnp.meshgrid(*[jnp.arange(112, dtype=jnp.float32)] * 3,
                         indexing="ij"), -1).reshape(-1, 3)
        disp = jnp.clip(jr.normal(jr.key(0), (P, 3)) * 0.7, -4.5, 4.5)
        w = jr.uniform(jr.key(1), (P,)) + 0.5
        return lattice + disp, w

    pos, w = make()
    probe = jax.jit(lambda: jr.normal(jr.key(2), shape))()

    def run(tag, **kw):
        try:
            gfn = jax.jit(jax.value_and_grad(
                lambda p, w: jnp.vdot(paint_window(p, shape, lat, w, 2,
                                                   clip=True, **kw), probe),
                (0, 1)))
            t = timeit(gfn, pos, w)
            print(f"{tag:46s}: {t:8.2f} ms", flush=True)
            return t
        except Exception as e:
            print(f"{tag:46s}: FAILED {type(e).__name__}: {str(e)[:90]}",
                  flush=True)
            return np.inf

    H = lax.Precision.HIGHEST
    H3 = lax.Precision.HIGH
    # geometry at HIGHEST, bs=8
    for md in (8, 5):
        for g in ((8, 8, None), (16, 16, None), (16, 16, 28), (16, 16, 56),
                  (28, 28, None)):
            run(f"md={md} g={g} bs=8 HIGHEST",
                max_disp=md, group=g, batch_size=8, precision=H)
    # precision + batch on promising geometry
    for g in ((16, 16, None), (16, 16, 56)):
        run(f"md=5 g={g} bs=8 HIGH",
            max_disp=5, group=g, batch_size=8, precision=H3)
        run(f"md=5 g={g} bs=4 HIGHEST",
            max_disp=5, group=g, batch_size=4, precision=H)
        run(f"md=5 g={g} bs=16 HIGHEST",
            max_disp=5, group=g, batch_size=16, precision=H)


if __name__ == "__main__":
    main()
