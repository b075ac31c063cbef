"""Headline benchmark: PM forward+gradient evaluations per second.

Config 2 of BASELINE.json: 2LPT + full Lagrangian bias + RSD observable at a
128^3 final mesh (default oversampling -> 224^3 evolution mesh), quad-Gaussian
field-level likelihood, float32, one forward + reverse render of the joint
logpdf per evaluation — the unit of cost of every MCLMC/NUTS step.

Run on the GPU (it refuses to time anything else):
  python bench.py [final=128] [auto|window|scatter] [lpt|nbody]
  python bench.py pm [mesh=256] [n_steps=10]     # pure-PM microbench

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "evals/sec", "vs_baseline": null,
   "device": {"platform": "gpu", "kind": ..., "count": ...}}
(the reference publishes no numbers — BASELINE.md documents the absence).
Any failure raises, so the exit code is non-zero.
"""
import json
import os
import sys
import time

import numpy as np

from montecosmo_tpu.utils.cache import enable_compile_cache


def flagship_model(final=128, paint_method="auto", evolution="lpt"):
    """The benchmark configuration at a `final`^3 final mesh (1 Gpc/h box)."""
    from montecosmo_tpu import FieldLevelModel, default_config

    conf = dict(default_config)
    conf.update(
        final_shape=3 * (final,), cell_length=500.0 * 2 / final,
        evolution=evolution, lpt_order=2, a_obs=0.5, curved_sky=False,
        box_center=(0.0, 0.0, 1500.0), lik_type="quad_gauss", precond="kaiser",
        paint_method=paint_method,
    )
    return FieldLevelModel(**conf)


def flagship(final=128, paint_method="auto", evolution="lpt"):
    """(model, params, obs) of the benchmark configuration: the model,
    fiducial parameters with a white-noise field from seed 0, and a count
    mesh drawn from the model at those parameters."""
    from jax import random as jr

    model = flagship_model(final, paint_method, evolution)
    params = model.reparam(dict(model.fiduc), inv=True)
    params["white_mesh_"] = jr.normal(jr.key(0), model.init_shape)

    pred = model.predict(seed=1, samples=params, hide_base=False,
                         hide_det=False, hide_samp=False)
    return model, params, {"count_mesh": np.asarray(pred["count_mesh"])}


def build(final=128, paint_method="auto", evolution="lpt"):
    """(step, params): the jitted joint-logpdf value+grad of `flagship`."""
    import jax

    model, params, obs = flagship(final, paint_method, evolution)

    if os.environ.get("MONTECOSMO_STAGED_EVAL") == "1":
        # 4 smaller stage programs instead of one monolithic program
        # (opt-in: the split keeps stage-1 vjp residuals and stage outputs
        # live at once, so it needs more memory than the monolithic program)
        vag = model.value_and_grad_staged()
        return (lambda p: vag({**p, **obs})), params

    def eval_step(p):
        return jax.value_and_grad(lambda q: model.logpdf({**q, **obs}))(p)

    return jax.jit(eval_step), params


def build_pm(mesh=256, n_steps=10, box=1000.0):
    """North-star microbench: pure PM N-body forward+gradient.

    BASELINE.json north star: "a 256^3-mesh 10-step PM forward+gradient
    evaluation" — white noise -> linear field -> 2LPT init -> `n_steps`
    BullFrog kick-drift-kick steps -> CIC paint at the same mesh, scalar
    loss, reverse-mode gradient w.r.t. the white-noise field.  No bias/RSD/
    likelihood machinery: this is the gravity-engine cost unit, comparable
    to JaxPM-style PM benchmarks (mesh^3 particles on a mesh^3 grid).
    """
    import jax
    from jax import numpy as jnp, random as jr

    from montecosmo_tpu.models.bricks import regular_pos, white2lin
    from montecosmo_tpu.ops.background import Background, Planck18
    from montecosmo_tpu.ops.hermitian import rg2cgh
    from montecosmo_tpu.ops.paint import paint
    from montecosmo_tpu.ops.pm import nbody_bf

    shape, box_size = 3 * (mesh,), 3 * (float(box),)
    cosmo = Planck18()

    def loss_fn(white):
        bg = Background.create(cosmo)
        wh = rg2cgh(white) * np.prod(np.divide(shape, box_size)) ** 0.5
        lin = white2lin(cosmo, wh, shape, box_size)
        pos = regular_pos(shape)
        pos, vel = nbody_bf(bg, lin, pos, a0=0.0, a1=1.0, n_steps=n_steps,
                            paint_order=2, lpt_order=2, sites_shape=shape)
        final = paint(pos[-1], shape, order=2)
        return jnp.mean((final - 1.0) ** 2)

    white = jr.normal(jr.key(0), shape)
    return jax.jit(jax.value_and_grad(loss_fn)), white


def build_pm_staged(mesh=256, n_steps=10, box=1000.0):
    """North-star microbench, host-staged (same math as `build_pm`).

    Splits the integration at program boundaries with
    `utils.staged.host_scan_value_and_grad`: init / each BullFrog step /
    loss / each transpose is its own program of ~1-3 force evaluations,
    which bounds the length of any one device program.  Opt-in
    (`MONTECOSMO_STAGED_PM=1`); exactness vs the monolithic path is tested
    (tests/test_staged_pm.py).
    """
    import jax
    from jax import numpy as jnp, random as jr

    from montecosmo_tpu.models.bricks import regular_pos, white2lin
    from montecosmo_tpu.ops.background import Background, Planck18
    from montecosmo_tpu.ops.hermitian import rg2cgh
    from montecosmo_tpu.ops.paint import paint
    from montecosmo_tpu.ops.pm import bullfrog_step, lpt
    from montecosmo_tpu.utils.staged import host_scan_value_and_grad

    shape, box_size = 3 * (mesh,), 3 * (float(box),)
    cosmo = Planck18()

    # concrete growth knots (one tiny device program)
    def _knots():
        bg = Background.create(cosmo)
        g0, g1 = bg.a2g(jnp.asarray(0.0)), bg.a2g(jnp.asarray(1.0))
        dgv = (g1 - g0) / n_steps
        return g0 + dgv * jnp.arange(n_steps), dgv

    gs, dg = jax.jit(_knots)()
    gs, dg = np.asarray(gs), float(dg)

    def init_fn(white):
        bg = Background.create(cosmo)
        wh = rg2cgh(white) * np.prod(np.divide(shape, box_size)) ** 0.5
        lin = white2lin(cosmo, wh, shape, box_size)
        pos = regular_pos(shape)
        # read_order=1 at the regular lattice, as nbody_bf's LPT init does
        dpos, vel = lpt(bg, lin, pos, a=0.0, lpt_order=2, read_order=1,
                        sites_shape=shape)
        return (pos + dpos, vel)

    # steps per device program: larger chunks amortize program dispatch and
    # let XLA overlap across steps
    spp = int(os.environ.get("MONTECOSMO_PM_STEPS_PER_PROGRAM", 1))

    def body_fn(state, g0s):
        import jax as _jax
        from jax import lax

        bg = Background.create(cosmo)
        step = bullfrog_step(bg, dg, shape, paint_order=2)
        if spp == 1:
            return step(state, g0s)[0]
        return lax.scan(_jax.checkpoint(step), state, g0s)[0]

    def loss_fn(state):
        final = paint(state[0], shape, order=2)
        return jnp.mean((final - 1.0) ** 2)

    stage_times = {} if os.environ.get("MONTECOSMO_PM_PROFILE") else None
    vag = host_scan_value_and_grad(init_fn, body_fn, loss_fn,
                                   stage_times=stage_times)
    assert n_steps % spp == 0, (n_steps, spp)
    if spp == 1:
        xs = [np.float32(g) for g in gs]
    else:
        xs = [np.asarray(gs[i:i + spp], np.float32)
              for i in range(0, n_steps, spp)]
    white = jr.normal(jr.key(0), shape)

    def run(w):
        out = vag(w, xs)
        if stage_times:
            for k, ts in stage_times.items():
                ms = [round(t * 1e3, 1) for t in ts[-len(xs):]]
                print(f"# stage {k}: {ms} ms", file=sys.stderr)
            stage_times.clear()
        return out

    return run, white


def main_pm(mesh=256, n_steps=10, n_warmup=2, n_iter=10):
    import jax

    device = _require_gpu()
    enable_compile_cache()

    if os.environ.get("MONTECOSMO_STAGED_PM") == "1":
        step, white = build_pm_staged(mesh, n_steps)
    else:
        step, white = build_pm(mesh, n_steps)
    for _ in range(n_warmup):
        loss, grad = jax.block_until_ready(step(white))
    if not np.isfinite(float(loss)):
        raise FloatingPointError("non-finite PM loss")

    t0 = time.perf_counter()
    for _ in range(n_iter):
        loss, grad = step(white)
    jax.block_until_ready((loss, grad))
    dt = (time.perf_counter() - t0) / n_iter

    result = {
        "metric": f"pure PM N-body forward+grad at {mesh}^3 mesh/particles "
                  f"({n_steps} BullFrog steps, 2LPT init, CIC paint, f32)",
        "value": 1.0 / dt, "unit": "evals/sec",
        "vs_baseline": None, "ms_per_eval": dt * 1e3, "device": device,
    }
    print(json.dumps(result))
    return result


def _require_gpu():
    """The device the numbers are taken on; a run that finds no GPU fails
    instead of timing XLA's CPU backend."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"bench.py measures the GPU; JAX found {dev}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def main(final=128, n_warmup=2, n_iter=10, paint_method="auto",
         evolution="lpt"):
    import jax

    device = _require_gpu()
    enable_compile_cache()

    step, params = build(final, paint_method, evolution)
    for _ in range(n_warmup):  # the first call compiles
        logp, grads = jax.block_until_ready(step(params))
    if not np.isfinite(float(logp)):
        raise FloatingPointError("non-finite logpdf in benchmark")

    t0 = time.perf_counter()
    for _ in range(n_iter):
        logp, grads = step(params)
    jax.block_until_ready((logp, grads))
    dt = (time.perf_counter() - t0) / n_iter

    result = {
        "metric": f"PM forward+grad evals/sec at {final}^3 final mesh "
                  + ("(BullFrog 10-step N-body"
                     if evolution == "nbody" else "(2LPT")
                  + " + Lagrangian bias + RSD, quad-Gaussian likelihood, f32)",
        "value": 1.0 / dt,
        "unit": "evals/sec",
        "vs_baseline": None,
        "device": device,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "pm":
        # north-star microbench: python bench.py pm [mesh=256] [n_steps=10]
        main_pm(int(sys.argv[2]) if len(sys.argv) > 2 else 256,
                int(sys.argv[3]) if len(sys.argv) > 3 else 10)
    else:
        final = int(sys.argv[1]) if len(sys.argv) > 1 else 128
        main(final, paint_method=sys.argv[2] if len(sys.argv) > 2 else "auto",
             evolution=sys.argv[3] if len(sys.argv) > 3 else "lpt")
