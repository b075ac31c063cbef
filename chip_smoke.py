"""Smoke run of the main path on one GPU: the quickest proof that the system
still starts and computes the right thing on the card.

    python chip_smoke.py            # one GPU: device, paint, model, sampler
    python chip_smoke.py --multi    # four GPUs: the sharded 256^3 value+grad
                                    # against one card, and one 64^3 MCLMC
                                    # step on a (chains, mesh) = (2, 2) mesh

Everything runs in this one process (one process per card).  Each phase
prints its results; any failure raises and the script exits non-zero.  The
last line of standard output is one JSON object,
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}},
printed only when every phase passed.

Phases at one card, at the sizes of the benchmark configuration (`bench.py`):
  1. device  : card name and power limit, JAX version, XLA_FLAGS; the default
               backend must be the GPU (JAX falls back to the CPU with only a
               warning when its CUDA plugin does not start).
  2. paint   : the lattice-window paint/read (`ops.paint_window`) against the
               plain XLA scatter/gather reference (`ops.paint`) at the
               128^3 model's 224^3 particle/paint mesh and at the 256^3 PM
               microbench mesh, at HIGH and HIGHEST matmul precision, then
               the value+grad time of each formulation.
  3. model   : the flagship 128^3 2LPT + Lagrangian bias + RSD value+grad
               (memory analysis, compile and eval time), and a 32^3
               cross-check of the same computation against the CPU backend.
  4. sampler : MCLMC init + a few thinned samples of the 128^3 model.
"""
import json
import os
import subprocess
import sys
import time

# the 32^3 cross-check runs on the CPU backend of this same process
if os.environ.get("JAX_PLATFORMS") and "cpu" not in os.environ["JAX_PLATFORMS"]:
    os.environ["JAX_PLATFORMS"] += ",cpu"

import numpy as np
import jax
from jax import lax, numpy as jnp, random as jr

import bench
from montecosmo_tpu.ops.paint import paint, read
from montecosmo_tpu.ops.paint_window import paint_window, read_window
from montecosmo_tpu.utils.cache import enable_compile_cache

# HIGHEST keeps the window matmuls in f32: what is left against the scatter
# reference is the order of f32 summation (a handful of deposits per cell);
# TF32 (HIGH) misses this bound by an order of magnitude.
WINDOW_HIGHEST_TOL = 1e-5
# The f32 logpdf is a sum over every cell: two reduction orders (GPU vs CPU,
# one card vs four) differ by a few ulp of the partial sums, far inside 1e-5.
LOGP_RTOL = 1e-5
# The white-field gradient goes through FFTs, paints, reads and
# transcendentals whose f32 rounding differs between backends and libraries
# (cuFFT vs the CPU FFT, atomic vs sequential scatter-add order); 1e-3
# relative L2 allows for that rounding and nothing more.
GRAD_RL2 = 1e-3


def device_info():
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def check_device():
    """Print the card and the software, and fail unless JAX runs on a GPU."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        print("nvidia-smi:", smi.stdout.strip() or smi.stderr.strip())
    except (OSError, subprocess.TimeoutExpired) as exc:
        print(f"nvidia-smi: not available ({exc})")
    print(f"jax {jax.__version__}, XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(f"JAX default backend is {backend!r}, not 'gpu'")
    x = jnp.ones(8)
    if {d.platform for d in x.devices()} != {"gpu"}:
        raise RuntimeError(f"arrays live on {x.devices()}, not on the GPU")
    info = device_info()
    print(f"[device] {info}")
    return info


def _lattice_positions(lattice, stride, max_disp, key, sigma=1.5):
    """Lattice-major positions displaced by a clipped Gaussian of `sigma`
    cells, so that every particle stays inside the window's `max_disp`."""
    sites = jnp.stack(jnp.meshgrid(*(jnp.arange(n, dtype=jnp.float32) * stride
                                     for n in lattice), indexing="ij"), -1)
    disp = jnp.clip(sigma * jr.normal(key, sites.shape), 1 - max_disp,
                    max_disp - 1)
    return (sites + disp).reshape(-1, 3)


def _time(fn, *args, n_iter=5):
    """Seconds per call after a compile call and a warm call."""
    jax.block_until_ready(fn(*args))
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n_iter


def phase_paint(mesh, max_disp, order=2, timing=True, seed=0):
    """Window paint/read against the scatter/gather reference on a `mesh`^3
    lattice of as many particles; returns the errors (and times)."""
    shape = lattice = (mesh,) * 3
    k_pos, k_mesh, k_w = jr.split(jr.key(seed), 3)
    pos = _lattice_positions(lattice, 1, max_disp, k_pos)
    field = jr.normal(k_mesh, shape)
    wts = jr.normal(k_w, pos.shape[:1])

    ref_paint = jax.jit(lambda p: paint(p, shape, order=order))
    ref_read = jax.jit(lambda p, m: read(p, m, order=order))

    def win_paint(prec):
        return jax.jit(lambda p: paint_window(p, shape, lattice, 1.0, order,
                                              max_disp=max_disp,
                                              precision=prec))

    def win_read(prec):
        return jax.jit(lambda p, m: read_window(p, m, lattice, order,
                                                max_disp=max_disp,
                                                precision=prec))

    mesh_ref = np.asarray(ref_paint(pos), np.float64)
    read_ref = np.asarray(ref_read(pos, field), np.float64)
    res = {"mesh": mesh, "max_disp": max_disp}
    precisions = {"HIGHEST": lax.Precision.HIGHEST, "HIGH": lax.Precision.HIGH}
    for name, prec in precisions.items():
        m = np.asarray(win_paint(prec)(pos), np.float64)
        r = np.asarray(win_read(prec)(pos, field), np.float64)
        res[f"paint_err_{name}"] = float(np.abs(m - mesh_ref).max()
                                         / np.abs(mesh_ref).max())
        res[f"mass_err_{name}"] = float(abs(m.sum() - mesh_ref.sum())
                                        / mesh_ref.sum())
        res[f"read_err_{name}"] = float(np.abs(r - read_ref).max()
                                        / np.abs(read_ref).max())
    print(f"[paint {mesh}^3] errors {json.dumps(res)}")
    for kind in ("paint", "read"):
        err = res[f"{kind}_err_HIGHEST"]
        if not err <= WINDOW_HIGHEST_TOL:
            raise AssertionError(f"window {kind} at HIGHEST differs from the "
                                 f"reference by {err:.3g} > {WINDOW_HIGHEST_TOL}")
    if res["mass_err_HIGHEST"] > WINDOW_HIGHEST_TOL:
        raise AssertionError(f"window paint mass error {res['mass_err_HIGHEST']}")

    if timing:
        target = field

        def paint_vg(fn):
            return jax.jit(jax.value_and_grad(
                lambda p: jnp.vdot(fn(p), target)))

        def read_vg(fn):
            return jax.jit(jax.value_and_grad(
                lambda p, m: jnp.vdot(fn(p, m), wts), argnums=(0, 1)))

        times = {
            "paint_scatter": _time(paint_vg(lambda p: paint(p, shape,
                                                            order=order)), pos),
            "read_gather": _time(read_vg(lambda p, m: read(p, m, order=order)),
                                 pos, field),
        }
        for name, prec in precisions.items():
            times[f"paint_window_{name}"] = _time(paint_vg(
                lambda p: paint_window(p, shape, lattice, 1.0, order,
                                       max_disp=max_disp, precision=prec)),
                pos)
            times[f"read_window_{name}"] = _time(read_vg(
                lambda p, m: read_window(p, m, lattice, order,
                                         max_disp=max_disp, precision=prec)),
                pos, field)
        print(f"[paint {mesh}^3] value+grad ms "
              + json.dumps({k: v * 1e3 for k, v in times.items()}))
        res["ms"] = {k: v * 1e3 for k, v in times.items()}
    return res


def _finite(tree):
    return all(bool(jnp.all(jnp.isfinite(v))) for v in jax.tree.leaves(tree))


def phase_model(flagship, n_iter=3):
    """Compile and run the value+grad of `flagship` = (model, params, obs);
    prints the compiled memory analysis, returns the logpdf and times."""
    model, params, obs = flagship
    final = model.final_shape[0]
    t0 = time.perf_counter()
    compiled = jax.jit(jax.value_and_grad(
        lambda q: model.logpdf({**q, **obs}))).lower(params).compile()
    t_compile = time.perf_counter() - t0
    print(f"[model {final}^3] memory_analysis: {compiled.memory_analysis()}")
    logp, grads = jax.block_until_ready(compiled(params))
    if not (np.isfinite(float(logp)) and _finite(grads)):
        raise FloatingPointError(f"non-finite value+grad at {final}^3: {logp}")
    dt = _time(compiled, params, n_iter=n_iter)
    out = {"final": final, "logp": float(logp), "compile_s": t_compile,
           "eval_s": dt}
    print(f"[model {final}^3] {json.dumps(out)}")
    return out


def phase_crosscheck(final=32, device=None):
    """The flagship value+grad at `final`^3 on the default device against
    the same computation on the CPU backend (`device`)."""
    device = jax.devices("cpu")[0] if device is None else device
    model, params, obs = bench.flagship(final)
    vg = jax.jit(jax.value_and_grad(lambda q, o: model.logpdf({**q, **o})))
    logp, grads = vg(params, obs)
    logp_c, grads_c = vg(*jax.device_put((params, obs), device))
    logp, logp_c = float(logp), float(logp_c)
    g = np.asarray(grads["white_mesh_"], np.float64)
    g_c = np.asarray(grads_c["white_mesh_"], np.float64)
    out = {"final": final, "logp": logp, "logp_cpu": logp_c,
           "logp_rel": abs(logp - logp_c) / abs(logp_c),
           "grad_rel_l2": float(np.linalg.norm(g - g_c) / np.linalg.norm(g_c))}
    print(f"[crosscheck {final}^3 vs {device}] {json.dumps(out)}")
    if not out["logp_rel"] <= LOGP_RTOL:
        raise AssertionError(f"logp differs from the CPU by {out['logp_rel']}")
    if not out["grad_rel_l2"] <= GRAD_RL2:
        raise AssertionError(f"white_mesh_ gradient differs from the CPU by "
                             f"{out['grad_rel_l2']}")
    return out


def _mclmc_chain(model, obs, n_samples, thinning):
    """key, params -> logdensity of `n_samples` thinned MCLMC samples."""
    from montecosmo_tpu.samplers import get_mclmc_run, mclmc_init
    from montecosmo_tpu.samplers.mclmc import MCLMCAdaptationState

    def logdf(p):
        return model.logpdf({**p, **obs})

    def chain(key, params):
        state = mclmc_init(params, logdf, key)
        d = sum(int(np.prod(jnp.shape(v))) for v in params.values())
        config = MCLMCAdaptationState(L=jnp.sqrt(float(d)), step_size=0.01,
                                      inverse_mass_matrix=1.0)
        _, samples = get_mclmc_run(logdf, n_samples=n_samples,
                                   thinning=thinning)(key, state, config)
        return samples["logdensity"]

    return chain


def phase_sampler(flagship, n_samples=3, thinning=2):
    """MCLMC init + `n_samples` thinned samples of `flagship`."""
    model, params, obs = flagship
    run = jax.jit(_mclmc_chain(model, obs, n_samples, thinning))
    t0 = time.perf_counter()
    logd = np.asarray(run(jr.key(0), params))
    dt = time.perf_counter() - t0
    print(f"[sampler {model.final_shape[0]}^3] logdensity {logd.tolist()} "
          f"({dt:.1f} s incl. compile)")
    if logd.shape != (n_samples,) or not np.all(np.isfinite(logd)):
        raise FloatingPointError(f"MCLMC logdensity {logd}")
    return logd


def _synthetic_obs(model, seed=0):
    """A Poisson count mesh at the fiducial mean density: a realistic
    observation for a value+grad comparison without compiling the forward
    model for it."""
    nbar_cell = float(np.mean(model.fiduc["ngbars"])) * model.cell_length**3
    rng = np.random.default_rng(seed)
    return {"count_mesh": rng.poisson(nbar_cell, model.final_shape)
            .astype(np.float32)}


def phase_multi(final=256, sampler_final=64, n_dev=4):
    """The sharded flagship value+grad over `n_dev` cards against the same
    computation on one card (the window paint route that a mesh context
    takes, on a 1-device mesh), and one MCLMC step of the `sampler_final`^3
    model on a (chains, mesh) = (2, n_dev // 2) mesh."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from montecosmo_tpu.parallel.context import mesh_context

    devices = jax.devices()
    if len(devices) < n_dev:
        raise RuntimeError(f"--multi needs {n_dev} devices, found {devices}")
    devices = np.asarray(devices[:n_dev])

    model = bench.flagship_model(final)
    params = model.reparam(dict(model.fiduc), inv=True)
    params["white_mesh_"] = jr.normal(jr.key(0), model.init_shape)
    obs = _synthetic_obs(model)

    def value_grad(mesh):
        with mesh_context(mesh):
            fn = jax.jit(jax.value_and_grad(
                lambda q, o: model.logpdf({**q, **o})))
            t0 = time.perf_counter()
            logp, grads = jax.block_until_ready(fn(params, obs))
            t1 = time.perf_counter()
            jax.block_until_ready(fn(params, obs))
            t2 = time.perf_counter()
        return (float(logp), np.asarray(grads["white_mesh_"], np.float64),
                t1 - t0, t2 - t1)

    logp, g, t1, dt1 = value_grad(Mesh(devices[:1], ("mesh",)))
    logp_s, g_s, t4, dt4 = value_grad(Mesh(devices, ("mesh",)))
    out = {"final": final, "n_dev": n_dev, "logp_1card": logp,
           "logp_sharded": logp_s, "logp_rel": abs(logp_s - logp) / abs(logp),
           "grad_rel_l2": float(np.linalg.norm(g_s - g) / np.linalg.norm(g)),
           "setup_compile_s_1card": t1, "setup_compile_s_sharded": t4,
           "eval_s_1card": dt1, "eval_s_sharded": dt4}
    print(f"[multi {final}^3 sharded vs 1 card] {json.dumps(out)}")
    if not (out["logp_rel"] <= LOGP_RTOL and out["grad_rel_l2"] <= GRAD_RL2):
        raise AssertionError("sharded value+grad differs from one card")

    n_chains = 2
    mesh = Mesh(devices.reshape(n_chains, -1), ("chains", "mesh"))
    smodel = bench.flagship_model(sampler_final)
    sparams = smodel.reparam(dict(smodel.fiduc), inv=True)
    sparams["white_mesh_"] = jr.normal(jr.key(1), smodel.init_shape)
    chain = _mclmc_chain(smodel, _synthetic_obs(smodel), n_samples=1,
                         thinning=1)
    keys = jax.device_put(jr.split(jr.key(0), n_chains),
                          NamedSharding(mesh, P("chains")))
    batched = {k: jax.device_put(
        jnp.broadcast_to(v, (n_chains, *jnp.shape(v))),
        NamedSharding(mesh, P("chains", *(None,) * jnp.ndim(v))))
        for k, v in sparams.items()}
    with mesh_context(mesh):
        logd = np.asarray(jax.jit(jax.vmap(chain, spmd_axis_name="chains"))(
            keys, batched))
    print(f"[multi mclmc {sampler_final}^3 on (2, {n_dev // 2})] "
          f"logdensity {logd.tolist()}")
    if not np.all(np.isfinite(logd)):
        raise FloatingPointError(f"sharded MCLMC logdensity {logd}")
    return out


def main(argv):
    multi = "--multi" in argv
    enable_compile_cache()
    info = check_device()
    if multi:
        phase_multi()
    else:
        # 128^3 model: default oversampling 7/4 -> 224^3 particles and paint
        # mesh, window bound ceil(36 Mpc/h / 4.46 Mpc/h) = 9 cells
        # (models/model.py); 256^3 PM microbench mesh in a 1 Gpc/h box:
        # 12 cells cover 45 Mpc/h of displacement
        phase_paint(224, max_disp=9)
        phase_paint(256, max_disp=12)
        flagship = bench.flagship(128)
        phase_model(flagship)
        phase_crosscheck(32)
        phase_sampler(flagship)
    print(json.dumps({"ok": True, "device": info}))


if __name__ == "__main__":
    main(sys.argv[1:])
