"""Per-device memory of the sharded PRODUCTION path.

Compiles `jit(value_and_grad(model.logpdf))` for the flagship config under
`parallel.context.mesh_context` on an n-device mesh (virtual CPU devices) and
prints `compiled.memory_analysis()` — the acceptance metric for spatial
decomposition is per-device temp/argument bytes shrinking ~1/n from 1 -> 8
devices, not wall time (uninformative on oversubscribed virtual devices).

Run (from the repository root): PYTHONPATH=. python run/memprobe.py [final=32] [ndev=8 ...]
"""
import os
import sys

final = int(sys.argv[1]) if len(sys.argv) > 1 else 32
ndevs = [int(a) for a in sys.argv[2:]] or [1, 8]

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + f" --xla_force_host_platform_device_count={max(ndevs)}")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
from montecosmo_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
from jax import random as jr  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from montecosmo_tpu import FieldLevelModel, default_config  # noqa: E402
from montecosmo_tpu.parallel.context import mesh_context  # noqa: E402

conf = dict(default_config)
conf.update(final_shape=3 * (final,), cell_length=1000.0 / final,
            evolution="lpt", lpt_order=2, a_obs=None, curved_sky=True,
            box_center=(0.0, 0.0, 1500.0), ap_auto=True,
            lik_type="quad_gauss", precond="kaiser")
model = FieldLevelModel(**conf)

params = model.reparam(dict(model.fiduc), inv=True)
params["white_mesh_"] = jr.normal(jr.key(0), model.init_shape)
if final <= 64:
    pred = model.predict(seed=1, samples=params, hide_base=False,
                         hide_det=False, hide_samp=False)
    obs = {"count_mesh": np.asarray(pred["count_mesh"])}
else:
    # synthetic flat observation: fine for the memory probe (compile) and
    # for MEMPROBE_EXEC finiteness checks, but note EXEC at final>64 then
    # measures value+grad on CONSTANT fake data, not a realistic field
    obs = {"count_mesh": np.full(model.final_shape, model.count_fid,
                                 np.float32)}
    if os.environ.get("MEMPROBE_EXEC"):
        print(f"WARNING: MEMPROBE_EXEC at final={final} runs against a "
              "synthetic flat count_mesh — finiteness only, not validation "
              "on realistic data", flush=True)


def probe(n):
    devs = np.asarray(jax.devices()[:n])
    mesh = Mesh(devs, ("mesh",))
    # production layout (--spatial-mesh campaigns): the mesh-sized latent is
    # X-slab-sharded over the spatial mesh; scalars replicated. Replicating
    # the latent instead (MEMPROBE_REPLICATED_ARG=1) adds its full-size
    # argument AND gradient to every device.
    replicated = bool(os.environ.get("MEMPROBE_REPLICATED_ARG"))

    def spec(k, v):
        if (not replicated and getattr(v, "ndim", 0) == 3
                and v.shape[0] % n == 0):
            return P("mesh", None, None)
        return P()

    with mesh_context(mesh):
        fn = jax.jit(jax.value_and_grad(lambda p: model.logpdf({**p, **obs})))
        shard = {k: jax.device_put(v, NamedSharding(mesh, spec(k, v)))
                 for k, v in params.items()}
        compiled = fn.lower(shard).compile()
    return compiled, shard, mesh


def top_shapes(txt, k=25):
    """Largest per-device tensor shapes in the post-SPMD optimized HLO:
    full-size shapes at n>1 are buffers GSPMD chose to replicate."""
    import re
    from collections import Counter

    sizes = Counter()
    for m in re.finditer(r"= (f32|c64|s32|pred|bf16)\[([\d,]+)\]", txt):
        dt, dims = m.groups()
        nelem = int(np.prod([int(d) for d in dims.split(",")])) if dims else 1
        bytes_ = nelem * {"f32": 4, "c64": 8, "s32": 4, "pred": 1, "bf16": 2}[dt]
        sizes[f"{dt}[{dims}]"] += bytes_
    for shape, tot in sizes.most_common(k):
        print(f"  {tot/2**20:9.1f} MiB total  {shape}")


for n in ndevs:
    compiled, shard, mesh = probe(n)
    ma = compiled.memory_analysis()
    print(f"n={n}: temp={ma.temp_size_in_bytes/2**20:8.1f} MiB  "
          f"args={ma.argument_size_in_bytes/2**20:6.1f}  "
          f"out={ma.output_size_in_bytes/2**20:6.1f}  "
          f"alias={ma.alias_size_in_bytes/2**20:6.1f}", flush=True)
    if os.environ.get("MEMPROBE_EXEC"):
        # EXECUTE the decomposed value+grad (not just compile) — wall
        # time irrelevant on oversubscribed virtual
        # devices; the deliverable is a finite logpdf + finite gradient
        # from the actually-partitioned program.
        import time
        with mesh_context(mesh):
            t0 = time.time()
            val, grad = compiled(shard)
            val = float(val)  # waits for the device
            t1 = time.time()
            gl = [np.asarray(g) for g in jax.tree.leaves(grad)]
            gfin = all(bool(np.isfinite(g).all()) for g in gl)
            gnorm = float(sum(float((g.astype(np.float64) ** 2).sum())
                              for g in gl)) ** 0.5
        print(f"  EXEC n={n}: logpdf={val:.6e} finite={np.isfinite(val)} "
              f"|grad|={gnorm:.6e} grad_finite={gfin} "
              f"wall={t1-t0:.1f}s", flush=True)
    hlo_path = os.environ.get("MEMPROBE_HLO")
    txt = (compiled.as_text()
           if os.environ.get("MEMPROBE_TOP") or hlo_path else None)
    if os.environ.get("MEMPROBE_TOP"):
        top_shapes(txt)
    if hlo_path:
        # full post-SPMD optimized HLO with op_name metadata — grep full-size
        # (unsharded) shapes here to attribute the replicated memory floor
        from pathlib import Path
        Path(hlo_path).parent.mkdir(parents=True, exist_ok=True)
        with open(f"{hlo_path}.n{n}.txt", "w") as f:
            f.write(txt)
        print(f"  HLO -> {hlo_path}.n{n}.txt", flush=True)
