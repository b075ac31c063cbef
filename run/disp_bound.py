"""Measure the actual particle displacement bound of the PM evolution.

The window-matmul paint sizes its per-group margin from a blanket
45 Mpc/h displacement bound (bench.py, model max_disp) — at 256^3 in a
1 Gpc/h box that is md = 12 cells, inflating every window pass by
~(1 + 2 md/gs)^3. This probe runs the north-star forward
evolution and prints the MEASURED |displacement| distribution, so the
margin can be set from physics + safety factor instead of the blanket.

Run (the bound is resolution-independent in Mpc/h, so the CPU will do):
  python run/disp_bound.py [mesh=128] [box=1000] [n_steps=10] [--platform cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

mesh = int(sys.argv[1]) if len(sys.argv) > 1 else 128
box = float(sys.argv[2]) if len(sys.argv) > 2 else 1000.0
n_steps = int(sys.argv[3]) if len(sys.argv) > 3 else 10

import jax  # noqa: E402

if "--platform" in sys.argv:
    jax.config.update("jax_platforms",
                      sys.argv[sys.argv.index("--platform") + 1])
from jax import numpy as jnp, random as jr  # noqa: E402

from montecosmo_tpu.models.bricks import regular_pos, white2lin  # noqa: E402
from montecosmo_tpu.ops.background import Background, Planck18  # noqa: E402
from montecosmo_tpu.ops.hermitian import rg2cgh  # noqa: E402
from montecosmo_tpu.ops.pm import nbody_bf  # noqa: E402

shape, box_size = 3 * (mesh,), 3 * (box,)
cell = box / mesh
max_disp = int(np.ceil(45.0 / cell))


@jax.jit
def run(white):
    bg = Background.create(Planck18())
    wh = rg2cgh(white) * np.prod(np.divide(shape, box_size)) ** 0.5
    lin = white2lin(Planck18(), wh, shape, box_size)
    pos = regular_pos(shape)
    pos_t, _ = nbody_bf(bg, lin, pos, a0=0.0, a1=1.0, n_steps=n_steps,
                        paint_order=2, lpt_order=2, lattice_shape=shape,
                        max_disp=max_disp, sites_shape=shape)
    disp = (pos_t[-1] - pos + mesh / 2) % mesh - mesh / 2  # periodic-aware
    per_axis = jnp.abs(disp)
    return (jnp.max(per_axis), jnp.mean(per_axis ** 2) ** 0.5,
            jnp.quantile(per_axis.ravel(),
                         jnp.asarray([0.99, 0.9999, 0.999999])))


mx, rms, qs = run(jr.normal(jr.key(0), shape))
print(f"mesh {mesh}^3, box {box} Mpc/h, cell {cell:.2f} Mpc/h, "
      f"{n_steps} BullFrog steps (blanket margin {max_disp} cells "
      f"= {max_disp * cell:.0f} Mpc/h)")
print(f"per-axis |disp|: rms {float(rms) * cell:6.2f} Mpc/h   "
      f"q99 {float(qs[0]) * cell:6.2f}   q99.99 {float(qs[1]) * cell:6.2f}   "
      f"q99.9999 {float(qs[2]) * cell:6.2f}   MAX {float(mx) * cell:6.2f}")
print(f"suggested margin (MAX * 1.25): "
      f"{float(mx) * cell * 1.25:.1f} Mpc/h = "
      f"{int(np.ceil(float(mx) * 1.25))} cells at this resolution")
