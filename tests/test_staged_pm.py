"""Host-staged PM value+grad == monolithic checkpointed-scan value+grad.

The staged path (utils/staged.py + bench.build_pm_staged, opt-in) splits the
integration into short device programs; it must be numerically the SAME
computation as the monolithic `jit(value_and_grad)` over `nbody_bf`'s
checkpointed scan (reference cost model: montecosmo/bricks.py nbody
evolution via diffrax checkpointed adjoints).
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench import build_pm, build_pm_staged  # noqa: E402


def test_staged_pm_matches_monolithic():
    mono, white = build_pm(mesh=16, n_steps=4, box=200.0)
    staged, white2 = build_pm_staged(mesh=16, n_steps=4, box=200.0)
    np.testing.assert_array_equal(np.asarray(white), np.asarray(white2))

    v0, g0 = mono(white)
    v1, g1 = staged(white)
    np.testing.assert_allclose(float(v0), float(v1), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g0), np.asarray(g1),
                               rtol=2e-4, atol=1e-7)


def test_host_scan_value_and_grad_generic():
    """The utility itself against jax on an analytically-checkable chain."""
    import jax
    from jax import numpy as jnp

    from montecosmo_tpu.utils.staged import host_scan_value_and_grad

    def init_fn(a):
        return {"y": a * 2.0, "z": jnp.sum(a)}

    def body_fn(state, x):
        return {"y": state["y"] * jnp.cos(x) + state["z"],
                "z": state["z"] * 0.9 + jnp.sum(state["y"]) * 1e-3}

    def loss_fn(state):
        return jnp.sum(state["y"] ** 2) + state["z"] ** 2

    xs = [np.float32(v) for v in (0.1, 0.7, 1.3)]
    a = jnp.arange(6.0).reshape(2, 3) / 7.0

    def ref(a):
        s = init_fn(a)
        for x in xs:
            s = body_fn(s, x)
        return loss_fn(s)

    v_ref, g_ref = jax.value_and_grad(ref)(a)
    v, g = host_scan_value_and_grad(init_fn, body_fn, loss_fn)(a, xs)
    np.testing.assert_allclose(float(v), float(v_ref), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-5)
