"""Small numerics helpers shared across the framework.

Parity: reference `montecosmo/utils.py:21-60` (safe_div, nvmap, vlim, get_jit).
"""
from functools import wraps

import numpy as np
from jax import jit, vmap, numpy as jnp


def safe_sqrt(x):
    """sqrt with all-orders-clean derivatives at x <= 0 (double-where).

    A bare `x**0.5` on a mesh with EXACT zeros (e.g. a power mesh whose
    below-table/DC entries are masked to 0.0) has an infinite-slope vjp
    there; re-linearizing that vjp (forward-over-reverse HVPs, e.g. the
    NUTS Laplace mass seed) produces inf*0 = NaN even though value and
    first gradient are finite (all-NaN 3x3 scalar Hessians of the full
    model at the warm start without it)."""
    pos = x > 0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


def safe_div(x, y):
    """Division where division by zero yields zero, with safe gradients.

    Uses the double-where trick so reverse-mode AD never sees a 0/0
    (https://github.com/jax-ml/jax/issues/5039).
    Works on both numpy and jax inputs (numpy in, numpy out).
    """
    where = jnp.where if isinstance(x, jnp.ndarray) or isinstance(y, jnp.ndarray) else np.where
    denom = where(y == 0, 1, y)
    return where(y == 0, 0, x / denom)


def nvmap(fun, n):
    """Nest vmap n times."""
    for _ in range(n):
        fun = vmap(fun)
    return fun


def vlim(a, level=1.0, scale=1.0, axis=None):
    """Robust (inf, sup) limits of an array: discard quantiles bilaterally at
    `level` then scale the margin around the midpoint."""
    vmin = jnp.quantile(a, (1 - level) / 2, axis=axis)
    vmax = jnp.quantile(a, (1 + level) / 2, axis=axis)
    mid, half = (vmax + vmin) / 2, scale * (vmax - vmin) / 2
    return jnp.stack((mid - half, mid + half), axis=-1)


def get_jit(*jit_args, **jit_kwargs):
    """jit decorator factory that preserves the wrapped function's metadata."""
    def deco(fun):
        return wraps(fun)(jit(fun, *jit_args, **jit_kwargs))
    return deco
