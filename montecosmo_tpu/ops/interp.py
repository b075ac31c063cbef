"""Uniform-grid linear interpolation: index arithmetic instead of searchsorted.

`jnp.interp` binary-searches the node table per query — ~log2(n) dependent
random gathers per element (~9 for 256 nodes).  All the framework's tables are (or can be resampled to) UNIFORM
grids in x or log x, where the bracketing index is one multiply:

    i = floor((x - x0) / dx)

followed by a single 2-wide row gather for the (y_i, y_{i+1}) pair.

Parity: replaces jnp.interp call sites (reference uses jnp.interp /
interpax; montecosmo/bricks.py:108-157).
"""
import numpy as np
from jax import numpy as jnp


def uniform_interp(x, x0, dx, ytab, left=None, right=None, logx=False,
                   xtab=None):
    """Linear interpolation of `ytab` sampled at x0 + i*dx (i = 0..n-1).

    x     : query array (any shape); the BRACKET is found in log-space if
            logx=True (x0/dx are then in log units; x <= 0 maps to `left`).
    xtab  : optional CONCRETE node positions in linear units — the lerp then
            runs linearly in x between them (jnp.interp semantics on
            log-spaced nodes); without it the lerp is linear in the grid
            coordinate (i.e. in log x when logx=True).
    left  : value for x below the grid (None -> clamp to ytab[0]).
    right : value for x above the grid (None -> clamp to ytab[-1]).
    ytab may have trailing channel dims: (n, ...) -> output x.shape + (...,).
    """
    n = ytab.shape[0]
    x = jnp.asarray(x)
    xq = jnp.log(jnp.maximum(x, jnp.finfo(jnp.result_type(float)).tiny)) \
        if logx else x
    t = (xq - x0) / dx
    i = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, n - 2)

    # shape-preserving gathers: flattening the query mesh (reshape(-1))
    # merges its sharded dim into an unpartitionable reshape under a mesh
    # context — GSPMD then all-gathers the FULL rfft-sized mesh on every
    # device (measured: 45 MiB c64[224,224,113] all-gathers at 128^3/n=8
    # on virtual CPU devices)
    trail = ytab.ndim - 1
    pairs = jnp.stack([ytab[:-1], ytab[1:]], axis=1)     # (n-1, 2, ...)
    lohi = jnp.take(pairs, i, axis=0)                    # i.shape + (2, ...)
    lo = jnp.take(lohi, 0, axis=i.ndim)
    hi = jnp.take(lohi, 1, axis=i.ndim)
    if xtab is not None:
        # lerp linearly in x: gather (x_i, 1/(x_{i+1}-x_i)) (static rows)
        xt = np.asarray(xtab, np.float32)
        xpairs = jnp.asarray(np.stack([xt[:-1], 1.0 / np.diff(xt)], 1))
        xp = jnp.take(xpairs, i, axis=0)                 # i.shape + (2,)
        frac = ((x - jnp.take(xp, 0, axis=i.ndim))
                * jnp.take(xp, 1, axis=i.ndim)).astype(ytab.dtype)
    else:
        frac = (t - i).astype(ytab.dtype)
    frac = frac.reshape(frac.shape + (1,) * trail)
    y = lo + frac * (hi - lo)

    below = t < 0
    above = t > (n - 1)
    if logx:
        below = below | (x <= 0)
    ybelow = ytab[0] if left is None else left
    yabove = ytab[-1] if right is None else right
    bshape = below.shape + (1,) * (ytab.ndim - 1)
    y = jnp.where(below.reshape(bshape), ybelow, y)
    y = jnp.where(above.reshape(bshape), yabove, y)
    return y


def is_uniform(x, logx=False, rtol=1e-6):
    """True if the CONCRETE 1-D node array is uniformly spaced (in log x)."""
    x = np.asarray(x, float)
    if logx:
        if np.any(x <= 0):
            return False
        x = np.log(x)
    d = np.diff(x)
    return d.size > 0 and np.all(np.abs(d - d[0]) <= rtol * np.abs(d[0]))


def log_uniform_interp_fn(ks, ys, left=0.0, right=0.0, n_min=256):
    """Build a fast mesh interpolator for a table with CONCRETE nodes `ks`
    (values `ys` may be traced).  Log-uniform node grids are used directly;
    others are resampled once onto a log-uniform grid (a tiny in-graph
    jnp.interp over the table itself, NOT over mesh-sized queries)."""
    ks_np = np.asarray(ks, float)
    if is_uniform(ks_np, logx=True):
        logk0 = float(np.log(ks_np[0]))
        dlogk = float((np.log(ks_np[-1]) - logk0) / (ks_np.size - 1))
        tab, nodes = jnp.asarray(ys), ks_np
    else:
        t = np.log(ks_np)
        n = max(2 * ks_np.size, n_min)
        tu = np.linspace(t[0], t[-1], n)
        nodes = np.exp(tu)
        tab = jnp.interp(jnp.asarray(nodes), jnp.asarray(ks_np), ys)
        logk0, dlogk = float(tu[0]), float(tu[1] - tu[0])

    def fn(x):
        return uniform_interp(x, logk0, dlogk, tab, left=left, right=right,
                              logx=True, xtab=nodes)

    return fn


def resample_uniform(x, y, n=None, logx=False):
    """Resample a CONCRETE (x, y) table onto a uniform grid spanning the same
    range (in log x if logx).  Returns (x0, dx, ytab) ready for
    `uniform_interp`.  Trace-time (numpy) — use on static tables only."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    if n is None:
        n = max(2 * x.size, 64)
    t = np.log(x) if logx else x
    tu = np.linspace(t[0], t[-1], n)
    yu = np.interp(tu, t, y)
    return float(tu[0]), float(tu[1] - tu[0]), jnp.asarray(yu, jnp.float32)
