"""Bayesian decision utilities: weighted quantiles and credible sets.

Functional parity with reference `montecosmo/bdec.py` (weighted 1st/2nd-order
quantiles :105-163, interval dispatch :194-210, equal-tail intervals :215-237,
multivariate sets :240-266, smallest interval :269-342), rebuilt around a
different core: every estimator is a pure 1-D routine over sorted
(value, cdf, weight) knots, lifted to batches by vmap with the sample axis
LAST. The 1st-order inverse CDF is a single `jnp.interp`;
the 2nd-order one uses the Muller ("citardauq") quadratic root, which is
smooth through zero-curvature segments with no special-casing.
"""
import numpy as np
from jax import numpy as jnp, vmap

from montecosmo_tpu.utils.safe import safe_div

__all__ = ["cumulative_trapezoid", "quantile", "argmedian", "credint",
           "qbci", "qbcs", "sci", "sci_noweights"]


def cumulative_trapezoid(y, x=None, dx=1.0, axis=-1, initial=None):
    """Cumulative composite-trapezoid integral of y(x) along `axis`.

    `x` may be 1-D (shared coordinate) or shaped like `y`; `initial` prepends
    a constant so the output keeps y's length along the axis.
    """
    yy = jnp.moveaxis(jnp.asarray(y), axis, -1)
    mids = 0.5 * (yy[..., 1:] + yy[..., :-1])
    if x is None:
        steps = dx
    else:
        x = jnp.asarray(x)
        steps = jnp.diff(x if x.ndim == 1 else jnp.moveaxis(x, axis, -1),
                         axis=-1)
    out = jnp.cumsum(steps * mids, axis=-1)
    if initial is not None:
        lead = jnp.full((*out.shape[:-1], 1), initial, out.dtype)
        out = jnp.concatenate([lead, out], axis=-1)
    return jnp.moveaxis(out, -1, axis)


# ------------------------------------------------------------------ CDF knots
def _sorted_knots(x, weights, axis):
    """Sort samples (and weights) along `axis`; flatten batch to rows.

    Returns (xs, ws, batch_shape) with xs/ws shaped (batch, n), sorted
    along the trailing sample axis. 1-D weights index the sample axis.
    """
    x = jnp.atleast_1d(jnp.asarray(x))
    axis = axis % x.ndim
    if weights is None:
        w = jnp.ones_like(x)
    else:
        w = jnp.asarray(weights)
        if w.ndim == 1 and x.ndim > 1:
            w = w.reshape((-1,) + (1,) * (x.ndim - 1 - axis))
        w = jnp.broadcast_to(w, x.shape)
    xs = jnp.moveaxis(x, axis, -1)
    ws = jnp.moveaxis(w, axis, -1)
    batch_shape, n = xs.shape[:-1], xs.shape[-1]
    xs, ws = xs.reshape(-1, n), ws.reshape(-1, n)
    order = jnp.argsort(xs, axis=-1)
    return (jnp.take_along_axis(xs, order, -1),
            jnp.take_along_axis(ws, order, -1), batch_shape)


def _cdf_knots(xs, ws, ord):
    """Normalized CDF at the sorted knots (trailing axis), plus weights
    renormalized by the same total (needed by the ord-2 density solve)."""
    if ord == 1:
        raw = jnp.cumsum(ws, axis=-1)
    elif ord == 2:
        raw = cumulative_trapezoid(ws, xs, axis=-1, initial=0.0)
    else:
        raise NotImplementedError("only CDF interpolation orders 1 and 2")
    total = raw[..., -1:]
    return safe_div(raw, total), safe_div(ws, total)


def _inv_cdf(p, xs, cdf, ws, ord):
    """Inverse CDF at probabilities `p` (any shape) for 1-D knots.

    ord=1: piecewise-linear CDF -> one jnp.interp (clamped at the ends,
    i.e. no extrapolation). ord=2: piecewise-quadratic CDF (the density is
    linear within a segment); within segment [x0, x1] the offset u solves
    slope/2 u^2 + w0 u = dp, taken in the Muller/citardauq form
    u = 2 dp / (w0 + sqrt(w0^2 + 2 slope dp)) which degrades gracefully for
    slope -> 0 (linear limit) and |slope| -> inf (zero-width segment).
    """
    if ord == 1:
        return jnp.interp(p, cdf, xs)
    n = xs.shape[0]
    seg = jnp.clip(jnp.searchsorted(cdf, p, side="left"), 1, n - 1)
    x0, x1 = xs[seg - 1], xs[seg]
    w0 = ws[seg - 1]
    dp = p - cdf[seg - 1]
    slope = safe_div(ws[seg] - w0, x1 - x0)
    disc = jnp.sqrt(jnp.maximum(w0 * w0 + 2.0 * slope * dp, 0.0))
    return jnp.clip(x0 + safe_div(2.0 * dp, w0 + disc), x0, x1)


def quantile(x, p, axis=0, weights=None, ord=1):
    """Weighted quantile by CDF interpolation.

    ord=1 : linear interpolation of the cumulative weight sum (sample
            quantiles); ord=2 : quadratic interpolation of the trapezoid
    density integral (density quantiles — better when the samples are grid
    points carrying pdf values). Returns shape (*p.shape, *batch).
    """
    p = jnp.asarray(p)
    xs, ws, batch_shape = _sorted_knots(x, weights, axis)
    cdf, wn = _cdf_knots(xs, ws, ord)
    rows = vmap(lambda xk, ck, wk: _inv_cdf(p.reshape(-1), xk, ck, wk, ord))
    q = jnp.moveaxis(rows(xs, cdf, wn), 0, -1)  # (P, batch)
    return q.reshape(*p.shape, *batch_shape)


def argmedian(a, axis=-1):
    """Indices of median values along `axis` (the upper index when even)."""
    k = a.shape[axis] // 2
    return np.argpartition(a, k, axis).take(k, axis)


# ----------------------------------------------------------------- intervals
def credint(x, p=0.95, axis=0, weights=None, type="small", ord=1):
    """p-credible interval: 'small' (smallest / HDI), else quantile-based
    'low' / 'med' (equal-tail) / 'high'."""
    if type != "small":
        return qbci(x, p, axis, weights, type, ord)
    if weights is None:
        return sci_noweights(x, p, axis)
    return sci(x, p, axis, weights, ord)


_TAIL_FRACTION = {"low": 0.0, "med": 0.5, "high": 1.0}


def qbci(x, p=0.95, axis=0, weights=None, type="med", ord=1):
    """Quantile-based credible interval. The interval [q(t(1-p)), q(t(1-p)+p)]
    with tail fraction t = 0 ('low'), 1/2 ('med', equal-tail), 1 ('high');
    both endpoints come from one stacked quantile call."""
    p = jnp.asarray(p)
    lo = _TAIL_FRACTION[type] * (1.0 - p)
    ends = quantile(x, jnp.stack([lo, lo + p]), axis, weights, ord)
    return jnp.moveaxis(ends, 0, -1)


def qbcs(x, p=0.95, weights=None, type="med", norm=jnp.inf):
    """Quantile-based credible SET: the `norm`-ball of probability p around
    per-dimension low/median/high centers.

    x : (*batch, n_samples, n_dim). Returns (center, radius).
    """
    x = jnp.atleast_2d(x)
    n_dim = x.shape[-1]
    which = np.array([_TAIL_FRACTION[t] * 2 for t in
                      np.broadcast_to(type, n_dim)], dtype=int)  # 0 / 1 / 2
    ends = quantile(x, jnp.asarray([0.0, 0.5, 1.0]), -2, weights)
    center = jnp.moveaxis(ends, 0, -1)[..., jnp.arange(n_dim), which]
    dists = jnp.linalg.norm(x - center[..., None, :], ord=norm, axis=-1)
    return center, quantile(dists, p, -1, weights)


def sci_noweights(x, p=0.95, axis=0):
    """Smallest credible interval (HDI) for unweighted samples.

    Host-side (the window length round(p n) is data-dependent): slide a
    fixed-count window over the order statistics, keep the narrowest.
    """
    xs = np.sort(np.moveaxis(np.asarray(x), axis, 0), axis=0)
    n = xs.shape[0]
    k = min(int(np.rint(p * n)), n - 1)
    spans = xs[k:] - xs[: n - k]
    left = spans.argmin(axis=0)
    lo = np.take_along_axis(xs, left[None], 0)[0]
    hi = np.take_along_axis(xs, (left + k)[None], 0)[0]
    return jnp.stack([jnp.asarray(lo), jnp.asarray(hi)], axis=-1)


def sci(x, p=0.95, axis=0, weights=None, ord=1):
    """Smallest credible interval (HDI) for weighted samples — jittable and
    vectorized over p.

    Every sorted sample is a candidate left edge; its right edge is the
    inverse CDF at (cdf_left + p); candidates whose left tail mass already
    exceeds 1-p get an infinite span before the argmin.
    """
    p = jnp.asarray(p)
    xs, ws, batch_shape = _sorted_knots(x, weights, axis)
    cdf, wn = _cdf_knots(xs, ws, ord)

    def per_row(xk, ck, wk):
        def per_p(pp):
            rights = _inv_cdf(ck + pp, xk, ck, wk, ord)
            spans = jnp.where(ck <= 1.0 - pp, rights - xk, jnp.inf)
            left = jnp.argmin(spans)
            return jnp.stack([xk[left], rights[left]])

        return vmap(per_p)(p.reshape(-1))

    out = vmap(per_row)(xs, cdf, wn)            # (batch, P, 2)
    out = jnp.moveaxis(out, 0, -2)              # (P, batch, 2)
    return out.reshape(*p.shape, *batch_shape, 2)


# ----------------------------------------------------------------- credible sets
def scs(x, p=0.95, weights=None, grid_size=64, bandwidth=None):
    """p-Smallest Credible Set / Highest Density Region in d dimensions.

    Gaussian-product KDE (Scott bandwidth by default) of weighted samples
    `x` (n, d), d <= 3.  The HDR level follows Hyndman (1996): the weighted
    (1-p)-quantile of the KDE evaluated AT the samples — the region
    {y : kde(y) >= level} then carries probability mass ~p.

    Returns (axes, density_mesh, level): per-dimension grid axes, the KDE
    on the tensor grid (for contour plotting), and the density level.

    The reference DECLARES this function but never implemented it
    (reference bdec.py:345-356 assigns `kde_mesh = 'foo'`); this is a
    working implementation, not a port.
    """
    x = jnp.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    n, d = x.shape
    assert d <= 3, "scs supports up to 3 dimensions"
    if weights is None:
        w = jnp.full(n, 1.0 / n)
    else:
        w = jnp.asarray(weights)
        w = w / jnp.sum(w)
    n_eff = 1.0 / jnp.sum(w**2)

    mean = jnp.sum(w[:, None] * x, 0)
    sig = jnp.sqrt(jnp.sum(w[:, None] * (x - mean) ** 2, 0))
    if bandwidth is None:
        bandwidth = sig * n_eff ** (-1.0 / (d + 4))      # Scott's rule
    bw = jnp.broadcast_to(jnp.asarray(bandwidth), (d,))

    axes = [jnp.linspace(x[:, k].min() - 3 * bw[k],
                         x[:, k].max() + 3 * bw[k], grid_size)
            for k in range(d)]

    def kern(grid_k, k):
        z = (grid_k[:, None] - x[None, :, k]) / bw[k]
        return jnp.exp(-0.5 * z**2) / (bw[k] * jnp.sqrt(2 * jnp.pi))

    Ks = [kern(axes[k], k) for k in range(d)]            # (g, n) each
    if d == 1:
        mesh = Ks[0] @ w
    elif d == 2:
        mesh = jnp.einsum("an,bn,n->ab", Ks[0], Ks[1], w)
    else:
        mesh = jnp.einsum("an,bn,cn,n->abc", Ks[0], Ks[1], Ks[2], w)

    # KDE at the samples (exact, O(n^2)) for the Hyndman level
    Zs = [kern(x[:, k], k) for k in range(d)]            # (n, n) each
    prod = Zs[0]
    for Z in Zs[1:]:
        prod = prod * Z
    f_samp = prod @ w
    level = quantile(f_samp, jnp.asarray(1.0 - p), weights=w)
    return axes, mesh, level
