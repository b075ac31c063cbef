"""Probability distributions for the field-level model.

Standard families (Normal, Uniform, TruncatedNormal, Poisson) plus the
reference's custom field-level noise models and detruncated priors:

* DetruncTruncNorm / DetruncUnif — priors in unconstrained sample space whose
  push-forward through `std2trunc` is TruncatedNormal / Uniform
  (parity: utils.py:267-353),
* SinhArcsinh — moment-standardized SHASH (utils.py:392-464),
* QuadGaussian — obs = loc + s1 e + s2 (e^2-1), exact 2-preimage density
  (utils.py:474-538),
* TwoQuadGaussian — independent-noise variant, Gauss-Hermite density
  (utils.py:541-635),
* SkewNormal — centered-parametrization Azzalini with Owen's-T cdf
  (utils.py:645-748),
* CubGaussian — cubic-Hermite noise with Cardano-root density (the reference
  keeps it in tests/plot_gxy_stoch.py:19-140; here it is first-class).

All distributions are plain objects constructed inside traced code: methods
are pure jnp, shapes broadcast, log_cdf is provided wherever the likelihood
layer needs per-voxel cumulative densities.
"""
from functools import partial

import numpy as np
from jax import grad, lax, numpy as jnp, random as jr
from jax.scipy.special import gammaln, logsumexp, xlogy
from jax.scipy.stats import norm
from numpy.polynomial.hermite_e import hermegauss
from numpy.polynomial.legendre import leggauss

from montecosmo_tpu.models.truncnorm import std2trunc, trunc2std
from montecosmo_tpu.utils.safe import nvmap


def _norm_logcdf_interval(lo, hi):
    """log(Phi(hi) - Phi(lo)) for hi >= lo, fully in log space.

    Reflect the interval onto the half-line where `logcdf` uses its accurate
    asymptotic branch (endpoints <= 0), then log-subtract with expm1:
    log(Phi(b) - Phi(a)) = logcdf(b) + log(-expm1(logcdf(a) - logcdf(b))).
    """
    flip = lo + hi > 0
    a = jnp.where(flip, -hi, lo)
    b = jnp.where(flip, -lo, hi)
    la, lb = norm.logcdf(a), norm.logcdf(b)
    return lb + jnp.log(-jnp.expm1(jnp.minimum(la - lb, -1e-38)))


class Distribution:
    """Minimal distribution interface: sample / log_prob (+ cdf/log_cdf)."""

    def sample(self, key, sample_shape=()):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    @property
    def batch_shape(self):
        return ()


# ======================================================================= standard
class Normal(Distribution):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = loc, scale

    @property
    def batch_shape(self):
        return jnp.broadcast_shapes(jnp.shape(self.loc), jnp.shape(self.scale))

    def sample(self, key, sample_shape=()):
        eps = jr.normal(key, sample_shape + self.batch_shape)
        return self.loc + self.scale * eps

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -0.5 * z**2 - jnp.log(self.scale) - 0.5 * jnp.log(2 * jnp.pi)

    def cdf(self, value):
        return norm.cdf((value - self.loc) / self.scale)

    def log_cdf(self, value):
        return norm.logcdf((value - self.loc) / self.scale)

    @property
    def mean(self):
        return jnp.broadcast_to(self.loc, self.batch_shape)

    @property
    def variance(self):
        return jnp.broadcast_to(jnp.square(self.scale), self.batch_shape)


class Uniform(Distribution):
    def __init__(self, low=0.0, high=1.0):
        self.low, self.high = low, high

    @property
    def batch_shape(self):
        return jnp.broadcast_shapes(jnp.shape(self.low), jnp.shape(self.high))

    def sample(self, key, sample_shape=()):
        u = jr.uniform(key, sample_shape + self.batch_shape)
        return self.low + (self.high - self.low) * u

    def log_prob(self, value):
        inside = (self.low <= value) & (value <= self.high)
        return jnp.where(inside, -jnp.log(self.high - self.low), -jnp.inf)

    def cdf(self, value):
        return jnp.clip((value - self.low) / (self.high - self.low), 0.0, 1.0)

    def log_cdf(self, value):
        return jnp.log(self.cdf(value))


class TruncatedNormal(Distribution):
    def __init__(self, loc=0.0, scale=1.0, low=-jnp.inf, high=jnp.inf):
        self.loc, self.scale, self.low, self.high = loc, scale, low, high

    @property
    def batch_shape(self):
        return jnp.broadcast_shapes(*(jnp.shape(x) for x in
                                      (self.loc, self.scale, self.low, self.high)))

    def sample(self, key, sample_shape=()):
        eps = jr.normal(key, sample_shape + self.batch_shape)
        args = jnp.broadcast_arrays(eps, jnp.asarray(self.loc, float),
                                    jnp.asarray(self.scale, float),
                                    jnp.asarray(self.low, float),
                                    jnp.asarray(self.high, float))
        return nvmap(std2trunc, args[0].ndim)(*args)

    def log_prob(self, value):
        a = (self.low - self.loc) / self.scale
        b = (self.high - self.loc) / self.scale
        z = (value - self.loc) / self.scale
        log_norm = _norm_logcdf_interval(jnp.asarray(a, float), jnp.asarray(b, float))
        lp = norm.logpdf(z) - jnp.log(self.scale) - log_norm
        inside = (self.low <= value) & (value <= self.high)
        return jnp.where(inside, lp, -jnp.inf)


class Poisson(Distribution):
    def __init__(self, rate):
        self.rate = rate

    @property
    def batch_shape(self):
        return jnp.shape(self.rate)

    def sample(self, key, sample_shape=()):
        return jr.poisson(key, self.rate, sample_shape + self.batch_shape).astype(float)

    def log_prob(self, value):
        return xlogy(value, self.rate) - self.rate - gammaln(value + 1)

    def log_cdf(self, value):
        # regularized upper incomplete gamma Q(floor(v)+1, rate)
        from jax.scipy.special import gammaincc
        return jnp.log(jnp.clip(gammaincc(jnp.floor(value) + 1, self.rate),
                                1e-300, 1.0))

    def cdf(self, value):
        return jnp.exp(self.log_cdf(value))

    @property
    def mean(self):
        return self.rate

    @property
    def variance(self):
        return self.rate


# ======================================================================= detruncated priors
class DetruncTruncNorm(Distribution):
    """Prior in sample space whose push-forward through
    `std2trunc(., loc_fid, scale_fid, low, high)` is
    TruncatedNormal(loc, scale, low, high)."""

    def __init__(self, loc=0.0, scale=1.0, low=-jnp.inf, high=jnp.inf,
                 loc_fid=None, scale_fid=None):
        self.loc, self.scale, self.low, self.high = loc, scale, low, high
        self.loc_fid = loc if loc_fid is None else loc_fid
        self.scale_fid = scale if scale_fid is None else scale_fid

    @property
    def batch_shape(self):
        return jnp.broadcast_shapes(*(jnp.shape(x) for x in
                                      (self.loc, self.scale, self.low, self.high,
                                       self.loc_fid, self.scale_fid)))

    def sample(self, key, sample_shape=()):
        base = TruncatedNormal(self.loc, self.scale, self.low, self.high)
        y = base.sample(key, sample_shape)
        args = jnp.broadcast_arrays(y, jnp.asarray(self.loc_fid, float),
                                    jnp.asarray(self.scale_fid, float),
                                    jnp.asarray(self.low, float),
                                    jnp.asarray(self.high, float))
        return nvmap(trunc2std, args[0].ndim)(*args)

    def _log_prob_scalar(self, value, loc, scale, low, high, loc_fid, scale_fid):
        push = partial(std2trunc, loc=loc_fid, scale=scale_fid, low=low, high=high)
        # floor: far beyond the bounds the soft-tail slope underflows to 0 in
        # f32; log(0) would poison sampler gradients with NaNs
        ladj = jnp.log(jnp.abs(grad(push)(value)) + 1e-30)
        return TruncatedNormal(loc, scale, low, high).log_prob(push(value)) + ladj

    def log_prob(self, value):
        args = jnp.broadcast_arrays(value, *(jnp.asarray(x, float) for x in
                                             (self.loc, self.scale, self.low, self.high,
                                              self.loc_fid, self.scale_fid)))
        return nvmap(self._log_prob_scalar, args[0].ndim)(*args)


class DetruncUnif(Distribution):
    """Prior in sample space whose push-forward through
    `std2trunc(., loc_fid, scale_fid, low, high)` is Uniform(low, high)."""

    def __init__(self, low=0.0, high=1.0, loc_fid=None, scale_fid=None):
        self.low, self.high = low, high
        self.loc_fid = (high + low) / 2 if loc_fid is None else loc_fid
        self.scale_fid = (high - low) / 12**0.5 if scale_fid is None else scale_fid

    @property
    def batch_shape(self):
        return jnp.broadcast_shapes(*(jnp.shape(x) for x in
                                      (self.low, self.high, self.loc_fid,
                                       self.scale_fid)))

    def sample(self, key, sample_shape=()):
        y = Uniform(self.low, self.high).sample(key, sample_shape)
        args = jnp.broadcast_arrays(y, jnp.asarray(self.loc_fid, float),
                                    jnp.asarray(self.scale_fid, float),
                                    jnp.asarray(self.low, float),
                                    jnp.asarray(self.high, float))
        return nvmap(trunc2std, args[0].ndim)(*args)

    def _log_prob_scalar(self, value, low, high, loc_fid, scale_fid):
        push = partial(std2trunc, loc=loc_fid, scale=scale_fid, low=low, high=high)
        ladj = jnp.log(jnp.abs(grad(push)(value)) + 1e-30)
        # push saturates AT the bounds: evaluate the uniform just inside so the
        # density (hence logpdf) stays finite when the tail clamps to the edge
        y = jnp.clip(push(value), low + 1e-30, high - 1e-30)
        return Uniform(low, high).log_prob(y) + ladj

    def log_prob(self, value):
        args = jnp.broadcast_arrays(value, *(jnp.asarray(x, float) for x in
                                             (self.low, self.high, self.loc_fid,
                                              self.scale_fid)))
        return nvmap(self._log_prob_scalar, args[0].ndim)(*args)


# ======================================================================= SHASH
def _std_normal_quadrature(deg):
    """(nodes, weights) with E_{N(0,1)}[f] ~ sum_i w_i f(z_i) (probabilists')."""
    z, w = hermegauss(deg)
    return jnp.asarray(z), jnp.asarray(w) / np.sqrt(2 * np.pi)


class SinhArcsinh(Distribution):
    """Sinh-arcsinh of a normal, standardized so loc/scale ARE the mean/std.

    The distribution of x = loc + scale * (g(eps) - E g) / Std g with
    g(eps) = sinh(tailweight * (arcsinh(eps) + skewness)) and eps ~ N(0,1).
    Standardizing by the raw moments makes shape (skew/tailweight) orthogonal
    to location/scale, killing the loc<->skew sampling ridge of the raw SHASH.
    E g / Var g are evaluated by a fixed Gauss-Hermite rule (no closed form
    without fractional-order Bessel K). Parity: utils.py:392-464 behavior.
    """

    QUAD_DEG = 20

    def __init__(self, mean=0.0, std=1.0, skewness=0.0, tailweight=1.0):
        self.loc, self.scale = mean, std
        self.skewness, self.tailweight = skewness, tailweight

    @property
    def batch_shape(self):
        return jnp.broadcast_shapes(*(jnp.shape(x) for x in
                                      (self.loc, self.scale, self.skewness,
                                       self.tailweight)))

    def _g(self, eps):
        """The raw transform g applied elementwise (broadcasts with batch)."""
        return jnp.sinh(self.tailweight * (jnp.arcsinh(eps) + self.skewness))

    def _g_mean_std(self):
        """First two moments of g(eps), quadrature axis trailing."""
        z, w = _std_normal_quadrature(self.QUAD_DEG)
        t = jnp.asarray(self.tailweight)[..., None]
        s = jnp.asarray(self.skewness)[..., None]
        gz = jnp.sinh(t * (jnp.arcsinh(z) + s))
        mean_g = jnp.sum(w * gz, axis=-1)
        var_g = jnp.sum(w * jnp.square(gz), axis=-1) - jnp.square(mean_g)
        return mean_g, jnp.sqrt(var_g)

    def sample(self, key, sample_shape=()):
        mg, sg = self._g_mean_std()
        eps = jr.normal(key, sample_shape + self.batch_shape)
        return self.loc + self.scale * (self._g(eps) - mg) / sg

    def _pullback(self, value):
        """Invert value -> eps; also return the raw variate and Std g."""
        mg, sg = self._g_mean_std()
        raw = mg + sg * (value - self.loc) / self.scale
        eps = jnp.sinh(jnp.arcsinh(raw) / self.tailweight - self.skewness)
        return eps, raw, sg

    def log_prob(self, value):
        eps, raw, sg = self._pullback(value)
        # forward derivative at the preimage:
        #   dvalue/deps = (scale/sg) * g'(eps),
        #   g'(eps) = tailweight * cosh(.) / sqrt(1+eps^2),  cosh(.) = sqrt(1+g^2)
        log_fwd = (jnp.log(self.scale) - jnp.log(sg) + jnp.log(self.tailweight)
                   + 0.5 * (jnp.log1p(jnp.square(raw)) - jnp.log1p(jnp.square(eps))))
        return norm.logpdf(eps) - log_fwd

    def cdf(self, value):
        return norm.cdf(self._pullback(value)[0])

    def log_cdf(self, value):
        return norm.logcdf(self._pullback(value)[0])

    @property
    def mean(self):
        return jnp.broadcast_to(self.loc, self.batch_shape)

    @property
    def variance(self):
        return jnp.broadcast_to(jnp.square(self.scale), self.batch_shape)


# ======================================================================= quad gaussian
class QuadGaussian(Distribution):
    """Quadratic-in-Gaussian noise, mean-subtracted:
        obs = loc + scale1 eps + scale2 (eps^2 - 1),  eps ~ N(0,1),
    so E = loc, Var = scale1^2 + 2 scale2^2 (parity: utils.py:474-538).

    Derivation here completes the square: with h = scale1/(2 scale2),
        obs - loc = scale2 [(eps + h)^2 - (1 + h^2)],
    i.e. a shifted/scaled noncentral chi^2_1. Writing
        u := (obs - loc)/scale2 + 1 + h^2 = (eps + h)^2,
    the preimages are eps = -h +- sqrt(u) and the exact density is
        p(obs) = [phi(sqrt(u)-h) + phi(-sqrt(u)-h)] / (2 |scale2| sqrt(u)),
    supported on u > 0 (one-sided bound at loc - scale2 (1 + h^2)).
    Degenerates smoothly to Normal(loc, scale1) as scale2 -> 0 (explicit
    switch below the `LINEAR_TOL` threshold to keep f32 gradients clean).
    """

    LINEAR_TOL = 1e-8

    def __init__(self, loc=0.0, scale1=1.0, scale2=0.0):
        self.loc, self.scale1, self.scale2 = loc, scale1, scale2

    @property
    def batch_shape(self):
        return jnp.broadcast_shapes(*(jnp.shape(x) for x in
                                      (self.loc, self.scale1, self.scale2)))

    def sample(self, key, sample_shape=()):
        eps = jr.normal(key, sample_shape + self.batch_shape)
        return self.loc + self.scale1 * eps + self.scale2 * (eps**2 - 1.0)

    def _completed_square(self, value):
        """(curv, h, u, root): obs - loc = curv [(eps+h)^2 - (1+h^2)], u=(eps+h)^2.

        curv is guarded away from 0 (callers switch to the linear branch there),
        and root = sqrt(u) is guarded on u <= 0 (outside the support).
        """
        curv = jnp.where(jnp.abs(self.scale2) < 1e-12, 1.0, self.scale2)
        h = self.scale1 / (2.0 * curv)
        u = (value - self.loc) / curv + 1.0 + jnp.square(h)
        root = jnp.sqrt(jnp.where(u > 0, u, 1.0))
        return curv, h, u, root

    def _linear_branch(self):
        return jnp.abs(self.scale2) < self.LINEAR_TOL

    def log_prob(self, value):
        curv, h, u, root = self._completed_square(value)
        two_phi = jnp.logaddexp(norm.logpdf(root - h), norm.logpdf(root + h))
        lp = two_phi - jnp.log(2.0 * jnp.abs(curv) * root)
        lp = jnp.where(u > 0, lp, -jnp.inf)
        z = (value - self.loc) / self.scale1
        lp_lin = norm.logpdf(z) - jnp.log(self.scale1)
        return jnp.where(self._linear_branch(), lp_lin, lp)

    def log_cdf(self, value):
        curv, h, u, root = self._completed_square(value)
        lo, hi = -h - root, -h + root
        # curv > 0: {obs <= value} = {eps in [lo, hi]}, empty when u <= 0
        opens_up = jnp.where(u > 0, _norm_logcdf_interval(lo, hi), -jnp.inf)
        # curv < 0: complement {eps <= lo} U {eps >= hi}, everything when u <= 0
        opens_down = jnp.where(
            u > 0, jnp.logaddexp(norm.logcdf(lo), norm.logcdf(-hi)), 0.0)
        lc = jnp.where(curv > 0, opens_up, opens_down)
        lc_lin = norm.logcdf((value - self.loc) / self.scale1)
        return jnp.where(self._linear_branch(), lc_lin, lc)

    def cdf(self, value):
        return jnp.exp(self.log_cdf(value))

    @property
    def mean(self):
        return jnp.broadcast_to(self.loc, self.batch_shape)

    @property
    def variance(self):
        return jnp.broadcast_to(self.scale1**2 + 2 * self.scale2**2, self.batch_shape)

    @property
    def third_central_moment(self):
        # E[(s1 e + s2(e^2-1))^3] with E e^4 = 3, E e^6 = 15:
        # 3 s1^2 s2 E[e^2(e^2-1)] term -> 6 s1^2 s2; s2^3 E[(e^2-1)^3] -> 8 s2^3
        return jnp.broadcast_to(
            6.0 * self.scale1**2 * self.scale2 + 8.0 * self.scale2**3,
            self.batch_shape)


class TwoQuadGaussian(Distribution):
    """Two-field quadratic-in-Gaussian noise (parity: utils.py:541-635):
        obs = loc + scale1 eps1 + scale2 (eps2^2 - 1),  eps1 _|_ eps2.
    Same first two moments as QuadGaussian but third moment 8 scale2^3 (the
    6 scale1^2 scale2 cross term needs shared noise).

    Structured as a finite normal MIXTURE: conditioning on eps2 = z gives
    obs | z ~ N(loc + scale2 (z^2 - 1), scale1); marginalizing with a fixed
    Gauss-Hermite rule yields sum_i w_i N(mu_i, scale1) — log_prob/log_cdf are
    then one logsumexp over the trailing component axis.
    """

    def __init__(self, loc=0.0, scale1=1.0, scale2=0.0, n_quad=64):
        self.loc, self.scale1, self.scale2 = loc, scale1, scale2
        self.n_quad = n_quad

    @property
    def batch_shape(self):
        return jnp.broadcast_shapes(*(jnp.shape(x) for x in
                                      (self.loc, self.scale1, self.scale2)))

    def sample(self, key, sample_shape=()):
        k1, k2 = jr.split(key)
        shp = sample_shape + self.batch_shape
        return (self.loc + self.scale1 * jr.normal(k1, shp)
                + self.scale2 * (jr.normal(k2, shp) ** 2 - 1.0))

    def _mixture(self):
        """(component means, log weights), component axis trailing."""
        z, w = _std_normal_quadrature(self.n_quad)
        means = jnp.asarray(self.loc)[..., None] \
            + jnp.asarray(self.scale2)[..., None] * (jnp.square(z) - 1.0)
        return means, jnp.log(w)

    def log_prob(self, value):
        means, logw = self._mixture()
        scale = jnp.asarray(self.scale1)[..., None]
        comp = logw + norm.logpdf(value[..., None], loc=means, scale=scale)
        return logsumexp(comp, axis=-1)

    def log_cdf(self, value):
        means, logw = self._mixture()
        scale = jnp.asarray(self.scale1)[..., None]
        comp = logw + norm.logcdf((value[..., None] - means) / scale)
        return logsumexp(comp, axis=-1)

    def cdf(self, value):
        return jnp.exp(self.log_cdf(value))

    @property
    def mean(self):
        return jnp.broadcast_to(self.loc, self.batch_shape)

    @property
    def variance(self):
        return jnp.broadcast_to(self.scale1**2 + 2 * self.scale2**2, self.batch_shape)


# ======================================================================= skew normal
# E|N(0,1)| — the standardized-mean unit of the skew-normal half-normal part
_HALF_NORMAL_MEAN = np.sqrt(2.0 / np.pi)
# |skewness| as delta -> 1 (the attainable supremum)
_SKEW_SUP = 0.5 * (4.0 - np.pi) * (2.0 / (np.pi - 2.0)) ** 1.5
_DELTA_CAP = 1.0 - 1e-7


def _owens_t_reduced(h, a, nodes, weights):
    """Owen's T for 0 <= a <= 1 via the rational-integrand definition
    T(h, a) = (1/2pi) int_0^a exp(-h^2 (1+x^2)/2) / (1+x^2) dx,
    with Gauss-Legendre nodes mapped onto [0, a]. The a <= 1 restriction keeps
    the integration interval short so a fixed rule is uniformly accurate."""
    x = a[..., None] * nodes
    integrand = jnp.exp(-0.5 * h[..., None] ** 2 * (1.0 + x * x)) / (1.0 + x * x)
    return a * jnp.sum(weights * integrand, axis=-1) / (2.0 * np.pi)


def _owens_t(h, a, nodes, weights):
    """Owen's T(h, a) for any real a: odd in a, and |a| > 1 is folded to
    1/|a| <= 1 through the complement identity
    T(h, a) = [Phi(h) + Phi(ah)]/2 - Phi(h) Phi(ah) - T(ah, 1/a),  a > 0."""
    aa = jnp.abs(a)
    fold = aa > 1.0
    inv = 1.0 / jnp.maximum(aa, 1.0)
    base = _owens_t_reduced(jnp.where(fold, aa * h, h),
                            jnp.where(fold, inv, aa), nodes, weights)
    ph, pah = norm.cdf(h), norm.cdf(aa * h)
    folded = 0.5 * (ph + pah) - ph * pah - base
    return jnp.sign(a) * jnp.where(fold, folded, base)


class SkewNormal(Distribution):
    """Azzalini skew-normal, parametrized by its own moments (mean, std, skew)
    so location/scale decouple from shape (no MCMC ridge). Behavior parity:
    utils.py:645-748.

    Internally the skewness is inverted to the shape parameter delta: with
    m = E|N(0,1)| * delta (the standardized mean), the skewness is
    gamma = (4-pi)/2 * m^3 / (1-m^2)^(3/2), inverted via the cube root
    r = cbrt(2 gamma / (4-pi)) = m / sqrt(1-m^2)  =>  m = r / sqrt(1+r^2).
    |skew| clips just inside the attainable supremum ~0.9953. log_prob costs
    ~2 special-function evals per cell; cdf needs Owen's T (fixed quadrature,
    domain-reduced — never used in log_prob)."""

    def __init__(self, mean=0.0, std=1.0, skew=0.0,
                 max_skew=_SKEW_SUP * (1.0 - 1e-6), n_owen=48):
        self.mean_, self.std, self.skew = mean, std, skew
        self.max_skew = float(min(max_skew, _SKEW_SUP * (1.0 - 1e-6)))
        x, w = leggauss(n_owen)  # nodes on [0, 1]
        self._nodes = jnp.asarray((x + 1.0) / 2.0)
        self._weights = jnp.asarray(w / 2.0)

    @property
    def batch_shape(self):
        return jnp.broadcast_shapes(*(jnp.shape(x) for x in
                                      (self.mean_, self.std, self.skew)))

    @property
    def _delta(self):
        g = jnp.clip(self.skew, -self.max_skew, self.max_skew)
        r = jnp.cbrt(2.0 * g / (4.0 - np.pi))     # = m / sqrt(1 - m^2), odd in g
        m = r * lax.rsqrt(1.0 + r * r)             # standardized mean
        return jnp.clip(m / _HALF_NORMAL_MEAN, -_DELTA_CAP, _DELTA_CAP)

    def _direct(self):
        """Direct Azzalini parameters (xi, omega, alpha) from the moments."""
        d = self._delta
        m = _HALF_NORMAL_MEAN * d
        omega = self.std * lax.rsqrt(1.0 - m * m)
        return self.mean_ - omega * m, omega, d * lax.rsqrt(1.0 - d * d)

    def log_prob(self, value):
        xi, omega, alpha = self._direct()
        z = (value - xi) / omega
        return (np.log(2.0) - jnp.log(omega)
                + norm.logpdf(z) + norm.logcdf(alpha * z))

    def sample(self, key, sample_shape=()):
        shp = sample_shape + self.batch_shape
        u0, u1 = jr.normal(key, (2,) + shp)
        xi, omega, _ = self._direct()
        d = self._delta
        return xi + omega * (d * jnp.abs(u0) + jnp.sqrt(1.0 - d * d) * u1)

    def cdf(self, value):
        xi, omega, alpha = self._direct()
        z = (value - xi) / omega
        alpha = jnp.broadcast_to(alpha, jnp.shape(z))
        t = _owens_t(z, alpha, self._nodes, self._weights)
        return jnp.clip(norm.cdf(z) - 2.0 * t, 0.0, 1.0)

    def log_cdf(self, value):
        return jnp.log(jnp.clip(self.cdf(value), 1e-300, 1.0))

    @property
    def mean(self):
        return jnp.broadcast_to(self.mean_, self.batch_shape)

    @property
    def variance(self):
        return jnp.broadcast_to(self.std**2, self.batch_shape)

    @property
    def skewness(self):
        return jnp.broadcast_to(jnp.clip(self.skew, -self.max_skew, self.max_skew),
                                self.batch_shape)


def match_quadratic_gaussian(loc, scale1, scale2):
    """(mean, std, skew) of the SkewNormal matching the first three central
    moments of QuadGaussian(loc, scale1, scale2) — the moment-matched
    surrogate used by the 'shash'/'skew' likelihoods."""
    qd = QuadGaussian(loc, scale1, scale2)
    std = jnp.sqrt(qd.variance)
    return qd.mean, std, qd.third_central_moment / std**3


# ======================================================================= cubic gaussian
class CubGaussian(Distribution):
    """Cubic-Hermite-in-Gaussian noise:
        obs = loc + s1 eps + s2 (eps^2 - 1) + s3 (eps^3 - 3 eps),
    with density from the real roots of the cubic (Cardano / trigonometric
    forms), summed over preimages.  Reduces to QuadGaussian as s3 -> 0."""

    def __init__(self, loc=0.0, scale1=1.0, scale2=0.0, scale3=0.0):
        self.loc, self.scale1, self.scale2, self.scale3 = loc, scale1, scale2, scale3

    @property
    def batch_shape(self):
        return jnp.broadcast_shapes(*(jnp.shape(x) for x in
                                      (self.loc, self.scale1, self.scale2, self.scale3)))

    def sample(self, key, sample_shape=()):
        eps = jr.normal(key, sample_shape + self.batch_shape)
        return (self.loc + self.scale1 * eps + self.scale2 * (eps**2 - 1)
                + self.scale3 * (eps**3 - 3 * eps))

    def log_prob(self, value):
        """Sum of N(0,1) densities over real roots eps of
        s3 e^3 + s2 e^2 + (s1 - 3 s3) e - (v - loc + s2) = 0, each weighted by
        1/|f'(eps)|.  Roots via the trigonometric method on the depressed
        cubic (differentiable away from the discriminant zero set)."""
        s1, s2, s3 = self.scale1, self.scale2, self.scale3
        tiny = jnp.abs(s3) < 1e-12
        s3_safe = jnp.where(tiny, 1.0, s3)

        # depressed cubic t^3 + p t + q with e = t - s2/(3 s3)
        a2 = s2 / s3_safe
        a1 = (s1 - 3 * s3) / s3_safe
        a0 = -(value - self.loc + s2) / s3_safe
        p = a1 - a2**2 / 3
        q = 2 * a2**3 / 27 - a2 * a1 / 3 + a0
        disc = -(4 * p**3 + 27 * q**2)

        def density_at(eps):
            fp = jnp.abs(s1 - 3 * s3 + 2 * s2 * eps + 3 * s3 * eps**2)
            return norm.pdf(eps) / jnp.maximum(fp, 1e-12)

        # three real roots (disc > 0): trigonometric form
        p_neg = jnp.minimum(p, -1e-12)
        m = 2 * jnp.sqrt(-p_neg / 3)
        arg = jnp.clip(3 * q / (p_neg * m), -1.0, 1.0)
        theta = jnp.arccos(arg) / 3
        dens3 = 0.0
        for k in range(3):
            t = m * jnp.cos(theta - 2 * np.pi * k / 3)
            dens3 = dens3 + density_at(t - a2 / 3)

        # one real root (disc < 0): Cardano with cube roots
        sq = jnp.sqrt(jnp.maximum(q**2 / 4 + p**3 / 27, 1e-300))
        u = jnp.cbrt(-q / 2 + sq)
        v = jnp.cbrt(-q / 2 - sq)
        dens1 = density_at(u + v - a2 / 3)

        dens = jnp.where(disc > 0, dens3, dens1)
        lp_cub = jnp.log(jnp.maximum(dens, 1e-300))
        lp_quad = QuadGaussian(self.loc, s1, s2).log_prob(value)
        return jnp.where(tiny, lp_quad, lp_cub)

    @property
    def mean(self):
        return jnp.broadcast_to(self.loc, self.batch_shape)

    @property
    def variance(self):
        return jnp.broadcast_to(
            self.scale1**2 + 2 * self.scale2**2 + 6 * self.scale3**2
            + 6 * self.scale1 * self.scale3, self.batch_shape)


# ======================================================================= block MVN
class BlockMultivariateNormal(Distribution):
    """Gaussian over D jointly-correlated components per independent block.

    Parametrized by `loc` of shape (..., D, B) and per-block lower Cholesky
    factors `scale_tril` of shape (B, D, D): block b couples the D components
    loc[..., :, b].  The layout matches stacked multipole spectra — D poles
    (leading) by B wavenumber bins — where the per-k-bin multipole covariance
    is dense in ell but diagonal across k (Grieb et al. 2016 Gaussian
    covariance).  `log_prob` returns per-element terms (like `Normal`) whose
    sum over the trailing (D, B) axes is the joint block-MVN log-density:
    with z = L^-1 (x - loc), element (i, b) contributes
    -z_ib^2/2 - log L_b[i, i] - log(2 pi)/2.

    Used by `FieldLevelModel.likelihood` for observable='powspec' (the
    reference leaves this observable as a TODO, model.py:60).
    """

    def __init__(self, loc, scale_tril):
        self.loc = loc
        self.scale_tril = scale_tril

    @property
    def batch_shape(self):
        D, B = self.scale_tril.shape[-2], self.scale_tril.shape[-3]
        return jnp.broadcast_shapes(jnp.shape(self.loc), (D, B))

    def _solve(self, dev):
        """L^-1 dev per block: dev (..., D, B) -> z (..., D, B)."""
        from jax.scipy.linalg import solve_triangular
        dev_b = jnp.moveaxis(dev, -1, -2)[..., None]       # (..., B, D, 1)
        z = solve_triangular(self.scale_tril, dev_b, lower=True)
        return jnp.moveaxis(z[..., 0], -1, -2)             # (..., D, B)

    def sample(self, key, sample_shape=()):
        eps = jr.normal(key, sample_shape + self.batch_shape)  # (..., D, B)
        corr = jnp.einsum("bij,...jb->...ib", self.scale_tril, eps,
                          precision=lax.Precision.HIGHEST)
        return self.loc + corr

    def log_prob(self, value):
        z = self._solve(value - self.loc)
        logdiag = jnp.log(jnp.diagonal(self.scale_tril, axis1=-2, axis2=-1))
        return -0.5 * z**2 - logdiag.T - 0.5 * jnp.log(2 * jnp.pi)

    def log_cdf(self, value):
        """Componentwise cdf of the whitened residuals (diagnostic use)."""
        return norm.logcdf(self._solve(value - self.loc))

    @property
    def mean(self):
        return jnp.broadcast_to(self.loc, self.batch_shape)

    @property
    def variance(self):
        var = jnp.sum(self.scale_tril**2, axis=-1)          # (B, D)
        return jnp.broadcast_to(var.T, self.batch_shape)
