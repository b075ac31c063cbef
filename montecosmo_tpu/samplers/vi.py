"""Mean-field Gaussian ADVI over the unconstrained sample space.

The model's sample space is already unconstrained (detruncated priors map
every latent to ~N(0,1) coordinates, models/distributions.py), so the
variational family q = N(mu, diag sigma^2) over the raveled latent pytree
needs no extra bijector.  The reparametrized ELBO

    ELBO = E_{eps~N(0,I)}[logpdf(mu + sigma * eps)] + sum(log sigma) + const

is maximized with Adam; the whole loop compiles as one `lax.scan` on
device.

The reference exposes no variational sampler (only the Adam MAP loop,
reference samplers.py:679-696); this closes the north-star's "variational
samplers step through it" clause.
"""

import optax
from jax import flatten_util, jit, lax, numpy as jnp, random as jr, value_and_grad

import jax


def advi(logpdf, start, n_steps=1000, n_mc=4, lr0=1e-2, seed=0,
         init_log_sigma=-2.0, scan=True):
    """Fit q = N(mu, diag sigma^2) to `exp(logpdf)` by stochastic ELBO ascent.

    logpdf : dict -> scalar joint log-density (sample-space params).
    start  : initial latent pytree (e.g. a prior sample or fiducial point).
    n_mc   : Monte-Carlo samples per ELBO gradient.
    Returns (ApproxPosterior, elbo trace array).
    """
    x0, unravel = flatten_util.ravel_pytree(start)
    d = x0.shape[0]

    def elbo(params, key):
        mu, log_sigma = params
        eps = jr.normal(key, (n_mc, d), x0.dtype)
        xs = mu + jnp.exp(log_sigma) * eps
        lps = jax.vmap(lambda x: logpdf(unravel(x)))(xs)
        return jnp.mean(lps) + jnp.sum(log_sigma)

    schedule = lambda i: lr0 / jnp.sqrt(1.0 + 0.1 * i)
    opt = optax.adam(schedule)
    params0 = (x0, jnp.full(d, init_log_sigma, x0.dtype))

    @jit
    def step(carry, key):
        params, opt_state = carry
        value, grads = value_and_grad(
            lambda p: -elbo(p, key))(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), -value

    keys = jr.split(jr.key(seed), n_steps)
    carry = (params0, opt.init(params0))
    if scan:
        carry, elbos = lax.scan(step, carry, keys)
    else:
        elbos = []
        for k in keys:
            carry, v = step(carry, k)
            elbos.append(float(v))
        elbos = jnp.asarray(elbos)
    (mu, log_sigma), _ = carry
    return ApproxPosterior(mu, jnp.exp(log_sigma), unravel), elbos


class ApproxPosterior:
    """Mean-field Gaussian posterior approximation over a latent pytree."""

    def __init__(self, mu, sigma, unravel):
        self.mu, self.sigma, self._unravel = mu, sigma, unravel

    @property
    def mean(self):
        return self._unravel(self.mu)

    @property
    def std(self):
        return self._unravel(self.sigma)

    def sample(self, key, n=1):
        """n draws as a batched pytree (leading axis n)."""
        eps = jr.normal(key, (n, self.mu.shape[0]), self.mu.dtype)
        xs = self.mu + self.sigma * eps
        return jax.vmap(self._unravel)(xs)

    def log_prob(self, params):
        x, _ = flatten_util.ravel_pytree(params)
        z = (x - self.mu) / self.sigma
        return jnp.sum(-0.5 * z**2 - jnp.log(self.sigma)
                       - 0.5 * jnp.log(2 * jnp.pi))
