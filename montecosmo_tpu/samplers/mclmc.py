"""Microcanonical Langevin Monte Carlo (MCLMC) and its Metropolis-adjusted
variant (MAMS), with automatic L / step-size adaptation.

Native implementation of the sampler stack the reference takes from BlackJAX
(`montecosmo/samplers.py:285-583`), following Robnik+2022 (arXiv:2212.08549)
and Robnik&Seljak 2023 for the adaptation:

* isokinetic dynamics on the sphere: the exact ESH momentum bounce
  u' = (e (1-z)(1+z+c(1-z)) + 2 z u) / |...|,  z = e^{-delta},
  delta = eps |g| / (d-1), c = <u, e>, with kinetic-energy change
  (d-1)(delta - log 2 + log(1 + c + (1-c) z^2)),
* minimal-norm (McLachlan) 2nd-order splitting: 2 gradient evals / step,
* partial momentum refresh (OU on the sphere) with rate eps/L,
* tune1: stochastic step-size control targeting a desired energy variance
  per dimension;  tune2: trajectory length L (and optionally a diagonal
  inverse mass matrix) from streaming position variances,
* MAMS: full-refresh trajectories of random length ~ U(0, 2 L / eps) with an
  MH correction, step size tuned to a target acceptance rate.

All loops are `lax.scan`s over flattened states: chains shard cleanly with
`vmap` + jax.sharding (see parallel.chains.map_chains).
"""
from functools import partial
from typing import Any, NamedTuple

import numpy as np
from jax import flatten_util, lax, numpy as jnp, random as jr, value_and_grad

import jax


class IntegratorState(NamedTuple):
    position: Any          # pytree
    momentum: Any          # flat unit vector (d,)
    logdensity: Any
    logdensity_grad: Any   # pytree


class MCLMCAdaptationState(NamedTuple):
    L: Any
    step_size: Any
    inverse_mass_matrix: Any  # flat (d,) or scalar 1.0


_MCLACHLAN_B1 = 0.1931833275037836


def _ravel(tree):
    return flatten_util.ravel_pytree(tree)


def mclmc_init(position, logdensity_fn, rng_key):
    """Initial state: random unit momentum + logdensity and gradient."""
    flat, unravel = _ravel(position)
    u = jr.normal(rng_key, flat.shape, dtype=flat.dtype)
    u = u / jnp.linalg.norm(u)
    logdensity, grad = value_and_grad(logdensity_fn)(position)
    return IntegratorState(position, u, logdensity, grad)


def _momentum_update(u, grad_flat, sqrt_invmm, step_size):
    """Exact isokinetic (ESH) momentum bounce; returns (u', dKE)."""
    d = u.shape[0]
    g = grad_flat * sqrt_invmm
    gnorm = jnp.maximum(jnp.linalg.norm(g), 1e-30)
    e = g / gnorm
    delta = step_size * gnorm / (d - 1)
    c = jnp.dot(u, e, precision=lax.Precision.HIGHEST)
    z = jnp.exp(-delta)
    u_new = e * (1 - z) * (1 + z + c * (1 - z)) + 2 * z * u
    u_new = u_new / jnp.linalg.norm(u_new)
    # dKE = (d-1)(delta - log 2 + log(1 + c + (1-c) z^2)), rewritten via
    # 1 + c + (1-c) z^2 = 2 (1 + (1-c)(z^2-1)/2) so the log is evaluated as
    # log1p of an O(delta) quantity instead of log of ~2: the naive form's
    # f32 quantization (~eps per log) is amplified by (d-1) — ~0.1 of pure
    # noise per momentum update at d ~ 1e6, which poisons the tuner's
    # energy-change measurements at exactly the step sizes where the true
    # signal is O(0.3).  Mathematically identical; relative error ~eps/|c|.
    z2m1 = jnp.expm1(-2.0 * delta)  # z^2 - 1, no cancellation for small delta
    dKE = (d - 1) * (delta + jnp.log1p(0.5 * (1 - c) * z2m1))
    return u_new, dKE


def _mclachlan_step(state: IntegratorState, logdensity_fn, step_size, sqrt_invmm):
    """One minimal-norm 2nd-order isokinetic step (2 gradient evals)."""
    x_flat, unravel = _ravel(state.position)
    g_flat, _ = _ravel(state.logdensity_grad)
    u = state.momentum
    b1 = _MCLACHLAN_B1

    u, dk1 = _momentum_update(u, g_flat, sqrt_invmm, b1 * step_size)
    x_flat = x_flat + 0.5 * step_size * sqrt_invmm * u
    logdensity, grad = value_and_grad(logdensity_fn)(unravel(x_flat))
    g_flat, _ = _ravel(grad)
    u, dk2 = _momentum_update(u, g_flat, sqrt_invmm, (1 - 2 * b1) * step_size)
    x_flat = x_flat + 0.5 * step_size * sqrt_invmm * u
    logdensity, grad = value_and_grad(logdensity_fn)(unravel(x_flat))
    g_flat, _ = _ravel(grad)
    u, dk3 = _momentum_update(u, g_flat, sqrt_invmm, b1 * step_size)

    new = IntegratorState(unravel(x_flat), u, logdensity, grad)
    return new, dk1 + dk2 + dk3


def _partial_refresh(u, rng_key, step_size, L):
    """OU momentum refresh on the sphere with rate eps/L."""
    d = u.shape[0]
    nu = jnp.sqrt((jnp.exp(2 * step_size / L) - 1.0) / d)
    z = nu * jr.normal(rng_key, u.shape, dtype=u.dtype)
    un = u + z
    return un / jnp.linalg.norm(un)


def mclmc_kernel(logdensity_fn, inverse_mass_matrix=1.0):
    """Unadjusted MCLMC transition: McLachlan step + partial refresh.

    Returns (new_state, info) with info = dict(energy_change, logdensity).
    """
    sqrt_invmm = jnp.sqrt(inverse_mass_matrix)

    def kernel(rng_key, state: IntegratorState, L, step_size):
        new, dKE = _mclachlan_step(state, logdensity_fn, step_size, sqrt_invmm)
        energy_change = dKE - new.logdensity + state.logdensity
        u = _partial_refresh(new.momentum, rng_key, step_size, L)
        new = new._replace(momentum=u)
        return new, dict(energy_change=energy_change, logdensity=new.logdensity)

    return kernel


# --------------------------------------------------------------------- adaptation
def _nan_guard(prev_state, next_state, step_size_max, energy_change, step_size):
    """Reject non-finite transitions and shrink the step-size cap."""
    flat, _ = _ravel(next_state.position)
    ok = (jnp.isfinite(energy_change)
          & jnp.all(jnp.isfinite(flat))
          & jnp.isfinite(next_state.logdensity))
    state = jax.tree.map(lambda n, p: jnp.where(ok, n, p), next_state, prev_state)
    step_size_max = jnp.where(ok, step_size_max, step_size * 0.8)
    energy_change = jnp.where(ok, energy_change, jnp.inf)
    return ok, state, step_size_max, energy_change


def mclmc_warmup(seed, init_pos, logdf, n_steps=0, config=None,
                 desired_energy_var=5e-4, diagonal_preconditioning=False,
                 num_effective_samples=256, trust_in_estimate=1.5):
    """Tune (L, step_size[, diag inverse mass]) for MCLMC.

    tune1 (first half): stochastic step-size control — per step the squared
    energy error xi = E^2/(d sigma*^2) updates a forgetting average of
    xi / eps^6 (the error scales as eps^6 for a 2nd-order integrator), whose
    -1/6 power is the new step size.  tune2 (second half): same, plus
    streaming position moments giving L = sqrt(sum Var[x]) and optionally the
    diagonal inverse mass matrix.

    Returns (state, MCLMCAdaptationState) — same contract as the reference's
    `get_mclmc_warmup` (samplers.py:285-340).
    """
    init_seed, tune_seed = jr.split(seed, 2)
    state = mclmc_init(init_pos, logdf, init_seed)
    flat, unravel = _ravel(state.position)
    d = flat.shape[0]

    if config is None:
        config = MCLMCAdaptationState(
            jnp.asarray(d**0.5, flat.dtype),
            jnp.asarray(d**0.5 / 1e4, flat.dtype),
            inverse_mass_matrix=jnp.ones(d, flat.dtype))
    elif isinstance(config, dict):
        config = MCLMCAdaptationState(
            L=config["L"], step_size=config["step_size"],
            inverse_mass_matrix=config.get("inverse_mass_matrix", jnp.ones(d)))

    if n_steps == 0:
        return state, config

    steps1 = n_steps // 2
    steps2 = n_steps - steps1

    carry = _warmup_carry0(state, config, flat.dtype, d)
    keys1, keys2 = jr.split(tune_seed)
    carry = _warmup_chunk(carry, jr.split(keys1, steps1), False, logdf,
                          desired_energy_var, num_effective_samples,
                          trust_in_estimate)
    carry = _warmup_chunk(carry, jr.split(keys2, steps2), True, logdf,
                          desired_energy_var, num_effective_samples,
                          trust_in_estimate)
    return _warmup_finalize(carry, diagonal_preconditioning)


def _warmup_carry0(state, config, dtype, d):
    """Initial adaptation carry (see mclmc_warmup)."""
    F0 = jnp.zeros((), dtype)
    W0 = jnp.zeros((), dtype)
    cap0 = jnp.asarray(jnp.inf, dtype)
    xi0 = (jnp.zeros((), dtype), jnp.zeros((), dtype))
    mom0 = (jnp.zeros((), dtype), jnp.zeros(d, dtype), jnp.zeros(d, dtype))
    return (state, config, (F0, W0, cap0, xi0), mom0)


def _warmup_chunk(carry, keys, stream_moments, logdf, desired_energy_var=5e-4,
                  num_effective_samples=256, trust_in_estimate=1.5):
    """Scan a chunk of warmup steps over `keys`, returning the carry.

    Pure and vmappable: long warmups are CHUNKED at the host level (progress
    and checkpoint/resume points) by slicing the key array — the adaptation
    trajectory is bit-identical to one long scan.
    """
    d = _ravel(carry[0].position)[0].shape[0]
    gamma = (num_effective_samples - 1.0) / (num_effective_samples + 1.0)

    def make_phase(stream_moments):
        def step(carry, key):
            state, params, (F, W, step_size_max, xi_avg), (w_sum, x_sum, x2_sum) = carry
            kernel = mclmc_kernel(logdf, params.inverse_mass_matrix)
            next_state, info = kernel(key, state, params.L, params.step_size)
            ok, state, step_size_max, energy_change = _nan_guard(
                state, next_state, step_size_max, info["energy_change"],
                params.step_size)

            # f32 energy-measurement noise floor: energy_change subtracts two
            # logdensities of magnitude |L| whose float32 quantization
            # (ulp <= 2*eps*|L|, eps = 2^-23) puts ~ulp^2/6 of variance into
            # every measurement.  Chasing a desired_energy_var below that
            # floor collapses the step size toward zero (observed: 64^3
            # quad-Gauss campaign, |logpdf| ~ 4.7e6 -> quantization ~ 0.5 vs
            # the 1e-7/dim full-warmup target de ~ 0.3; ss fell 5e-3 ->
            # 4e-6 and the chains froze).  Clamp the per-dim target so the
            # true signal stays >~5x the noise RMS; in f64 the floor is
            # ~1e-31 and the clamp is exactly a no-op — the f64 reference
            # (run/infer.py:76) never hits this.
            eps_mach = jnp.finfo(energy_change.dtype).eps
            noise_var = (2.0 * eps_mach * jnp.abs(state.logdensity)) ** 2 / 6.0
            dev_eff = jnp.maximum(desired_energy_var, 25.0 * noise_var / d)
            xi = energy_change**2 / (d * dev_eff) + 1e-8
            log_xi = jnp.log(xi)
            valid = jnp.isfinite(log_xi)  # guarded bad steps carry xi = inf
            log_xi = jnp.where(valid, log_xi, 0.0)
            w = jnp.where(valid,
                          jnp.exp(-0.5 * (log_xi / (6.0 * trust_in_estimate))**2),
                          0.0)
            # per-step estimate of the optimal step size (2nd-order
            # integrator: squared energy error ~ eps^6), averaged in LOG space
            # with forgetting — bounded influence of early transients
            log_eps_hat = jnp.log(params.step_size) - log_xi / 6.0
            F = gamma * F + w * log_eps_hat
            W = gamma * W + w
            step_size = jnp.exp(F / jnp.maximum(W, 1e-12))
            step_size = jnp.minimum(step_size, step_size_max)
            params = params._replace(step_size=step_size)
            # arithmetic mean of xi at the current eps (for the final rescale);
            # guarded steps count as the cap (the step was too large)
            xi_avg = (gamma * xi_avg[0] + jnp.where(valid, jnp.minimum(xi, 1e3), 1e3),
                      gamma * xi_avg[1] + 1.0)

            if stream_moments:
                x, _ = _ravel(state.position)
                wgt = ok.astype(x.dtype)
                w_sum = w_sum + wgt
                x_sum = x_sum + wgt * x
                x2_sum = x2_sum + wgt * x**2
            return (state, params, (F, W, step_size_max, xi_avg),
                    (w_sum, x_sum, x2_sum)), None

        return step

    return lax.scan(make_phase(stream_moments), carry, keys)[0]


def _warmup_finalize(carry, diagonal_preconditioning):
    """Final (state, MCLMCAdaptationState) from the adaptation carry."""
    state, params, (_, _, _, (xi_num, xi_den)), (w_sum, x_sum, x2_sum) = carry
    flat, _ = _ravel(state.position)
    d = flat.shape[0]

    # rescale so the ARITHMETIC mean of xi is ~1 (log averaging targets the
    # geometric mean, which undershoots for heavy-tailed energy errors)
    xi_arith = xi_num / jnp.maximum(xi_den, 1e-12)
    correction = jnp.clip(xi_arith, 1.0, 1e3) ** (-1.0 / 6.0)
    params = params._replace(step_size=params.step_size * correction)

    x_avg = x_sum / jnp.maximum(w_sum, 1)
    variances = jnp.maximum(x2_sum / jnp.maximum(w_sum, 1) - x_avg**2, 1e-12)

    if diagonal_preconditioning:
        invmm = variances
        # the effective step lives in whitened coordinates: rescale eps so the
        # typical per-coordinate move is preserved
        old = jnp.sqrt(jnp.asarray(params.inverse_mass_matrix))
        new = jnp.sqrt(invmm)
        scale = jnp.exp(jnp.mean(jnp.log(old / new)))
        params = params._replace(inverse_mass_matrix=invmm,
                                 step_size=params.step_size * scale,
                                 L=jnp.sqrt(jnp.asarray(float(d), flat.dtype)))
    else:
        params = params._replace(L=jnp.sqrt(jnp.sum(variances)))

    return state, params


def mclmc_run(seed, state, config, logdf, n_samples, transform=None,
              thinning=1, progress_bar=False):
    """Run MCLMC for `n_samples` thinned samples (thinning inner steps each).

    Per kept sample records (position, logdensity, mse_per_dim = RMS^2 of the
    per-step energy change / d) and n_evals bookkeeping (2 grad evals per
    McLachlan step).  Same contract as the reference's `get_mclmc_run`
    (samplers.py:344-401).
    """
    if isinstance(config, dict):
        L = config["L"]
        step_size = config["step_size"]
        invmm = config.get("inverse_mass_matrix", 1.0)
    else:
        L, step_size, invmm = config.L, config.step_size, config.inverse_mass_matrix

    kernel = mclmc_kernel(logdf, invmm)
    flat, _ = _ravel(state.position)
    d = flat.shape[0]

    if transform is None:
        transform = lambda state, info: (
            state.position,
            {"logdensity": state.logdensity,
             "mse_per_dim": info["energy_change"] ** 2 / d})

    def inner(state, key):
        state, info = kernel(key, state, L, step_size)
        return state, info["energy_change"]

    def outer(state, keys):
        state, de = lax.scan(inner, state, keys)
        info = {"energy_change": jnp.sqrt(jnp.mean(de**2))}
        return state, transform(state, info)

    keys = jr.split(seed, (n_samples, thinning))
    state, history = lax.scan(outer, state, keys)
    samples, infos = history
    infos = dict(infos)
    infos["n_evals"] = 2 * thinning * jnp.ones(n_samples)
    return state, {**samples, **infos}


def get_mclmc_warmup(logdf, n_steps=None, config=None, desired_energy_var=5e-4,
                     diagonal_preconditioning=False):
    return partial(mclmc_warmup, logdf=logdf, n_steps=n_steps, config=config,
                   desired_energy_var=desired_energy_var,
                   diagonal_preconditioning=diagonal_preconditioning)


def get_mclmc_run(logdf, n_samples, transform=None, thinning=1, progress_bar=False):
    return partial(mclmc_run, logdf=logdf, n_samples=n_samples,
                   transform=transform, thinning=thinning,
                   progress_bar=progress_bar)


# ======================================================================= MAMS
def _trajectory(state, logdensity_fn, step_size, sqrt_invmm, n_steps, max_steps):
    """Integrate up to `max_steps` McLachlan steps, active for the first
    `n_steps` — accumulates the energy change for the MH correction."""
    def body(carry, i):
        state, dE = carry
        new, dKE = _mclachlan_step(state, logdensity_fn, step_size, sqrt_invmm)
        step_dE = dKE - new.logdensity + state.logdensity
        take = i < n_steps
        state = jax.tree.map(lambda n, p: jnp.where(take, n, p), new, state)
        dE = dE + jnp.where(take, step_dE, 0.0)
        return (state, dE), None

    (state, dE), _ = lax.scan(body, (state, jnp.zeros(())), jnp.arange(max_steps))
    return state, dE


def mams_kernel(logdensity_fn, inverse_mass_matrix, step_size, avg_steps, max_steps,
                L_proposal_factor=jnp.inf):
    """Metropolis-adjusted MCLMC: full momentum refresh, random trajectory
    length ~ ceil(U(0,1) * 2 * avg_steps), MH accept on the energy error."""
    sqrt_invmm = jnp.sqrt(inverse_mass_matrix)

    def kernel(rng_key, state: IntegratorState):
        key_mom, key_len, key_acc = jr.split(rng_key, 3)
        u = jr.normal(key_mom, state.momentum.shape, dtype=state.momentum.dtype)
        u = u / jnp.linalg.norm(u)
        state = state._replace(momentum=u)

        n_steps = jnp.ceil(jr.uniform(key_len) * 2 * avg_steps).astype(int)
        n_steps = jnp.clip(n_steps, 1, max_steps)
        prop, dE = _trajectory(state, logdensity_fn, step_size, sqrt_invmm,
                               n_steps, max_steps)

        p_acc = jnp.minimum(1.0, jnp.exp(-dE))
        p_acc = jnp.where(jnp.isfinite(dE), p_acc, 0.0)
        accept = jr.uniform(key_acc) < p_acc
        new = jax.tree.map(lambda p, s: jnp.where(accept, p, s), prop, state)
        info = dict(acceptance_rate=p_acc, num_integration_steps=n_steps,
                    is_accepted=accept)
        return new, info

    return kernel


def mams_warmup(seed, init_pos, logdf, n_steps=0, config=None,
                diagonal_preconditioning=False, target_acc_rate=0.65,
                max_steps=128, random_trajectory_length=True,
                L_proposal_factor=jnp.inf):
    """Tune MAMS: Robbins-Monro step-size control toward `target_acc_rate`,
    L from streaming position variances.  Same contract as the reference's
    `get_mams_warmup` (samplers.py:432-497)."""
    init_seed, tune_seed = jr.split(seed, 2)
    state = mclmc_init(init_pos, logdf, init_seed)
    flat, unravel = _ravel(state.position)
    d = flat.shape[0]

    if config is None:
        config = MCLMCAdaptationState(
            jnp.asarray(d**0.5, flat.dtype),
            jnp.asarray(d**0.5 / 64, flat.dtype),
            inverse_mass_matrix=jnp.ones(d, flat.dtype))
    elif isinstance(config, dict):
        config = MCLMCAdaptationState(
            L=config["L"], step_size=config["step_size"],
            inverse_mass_matrix=config.get("inverse_mass_matrix", jnp.ones(d)))

    if n_steps == 0:
        return state, config

    carry = _mams_carry0(state, config, flat.dtype, d)
    xs = (jnp.arange(n_steps), jr.split(tune_seed, n_steps))
    carry = _mams_chunk(carry, xs, logdf, target_acc_rate, max_steps,
                        L_proposal_factor)
    return _mams_finalize(carry, diagonal_preconditioning)


def _mams_carry0(state, config, dtype, d):
    """Initial MAMS adaptation carry: (state, params, position moments)."""
    mom0 = (jnp.zeros((), dtype), jnp.zeros(d, dtype), jnp.zeros(d, dtype))
    return (state, config, mom0)


def _mams_chunk(carry, xs, logdf, target_acc_rate=0.65, max_steps=128,
                L_proposal_factor=jnp.inf):
    """Scan a chunk of MAMS warmup steps; xs = (step indices, keys).

    Pure and vmappable; slicing (indices, keys) at the host level keeps the
    Robbins-Monro trajectory identical to one long scan (the learning rate
    depends on the GLOBAL step index carried in xs).
    """

    def step(carry, xs):
        i, key = xs
        state, params, (w_sum, x_sum, x2_sum) = carry
        avg_steps = jnp.maximum(params.L / params.step_size, 1.0)
        kernel = mams_kernel(logdf, params.inverse_mass_matrix, params.step_size,
                             avg_steps, max_steps, L_proposal_factor)
        state, info = kernel(key, state)

        # Robbins-Monro on log step size toward the target acceptance
        lr = 0.5 / jnp.sqrt(1.0 + i)
        log_eps = jnp.log(params.step_size) \
            + lr * (info["acceptance_rate"] - target_acc_rate)
        params = params._replace(step_size=jnp.exp(log_eps))

        x, _ = _ravel(state.position)
        w_sum = w_sum + 1.0
        x_sum = x_sum + x
        x2_sum = x2_sum + x**2
        return (state, params, (w_sum, x_sum, x2_sum)), None

    return lax.scan(step, carry, xs)[0]


def _mams_finalize(carry, diagonal_preconditioning):
    """Final (state, MCLMCAdaptationState) from the MAMS adaptation carry."""
    state, params, (w_sum, x_sum, x2_sum) = carry
    flat, _ = _ravel(state.position)
    d = flat.shape[0]
    x_avg = x_sum / jnp.maximum(w_sum, 1)
    variances = jnp.maximum(x2_sum / jnp.maximum(w_sum, 1) - x_avg**2, 1e-12)
    if diagonal_preconditioning:
        params = params._replace(inverse_mass_matrix=variances,
                                 L=jnp.sqrt(jnp.asarray(float(d), flat.dtype)))
    else:
        params = params._replace(L=jnp.sqrt(jnp.sum(variances)))
    return state, params


def mams_run(seed, state, config, logdf, n_samples, transform=None, thinning=1,
             progress_bar=False, max_steps=256, L_proposal_factor=jnp.inf):
    """Run MAMS; records (position, logdensity, acceptance_rate, n_evals)."""
    if isinstance(config, dict):
        L, step_size = config["L"], config["step_size"]
        invmm = config.get("inverse_mass_matrix", 1.0)
    else:
        L, step_size, invmm = config.L, config.step_size, config.inverse_mass_matrix

    avg_steps = jnp.maximum(L / step_size, 1.0)
    kernel = mams_kernel(logdf, invmm, step_size, avg_steps, max_steps,
                         L_proposal_factor)

    if transform is None:
        transform = lambda state, info: (
            state.position,
            {"logdensity": state.logdensity,
             "acceptance_rate": info["acceptance_rate"],
             "n_evals": info["num_integration_steps"] * 2})

    def inner(state, key):
        state, info = kernel(key, state)
        return state, (info["acceptance_rate"], info["num_integration_steps"])

    def outer(state, keys):
        state, (acc, n_int) = lax.scan(inner, state, keys)
        info = dict(acceptance_rate=jnp.mean(acc),
                    num_integration_steps=jnp.sum(n_int))
        return state, transform(state, info)

    keys = jr.split(seed, (n_samples, thinning))
    state, history = lax.scan(outer, state, keys)
    samples, infos = history
    return state, {**samples, **infos}


def get_mams_warmup(logdf, n_steps=None, config=None, diagonal_preconditioning=False):
    return partial(mams_warmup, logdf=logdf, n_steps=n_steps, config=config,
                   diagonal_preconditioning=diagonal_preconditioning)


def get_mams_run(logdf, n_samples, transform=None, thinning=1, progress_bar=False):
    return partial(mams_run, logdf=logdf, n_samples=n_samples,
                   transform=transform, thinning=thinning,
                   progress_bar=progress_bar)
