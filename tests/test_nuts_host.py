"""Host-driven NUTS transition == monolithic `jit(vmap(nuts_kernel))`.

The host transition bounds the length of one device program (one NUTS step
of nuts_kernel is ONE program of up to 2^max_depth gradient evals); it must
be the SAME Markov transition — same key schedule, same
masking of finished chains, same divergence/depth bookkeeping.
"""
import numpy as np
import jax
from jax import numpy as jnp, random as jr, vmap

from montecosmo_tpu.samplers.hmc import (
    HMCState, hmc_init, nuts_host_transition, nuts_kernel,
)


def _target(scales):
    def logdf(v, cond=None):
        shift = 0.0 if cond is None else cond.get("shift", 0.0)
        x = v["x"] - shift
        return -0.5 * jnp.sum((x / scales) ** 2) - 0.1 * jnp.sum(x**4)
    return logdf


def _batch_init(logdf, keys, cond=None):
    def one(key, c):
        pos = {"x": 0.5 * jr.normal(key, (6,))}
        return hmc_init(pos, lambda v: logdf(v, c))
    return jax.jit(vmap(one))(keys, cond)


def _run_both(step_size, max_doublings, evals_per_program, seed=0,
              n_chains=3, shift=None):
    scales = jnp.asarray([0.1, 0.3, 1.0, 3.0, 10.0, 0.5])
    logdf = _target(scales)
    keys = jr.split(jr.key(seed), n_chains)
    cond = ({"shift": jnp.linspace(-1.0, 1.0, n_chains)} if shift
            else {"shift": jnp.zeros(n_chains)})
    state = _batch_init(logdf, keys, cond)

    ss = jnp.full((n_chains,), step_size)
    invmm = jnp.ones((n_chains, 6))
    step_keys = jr.split(jr.key(seed + 100), n_chains)

    def mono(key, st, ss1, im1, c1):
        kern = nuts_kernel(lambda v: logdf(v, c1), ss1, im1,
                           max_num_doublings=max_doublings)
        return kern(key, st)
    ref_state, ref_info = jax.jit(vmap(mono))(step_keys, state, ss, invmm,
                                              cond)

    host = nuts_host_transition(logdf, {"x": jnp.zeros(6)},
                                max_num_doublings=max_doublings,
                                evals_per_program=evals_per_program)
    got_state, got_info = host(step_keys, state, ss, invmm, cond)
    return (ref_state, ref_info), (got_state, got_info)


def _assert_equal(ref, got):
    (rs, ri), (gs, gi) = ref, got
    np.testing.assert_allclose(np.asarray(gs.position["x"]),
                               np.asarray(rs.position["x"]), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(gs.logdensity),
                               np.asarray(rs.logdensity), rtol=1e-6)
    for k in ("acceptance_rate", "num_integration_steps", "is_divergent",
              "depth", "energy"):
        np.testing.assert_allclose(np.asarray(gi[k]), np.asarray(ri[k]),
                                   rtol=1e-6, err_msg=k)


def test_host_equals_monolithic_typical():
    # moderate step size: trees of a few doublings, chains stop at
    # different depths (exercises the freeze masking)
    for seed in range(4):
        ref, got = _run_both(0.25, max_doublings=6, evals_per_program=4,
                             seed=seed)
        _assert_equal(ref, got)


def test_host_equals_monolithic_divergent():
    # huge step size: divergences in the first leaves
    ref, got = _run_both(50.0, max_doublings=5, evals_per_program=8, seed=1)
    _assert_equal(ref, got)
    assert np.asarray(got[1]["is_divergent"]).any()


def test_host_equals_monolithic_max_depth():
    # tiny step size: every chain hits the depth cap
    ref, got = _run_both(1e-3, max_doublings=3, evals_per_program=2, seed=2)
    _assert_equal(ref, got)
    assert (np.asarray(got[1]["depth"]) == 3).all()


def test_host_equals_monolithic_per_chain_conditioning():
    ref, got = _run_both(0.25, max_doublings=5, evals_per_program=4, seed=3,
                         shift=True)
    _assert_equal(ref, got)


def test_host_chunk_size_invariance():
    # the chunk size must not change the transition at all
    out = [_run_both(0.25, max_doublings=6, evals_per_program=m, seed=5)[1]
           for m in (1, 2, 8)]
    for other in out[1:]:
        _assert_equal(out[0], other)
