"""HMC and iterative NUTS with Stan-style window adaptation, plus the
Metropolis-within-Gibbs combinators used for blocked field/parameter updates.

Native implementation of the reference's BlackJAX-based stack
(`montecosmo/samplers.py:17-269`):

* leapfrog + fixed-length HMC kernel,
* dynamic NUTS: iterative progressive sampling with the checkpoint trick for
  sub-tree U-turn checks (O(log2 max_depth) memory, exact detailed balance;
  multinomial biased-progressive sampling, generalized U-turn criterion),
* dual-averaging step size + Welford diagonal mass in fast/slow/fast windows,
* `mwg_*`: blocked Gibbs over a dict of per-block kernels/states.

Everything runs on flattened positions (ravel_pytree) so the kernels are a
handful of fused vector ops between gradient evaluations — the gradients
(full forward+reverse model renders) dominate.
"""
from functools import partial
from typing import Any, NamedTuple

import numpy as np
from jax import flatten_util, lax, numpy as jnp, random as jr, value_and_grad

import jax


class HMCState(NamedTuple):
    position: Any          # pytree
    logdensity: Any
    logdensity_grad: Any   # pytree


def _ravel(tree):
    return flatten_util.ravel_pytree(tree)


def hmc_init(position, logdensity_fn):
    logdensity, grad = value_and_grad(logdensity_fn)(position)
    return HMCState(position, logdensity, grad)


def _vel(invmm, r):
    """Velocity invmm·r — diagonal metric as an elementwise product, dense
    (d, d) metric as a matvec.  `jnp.ndim` is static under trace/vmap, so
    the branch compiles away."""
    if jnp.ndim(invmm) == 2:
        return jnp.dot(invmm, r, precision=lax.Precision.HIGHEST)
    return invmm * r


def _bcast_invmm(inverse_mass_matrix, x0):
    """Normalize an inverse-mass argument against the flat position: scalars
    and (d,) vectors broadcast to a diagonal metric, (d, d) stays dense."""
    invmm = jnp.asarray(inverse_mass_matrix, x0.dtype)
    return invmm if invmm.ndim == 2 else jnp.broadcast_to(invmm, x0.shape)


def _momentum(rng_key, invmm, x0):
    """Sample r ~ N(0, M) with M = invmm⁻¹.  Dense: invmm = LLᵀ gives
    r = L⁻ᵀξ (cov L⁻ᵀL⁻¹ = invmm⁻¹); the (d, d) solve is negligible next to
    the model gradients that dominate every trajectory."""
    xi = jr.normal(rng_key, x0.shape, x0.dtype)
    if jnp.ndim(invmm) == 2:
        chol = jnp.linalg.cholesky(invmm)
        return jax.scipy.linalg.solve_triangular(chol.T, xi, lower=False)
    return xi / jnp.sqrt(invmm)


def _leapfrog(x, r, g, logdensity_fn, unravel, step_size, invmm):
    """One velocity-Verlet step on the flat phase space; g = grad logp."""
    r = r + 0.5 * step_size * g
    x = x + step_size * _vel(invmm, r)
    logdensity, grad_tree = value_and_grad(logdensity_fn)(unravel(x))
    g = _ravel(grad_tree)[0]
    r = r + 0.5 * step_size * g
    return x, r, g, logdensity


def _kinetic(r, invmm):
    return 0.5 * jnp.dot(r, _vel(invmm, r), precision=lax.Precision.HIGHEST)


# ======================================================================= HMC
def hmc_kernel(logdensity_fn, step_size, num_integration_steps,
               inverse_mass_matrix=1.0):
    """Fixed-trajectory HMC with MH correction."""

    def kernel(rng_key, state: HMCState):
        key_mom, key_acc = jr.split(rng_key)
        x0, unravel = _ravel(state.position)
        g0 = _ravel(state.logdensity_grad)[0]
        invmm = _bcast_invmm(inverse_mass_matrix, x0)
        r0 = _momentum(key_mom, invmm, x0)
        H0 = -state.logdensity + _kinetic(r0, invmm)

        def body(carry, _):
            x, r, g, ld = carry
            x, r, g, ld = _leapfrog(x, r, g, logdensity_fn, unravel, step_size, invmm)
            return (x, r, g, ld), None

        (x, r, g, ld), _ = lax.scan(body, (x0, r0, g0, state.logdensity),
                                    None, length=num_integration_steps)
        H1 = -ld + _kinetic(r, invmm)
        dH = H1 - H0
        p_acc = jnp.where(jnp.isfinite(dH), jnp.minimum(1.0, jnp.exp(-dH)), 0.0)
        accept = jr.uniform(key_acc) < p_acc

        new = HMCState(unravel(x), ld, _ravel_inverse_grad(unravel, g))
        out = jax.tree.map(lambda n, o: jnp.where(accept, n, o), new, state)
        info = dict(acceptance_rate=p_acc, is_accepted=accept,
                    num_integration_steps=num_integration_steps, energy=H1)
        return out, info

    return kernel


def _ravel_inverse_grad(unravel, g_flat):
    return unravel(g_flat)


# ======================================================================= NUTS
class _Tree(NamedTuple):
    """A (sub)trajectory: edge states, multinomial sample, weights, stats."""
    x_left: Any
    r_left: Any
    g_left: Any
    ld_left: Any
    x_right: Any
    r_right: Any
    g_right: Any
    ld_right: Any
    x_prop: Any            # multinomial sample from the trajectory
    ld_prop: Any
    g_prop: Any
    logw: Any              # logsumexp of -H over the trajectory
    r_sum: Any             # momentum sum over the trajectory
    turning: Any
    diverging: Any
    sum_acc: Any           # sum of per-leaf min(1, e^{H0-H}) for adaptation
    n_leaves: Any


def _is_turning(r_left, r_right, r_sum, invmm):
    v = _vel(invmm, r_sum)
    return ((jnp.dot(v, r_left, precision=lax.Precision.HIGHEST) <= 0)
            | (jnp.dot(v, r_right, precision=lax.Precision.HIGHEST) <= 0))


def _leaf_cond(s, n_leaf):
    """Continue integrating leaves of the current subtree?"""
    return (s["i"] < n_leaf) & ~s["turning"] & ~s["diverging"]


def _subtree_carry0(key, tree: _Tree, direction, d, max_depth):
    """Leaf-loop carry at the start of a subtree build from `tree`'s edge."""
    x, r, g, ld = lax.cond(
        direction > 0,
        lambda: (tree.x_right, tree.r_right, tree.g_right, tree.ld_right),
        lambda: (tree.x_left, tree.r_left, tree.g_left, tree.ld_left))
    dt = x.dtype
    return dict(
        i=jnp.asarray(0), key=key, x=x, r=r, g=g, ld=ld,
        x_prop=x, ld_prop=ld, g_prop=g,
        logw=jnp.asarray(-jnp.inf, dt),
        r_sum=jnp.zeros_like(r), sum_acc=jnp.zeros((), dt),
        turning=jnp.asarray(False), diverging=jnp.asarray(False),
        r_ckpts=jnp.zeros((max_depth + 1, d), dt),
        rsum_ckpts=jnp.zeros((max_depth + 1, d), dt),
        x_first=x, r_first=r, g_first=g, ld_first=ld)


def _leaf_body(s, *, logdensity_fn, unravel, step_size, invmm, H0, direction,
               divergence_threshold, max_depth):
    """One leapfrog leaf of a subtree build (progressive multinomial +
    checkpoint-scheme internal turning checks)."""
    key, sub = jr.split(s["key"])
    x, r, g, ld = _leapfrog(s["x"], s["r"], s["g"], logdensity_fn, unravel,
                            direction * step_size, invmm)
    H = -ld + _kinetic(r, invmm)
    dH = H - H0
    diverging = ~jnp.isfinite(dH) | (dH > divergence_threshold)
    logw_leaf = jnp.where(jnp.isfinite(H), -H, -jnp.inf)
    sum_acc = s["sum_acc"] + jnp.where(
        jnp.isfinite(dH), jnp.minimum(1.0, jnp.exp(-dH)), 0.0)

    # progressive multinomial within the subtree
    logw = jnp.logaddexp(s["logw"], logw_leaf)
    take = jr.uniform(key) < jnp.exp(logw_leaf - logw)
    x_prop = jnp.where(take, x, s["x_prop"])
    ld_prop = jnp.where(take, ld, s["ld_prop"])
    g_prop = jnp.where(take, g, s["g_prop"])

    r_sum = s["r_sum"] + r
    i = s["i"]

    # checkpoint at even leaves: slot = popcount(i)
    slot_w = _popcount(i)
    even = (i % 2) == 0
    r_ckpts = jnp.where(even, s["r_ckpts"].at[slot_w].set(r), s["r_ckpts"])
    rsum_ckpts = jnp.where(even, s["rsum_ckpts"].at[slot_w].set(r_sum),
                           s["rsum_ckpts"])

    # turning checks for subtrees ending at odd leaf i:
    # slots [popcount(i+1)-1, popcount(i)-1]
    idx_min = _popcount(i + 1) - 1
    idx_max = _popcount(i) - 1

    def check(slot, acc):
        active = (slot >= idx_min) & (slot <= idx_max) & ((i % 2) == 1)
        sub_rsum = r_sum - rsum_ckpts[slot] + r_ckpts[slot]
        turn = _is_turning(r_ckpts[slot], r, sub_rsum, invmm)
        return acc | (active & turn)

    turning = lax.fori_loop(0, max_depth + 1, check, jnp.asarray(False))

    first = i == 0
    return dict(
        i=i + 1, key=sub, x=x, r=r, g=g, ld=ld,
        x_prop=x_prop, ld_prop=ld_prop, g_prop=g_prop,
        logw=logw, r_sum=r_sum, sum_acc=sum_acc,
        turning=turning, diverging=diverging,
        r_ckpts=r_ckpts, rsum_ckpts=rsum_ckpts,
        x_first=jnp.where(first, x, s["x_first"]),
        r_first=jnp.where(first, r, s["r_first"]),
        g_first=jnp.where(first, g, s["g_first"]),
        ld_first=jnp.where(first, ld, s["ld_first"]))


def _subtree_final(s, direction) -> _Tree:
    """Orient a finished leaf-loop carry along the global left/right axes."""
    xl, rl, gl, ldl = lax.cond(
        direction > 0,
        lambda: (s["x_first"], s["r_first"], s["g_first"], s["ld_first"]),
        lambda: (s["x"], s["r"], s["g"], s["ld"]))
    xr, rr, gr, ldr = lax.cond(
        direction > 0,
        lambda: (s["x"], s["r"], s["g"], s["ld"]),
        lambda: (s["x_first"], s["r_first"], s["g_first"], s["ld_first"]))
    return _Tree(xl, rl, gl, ldl, xr, rr, gr, ldr,
                 s["x_prop"], s["ld_prop"], s["g_prop"], s["logw"],
                 s["r_sum"], s["turning"], s["diverging"],
                 s["sum_acc"], s["i"])


def _double_merge(tree: _Tree, sub: _Tree, direction, key_take, invmm) -> _Tree:
    """Biased progressive merge of a new subtree into the trajectory."""
    invalid = sub.turning | sub.diverging
    p_take = jnp.clip(jnp.exp(sub.logw - tree.logw), max=1.0)
    take = (jr.uniform(key_take) < p_take) & ~invalid
    x_prop = jnp.where(take, sub.x_prop, tree.x_prop)
    ld_prop = jnp.where(take, sub.ld_prop, tree.ld_prop)
    g_prop = jnp.where(take, sub.g_prop, tree.g_prop)

    def merged():
        xl, rl, gl, ldl = lax.cond(
            direction > 0,
            lambda: (tree.x_left, tree.r_left, tree.g_left, tree.ld_left),
            lambda: (sub.x_left, sub.r_left, sub.g_left, sub.ld_left))
        xr, rr, gr, ldr = lax.cond(
            direction > 0,
            lambda: (sub.x_right, sub.r_right, sub.g_right, sub.ld_right),
            lambda: (tree.x_right, tree.r_right, tree.g_right, tree.ld_right))
        r_sum = tree.r_sum + sub.r_sum
        turning = _is_turning(rl, rr, r_sum, invmm)
        return _Tree(xl, rl, gl, ldl, xr, rr, gr, ldr,
                     x_prop, ld_prop, g_prop,
                     jnp.logaddexp(tree.logw, sub.logw), r_sum,
                     turning, sub.diverging,
                     tree.sum_acc + sub.sum_acc,
                     tree.n_leaves + sub.n_leaves)

    def stopped():
        return tree._replace(turning=tree.turning | sub.turning,
                             diverging=tree.diverging | sub.diverging,
                             sum_acc=tree.sum_acc + sub.sum_acc,
                             n_leaves=tree.n_leaves + sub.n_leaves)

    return lax.cond(invalid, stopped, merged)


def nuts_kernel(logdensity_fn, step_size, inverse_mass_matrix=1.0,
                max_num_doublings=None, divergence_threshold=1000.0):
    """Dynamic NUTS transition (iterative, multinomial, biased progressive).

    Sub-tree U-turn checks use the checkpoint scheme: while integrating leaf i
    of a subtree, the left-edge momenta of the perfect subtrees ending at i
    live in slots [popcount(i+1)-1, popcount(i)-1] of a max_depth-sized
    buffer, written at even leaves into slot popcount(leaf).

    max_num_doublings defaults to $MONTECOSMO_NUTS_MAX_DOUBLINGS (else 10).
    One NUTS step with 2^10 costly gradient evals is one long device program
    (warmup starts at step_size 1e-3, hitting max depth every step);
    expensive-model campaigns cap the trajectory instead (run/infer.py sets
    this env).
    """
    if max_num_doublings is None:
        import os
        max_num_doublings = int(
            os.environ.get("MONTECOSMO_NUTS_MAX_DOUBLINGS", "10"))
    max_depth = max_num_doublings

    def kernel(rng_key, state: HMCState):
        key_mom, key_traj = jr.split(rng_key)
        x0, unravel = _ravel(state.position)
        g0 = _ravel(state.logdensity_grad)[0]
        d = x0.shape[0]
        invmm = _bcast_invmm(inverse_mass_matrix, x0)
        r0 = _momentum(key_mom, invmm, x0)
        H0 = -state.logdensity + _kinetic(r0, invmm)

        def build_subtree(key, tree: _Tree, depth, direction):
            """Integrate 2^depth leaves from the trajectory edge, with
            progressive multinomial sampling and internal turning checks."""
            n_leaf = 2**depth  # dynamic upper bound for while_loop
            init = _subtree_carry0(key, tree, direction, d, max_depth)
            body = partial(_leaf_body, logdensity_fn=logdensity_fn,
                           unravel=unravel, step_size=step_size, invmm=invmm,
                           H0=H0, direction=direction,
                           divergence_threshold=divergence_threshold,
                           max_depth=max_depth)
            s = lax.while_loop(lambda s: _leaf_cond(s, n_leaf), body, init)
            return _subtree_final(s, direction)

        logw0 = -H0
        tree0 = _Tree(x0, r0, g0, state.logdensity,
                      x0, r0, g0, state.logdensity,
                      x0, state.logdensity, g0, logw0,
                      r0, jnp.asarray(False), jnp.asarray(False),
                      jnp.zeros((), x0.dtype), jnp.asarray(1))

        def doubling_cond(carry):
            depth, key, tree = carry
            return (depth < max_depth) & ~tree.turning & ~tree.diverging

        def doubling_body(carry):
            depth, key, tree = carry
            key, key_dir, key_sub, key_take = jr.split(key, 4)
            direction = jnp.where(jr.bernoulli(key_dir), 1.0, -1.0)
            sub = build_subtree(key_sub, tree, depth, direction)
            tree = _double_merge(tree, sub, direction, key_take, invmm)
            return depth + 1, key, tree

        depth, _, tree = lax.while_loop(doubling_cond, doubling_body,
                                        (jnp.asarray(0), key_traj, tree0))

        new = HMCState(unravel(tree.x_prop), tree.ld_prop, unravel(tree.g_prop))
        n_int = tree.n_leaves - 1
        info = dict(acceptance_rate=tree.sum_acc / jnp.maximum(n_int, 1),
                    num_integration_steps=n_int,
                    is_divergent=tree.diverging, depth=depth,
                    energy=-tree.ld_prop)
        return new, info

    return kernel


def _where_leaf(pred, new, old):
    """jnp.where that also works on typed PRNG-key leaves."""
    if hasattr(new, "dtype") and jnp.issubdtype(new.dtype, jax.dtypes.prng_key):
        return jr.wrap_key_data(
            jnp.where(pred, jr.key_data(new), jr.key_data(old)))
    return jnp.where(pred, new, old)


def nuts_host_transition(logdensity_fn, position_like, *, max_num_doublings=None,
                         divergence_threshold=1000.0, evals_per_program=8):
    """HOST-driven NUTS transition: the doubling loop and the subtree leaf
    loop run at the host level, so no single device program integrates more
    than `evals_per_program` leapfrog leaves.

    Why: one NUTS step of `nuts_kernel` is ONE program of up to
    2^max_depth gradient evaluations, which on expensive models (N-body at
    >= 64^3) runs for minutes with no progress report or resume point.
    Here each leaf chunk is its own jitted program (device-resident carry
    between programs), the host reads only small per-chain flags, and early
    u-turns terminate chunking immediately.

    Semantics: EXACTLY `jit(vmap(nuts_kernel(...)))` — same per-chain key
    schedule, and finished chains are frozen with the same masking that
    vmap applies to `lax.while_loop` lanes (tested equal, including
    divergences and depth bookkeeping, in tests/test_nuts_host.py).

    logdensity_fn : (position, cond) -> logdensity.  `cond` is an arbitrary
        per-chain pytree of conditioning values (the NUTS-within-Gibbs
        "other blocks"); pass empty dicts when unused.
    position_like : SINGLE-chain position pytree (structure + dtypes).

    Returns `step(keys, state, step_size, invmm, cond)`; every argument
    carries a leading chains axis (state: HMCState of (C, ...) leaves,
    step_size (C,), invmm (C, d), (C,) or (C, d, d) dense), and it returns
    (state', info) like the monolithic kernel.
    """
    import os

    if max_num_doublings is None:
        max_num_doublings = int(
            os.environ.get("MONTECOSMO_NUTS_MAX_DOUBLINGS", "10"))
    max_depth = int(max_num_doublings)
    x_like, unravel = _ravel(position_like)
    d = x_like.shape[0]

    # chunk sizes: powers of two up to evals_per_program (subtree of depth k
    # runs ceil(2^k / m) chunks; small depths get exact-size programs so a
    # depth-0 subtree costs 1 eval, not m)
    m_max = max(1, int(evals_per_program))
    m_max = 1 << (m_max.bit_length() - 1)  # round down to a power of 2

    def one_init(key, st, invmm):
        x0 = _ravel(st.position)[0]
        g0 = _ravel(st.logdensity_grad)[0]
        key_mom, key_traj = jr.split(key)
        invmmb = _bcast_invmm(invmm, x0)
        r0 = _momentum(key_mom, invmmb, x0)
        H0 = -st.logdensity + _kinetic(r0, invmmb)
        logw0 = -H0
        tree0 = _Tree(x0, r0, g0, st.logdensity,
                      x0, r0, g0, st.logdensity,
                      x0, st.logdensity, g0, logw0,
                      r0, jnp.asarray(False), jnp.asarray(False),
                      jnp.zeros((), x0.dtype), jnp.asarray(1))
        return dict(key=key_traj, tree=tree0, H0=H0,
                    done=jnp.asarray(False), depth=jnp.asarray(0))

    def one_prep(c):
        key, key_dir, key_sub, key_take = jr.split(c["key"], 4)
        direction = jnp.where(jr.bernoulli(key_dir), 1.0, -1.0)
        s0 = _subtree_carry0(key_sub, c["tree"], direction, d, max_depth)
        # frozen chains must not advance their key (the masking vmap applies
        # to stopped while_loop lanes)
        new_key = _where_leaf(c["done"], c["key"], key)
        return {**c, "key": new_key}, s0, direction, key_take

    def one_chunk(s, direction, H0, step_size, invmm, n_leaf, done, cond, m):
        invmmb = _bcast_invmm(invmm, s["x"])
        body = partial(_leaf_body,
                       logdensity_fn=lambda v: logdensity_fn(v, cond),
                       unravel=unravel, step_size=step_size, invmm=invmmb,
                       H0=H0, direction=direction,
                       divergence_threshold=divergence_threshold,
                       max_depth=max_depth)

        def gstep(s, _):
            new = body(s)
            act = _leaf_cond(s, n_leaf) & ~done
            s = jax.tree.map(partial(_where_leaf, act), new, s)
            return s, None

        return lax.scan(gstep, s, None, length=m)[0]

    def one_active(s, n_leaf, done):
        return _leaf_cond(s, n_leaf) & ~done

    def one_merge(c, s, direction, key_take, invmm):
        invmmb = _bcast_invmm(invmm, s["x"])
        sub = _subtree_final(s, direction)
        new_tree = _double_merge(c["tree"], sub, direction, key_take, invmmb)
        tree = jax.tree.map(partial(_where_leaf, c["done"]), c["tree"],
                            new_tree)
        depth = jnp.where(c["done"], c["depth"], c["depth"] + 1)
        done = c["done"] | new_tree.turning | new_tree.diverging
        return {**c, "tree": tree, "depth": depth, "done": done}

    def one_final(c):
        tree = c["tree"]
        new = HMCState(unravel(tree.x_prop), tree.ld_prop,
                       unravel(tree.g_prop))
        n_int = tree.n_leaves - 1
        info = dict(acceptance_rate=tree.sum_acc / jnp.maximum(n_int, 1),
                    num_integration_steps=n_int,
                    is_divergent=tree.diverging, depth=c["depth"],
                    energy=-tree.ld_prop)
        return new, info

    p_init = jax.jit(jax.vmap(one_init))
    p_prep = jax.jit(jax.vmap(one_prep))
    p_active = jax.jit(jax.vmap(one_active))
    p_merge = jax.jit(jax.vmap(one_merge))
    p_final = jax.jit(jax.vmap(one_final))
    p_chunks = {m: jax.jit(jax.vmap(partial(one_chunk, m=m)))
                for m in ({1 << k for k in range(m_max.bit_length())})}

    def step(keys, state, step_size, invmm, cond):
        c = p_init(keys, state, invmm)
        n_chains = keys.shape[0]
        for depth in range(max_depth):
            c, s, direction, key_take = p_prep(c)
            n_leaf = jnp.full((n_chains,), 1 << depth, jnp.int32)
            off = 0
            while off < (1 << depth):
                m = min(m_max, (1 << depth) - off)
                s = p_chunks[m](s, direction, c["H0"], step_size, invmm,
                                n_leaf, c["done"], cond)
                off += m
                if off < (1 << depth) and not np.asarray(
                        p_active(s, n_leaf, c["done"])).any():
                    break
            c = p_merge(c, s, direction, key_take, invmm)
            if np.asarray(c["done"]).all():
                break
        return p_final(c)

    return step


def _popcount(i):
    """Number of set bits of a non-negative int32 scalar."""
    i = i.astype(jnp.uint32)
    i = i - ((i >> 1) & 0x55555555)
    i = (i & 0x33333333) + ((i >> 2) & 0x33333333)
    i = (i + (i >> 4)) & 0x0F0F0F0F
    return ((i * 0x01010101) >> 24).astype(jnp.int32)


# ======================================================================= adaptation
class _DualAveragingState(NamedTuple):
    log_eps: Any
    log_eps_avg: Any
    grad_avg: Any
    t: Any
    mu: Any


def _da_init(step_size):
    log_eps = jnp.log(step_size)
    return _DualAveragingState(log_eps, jnp.zeros(()), jnp.zeros(()),
                               jnp.zeros(()), jnp.log(10.0) + log_eps)


def _da_update(state: _DualAveragingState, acc_prob, target=0.65,
               gamma=0.05, t0=10.0, kappa=0.75):
    t = state.t + 1
    grad_avg = (1 - 1 / (t + t0)) * state.grad_avg + (target - acc_prob) / (t + t0)
    log_eps = state.mu - jnp.sqrt(t) / gamma * grad_avg
    eta = t ** (-kappa)
    log_eps_avg = eta * log_eps + (1 - eta) * state.log_eps_avg
    return _DualAveragingState(log_eps, log_eps_avg, grad_avg, t, state.mu)


def _adaptation_schedule(num_steps, init_buffer=75, term_buffer=50, window=25):
    """Stan-style fast/slow/fast schedule: per-step (update_mass_now,
    is_in_slow_window) flags, mass matrix refreshed at slow-window ends."""
    if num_steps < 20:
        return np.zeros(num_steps, bool), np.zeros(num_steps, bool)
    init_buffer = min(init_buffer, num_steps // 4)
    term_buffer = min(term_buffer, num_steps // 4)
    slow = np.zeros(num_steps, bool)
    update = np.zeros(num_steps, bool)
    start = init_buffer
    w = window
    while start < num_steps - term_buffer:
        end = min(start + w, num_steps - term_buffer)
        if num_steps - term_buffer - end < w:  # absorb the remainder
            end = num_steps - term_buffer
        slow[start:end] = True
        update[end - 1] = True
        start = end
        w *= 2
    return update, slow


def window_adaptation(kernel_factory, logdensity_fn, num_steps, initial_position,
                      target_acceptance_rate=0.65, initial_step_size=1e-3,
                      rng_key=None, initial_inverse_mass_matrix=None,
                      **kernel_kwargs):
    """Warm up step size (dual averaging) and diagonal inverse mass (Welford
    over slow windows) for an HMC/NUTS kernel factory
    `kernel_factory(logdensity_fn, step_size, inverse_mass_matrix, **kw)`.

    Returns ((last_state, params), info) with params = dict(step_size,
    inverse_mass_matrix) — the contract of the reference's
    `blackjax.window_adaptation(...).run` (samplers.py:44-48).
    """
    if rng_key is None:
        rng_key = jr.key(0)
    carry = _wa_carry0(logdensity_fn, initial_position, initial_step_size,
                       initial_inverse_mass_matrix)
    x0 = _ravel(carry[0].position)[0]

    update_now, in_slow = _adaptation_schedule(num_steps)
    keys = jr.split(rng_key, num_steps)
    carry, hist = _wa_chunk(
        carry, (keys, jnp.asarray(update_now), jnp.asarray(in_slow, x0.dtype)),
        kernel_factory, logdensity_fn, target_acceptance_rate, **kernel_kwargs)
    return _wa_finalize(carry), hist


def _wa_carry0(logdensity_fn, initial_position, initial_step_size=1e-3,
               initial_inverse_mass_matrix=None):
    """Initial window-adaptation carry: (state, dual-avg, invmm, Welford).

    `initial_inverse_mass_matrix` seeds the mass before the first
    slow-window refresh — e.g. from a tuned MCLMC phase-1 config or a
    Laplace approximation — instead of the unit default.  Its shape selects
    the METRIC for the whole warmup: scalar/(d,) adapts a diagonal mass,
    (d, d) adapts a DENSE mass (full Welford covariance in slow windows) —
    the right choice for small correlated blocks (e.g. cosmology+bias
    scalars, whose Omega_m/sigma8 degeneracy forces max-depth trees under
    any diagonal metric)."""
    state = hmc_init(initial_position, logdensity_fn)
    x0 = _ravel(state.position)[0]
    d = x0.shape[0]
    da = _da_init(jnp.asarray(initial_step_size))
    if initial_inverse_mass_matrix is None:
        invmm = jnp.ones(d, x0.dtype)
    else:
        im = jnp.asarray(initial_inverse_mass_matrix, x0.dtype)
        invmm = im if im.ndim == 2 else jnp.broadcast_to(im, (d,))
    m2 = jnp.zeros((d, d) if invmm.ndim == 2 else d, x0.dtype)
    welford = (jnp.zeros(()), jnp.zeros(d, x0.dtype), m2)
    return (state, da, invmm, welford)


def bracket_init(logdensity_fn, position, rng_key,
                 inverse_mass_matrix=1.0, initial_step_size=1.0):
    """First leg of Stan's step-size bracketing, split out so the search can
    run as HOST-chunked device programs (one `bracket_iter` = one leapfrog
    eval ~ one short program, vs a whole `while_loop` in one program that
    runs for minutes on expensive models).  Returns a
    pure-array carry dict; iterate with `bracket_iter` while `carry['more']`
    holds anywhere, then read the result off `bracket_final`."""
    state = hmc_init(position, logdensity_fn)
    x0, unravel = _ravel(state.position)
    g0 = _ravel(state.logdensity_grad)[0]
    invmm = _bcast_invmm(inverse_mass_matrix, x0)
    r0 = _momentum(rng_key, invmm, x0)
    H0 = -state.logdensity + _kinetic(r0, invmm)
    eps0 = jnp.asarray(initial_step_size, x0.dtype)
    carry = dict(x0=x0, r0=r0, g0=g0, H0=H0, invmm=invmm, eps=eps0,
                 dlog=jnp.zeros((), x0.dtype), d0=jnp.ones((), x0.dtype))
    dlog0 = _bracket_logacc(logdensity_fn, unravel, carry, eps0)
    log_half = jnp.log(jnp.asarray(0.5, x0.dtype))
    d0 = jnp.where(dlog0 > log_half, 1.0, -1.0).astype(x0.dtype)
    return {**carry, "dlog": dlog0, "d0": d0,
            "more": d0 * dlog0 > d0 * log_half}


def _bracket_logacc(logdensity_fn, unravel, carry, eps):
    x, r, g, ld = _leapfrog(carry["x0"], carry["r0"], carry["g0"],
                            logdensity_fn, unravel, eps, carry["invmm"])
    dlog = carry["H0"] - (-ld + _kinetic(r, carry["invmm"]))
    return jnp.where(jnp.isfinite(dlog), dlog, -jnp.inf)


def bracket_iter(logdensity_fn, position_like, carry):
    """One doubling/halving step of the bracket search (one gradient eval).
    `position_like` supplies the pytree structure for unraveling."""
    unravel = _ravel(position_like)[1]
    log_half = jnp.log(jnp.asarray(0.5, carry["eps"].dtype))
    eps = jnp.where(carry["more"], carry["eps"] * jnp.exp2(carry["d0"]),
                    carry["eps"])
    dlog = jnp.where(carry["more"],
                     _bracket_logacc(logdensity_fn, unravel, carry, eps),
                     carry["dlog"])
    more = carry["more"] & (carry["d0"] * dlog > carry["d0"] * log_half)
    return {**carry, "eps": eps, "dlog": dlog, "more": more}


def bracket_final(carry):
    # the search stops one step PAST the 50% crossing; when doubling upward
    # the final eps can sit beyond the leapfrog stability limit (acceptance
    # falls off a cliff there, not gently) — back off to the last passing eps
    eps = jnp.where(carry["d0"] > 0, 0.5 * carry["eps"], carry["eps"])
    return jnp.clip(eps, 1e-8, 1e3)


def find_reasonable_step_size(logdensity_fn, position, rng_key,
                              inverse_mass_matrix=1.0, initial_step_size=1.0,
                              max_iters=30):
    """Stan's bracketing initializer (Hoffman & Gelman 2014, alg. 4): from
    `initial_step_size`, double/halve until a single leapfrog step crosses
    50% acceptance.  O(log eps*) gradient evals; pure and vmappable.

    Starting window adaptation from a fixed 1e-3 makes every early NUTS
    tree hit max depth (2^max_depth gradient evals per warmup step); a
    bracketed start costs ~10 evals and removes that regime entirely.
    (Single-program form of the bracket_init/iter/final trio above.)"""
    carry0 = bracket_init(logdensity_fn, position, rng_key,
                          inverse_mass_matrix, initial_step_size)

    def cond(ci):
        carry, i = ci
        return (i < max_iters) & carry["more"]

    def body(ci):
        carry, i = ci
        return bracket_iter(logdensity_fn, position, carry), i + 1

    carry, _ = lax.while_loop(cond, body, (carry0, jnp.zeros((), jnp.int32)))
    return bracket_final(carry)


def _wa_post(carry, info, upd, slow, target_acceptance_rate=0.65):
    """Post-kernel window-adaptation update for ONE step: dual averaging,
    Welford within slow windows, mass refresh at slow-window ends.  Shared
    by the in-program scan (`_wa_chunk`) and the host-driven NUTS warmup
    (identical trajectories by construction)."""
    state, da, invmm, welford = carry
    d = _ravel(state.position)[0].shape[0]
    da = _da_update(da, info["acceptance_rate"], target=target_acceptance_rate)

    # Welford within slow windows (m2 ndim selects diag vs dense streaming)
    n, mean, m2 = welford
    x = _ravel(state.position)[0]
    n1 = n + slow
    delta = x - mean
    mean = mean + slow * delta / jnp.maximum(n1, 1)
    dense = jnp.ndim(m2) == 2
    m2 = m2 + slow * (jnp.outer(delta, x - mean) if dense
                      else delta * (x - mean))
    welford = (n1, mean, m2)

    # refresh mass at slow-window ends, reset Welford and dual averaging
    def refresh(args):
        da, invmm, (n, mean, m2) = args
        var = m2 / jnp.maximum(n - 1, 1)
        reg = 1e-3 * (5.0 / (n + 5.0))  # Stan shrinkage toward (a small) I
        reg = reg * jnp.eye(d, dtype=x.dtype) if dense else reg
        var = jnp.where(n > 1, var * (n / (n + 5.0)) + reg, invmm)
        da = _da_init(jnp.exp(da.log_eps))
        return da, var, (jnp.zeros(()), jnp.zeros(d, x.dtype),
                         jnp.zeros_like(m2))

    da, invmm, welford = lax.cond(upd, refresh, lambda a: a,
                                  (da, invmm, welford))
    return (state, da, invmm, welford)


def _wa_chunk(carry, xs, kernel_factory, logdensity_fn,
              target_acceptance_rate=0.65, **kernel_kwargs):
    """Scan a chunk of window-adaptation steps; xs = (keys, update, slow)
    slices of the precomputed schedule. Pure and vmappable; host-level
    chunking keeps the trajectory identical."""

    def step(carry, xs):
        key, upd, slow = xs
        state, da, invmm, welford = carry
        kernel = kernel_factory(logdensity_fn, jnp.exp(da.log_eps), invmm,
                                **kernel_kwargs)
        state, info = kernel(key, state)
        carry = _wa_post((state, da, invmm, welford), info, upd, slow,
                         target_acceptance_rate)
        return carry, dict(
            acceptance_rate=info["acceptance_rate"],
            num_integration_steps=info.get("num_integration_steps", 0),
            position=state.position)

    return lax.scan(step, carry, xs)


def _wa_finalize(carry):
    """Final (state, params) from the window-adaptation carry."""
    state, da, invmm, _ = carry
    return state, dict(step_size=jnp.exp(da.log_eps_avg),
                       inverse_mass_matrix=invmm)


# ======================================================================= within-Gibbs
def mwg_warmup(seed, state, logdf, config, n_samples=0, progress_bar=False):
    """Per-block NUTS window adaptation: each block is warmed conditioned on
    the current values of all the others.

    state : dict of block name -> HMCState (or dict position).
    config : dict of block name -> kwargs for window_adaptation.
    Returns ((state, params), (positions, infos)).
    """
    seeds = dict(zip(state.keys(), jr.split(seed, len(state))))
    state = dict(state)
    infos = {"n_evals": 0}
    params = {}
    positions = {}

    for k in state.keys():
        union = {}
        for kk in state.keys():
            union |= _position_of(state[kk])

        def logdf_k(value, _union=dict(union)):
            return logdf({**_union, **value})

        conf = dict(config.get(k, {}))
        conf.pop("num_integration_steps", None)
        (state[k], params[k]), hist = window_adaptation(
            nuts_kernel, logdf_k, num_steps=n_samples,
            initial_position=_position_of(state[k]),
            target_acceptance_rate=conf.pop("target_acceptance_rate", 0.65),
            initial_step_size=conf.pop("initial_step_size", 1e-3),
            rng_key=seeds[k], **conf)
        n_evals = hist["num_integration_steps"]
        infos["infos_" + k] = {"acceptance_rate": hist["acceptance_rate"],
                               "num_integration_steps": n_evals}
        infos["n_evals"] += jnp.sum(n_evals)
        positions |= hist["position"]

    return (state, params), (positions, infos)


def _position_of(state):
    return state.position if isinstance(state, HMCState) else state


def mwg_kernel_general(seed, state, logdf, step_fn, init_fn, config):
    """One Metropolis-within-Gibbs sweep: update each block with its own MCMC
    kernel, conditioned on the current values of all the other blocks."""
    seeds = dict(zip(state.keys(), jr.split(seed, len(state))))
    state = dict(state)
    infos = {"n_evals": 0}

    for k in state.keys():
        union = {}
        for kk in state.keys():
            union |= _position_of(state[kk])

        def logdf_k(value, _union=dict(union)):
            return logdf({**_union, **value})

        state[k] = init_fn[k](position=_position_of(state[k]),
                              logdensity_fn=logdf_k)
        state[k], info = step_fn[k](rng_key=seeds[k], state=state[k],
                                    logdensity_fn=logdf_k, **config[k])
        infos["infos_" + k] = {"acceptance_rate": info["acceptance_rate"],
                               "num_integration_steps": info["num_integration_steps"]}
        infos["n_evals"] += info["num_integration_steps"]

    # the last-updated block's logdensity is the joint at the final union
    infos["logdensity"] = state[k].logdensity
    return state, infos


def sampling_loop_general(seed, initial_state, logdf, step_fn, init_fn, config,
                          n_samples, progress_bar=False):
    """Scan the MWG kernel for n_samples sweeps, collecting unified positions."""

    def one_step(state, key):
        state, infos = mwg_kernel_general(key, state, logdf, step_fn, init_fn, config)
        union = {}
        for k in state.keys():
            union |= _position_of(state[k])
        return state, (union, infos)

    keys = jr.split(seed, n_samples)
    return lax.scan(one_step, initial_state, keys)


def nutswg_init(logdf, kernel="NUTS", blocks=None):
    """Build (step_fn, init_fn, config, init_state_fn) for blocked NUTS/HMC.

    blocks : dict of block name -> list of site names; default a 'mesh_' block
    (field) and a 'rest_' block (scalars), the reference's split
    (samplers.py:162-236).
    """
    init_ss = 1e-3
    target = 0.65

    def make_init(name):
        def init_fn(position, logdensity_fn):
            return hmc_init(position, logdensity_fn)
        return init_fn

    def make_step(name):
        if kernel == "HMC":
            n_int = 256 if name == "mesh_" else 64

            def step_fn(rng_key, state, logdensity_fn, step_size=init_ss,
                        inverse_mass_matrix=1.0, **kw):
                return hmc_kernel(logdensity_fn, step_size, n_int,
                                  inverse_mass_matrix)(rng_key, state)
        else:
            def step_fn(rng_key, state, logdensity_fn, step_size=init_ss,
                        inverse_mass_matrix=1.0, **kw):
                return nuts_kernel(logdensity_fn, step_size,
                                   inverse_mass_matrix)(rng_key, state)
        return step_fn

    names = ["mesh_", "rest_"]
    step_fn = {k: make_step(k) for k in names}
    init_fn = {k: make_init(k) for k in names}
    config = {k: {"target_acceptance_rate": target, "initial_step_size": init_ss}
              for k in names}

    def init_state_fn(init_pos):
        return get_init_state(init_pos, logdf, init_fn, blocks)

    return step_fn, init_fn, config, init_state_fn


def get_init_state(init_pos, logdf, init_fn, blocks=None):
    """Split a flat position dict into per-block HMCStates."""
    if blocks is None:
        mesh_keys = [k for k in init_pos if k.endswith("mesh_")]
        rest_keys = [k for k in init_pos if k not in mesh_keys]
        blocks = {"mesh_": mesh_keys, "rest_": rest_keys}

    state = {}
    items = list(blocks.items())
    for name, keys in items:
        pos = {k: init_pos[k] for k in keys}
        others = {k: init_pos[k] for k in init_pos if k not in keys}
        state[name] = init_fn[name](
            position=pos, logdensity_fn=lambda x, _o=others: logdf({**x, **_o}))
    return state


def nutswg_run(seed, init_state, config, logdf, step_fn, init_fn, n_samples,
               progress_bar=False):
    last_state, (samples, infos) = sampling_loop_general(
        seed, init_state, logdf, step_fn, init_fn, config, n_samples,
        progress_bar)
    return samples, infos, last_state


def get_nutswg_run(logdf, step_fn, init_fn, n_samples, progress_bar=False):
    return partial(nutswg_run, logdf=logdf, step_fn=step_fn, init_fn=init_fn,
                   n_samples=n_samples, progress_bar=progress_bar)


def nutswg_warm(seed, init_state, logdf, config, n_samples, progress_bar=False):
    (last_state, config), (samples, infos) = mwg_warmup(
        seed, init_state, logdf, config, n_samples, progress_bar=progress_bar)
    return samples, infos, last_state, config


def get_nutswg_warm(logdf, config, n_samples, progress_bar=False):
    return partial(nutswg_warm, logdf=logdf, config=config, n_samples=n_samples,
                   progress_bar=progress_bar)
