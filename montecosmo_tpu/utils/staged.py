"""Host-staged reverse-mode differentiation of scan-shaped computations.

A monolithic `jit(value_and_grad)` of an N-step PM integration is one
device program whose runtime grows linearly with N and with mesh size.
This module chains the SAME math as `lax.scan` + `jax.checkpoint` but at
the host level: the init stage, every scan step, the loss, and each step's
transpose execute as their own jitted device program, so no single program
exceeds a few force evaluations, and per-stage times can be read off the
host clock (`stage_times`).

This is the host-level analogue of gradient checkpointing — residuals for
the reverse sweep are the forward states themselves, kept device-resident
between programs (no host round trips), and each backward step re-runs its
forward inside the transpose program exactly as `jax.checkpoint` would.

The reference reaches the same cost trade-off with diffrax's checkpointed
adjoints inside one program (montecosmo/bricks.py nbody evolution); here
the split falls on PROGRAM boundaries.
"""
import jax
from jax import tree_util


def host_scan_value_and_grad(init_fn, body_fn, loss_fn, stage_times=None):
    """value_and_grad of ``loss_fn(scan(body_fn, init_fn(arg), xs))`` with
    every stage executed as its own jitted device program.

    init_fn : arg -> state
    body_fn : (state, x) -> state        (a scan body without the ys output)
    loss_fn : state -> scalar

    Returns ``value_and_grad(arg, xs)`` where ``xs`` is a sequence of
    per-step inputs (host-side list/array; each element becomes a traced
    argument, so all steps share ONE compiled program per stage kind).
    Gradients w.r.t. ``xs`` are not computed (integrator knot times are
    not differentiated through).

    Memory: keeps the n_steps+1 intermediate states device-resident during
    the backward sweep and frees each as soon as its transpose has consumed
    it — peak ~ (n_steps+2) states, the price of O(1)-compile-size
    host-level checkpointing.

    stage_times : optional dict; when given, every stage call is
    block_until_ready-timed and appended under its stage name (profiling
    of the per-program cost split).
    """
    def _timed(name, f):
        if stage_times is None:
            return f
        import time

        def g(*a):
            t0 = time.perf_counter()
            out = jax.block_until_ready(f(*a))
            stage_times.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return g

    init_j = _timed("init", jax.jit(init_fn))
    body_j = _timed("step", jax.jit(body_fn))
    loss_vag_j = _timed("loss+vjp", jax.jit(jax.value_and_grad(loss_fn)))

    def _body_vjp(state, x, ct):
        # recompute the step forward inside the transpose program (the
        # host-level jax.checkpoint): residuals never cross programs
        _, vjp = jax.vjp(lambda s: body_fn(s, x), state)
        return vjp(ct)[0]

    def _init_vjp(arg, ct):
        _, vjp = jax.vjp(init_fn, arg)
        return vjp(ct)[0]

    body_vjp_j = _timed("step-vjp", jax.jit(_body_vjp))
    init_vjp_j = _timed("init-vjp", jax.jit(_init_vjp))

    def value_and_grad(arg, xs):
        states = [init_j(arg)]
        for x in xs:
            states.append(body_j(states[-1], x))
        value, ct = loss_vag_j(states.pop())
        for x in xs[::-1]:
            ct = body_vjp_j(states.pop(), x, ct)
        return value, init_vjp_j(arg, ct)

    return value_and_grad


def assert_same_tree(a, b, rtol=1e-5, atol=1e-6):
    """Testing helper: assert two pytrees match leaf-wise."""
    import numpy as np

    la, ta = tree_util.tree_flatten(a)
    lb, tb = tree_util.tree_flatten(b)
    assert ta == tb, f"tree mismatch: {ta} vs {tb}"
    for xa, xb in zip(la, lb):
        np.testing.assert_allclose(np.asarray(xa), np.asarray(xb),
                                   rtol=rtol, atol=atol)
