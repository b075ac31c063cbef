"""Particle-mesh gravity: Poisson forces, 1/2LPT, and the BullFrog/FastPM
growth-time leapfrog.

Design:
* Poisson solve + gradient filters are fused into one FFT pipeline (the
  kernels are numpy constants folded into the elementwise pass).
* The N-body loop is a plain `lax.scan` whose body is wrapped in
  `jax.checkpoint`, giving O(1)-per-step reverse-mode memory without the
  diffrax dependency the reference uses purely for checkpointed adjoints
  (`montecosmo/nbody.py:963-1029`).  Snapshots are collected by the scan.
* All growth lookups go through the immutable `Background` tables, so the
  whole render differentiates end-to-end w.r.t. cosmology.

Parity: reference `montecosmo/nbody.py:583-667` (pm_forces/pm_forces2/lpt),
`nbody.py:902-1029` (bullfrog_vf, nbody_bf, nbody_bf_scan),
`nbody.py:1049-1153` (lpt_fpm, adaptive solver).
"""
from functools import partial

import numpy as np
from jax import checkpoint as jax_checkpoint, lax, numpy as jnp, tree_util

from montecosmo_tpu.ops.background import Background, Cosmology, Esqr
from montecosmo_tpu.ops.fourier import (
    irfftn, rfftn,
    bspline_hat, gaussian_hat, gradient_hat, invlaplace_hat, lazy_kvec, rfftk,
)
from montecosmo_tpu.ops.hermitian import ch2rshape
from montecosmo_tpu.ops.paint import paint, read, read_multi, read_sites


def pm_forces(pos, mesh, read_order: int = 2, paint_deconv: bool = False,
              grad_fd=np.inf, lap_fd=np.inf, kcut=np.inf, lattice_shape=None,
              max_disp=8, sites_shape=None):
    """Gravitational forces at particle positions from a density mesh.

    mesh : tuple -> paint the particles first (1 paint + 1 rfft);
           rfft array -> use as the density directly.
    Solves Poisson in Fourier space and reads the 3 gradient components at the
    particle positions (3 irfft + 3 gathers).
    """
    if isinstance(mesh, tuple):
        mesh_shape = mesh
        mesh = rfftn(paint(pos, mesh_shape, order=read_order,
                                   lattice_shape=lattice_shape,
                                   max_disp=max_disp, clip=True))
        if paint_deconv:
            kvec = lazy_kvec(rfftk(mesh_shape), mesh)
            # painted AND read at this order -> deconvolve twice
            mesh /= bspline_hat(kvec, order=read_order) ** 2

    # lazy_kvec: the 1/k^2 and window kernels stage on device instead of
    # being baked into the program as N^3 literals
    kvec = lazy_kvec(rfftk(ch2rshape(mesh.shape)), mesh)
    pot = mesh * invlaplace_hat(kvec, lap_fd)
    if kcut != np.inf:
        pot *= gaussian_hat(kvec, kcut)

    # fuse the 3 component reads into one row-gather
    grads = jnp.stack(
        [irfftn(-gradient_hat(kvec, i, grad_fd) * pot)
         for i in range(len(kvec))], axis=-1)
    if sites_shape is not None and read_order <= 2:
        # pos is the exact regular lattice: strided slicing, no gathers
        return read_sites(grads, sites_shape)
    if lattice_shape is not None:
        # lattice-ordered particles (the window route, taken under a
        # device-mesh context): gather-free window read; clip matches the
        # paint above (mass-conserving clamp of displacement outliers)
        from montecosmo_tpu.ops.paint_window import read_window
        return read_window(pos.reshape(-1, grads.shape[-1]), grads,
                           lattice_shape, read_order, max_disp=max_disp,
                           clip=True)
    return read_multi(pos, grads, read_order)


def delta2_source(mesh, grad_fd=np.inf, lap_fd=np.inf):
    """2LPT source field delta2 = sum_i<j (h_ii h_jj - h_ij^2) of the potential
    Hessian h_ij = d_i d_j invlaplace(delta), assembled with 6 FFTs.

    Equivalent Fourier-space identity (validated brute-force in
    tests/test_second_order.py): delta2(k) = (1/2) sum_{k1+k2=k}
    [1 - (k1.k2)^2/(k1^2 k2^2)] delta(k1) delta(k2), zero modes excluded.
    """
    kvec = lazy_kvec(rfftk(ch2rshape(mesh.shape)), mesh)
    pot = mesh * invlaplace_hat(kvec, lap_fd)

    delta2 = 0.0
    diag_sum = 0.0
    for i in range(len(kvec)):
        # running sum of products of diagonal Hessian terms
        hess_ii = irfftn(gradient_hat(kvec, i, grad_fd) ** 2 * pot)
        delta2 += hess_ii * diag_sum
        diag_sum += hess_ii
        for j in range(i + 1, len(kvec)):
            hess_ij = gradient_hat(kvec, i, grad_fd) * gradient_hat(kvec, j, grad_fd)
            delta2 -= irfftn(hess_ij * pot) ** 2
    return delta2


def pm_forces2(pos, mesh, read_order: int = 2, grad_fd=np.inf, lap_fd=np.inf,
               sites_shape=None):
    """2LPT source-term forces: delta2 = sum_i<j (h_ii h_jj - h_ij^2) of the
    potential Hessian (6 FFTs), then Poisson forces of delta2 (1 + 3 FFTs)."""
    delta2 = delta2_source(mesh, grad_fd=grad_fd, lap_fd=lap_fd)
    return pm_forces(pos, rfftn(delta2), read_order, grad_fd=grad_fd,
                     lap_fd=lap_fd, sites_shape=sites_shape)


def lpt(bg: Background, init_mesh, pos, a, lpt_order: int = 2,
        read_order: int = 2, grad_fd=np.inf, lap_fd=np.inf, sites_shape=None):
    """1st/2nd-order LPT displacement and growth-time velocity at scale
    factor(s) `a` (List&Hahn arXiv:2409.19049 eq. 3.5/3.7).

    init_mesh is the linear density at a=1 (real or rfft space).
    Velocities are in growth-time units: vel := d(dpos)/dD1.
    """
    if jnp.isrealobj(init_mesh):
        init_mesh = rfftn(init_mesh)

    force1 = pm_forces(pos, init_mesh, read_order, grad_fd=grad_fd, lap_fd=lap_fd,
                       sites_shape=sites_shape)
    dpos = bg.a2g(a) * force1
    vel = force1

    if lpt_order == 2:
        force2 = pm_forces2(pos, init_mesh, read_order, grad_fd=grad_fd,
                            lap_fd=lap_fd, sites_shape=sites_shape)
        dpos -= bg.a2g2(a) * force2
        vel -= bg.a2dg2dg(a) * force2

    return dpos, vel


def lpt_fpm(bg: Background, init_mesh, pos, a, lpt_order: int = 1,
            read_order: int = 2, grad_fd=np.inf, lap_fd=np.inf):
    """LPT in FastPM momentum conventions: p = a^2 f E dq/dD (for solvers that
    integrate in scale-factor time)."""
    a = jnp.atleast_1d(a)
    E = jnp.sqrt(Esqr(bg.cosmo, a))
    dpos, vel = lpt(bg, init_mesh, pos, a, lpt_order, read_order, grad_fd, lap_fd)
    # convert growth-time velocity to FastPM momentum term by term
    force1 = vel if lpt_order == 1 else None
    if lpt_order == 1:
        p = a**2 * bg.a2f(a) * E * (bg.a2g(a) * force1)
    else:
        # recompute split to convert each order with its own growth rate
        if jnp.isrealobj(init_mesh):
            init_mesh = rfftn(init_mesh)
        force1 = pm_forces(pos, init_mesh, read_order, grad_fd=grad_fd, lap_fd=lap_fd)
        force2 = pm_forces2(pos, init_mesh, read_order, grad_fd=grad_fd, lap_fd=lap_fd)
        dq1 = bg.a2g(a) * force1
        dq2 = bg.a2g2(a) * force2
        p = a**2 * E * (bg.a2f(a) * dq1 - bg.a2f2(a) * dq2)
        dpos = dq1 - dq2
    return dpos, p


# ----------------------------------------------------------------------- BullFrog
def alpha_bullfrog(bg: Background, g0, dg):
    """BullFrog kick coefficient (List&Hahn arXiv:2309.10865 eq. 2.3):
    exact 2LPT-matching growth-time integrator."""
    g1 = g0 + dg / 2
    g2 = g0 + dg
    dg2dg0, dg2dg2 = bg.g2dg2dg(g0), bg.g2dg2dg(g2)
    # linearization of (D2 - D1^2)/D1 around g0, evaluated at midpoint g1
    lin_ratio = (bg.g2g2(g0) + dg2dg0 * dg / 2) / g1 - g1
    return (dg2dg2 - lin_ratio) / (dg2dg0 - lin_ratio)


def alpha_fastpm(bg: Background, g0, dg):
    """FastPM kick coefficient (List&Hahn arXiv:2309.10865 eq. 3.16)."""
    g2 = g0 + dg
    a0, a2 = bg.g2a(g0), bg.g2a(g2)
    c0 = jnp.sqrt(Esqr(bg.cosmo, a0)) * g0 * bg.g2f(g0) * a0**2
    c2 = jnp.sqrt(Esqr(bg.cosmo, a2)) * g2 * bg.g2f(g2) * a2**2
    return c0 / c2


def bullfrog_step(bg: Background, dg, mesh_shape: tuple, paint_order: int = 2,
                  paint_deconv=False, grad_fd=np.inf, lap_fd=np.inf,
                  alpha_fn=alpha_bullfrog, lattice_shape=None, max_disp=8):
    """One drift-kick-drift BullFrog step in growth time, as a scan body.

    state = (pos, vel) with vel = dpos/dD1; g0 is the step's starting growth.
    """
    def step(state, g0):
        pos, vel = state
        pos = pos + vel * (dg / 2)                                 # drift
        forces = pm_forces(pos, tuple(mesh_shape), paint_order,    # kick
                           paint_deconv=paint_deconv, grad_fd=grad_fd, lap_fd=lap_fd,
                           lattice_shape=lattice_shape, max_disp=max_disp)
        alpha = alpha_fn(bg, g0, dg)
        g1 = g0 + dg / 2
        vel = alpha * vel + (1 - alpha) * forces / g1
        pos = pos + vel * (dg / 2)                                 # drift
        return (pos, vel), None

    return step


def nbody_bf(bg: Background, init_mesh, pos, a0=0.0, a1=1.0, n_steps=5,
             paint_order: int = 2, lpt_order: int = 2, paint_deconv=False,
             grad_fd=np.inf, lap_fd=np.inf, snapshots=None, alpha_fn=alpha_bullfrog,
             checkpoint=True, lattice_shape=None, max_disp=8, sites_shape=None,
             init_read_order: int = 1):
    """BullFrog N-body from `a0` to `a1`: LPT initialization then `n_steps`
    growth-time DKD steps compiled as one (checkpointed) `lax.scan`.

    snapshots : None -> return final state with a leading singleton axis;
                int k >= 2 -> also save k states growth-equispaced in [g0,g1]
                (snapshot times snap to step boundaries);
                list of scale factors -> same, snapped to step boundaries.
    init_read_order : window order for the LPT init force reads.  The default
                NGP read is exact (and gather-cheapest) when `pos` is the
                exact integer lattice; callers starting from an OFFSET lattice
                must pass the step `paint_order` here, or the init velocity is
                a half-cell-shifted force sample, inconsistent at linear order
                with the in-step forces (measured: breaks the BullFrog
                2LPT-exactness property by ~30%/step in
                tests/test_second_order.py).
    Returns (pos, vel) stacked over snapshots on the leading axis.
    """
    n_steps = int(n_steps)
    g0 = bg.a2g(jnp.asarray(a0))
    g1 = bg.a2g(jnp.asarray(a1))
    dg = (g1 - g0) / n_steps
    gs = g0 + dg * jnp.arange(n_steps)

    mesh_shape = ch2rshape(init_mesh.shape)
    dpos, vel = lpt(bg, init_mesh, pos=pos, a=a0, lpt_order=lpt_order,
                    read_order=init_read_order, grad_fd=grad_fd, lap_fd=lap_fd,
                    sites_shape=sites_shape)
    state = (pos + dpos, vel)

    body = bullfrog_step(bg, dg, mesh_shape, paint_order,
                         paint_deconv=paint_deconv, grad_fd=grad_fd,
                         lap_fd=lap_fd, alpha_fn=alpha_fn,
                         lattice_shape=lattice_shape, max_disp=max_disp)
    if checkpoint:
        body = jax_checkpoint(body)  # O(1) per-step reverse-mode memory

    if snapshots is None or (isinstance(snapshots, int) and snapshots <= 1):
        state, _ = lax.scan(body, state, gs)
        return tree_util.tree_map(lambda x: x[None], state)

    # map requested snapshot times to step-end indices
    if isinstance(snapshots, int):
        ts = np.linspace(0.0, 1.0, snapshots)
        idx = np.rint(ts * (n_steps - 1)).astype(int)
        take = np.zeros(n_steps, bool)
        take[idx] = True
        n_save = int(take.sum())

        def body_save(state, g0_):
            state, _ = body(state, g0_)
            return state, state

        state, states = lax.scan(body_save, state, gs)
        states = tree_util.tree_map(lambda x: x[np.flatnonzero(take)], states)
        return states

    # explicit list of scale factors
    g_req = bg.a2g(jnp.asarray(snapshots))
    step_ends = g0 + dg * (jnp.arange(n_steps) + 1)
    idx = jnp.argmin(jnp.abs(step_ends[None, :] - g_req[:, None]), axis=-1)

    def body_save(state, g0_):
        state, _ = body(state, g0_)
        return state, state

    state, states = lax.scan(body_save, state, gs)
    return tree_util.tree_map(lambda x: x[idx], states)


def nbody_bf_lightcone(bg: Background, init_mesh, pos, g_tgt, a0=0.0, a1=1.0,
                       n_steps=5, paint_order: int = 2, lpt_order: int = 2,
                       paint_deconv=False, grad_fd=np.inf, lap_fd=np.inf,
                       alpha_fn=alpha_bullfrog, checkpoint=True,
                       lattice_shape=None, max_disp=8, sites_shape=None,
                       init_read_order: int = 1):
    """BullFrog N-body evaluated on the light-cone: each particle's (pos, vel)
    linearly interpolated — in growth factor, matching the growth-equispaced
    DKD steps — between the two step-boundary states bracketing its crossing
    growth `g_tgt` (shape broadcastable to pos[..., :1], clipped to [g0, g1]).

    Beyond-reference capability: the reference asserts this out
    (model.py:770 "N-body light-cone not implemented yet").

    Shell interpolation: the hat weights w_i(g) = relu(1-|g-g_i|/dg) over
    the uniform step-boundary growth grid form a partition of unity, so the
    blend is STREAMED inside the scan carry (acc += w_i * state_i) — O(P)
    memory, no (n_steps, P, 3) snapshot stack, and no gathers.
    """
    n_steps = int(n_steps)
    g0 = bg.a2g(jnp.asarray(a0))
    g1 = bg.a2g(jnp.asarray(a1))
    dg = (g1 - g0) / n_steps
    gs = g0 + dg * jnp.arange(n_steps)

    mesh_shape = ch2rshape(init_mesh.shape)
    dpos, vel = lpt(bg, init_mesh, pos=pos, a=a0, lpt_order=lpt_order,
                    read_order=init_read_order, grad_fd=grad_fd, lap_fd=lap_fd,
                    sites_shape=sites_shape)
    state = (pos + dpos, vel)

    gt = jnp.clip(g_tgt, g0, g1)

    def hat(gi):
        return jnp.maximum(0.0, 1.0 - jnp.abs(gt - gi) / dg)

    w = hat(g0)
    acc = (w * state[0], w * state[1])

    body = bullfrog_step(bg, dg, mesh_shape, paint_order,
                         paint_deconv=paint_deconv, grad_fd=grad_fd,
                         lap_fd=lap_fd, alpha_fn=alpha_fn,
                         lattice_shape=lattice_shape, max_disp=max_disp)

    def body_lc(carry, g0_):
        state, acc = carry
        state, _ = body(state, g0_)
        w = hat(g0_ + dg)
        acc = (acc[0] + w * state[0], acc[1] + w * state[1])
        return (state, acc), None

    if checkpoint:
        body_lc = jax_checkpoint(body_lc)  # O(1) per-step reverse-mode memory

    (_, acc), _ = lax.scan(body_lc, (state, acc), gs)
    return acc


def nbody_bf_scan(bg: Background, init_mesh, pos, a, n_steps=5, paint_order: int = 2,
                  grad_fd=np.inf, lap_fd=np.inf):
    """Minimal BullFrog driver: velocity initialized from the Zel'dovich force
    at g=0 (no LPT pre-displacement), plain scan from g=0 to g(a)."""
    g = bg.a2g(jnp.asarray(a))
    dg = g / n_steps
    gs = dg * jnp.arange(n_steps)

    mesh_shape = ch2rshape(init_mesh.shape)
    vel = pm_forces(pos, init_mesh, paint_order, grad_fd=grad_fd, lap_fd=lap_fd)
    body = bullfrog_step(bg, dg, mesh_shape, paint_order, grad_fd=grad_fd, lap_fd=lap_fd)
    state, _ = lax.scan(body, (pos, vel), gs)
    return tree_util.tree_map(lambda x: x[None], state)


# ----------------------------------------------------------------------- adaptive
def nbody_rk4(bg: Background, init_mesh, pos, a0, a1, n_steps=16,
              paint_order: int = 2, grad_fd=4, lap_fd=np.inf):
    """Fixed-step RK4 N-body in scale-factor time (replacement for the
    reference's adaptive Tsit5 path, which exists for validation, not speed:
    `montecosmo/nbody.py:1126-1153`).  Uses FastPM momentum conventions."""
    mesh_shape = ch2rshape(init_mesh.shape)
    dpos, vel = lpt_fpm(bg, init_mesh, pos=pos, a=a0, lpt_order=1,
                        read_order=paint_order, grad_fd=grad_fd, lap_fd=lap_fd)
    pos = pos + dpos
    if a0 == a1:
        return tree_util.tree_map(lambda x: x[None], (pos, vel))

    cosmo = bg.cosmo

    def vf(state, a):
        pos, vel = state
        E = jnp.sqrt(Esqr(cosmo, a))
        forces = pm_forces(pos, tuple(mesh_shape), paint_order,
                           grad_fd=grad_fd, lap_fd=lap_fd) * 1.5 * cosmo.Omega_m
        return (vel / (a**3 * E), forces / (a**2 * E))

    da = (a1 - a0) / n_steps

    def step(state, a):
        def add(s, ds, c):
            return tree_util.tree_map(lambda x, d: x + c * d, s, ds)
        k1 = vf(state, a)
        k2 = vf(add(state, k1, da / 2), a + da / 2)
        k3 = vf(add(state, k2, da / 2), a + da / 2)
        k4 = vf(add(state, k3, da), a + da)
        state = tree_util.tree_map(
            lambda x, d1, d2, d3, d4: x + da / 6 * (d1 + 2 * d2 + 2 * d3 + d4),
            state, k1, k2, k3, k4)
        return state, None

    state, _ = lax.scan(jax_checkpoint(step), (pos, vel), a0 + da * jnp.arange(n_steps))
    return tree_util.tree_map(lambda x: x[None], state)


# Tsitouras 5(4) embedded pair (Tsitouras 2011, standard published tableau).
_TS_C = (0.161, 0.327, 0.9, 0.9800255409045097, 1.0)
_TS_A = (
    (0.161,),
    (-0.008480655492356989, 0.335480655492357),
    (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
    (5.325864828439257, -11.748883564062828, 7.4955393428898365,
     -0.09249506636175525),
    (5.86145544294642, -12.92096931784711, 8.159367898576159,
     -0.071584973281401, -0.028269050394068383),
)
_TS_B = (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
         -3.290069515436081, 2.324710524099774, 0.0)
_TS_BTILDE = (  # b - b_hat: weights of the embedded 4th-order error estimate
    -0.00178001105222577714, -0.0008164344596567469, 0.007880878010261995,
    -0.1447110071732629, 0.5823571654525552, -0.45808210592918697,
    1.0 / 66.0)


def nbody_tsit5(bg: Background, init_mesh, pos, a0, a1, tol=1e-3,
                paint_order: int = 2, grad_fd=4, lap_fd=np.inf,
                snapshots=None, max_steps=100, safety=0.9,
                pcoeff=0.4, icoeff=1.0):
    """Adaptive-step N-body: Tsit5 embedded pair + PI step-size control.

    Replacement for the reference's diffrax path
    (`montecosmo/nbody.py:1126-1153`, Tsit5 + PIDController(0.4, 1, 0)):
    a fixed-length `lax.scan` whose iterations accept/reject via masking
    (static shapes, reverse-differentiable through `jax.checkpoint`), with
    FSAL reuse (stage 7 of an accepted step is stage 1 of the next, so each
    step costs 6 force evaluations).  Like the reference this is a
    validation integrator — production runs use `nbody_bf`.

    snapshots: None -> final state only; int n -> n states at
    linspace(a0, a1, n); list -> states at those scale factors.  Snapshot
    edges are integrated as chained segments sharing the controller state.
    Returns a pytree (pos, vel) with a leading snapshot axis.
    """
    mesh_shape = ch2rshape(init_mesh.shape)
    dpos, vel = lpt_fpm(bg, init_mesh, pos=pos, a=a0, lpt_order=1,
                        read_order=paint_order, grad_fd=grad_fd, lap_fd=lap_fd)
    pos = pos + dpos
    if a0 == a1:
        return tree_util.tree_map(lambda x: x[None], (pos, vel))

    cosmo = bg.cosmo
    order = 5.0  # min(solver, embedded) + 1 — controller exponent base

    def vf(state, a):
        pos, vel = state
        E = jnp.sqrt(Esqr(cosmo, a))
        forces = pm_forces(pos, tuple(mesh_shape), paint_order,
                           grad_fd=grad_fd, lap_fd=lap_fd) * 1.5 * cosmo.Omega_m
        return (vel / (a**3 * E), forces / (a**2 * E))

    def axpy(y, ks, coefs, dt):
        """y + dt * sum(c_i k_i) over the state pytree."""
        return tree_util.tree_map(
            lambda yl, *kl: yl + dt * sum(c * k for c, k in zip(coefs, kl)),
            y, *ks)

    def err_norm(y0, y1, ks, dt):
        """RMS of the embedded error scaled by atol + rtol*max(|y0|,|y1|)."""
        sq_sum = 0.0
        count = 0
        for leaf0, leaf1, *kl in zip(tree_util.tree_leaves(y0),
                                     tree_util.tree_leaves(y1),
                                     *[tree_util.tree_leaves(k) for k in ks]):
            e = dt * sum(c * k for c, k in zip(_TS_BTILDE, kl))
            scale = tol + tol * jnp.maximum(jnp.abs(leaf0), jnp.abs(leaf1))
            sq_sum += jnp.sum((e / scale) ** 2)
            count += leaf0.size
        return jnp.sqrt(sq_sum / count)

    def segment(y, a_lo, a_hi, dt, err_prev, k1, n_acc, n_rej):
        """Adaptively integrate one [a_lo, a_hi] snapshot segment."""
        span = a_hi - a_lo

        def step(carry, _):
            y, a, dt, err_prev, k1, n_acc, n_rej = carry

            def do_step(y, a, dt, err_prev, k1, n_acc, n_rej):
                dt_eff = jnp.minimum(dt, a_hi - a)  # clip the last step
                ks = [k1]
                for ci, ai in zip(_TS_C, _TS_A):
                    ks.append(vf(axpy(y, ks, ai, dt_eff), a + ci * dt_eff))
                y1 = axpy(y, ks, _TS_B[:6], dt_eff)  # b7 = 0
                k7 = vf(y1, a + dt_eff)
                err = err_norm(y, y1, ks + [k7], dt_eff)
                err = jnp.where(jnp.isfinite(err), err, 2.0)  # reject NaN steps

                accept = err <= 1.0
                # PI controller (reference: PIDController(0.4, 1, 0))
                e_n = jnp.maximum(err, 1e-10)
                factor = safety * e_n ** (-(icoeff + pcoeff) / order) \
                    * jnp.maximum(err_prev, 1e-10) ** (pcoeff / order)
                dt_next = dt * jnp.clip(factor, 0.2, 10.0)

                y = tree_util.tree_map(
                    lambda old, new: jnp.where(accept, new, old), y, y1)
                k1 = tree_util.tree_map(
                    lambda old, new: jnp.where(accept, new, old), k1, k7)
                a = jnp.where(accept, a + dt_eff, a)
                err_prev = jnp.where(accept, e_n, err_prev)
                return (y, a, dt_next, err_prev, k1,
                        n_acc + accept, n_rej + (1 - accept))

            done = a >= a_hi - 1e-7 * span
            carry = lax.cond(
                done,
                lambda *s: s,
                do_step,
                y, a, dt, err_prev, k1, n_acc, n_rej)
            return carry, None

        carry = (y, jnp.asarray(a_lo, jnp.float32), dt, err_prev, k1,
                 n_acc, n_rej)
        carry, _ = lax.scan(jax_checkpoint(step), carry, None,
                            length=max_steps)
        y, a, dt, err_prev, k1, n_acc, n_rej = carry
        return y, dt, err_prev, k1, n_acc, n_rej

    if snapshots is None or (isinstance(snapshots, int) and snapshots < 2):
        ts = np.asarray([a1], float)  # SaveAt(t1=True) semantics
    elif isinstance(snapshots, int):
        ts = np.linspace(a0, a1, snapshots)
    else:
        ts = np.asarray(snapshots, float)

    y = (pos, vel)
    k1 = vf(y, jnp.asarray(a0, jnp.float32))
    dt = jnp.asarray((a1 - a0) / 20.0, jnp.float32)
    err_prev = jnp.asarray(1.0, jnp.float32)
    n_acc = n_rej = jnp.asarray(0, jnp.int32)

    saves, a_cur = [], float(a0)
    for t in ts:  # chained segments, shared controller state
        if t > a_cur:
            y, dt, err_prev, k1, n_acc, n_rej = segment(
                y, a_cur, float(t), dt, err_prev, k1, n_acc, n_rej)
            a_cur = float(t)
        saves.append(y)

    return tree_util.tree_map(lambda *xs: jnp.stack(xs), *saves)
