"""Fully decomposed (pod-scale) forward render: white noise -> linear field ->
Zel'dovich displacement -> painted density, with every mesh X-sharded over a
device-mesh axis and all cross-shard traffic on explicit collectives.

This is the config-5 pipeline (SURVEY §6): a mesh too large for one chip
flows through

    pencil rfftn (1 all_to_all)  ->  per-shard Fourier kernels
    -> 3 pencil irfftn gradients ->  per-slab Zel'dovich displacement
    -> halo-exchanged painting (2 ppermute)

without ever materializing a full mesh on one device.  Lattice particles are
slab-owned by construction; the paint halo must cover the largest
displacement (asserted by `max_disp`).

`sharded_bullfrog_steps` extends this with decomposed PM gravity (each DKD
step is halo paint -> pencil Poisson -> halo read) and an optional
fixed-capacity neighbor resort that re-owns boundary-crossing particles.
`sharded_lpt_observable` adds the 3rd-order Lagrangian bias expansion and
flat-sky RSD on the same layout.  Round-2 extensions: PNG + velocity-bias
operators, survey selection, and a ShardedFieldLevelModel wrapping the full
logpdf gradient.
"""
from functools import partial

import numpy as np
import jax
from jax import lax, numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from montecosmo_tpu.ops.background import Background
from montecosmo_tpu.ops.fourier import gradient_hat, invlaplace_hat
from montecosmo_tpu.parallel.fft import (
    _pencil_irfftn_local, _pencil_rfftn_local, pencil_rfftk,
)
from montecosmo_tpu.parallel.halo import halo_paint_local, halo_paint_window_local
from montecosmo_tpu.utils.safe import safe_div


def _delta2_local(pot, kvec, axis_name):
    """2LPT source delta2 = sum_{i<j} (h_ii h_jj - h_ij^2) of the potential
    Hessian, on the pencil layout (6 pencil irfftns).  Mirrors the fused
    running-sum form of `ops.pm.pm_forces2`."""
    delta2 = 0.0
    diag_sum = 0.0
    for i in range(3):
        h_ii = _pencil_irfftn_local(gradient_hat(kvec, i) ** 2 * pot, axis_name)
        delta2 += h_ii * diag_sum
        diag_sum += h_ii
        for j in range(i + 1, 3):
            h_ij = gradient_hat(kvec, i) * gradient_hat(kvec, j)
            delta2 -= _pencil_irfftn_local(h_ij * pot, axis_name) ** 2
    return delta2


def _linear_local(local, rshape, box_size, pow_interp, axis_name):
    """White noise slab -> linear field in pencil Fourier space.
    rfftn(N(0,I)) has E|.|^2 = n; delta_lin needs E|.|^2 = P(k) n^2/V
    -> multiply by sqrt(P(k) * n/V)."""
    k = _pencil_rfftn_local(local, axis_name)
    kvec = pencil_rfftk(rshape, box_size, axis_name)
    kmesh = sum(ki**2 for ki in kvec) ** 0.5
    cell_per_box = np.prod(np.divide(rshape, box_size))
    return k * (pow_interp(kmesh) * cell_per_box) ** 0.5, kvec


def _disp_local(lin, kvec, cell, lpt_order, axis_name, dtype):
    """1st (and optionally 2nd) order LPT force fields in cell units on the
    slab layout.  Returns (grads1, grads2-or-None): displacement =
    D1*grads1 - D2*grads2, growth-time velocity = grads1 - (dD2/dD1)*grads2."""
    pot = lin * invlaplace_hat(kvec)
    grads1 = [
        _pencil_irfftn_local(-gradient_hat(kvec, i) * pot, axis_name)
        / jnp.asarray(cell[i], dtype)
        for i in range(3)]  # h/Mpc kernels -> cell-unit displacement

    grads2 = None
    if lpt_order == 2:
        delta2 = _delta2_local(pot, kvec, axis_name)
        pot2 = _pencil_rfftn_local(delta2, axis_name) * invlaplace_hat(kvec)
        grads2 = [
            _pencil_irfftn_local(-gradient_hat(kvec, i) * pot2, axis_name)
            / jnp.asarray(cell[i], dtype)
            for i in range(3)]
    return grads1, grads2


def _local_lattice(rshape, axis_name):
    """This shard's slab of the global cell lattice, (X/P, Y, Z, 3)."""
    p = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    nx_local = rshape[0] // p
    ax = (idx * nx_local).astype(jnp.float32) + jnp.arange(
        nx_local, dtype=jnp.float32)
    ay = jnp.arange(rshape[1], dtype=jnp.float32)
    az = jnp.arange(rshape[2], dtype=jnp.float32)
    return jnp.stack(jnp.meshgrid(ax, ay, az, indexing="ij"), -1)




def _paint_local(pos, rshape, weights, order, axis_name, halo, method="auto"):
    """Paint the slab's lattice-ordered particles: scatter-free window matmuls
    (ops.paint_window via halo_paint_window_local) when the halo covers the
    window margin, else the scatter path.  Callers whose particles are NOT
    lattice-ordered (post-resort N-body) must pass method="scatter"."""
    md = halo - (order // 2 + 2)
    # window only when the bound is meaningful (>= 4 cells); tighter halos
    # would clip real displacements — fall back to the scatter
    if method != "scatter" and md >= 4:
        return halo_paint_window_local(pos, rshape, rshape, weights=weights,
                                       order=order, axis_name=axis_name,
                                       halo=halo, max_disp=md, clip=True)
    return halo_paint_local(pos, rshape, weights=weights, order=order,
                            axis_name=axis_name, halo=halo)

def sharded_zeldovich_density(white, bg: Background, box_size, a, mesh: Mesh,
                              pow_interp, axis_name="mesh", halo=8,
                              paint_order=2, lpt_order=1):
    """LPT-evolved density from an X-sharded real white-noise mesh.

    white      : (X, Y, Z) real unit-variance white noise, X-sharded.
    pow_interp : callable k -> P(k) [(Mpc/h)^3] (e.g. ops.power.lin_power_interp).
    lpt_order  : 1 (Zel'dovich) or 2 (adds the delta2 displacement via 6
                 Hessian + 1 forward + 3 gradient pencil FFTs).
    Returns the painted (1 + delta) mesh, X-sharded.
    """
    rshape = tuple(int(s) for s in white.shape)
    growth = bg.a2g(jnp.asarray(a))
    growth2 = bg.a2g2(jnp.asarray(a))
    cell = np.divide(box_size, rshape)

    def body(local):
        lin, kvec = _linear_local(local, rshape, box_size, pow_interp,
                                  axis_name)
        grads1, grads2 = _disp_local(lin, kvec, cell, lpt_order, axis_name,
                                     local.dtype)
        disp = growth * jnp.stack(grads1, -1)
        if grads2 is not None:
            disp -= growth2 * jnp.stack(grads2, -1)

        pos = (_local_lattice(rshape, axis_name) + disp).reshape(-1, 3)
        return _paint_local(pos, rshape, weights=1.0, order=paint_order,
                                axis_name=axis_name, halo=halo)

    # jit: stages kernel construction and avoids per-op dispatch
    fn = jax.jit(jax.shard_map(body, mesh=mesh,
                               in_specs=P(axis_name, None, None),
                               out_specs=P(axis_name, None, None)))
    return fn(white)


def sharded_lpt_observable(white, bg: Background, box_size, a, mesh: Mesh,
                           pow_interp, bias=None, rsd=False, png=None,
                           fNL=0.0, axis_name="mesh", halo=8, paint_order=2,
                           ap=None,
                           lpt_order=1):
    """Biased, optionally redshift-space density on the decomposed layout:
    white -> linear -> LPT displacement + Lagrangian bias weights (operators
    evaluated at the lattice nodes, renormalized with pmean'd variances) ->
    flat-sky RSD along z -> halo paint.

    bias : dict with any of b1, b2, bs2, b3, bds2, bs3, bn2 (missing -> 0);
           the same 3rd-order expansion as `models.bricks.lagrangian_bias`.
    png  : optional dict of fNL_bp/fNL_bpd/fNL_bpd2/fNL_bps2/fNL_bn2p PNG
           bias amplitudes; fNL adds local primordial non-Gaussianity to the
           linear field itself (bricks.add_png).  Velocity bias (bnpar)
           stays on the single-device path for now.
    rsd  : flat-sky redshift-space shift along the unsharded z axis
           (growth-time velocity x D f, as `models.bricks.rsd`) — particle
    ownership is unchanged, so no extra exchange is needed.
    Returns the painted weighted density, X-sharded.
    """
    body = _observable_body(tuple(int(s) for s in white.shape), box_size, bg,
                            a, pow_interp, bias, rsd, axis_name, halo,
                            paint_order, lpt_order, ap=ap, png=png, fNL=fNL)
    # jit: stages kernel construction and avoids per-op dispatch
    fn = jax.jit(jax.shard_map(body, mesh=mesh,
                               in_specs=P(axis_name, None, None),
                               out_specs=P(axis_name, None, None)))
    return fn(white)


def _observable_body(rshape, box_size, bg, a, pow_interp, bias, rsd,
                     axis_name, halo, paint_order, lpt_order, ap=None,
                     png=None, fNL=0.0):
    """Per-shard biased(+RSD) observable render, for composition inside a
    single shard_map (see sharded_lpt_observable / sharded_field_logpdf).

    png : optional dict of PNG bias amplitudes (fNL_bp, fNL_bpd, fNL_bpd2,
          fNL_bps2, fNL_bn2p; missing -> 0) — builds the primordial-potential
          operator fields (2 extra pencil FFTs).
    fNL : local primordial non-Gaussianity amplitude applied to the linear
          field itself, phi -> phi + fNL (phi^2 - <phi^2>) as
          `models.bricks.add_png` (2 extra pencil FFTs + one pmean).
    """
    from montecosmo_tpu.models.bricks import trans_phi2delta_interp

    bias = dict(bias or {})
    known = ("b1", "b2", "bs2", "b3", "bds2", "bs3", "bn2", "bnpar")
    unknown = set(bias) - set(known)
    assert not unknown, f"unknown bias keys {sorted(unknown)}; supported: {known}"
    b = {k: jnp.asarray(bias.get(k, 0.0), jnp.float32) for k in known}
    use_bnpar = bias.get("bnpar", 0.0) != 0.0
    png_dict = dict(png or {})
    png_known = ("fNL_bp", "fNL_bpd", "fNL_bpd2", "fNL_bps2", "fNL_bn2p")
    png_unknown = set(png_dict) - set(png_known)
    assert not png_unknown, (
        f"unknown png keys {sorted(png_unknown)}; supported: {png_known}")
    fp = {k: jnp.asarray(png_dict.get(k, 0.0), jnp.float32)
          for k in png_known}
    use_png = png is not None
    use_fnl = not (isinstance(fNL, (int, float)) and fNL == 0.0)
    trans_fn = (trans_phi2delta_interp(bg.cosmo, bg=bg)
                if (use_png or use_fnl) else None)

    growth = bg.a2g(jnp.asarray(a))
    growth2 = bg.a2g2(jnp.asarray(a))
    dg2dg = bg.a2dg2dg(jnp.asarray(a))
    f_growth = bg.a2f(jnp.asarray(a))
    cell = np.divide(box_size, rshape)

    def body(local):
        lin, kvec = _linear_local(local, rshape, box_size, pow_interp,
                                  axis_name)
        kmesh = sum(ki**2 for ki in kvec) ** 0.5
        if use_fnl:
            # phi -> phi + fNL (phi^2 - <phi^2>)   (bricks.add_png)
            trans = trans_fn(jnp.broadcast_to(kmesh, lin.shape))
            phi0 = _pencil_irfftn_local(safe_div(lin, trans), axis_name)
            phi2 = phi0**2
            phi0 = phi0 + fNL * (phi2 - lax.pmean(phi2.mean(), axis_name))
            lin = trans * _pencil_rfftn_local(phi0, axis_name)
        grads1, grads2 = _disp_local(lin, kvec, cell, lpt_order, axis_name,
                                     local.dtype)

        # ---- Lagrangian operator fields at the lattice nodes (pointwise on
        # the slab after each pencil irfftn; matches lagrangian_bias's
        # read_multi at lattice positions exactly)
        pot = lin * invlaplace_hat(kvec)
        shear = {}
        for i in range(2):
            nabi = gradient_hat(kvec, i)
            shear[(i, i)] = _pencil_irfftn_local(nabi**2 * pot - lin / 3,
                                                 axis_name)
            for j in range(i + 1, 3):
                nabj = gradient_hat(kvec, j)
                shear[(i, j)] = _pencil_irfftn_local(nabi * nabj * pot,
                                                     axis_name)
        shear[(2, 2)] = -(shear[(0, 0)] + shear[(1, 1)])
        sa, sb, sc = shear[(0, 0)], shear[(1, 1)], shear[(2, 2)]
        sd, se, sf = shear[(0, 1)], shear[(0, 2)], shear[(1, 2)]

        delta = _pencil_irfftn_local(lin, axis_name) * growth
        shear2 = (sa**2 + sb**2 + sc**2
                  + 2 * (sd**2 + se**2 + sf**2)) * growth**2
        shear3 = 3 * (sa * (sb * sc - sf**2) - sd * (sd * sc - se * sf)
                      + se * (sd * sf - sb * se)) * growth**3
        kmesh2 = sum(ki**2 for ki in kvec)
        delta_nab2 = _pencil_irfftn_local(-kmesh2 * lin, axis_name) * growth

        # global renormalization: <delta^2> over the full mesh via pmean
        sigma2 = lax.pmean((delta**2).mean(), axis_name)
        delta2 = delta**2 - sigma2
        shear2 = shear2 - 2 / 3 * sigma2  # <s^2> = 2/3 <delta^2>

        weights = (1.0 + b["b1"] * delta + b["b2"] * delta2 / 2
                   + b["bs2"] * shear2
                   + b["b3"] * (delta**3 - 3 * sigma2 * delta) / 6
                   + b["bds2"] * delta * shear2 + b["bs3"] * shear3
                   + b["bn2"] * delta_nab2)

        if use_png:
            # primordial-potential operators (lagrangian_bias, png branch)
            trans = trans_fn(jnp.broadcast_to(kmesh, lin.shape))
            phi = _pencil_irfftn_local(safe_div(lin, trans), axis_name)
            phi_nab2 = _pencil_irfftn_local(-kmesh2 * safe_div(lin, trans),
                                            axis_name)
            phi_delta = phi * delta
            sigma_pd = lax.pmean(phi_delta.mean(), axis_name)
            weights += fp["fNL_bp"] * phi
            weights += fp["fNL_bpd"] * (phi_delta - sigma_pd)
            weights += fp["fNL_bpd2"] * (phi * delta2 - 2 * sigma_pd * delta)
            weights += fp["fNL_bps2"] * phi * shear2
            weights += fp["fNL_bn2p"] * phi_nab2

        # ---- displacement (+ flat-sky RSD along the unsharded z axis)
        disp = growth * jnp.stack(grads1, -1)
        vel_z = grads1[2]
        if grads2 is not None:
            disp -= growth2 * jnp.stack(grads2, -1)
            vel_z = vel_z - dg2dg * grads2[2]
        if rsd:
            shift_z = growth * f_growth * vel_z
            if use_bnpar:
                # higher-derivative velocity bias: dvel = bnpar grad(delta) D
                # (h/Mpc, bricks.py lagrangian_bias) -> cell units along z
                gradz = _pencil_irfftn_local(gradient_hat(kvec, 2) * lin,
                                             axis_name)
                shift_z = shift_z + (b["bnpar"] * growth * gradz
                                     / jnp.asarray(cell[2], local.dtype))
            disp = disp.at[..., 2].add(shift_z)

        pos = _local_lattice(rshape, axis_name) + disp
        if ap is not None:
            # flat-sky parametric AP about the box center (model.py applies
            # AP after RSD too): z scales by alpha_par, x/y by alpha_perp.
            # |alpha - 1| * extent/2 must stay inside the halo/window margin
            # (the small-alpha regime AP is used in).
            from montecosmo_tpu.models.bricks import isoap2parperp
            apar, aperp = isoap2parperp(ap["alpha_iso"], ap["alpha_ap"])
            scale = jnp.stack([aperp, aperp, apar]).astype(pos.dtype)
            center = jnp.asarray(rshape, pos.dtype) / 2
            pos = center + scale * (pos - center)
        pos = pos.reshape(-1, 3)
        return _paint_local(pos, rshape, weights.reshape(-1), paint_order,
                            axis_name, halo)

    return body


def sharded_pm_forces_local(pos, rshape, axis_name="mesh", paint_order=2,
                            halo=4, weights=1.0):
    """PM forces at slab-owned particle positions, fully decomposed (call
    inside shard_map): halo paint -> pencil Poisson -> 3 pencil gradient
    irfftns -> halo read.  Cell-unit kernels (matches `ops.pm.pm_forces`
    painting from a tuple)."""
    from montecosmo_tpu.parallel.halo import halo_read_local

    dens = halo_paint_local(pos, rshape, weights=weights, order=paint_order,
                            axis_name=axis_name, halo=halo)
    k = _pencil_rfftn_local(dens, axis_name)
    kvec = pencil_rfftk(rshape, None, axis_name)  # cell units
    pot = k * invlaplace_hat(kvec)
    forces = []
    for i in range(3):
        g = _pencil_irfftn_local(-gradient_hat(kvec, i) * pot, axis_name)
        forces.append(halo_read_local(pos, g, order=paint_order,
                                      axis_name=axis_name, halo=halo))
    return jnp.stack(forces, -1)


def sharded_field_logpdf(white, obs, bg: Background, box_size, a, mesh: Mesh,
                         pow_interp, bias=None, rsd=False, noise_std=1.0,
                         lik_type="gauss", selection=None, ngbar=1.0,
                         png=None, fNL=0.0, axis_name="mesh", halo=8,
                         paint_order=2, lpt_order=1, stoch=None, ap=None):
    """Fully decomposed field-level log-posterior: standard-normal prior on
    the X-sharded white-noise latent plus a field likelihood on the biased
    (RSD) observable, reduced with one psum.

    lik_type  : 'gauss' (obs ~ N(dens, noise_std), masked by selection > 0),
                'poisson' (obs ~ Poisson(ngbar * selection * dens), floored
                at 1e-6 for log safety), or the pointwise stochasticity
                families of the single-chip model — 'quad_gauss',
                'two_quad_gauss', 'shash' (models/distributions.py run
                directly on the local slab; `stoch` supplies
                s_e / s_ed / s_e2, mirroring FieldLevelModel.likelihood).
    selection : optional X-sharded response/mask mesh multiplying the mean
                (None -> unit coverage).

    Differentiable end-to-end: jax.grad flows through the halo exchanges,
    the pencil all_to_alls, and the pmean renormalizations, so
    value_and_grad of this IS the pod-scale training step.  Render and
    reduction live in ONE shard_map so reverse-mode sees a single
    collective program.
    Returns a replicated scalar.
    """
    assert lik_type in ("gauss", "poisson", "quad_gauss",
                        "two_quad_gauss", "shash"), lik_type
    stoch = {"s_e": 1.0, "s_ed": 0.0, "s_e2": 0.0, **(stoch or {})}
    render = _observable_body(tuple(int(s) for s in white.shape), box_size,
                              bg, a, pow_interp, bias, rsd, axis_name, halo,
                              paint_order, lpt_order, ap=ap, png=png, fNL=fNL)

    def logp_local(w_local, o_local, sel_local):
        d_local = render(w_local)
        prior = -0.5 * jnp.sum(w_local**2)
        if lik_type == "gauss":
            resid = (sel_local * d_local - o_local) * (sel_local > 0)
            lik = -0.5 * jnp.sum(resid**2) / noise_std**2
        elif lik_type == "poisson":  # rate = ngbar * selection * dens
            rate = jnp.maximum(ngbar * sel_local * d_local, 1e-6)
            lik = jnp.sum(o_local * jnp.log(rate) - rate)
        else:
            # pointwise stochasticity families (model.py likelihood):
            # loc = ngbar * sel * dens, scale1 = |s_e + s_ed delta| sel^0.5
            from montecosmo_tpu.models.distributions import (
                QuadGaussian, SinhArcsinh, TwoQuadGaussian,
            )
            loc = ngbar * sel_local * d_local
            sel_sqrt = jnp.sqrt(jnp.maximum(sel_local, 0.0)) \
                * jnp.sqrt(jnp.asarray(ngbar, loc.dtype))
            s1 = jnp.abs(stoch["s_e"] + stoch["s_ed"] * (d_local - 1.0)) \
                * sel_sqrt + 1e-9
            s2 = stoch["s_e2"] * sel_sqrt
            if lik_type == "quad_gauss":
                dist = QuadGaussian(loc, s1, s2)
            elif lik_type == "two_quad_gauss":
                dist = TwoQuadGaussian(loc, s1, s2)
            else:
                ratio = s2 / s1
                dist = SinhArcsinh(loc, (s1**2 + 2 * s2**2) ** 0.5,
                                   3.540 * ratio, 1 + 5.884 * ratio**2)
            lik = jnp.sum(dist.log_prob(o_local))
        return lax.psum(prior + lik, axis_name)

    if selection is None:
        selection = jnp.ones((), white.dtype)
        sel_spec = P()
    else:
        sel_spec = P(axis_name, None, None)

    # check_vma=False: the fft transpose rule drops the varying-axes type,
    # which trips the vma checker in reverse mode (forward is unaffected);
    # collectives are still lowered identically.
    fn = jax.jit(jax.shard_map(
        logp_local, mesh=mesh,
        in_specs=(P(axis_name, None, None), P(axis_name, None, None),
                  sel_spec),
        out_specs=P(), check_vma=False))
    return fn(white, obs, selection)


def _resort_local(pos, vel, valid, rshape, axis_name, cap_face):
    """Neighbor particle exchange (call inside shard_map): re-own particles
    whose base cell drifted into the next/previous X-slab.

    Fixed-capacity design (static shapes for XLA): each face sends a padded
    (cap_face, 7) buffer [pos, vel, valid] via `ppermute`; the merged set is
    compacted back to the local capacity by a valid-first argsort.  Contract:
    per-resort drift < one slab width (particles that skip a slab are dropped
    — visible as mass loss, never silent corruption).
    Returns (pos, vel, valid) with the same shapes.
    """
    p = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    nx_local = rshape[0] // p
    span = jnp.asarray(rshape, pos.dtype)

    # wrap periodically; park invalid slots at the slab start so downstream
    # paint indexing stays in range (their weight is 0 anyway)
    park = jnp.stack([(idx * nx_local).astype(pos.dtype),
                      jnp.zeros((), pos.dtype), jnp.zeros((), pos.dtype)])
    pos = jnp.where(valid[:, None], pos % span, park)

    owner = (jnp.floor(pos[:, 0]).astype(jnp.int32) % rshape[0]) // nx_local
    shift = (owner - idx) % p
    stay = valid & (shift == 0)
    go_up = valid & (shift == 1)
    go_down = valid & (shift == p - 1)

    def pack(mask):
        order = jnp.argsort(~mask)[:cap_face]  # True slots first
        return pos[order], vel[order], mask[order]

    up = [(i, (i + 1) % p) for i in range(p)]
    down = [(i, (i - 1) % p) for i in range(p)]
    recv_up = [lax.ppermute(b, axis_name, up) for b in pack(go_up)]
    recv_dn = [lax.ppermute(b, axis_name, down) for b in pack(go_down)]

    all_pos = jnp.concatenate([pos, recv_up[0], recv_dn[0]])
    all_vel = jnp.concatenate([vel, recv_up[1], recv_dn[1]])
    all_valid = jnp.concatenate([stay, recv_up[2], recv_dn[2]])
    order = jnp.argsort(~all_valid)[: pos.shape[0]]
    return all_pos[order], all_vel[order], all_valid[order]


def sharded_bullfrog_steps(pos, vel, bg: Background, g0, g1, n_steps, rshape,
                           mesh: Mesh, axis_name="mesh", paint_order=2, halo=4,
                           resort=False, cap_face=None):
    """n BullFrog drift-kick-drift steps on the decomposed layout.

    pos, vel : (P, 3) global cell coordinates/velocities, leading axis sharded
    by slab ownership.  Without `resort`, valid only while every particle
    stays within `halo` cells of its owning slab.  With `resort=True`, a
    fixed-capacity neighbor exchange after every step re-owns migrating
    particles (contract: per-step drift < one slab width; `cap_face` bounds
    the particles crossing one face per step).  The default cap_face is the
    full local count — always safe under the contract but it triples the
    per-shard particle buffer; production runs should set it to a measured
    bound (e.g. 2x the particles within one cell of a face) and check the
    returned `valid` mask for overflow drops.

    Returns (pos, vel) without resort.  With resort, returns
    (pos, vel, valid) where each shard carries 2*cap_face slack slots
    (valid=False, parked at the slab start with weight 0) so slabs with net
    inflow never drop particles; check `valid.sum() == n_particles` for mass
    conservation and paint with `weights=valid`.
    """
    from montecosmo_tpu.ops.pm import alpha_bullfrog

    dg = (g1 - g0) / n_steps
    gs = g0 + dg * jnp.arange(n_steps)

    def body(pos, vel):
        cap = cap_face if cap_face is not None else pos.shape[0]
        valid = lax.pcast(jnp.ones(pos.shape[0], bool), (axis_name,),
                          to="varying")
        if resort:
            # capacity slack: slabs with net inflow must not drop particles
            p = lax.axis_size(axis_name)
            idx = lax.axis_index(axis_name)
            slack = 2 * cap
            park = jnp.stack([(idx * (rshape[0] // p)).astype(pos.dtype),
                              jnp.zeros((), pos.dtype),
                              jnp.zeros((), pos.dtype)])
            pos = jnp.concatenate([pos, jnp.broadcast_to(park, (slack, 3))])
            vel = jnp.concatenate([vel, jnp.zeros((slack, 3), vel.dtype)])
            valid = jnp.concatenate(
                [valid, lax.pcast(jnp.zeros(slack, bool), (axis_name,),
                                  to="varying")])

        def step(state, gstep):
            pos, vel, valid = state
            pos = pos + vel * (dg / 2)
            weights = valid.astype(pos.dtype) if resort else 1.0
            forces = sharded_pm_forces_local(pos, rshape, axis_name,
                                             paint_order, halo, weights)
            alpha = alpha_bullfrog(bg, gstep, dg)
            gmid = gstep + dg / 2
            vel = alpha * vel + (1 - alpha) * forces / gmid
            pos = pos + vel * (dg / 2)
            if resort:
                pos, vel, valid = _resort_local(pos, vel, valid, rshape,
                                                axis_name, cap)
            return (pos, vel, valid), None

        (pos, vel, valid), _ = lax.scan(step, (pos, vel, valid), gs)
        return pos, vel, valid

    fn = jax.jit(jax.shard_map(body, mesh=mesh,
                               in_specs=(P(axis_name), P(axis_name)),
                               out_specs=(P(axis_name),) * 3))
    out = fn(pos, vel)
    return out if resort else out[:2]
