"""Physics bricks: Kaiser linear model, reparametrizations, Lagrangian/Eulerian
bias expansions, box geometry & light-cone, RSD/AP distortions, selections,
and catalog painters.

Parity: reference `montecosmo/bricks.py` (cited per function).  Background
cosmology goes through the immutable `Background` tables; every function here
is pure and jit-compatible.
"""
from functools import partial

import jax
import numpy as np
from jax import grad, lax, numpy as jnp, random as jr, vmap
from jax.scipy.spatial.transform import Rotation

from montecosmo_tpu.metrics import optim_mu2_delta
from montecosmo_tpu.ops.background import Background, Cosmology, Esqr, RH, get_cosmology
from montecosmo_tpu.ops.fourier import gradient_hat, invlaplace_hat, lazy_kvec, rfftk, irfftn, rfftn
from montecosmo_tpu.ops.hermitian import (
    ch2rshape, cgh2rg, r2chshape, rg2cgh, scale_shape,
)
from montecosmo_tpu.ops.paint import nufft, paint, read, read_multi, read_sites
from montecosmo_tpu.ops.power import lin_power, lin_power_interp, lin_power_mesh
from montecosmo_tpu.models.truncnorm import std2trunc, trunc2std
from montecosmo_tpu.utils.geometry import cart2radecrad, radecrad2cart
from montecosmo_tpu.utils.safe import nvmap, safe_div, safe_sqrt


# ======================================================================= power / PNG
def trans_phi2delta_interp(cosmo: Cosmology, a=1.0, kpow=None, n_interp=256, bg=None):
    """Interpolator of the primordial-potential -> linear-density transfer
    2 rh^2 k^2 T(k) D(a) / (3 Omega_m)  (arXiv:1904.08859).

    Parity: bricks.py:108-127.
    """
    if bg is None:
        bg = Background.create(cosmo)
    ks, pow_lin = lin_power(cosmo, kpow=kpow, n_interp=n_interp)
    pow_large = ks**cosmo.n_s  # primordial power on large scales
    lin_trans = (pow_lin / pow_large / (pow_lin[0] / pow_large[0])) ** 0.5

    a_md = 1.0 / (1.0 + 10.0)  # matter-dominated era
    growth_md = bg.a2g(a_md) / a_md  # constant during matter domination
    norm_growth = bg.a2g(a) / growth_md
    trans = 2.0 * RH**2 * ks**2 * lin_trans * norm_growth / (3.0 * cosmo.Omega_m)

    # mesh-sized queries: uniform-log-grid fast path (ops/interp.py);
    # node positions are static (EH98 logspace or the register table)
    from montecosmo_tpu.ops.interp import log_uniform_interp_fn
    nodes = np.logspace(-4, 1, n_interp) if kpow is None else np.asarray(kpow[0])
    return log_uniform_interp_fn(nodes, trans, left=0.0, right=0.0)


def add_png(cosmo: Cosmology, fNL, lin_mesh, box_size, kpow=None, bg=None):
    """Add local primordial non-Gaussianity: phi -> phi + fNL (phi^2 - <phi^2>).

    Parity: bricks.py:129-141.
    """
    mesh_shape = ch2rshape(lin_mesh.shape)
    kvec = lazy_kvec(rfftk(mesh_shape, box_size), lin_mesh)
    kmesh = sum(ki**2 for ki in kvec) ** 0.5
    trans = trans_phi2delta_interp(cosmo, kpow=kpow, bg=bg)(kmesh)

    phi = irfftn(safe_div(lin_mesh, trans))
    phi2 = phi**2
    phi += fNL * (phi2 - phi2.mean())
    return trans * rfftn(phi)


def white_noise(seed, mesh_shape, box_size):
    """Unit-power white-noise field in Fourier space, physical units.

    Parity: bricks.py:143-150.
    """
    if isinstance(seed, int):
        seed = jr.key(seed)
    white = rg2cgh(jr.normal(seed, tuple(mesh_shape)))
    return white * np.prod(np.divide(mesh_shape, box_size)) ** 0.5


def white2lin(cosmo: Cosmology, white_mesh, init_shape, box_size, kpow=None):
    """White-noise mesh -> linear matter mesh (multiply by sqrt(P)).

    Parity: bricks.py:152-157.
    """
    pmesh = lin_power_mesh(cosmo, init_shape, box_size, kpow=kpow,
                           like=white_mesh)
    return white_mesh * safe_sqrt(pmesh)


def lin2white(cosmo: Cosmology, lin_mesh, init_shape, box_size, kpow=None):
    """Linear matter mesh -> white-noise mesh (divide by sqrt(P)).

    Parity: bricks.py:159-164.
    """
    pmesh = lin_power_mesh(cosmo, init_shape, box_size, kpow=kpow,
                           like=lin_mesh)
    return safe_div(lin_mesh, safe_sqrt(pmesh))


# ======================================================================= Kaiser
def kaiser_boost(cosmo: Cosmology, a, mesh_shape, box_size, b1E, fNL_bp=0.0,
                 png_type=None, los=(0.0, 0.0, 0.0), kpow=None, bg=None,
                 like=None):
    """Eulerian Kaiser boost (growth x (b1E + f mu^2)), plus the PNG
    scale-dependent term.

    Parity: bricks.py:170-184.
    """
    if bg is None:
        bg = Background.create(cosmo)
    kvec = rfftk(mesh_shape, box_size)
    if like is not None:
        kvec = lazy_kvec(kvec, like)
    kmesh = sum(ki**2 for ki in kvec) ** 0.5
    mumesh = safe_div(sum(ki * li for ki, li in zip(kvec, los)), kmesh)

    boost = bg.a2g(a) * (b1E + bg.a2f(a) * mumesh**2)
    if png_type is not None:
        trans = trans_phi2delta_interp(cosmo, kpow=kpow, bg=bg)(kmesh)
        boost += safe_div(fNL_bp, trans)
    return boost


def kaiser_model(cosmo: Cosmology, a, lin_mesh, box_size, b1E, fNL_bp=0.0,
                 png_type=None, los=(0.0, 0.0, 0.0), kpow=None, bg=None):
    """Linear (Kaiser) galaxy field: growth, Eulerian bias, RSD, PNG.

    Three regimes: flat-sky/no-lightcone (diagonal in Fourier), flat-sky
    lightcone (2 irffts), curved-sky (6-FFT Y_2m decomposition).
    Returns 1 + delta_g in real space.

    Parity: bricks.py:186-231.
    """
    if bg is None:
        bg = Background.create(cosmo)
    mesh_shape = ch2rshape(lin_mesh.shape)
    los = jnp.asarray(los)

    if los.shape == (3,) and jnp.shape(a) == ():  # flat-sky, no light-cone
        boost = kaiser_boost(cosmo, a, mesh_shape, box_size, b1E=b1E,
                             fNL_bp=fNL_bp, png_type=png_type, los=los,
                             kpow=kpow, bg=bg, like=lin_mesh)
        delta = irfftn(lin_mesh * boost)

    elif los.shape == (3,):  # flat-sky, light-cone
        kvec = lazy_kvec(rfftk(mesh_shape, box_size), lin_mesh)
        kmesh = sum(ki**2 for ki in kvec) ** 0.5
        mumesh = safe_div(sum(ki * li for ki, li in zip(kvec, los)), kmesh)

        delta = b1E * irfftn(lin_mesh) \
            + bg.a2f(a) * irfftn(mumesh**2 * lin_mesh)
        delta = bg.a2g(a) * delta
        if png_type is not None:
            trans = trans_phi2delta_interp(cosmo, kpow=kpow, bg=bg)(kmesh)
            delta += fNL_bp * irfftn(safe_div(lin_mesh, trans))

    else:  # curved-sky
        delta, mu2_delta = optim_mu2_delta(lin_mesh, los)
        delta = bg.a2g(a) * (b1E * delta + bg.a2f(a) * mu2_delta)
        if png_type is not None:
            kvec = lazy_kvec(rfftk(mesh_shape, box_size), lin_mesh)
            kmesh = sum(ki**2 for ki in kvec) ** 0.5
            trans = trans_phi2delta_interp(cosmo, kpow=kpow, bg=bg)(kmesh)
            delta += fNL_bp * irfftn(safe_div(lin_mesh, trans))

    return 1 + delta


def kaiser_posterior(delta_obs, cosmo: Cosmology, a, box_size, var_noise, b1E,
                     los=(0.0, 0.0, 0.0), bg=None):
    """Exact Gaussian posterior (mean, std) fields of the linear matter field
    given the observed field, under the Kaiser model.  Fourier space.

    Parity: bricks.py:234-247.
    """
    mesh_shape = ch2rshape(delta_obs.shape)
    pmesh = lin_power_mesh(cosmo, mesh_shape, box_size, like=delta_obs)
    pmesh *= np.prod(np.divide(mesh_shape, box_size))  # power in cell units
    boost = kaiser_boost(cosmo, a, mesh_shape, box_size, b1E, los=los, bg=bg,
                         like=delta_obs)

    stds = (pmesh / (1 + boost**2 / var_noise * pmesh)) ** 0.5
    means = stds**2 * boost / var_noise * delta_obs
    return means, stds


# ======================================================================= reparametrization
def samp2base(params: dict, config, inv=False, temp=1.0) -> dict:
    """Sample-space <-> base-space transform per scalar latent: affine
    x*scale_fid + loc_fid, or truncated-normal transport when bounded.
    Tempering rescales scale_fid by temp^1/2.

    Parity: bricks.py:255-287.
    """
    out = {}
    for in_name, value in params.items():
        name = in_name if inv else in_name[:-1]
        out_name = in_name + "_" if inv else in_name[:-1]

        conf = config[name]
        low, high = conf.get("low", -jnp.inf), conf.get("high", jnp.inf)
        loc_fid = conf["loc_fid"]
        scale_fid = conf["scale_fid"] * temp**0.5
        bounded = np.any(np.asarray(low) != -jnp.inf) or np.any(np.asarray(high) != jnp.inf)

        if not inv:
            if bounded:
                push = lambda x, l, s, lo, hi: std2trunc(x, l, s, lo, hi)
            else:
                push = lambda x, l, s, lo, hi: x * s + l
        else:
            if bounded:
                push = lambda x, l, s, lo, hi: trunc2std(x, l, s, lo, hi)
            else:
                push = lambda x, l, s, lo, hi: (x - l) / s

        value = jnp.broadcast_to(value, np.shape(loc_fid))
        args = jnp.broadcast_arrays(value, jnp.asarray(loc_fid), jnp.asarray(scale_fid),
                                    jnp.asarray(low, float), jnp.asarray(high, float))
        out[out_name] = nvmap(push, np.ndim(loc_fid))(*args)
    return out


def samp2base_mesh(init: dict, precond, transfer, inv=False, temp=1.0) -> dict:
    """Sample-space <-> base-space transform of the init mesh under
    preconditioning 'real' (rfftn), 'fourier'/'kaiser' (Hermitian repack),
    then multiplication by the transfer field.

    Parity: bricks.py:290-320.
    """
    assert len(init) <= 1, "init dict should only have one or zero key"
    for in_name, mesh in init.items():
        out_name = in_name + "_" if inv else in_name[:-1]
        transfer = transfer * temp**0.5

        if not inv:
            if precond == "real":
                mesh = rfftn(mesh)
            elif precond in ("fourier", "kaiser"):
                mesh = rg2cgh(mesh)
            mesh = mesh * transfer  # ~ CN(0, Vcell^-1) unit-power white noise
        else:
            mesh = safe_div(mesh, transfer)
            if precond == "real":
                mesh = irfftn(mesh)
            elif precond in ("fourier", "kaiser"):
                mesh = cgh2rg(mesh)
        return {out_name: mesh}
    return {}


# ======================================================================= bias
def lagrangian_bias(cosmo: Cosmology, pos, a, box_size, lin_mesh, bias, png,
                    png_type=None, kpow=None, read_order: int = 2, bg=None,
                    sites_shape=None, remat_ops=False):
    """Lagrangian bias expansion weights up to 3rd order + higher-derivative +
    PNG operators, read at particle positions and scaled by growth powers:

        w = 1 + b1 dL + b2/2 (dL^2 - s2) + bs2 (s^2 - 2/3 s2) + b3/6 (dL^3 - 3 s2 dL)
            + bds2 dL s^2 + bs3 s^3 + bn2 lap(dL)
            + fNL (bp phi + bpd phi dL + bpd2 phi dL^2 + bps2 phi s^2 + bn2p lap(phi))

    plus a separate velocity-bias displacement dvel from bnpar.
    Returns (weights, dvel, phi).

    References: Assassi+2015 arXiv:1510.03723, Abidi&Baldauf 2018
    arXiv:1802.07622, Modi+2020 arXiv:1910.07097.
    Parity: bricks.py:327-452.
    """
    if bg is None:
        bg = Background.create(cosmo)
    b1, b2, bs2 = bias["b1"], bias["b2"], bias["bs2"]
    b3, bds2, bs3 = bias["b3"], bias["bds2"], bias["bs3"]
    bn2, bnpar = bias["bn2"], bias["bnpar"]
    fNL_bp, fNL_bpd = png["fNL_bp"], png["fNL_bpd"]
    fNL_bpd2, fNL_bps2 = png["fNL_bpd2"], png["fNL_bps2"]
    fNL_bn2p = png["fNL_bn2p"]

    growths = bg.a2g(a)
    mesh_shape = ch2rshape(lin_mesh.shape) if jnp.iscomplexobj(lin_mesh) \
        else lin_mesh.shape
    kvec = lazy_kvec(rfftk(mesh_shape, box_size), lin_mesh)
    g = growths.squeeze()

    def shear_comp(lk, i, j):
        pot = lk * invlaplace_hat(kvec)
        nabi = gradient_hat(kvec, i)
        if i == j:
            return irfftn(nabi**2 * pot - lk / 3)
        return irfftn(nabi * gradient_hat(kvec, j) * pot)

    def shear_fields(lk, comp_fn):
        """shear2 = s_ij s_ij and shear3 = 3 det(s) meshes (traceless s;
        s_22 from the trace condition — 5 FFTs)."""
        sa = comp_fn(lk, 0, 0)
        sb = comp_fn(lk, 1, 1)
        sc = -(sa + sb)
        sd = comp_fn(lk, 0, 1)
        se = comp_fn(lk, 0, 2)
        sf = comp_fn(lk, 1, 2)
        shear2 = sa**2 + sb**2 + sc**2 + 2 * (sd**2 + se**2 + sf**2)
        # bs3 operator = 3 det(shear) (Sarrus)
        shear3 = 3 * (sa * (sb * sc - sf**2) - sd * (sd * sc - se * sf)
                      + se * (sd * sf - sb * se))
        return shear2, shear3

    def k2(lk):
        return sum(ki**2 for ki in kvec) * lk

    if remat_ops and sites_shape is not None and read_order <= 2:
        # ---- memory-bounded form: each operator group is its own remat
        # block, so the transpose frees one group's FFT workspaces before
        # recomputing the next (a single fused block schedules ~10 big-mesh
        # FFTs concurrently, whose workspaces are live at once);
        # reads at lattice sites are strided slices, so per-group reads cost
        # nothing extra over the fused row-gather of the general path.
        import jax as _jax

        def rd(mesh):
            return read_sites(mesh, sites_shape)

        ck = _jax.checkpoint
        delta_pos = ck(lambda lk: rd(irfftn(lk)))(lin_mesh) * g
        s2, s3 = ck(lambda lk: tuple(
            rd(m) for m in shear_fields(lk, ck(shear_comp, static_argnums=(1, 2)))
        ))(lin_mesh)
        shear2_pos, shear3_pos = s2 * g**2, s3 * g**3
        delta_nab2_pos = ck(lambda lk: rd(irfftn(-k2(lk))))(lin_mesh) * g
        delta_nabpar_pos = jnp.stack(
            [ck(lambda lk, i=i: rd(irfftn(gradient_hat(kvec, i) * lk)))(
                lin_mesh) for i in range(3)], axis=-1)
        if png_type is not None:
            interp = trans_phi2delta_interp(cosmo, kpow=kpow, bg=bg)

            def phik(lk):
                kmesh = sum(ki**2 for ki in kvec) ** 0.5
                return safe_div(lk, interp(kmesh))

            phi = irfftn(phik(lin_mesh))  # full mesh: a likelihood output
            phi_pos = rd(phi)
            phi_nab2_pos = ck(lambda lk: rd(irfftn(-k2(phik(lk)))))(lin_mesh)
        else:
            phi = 0.0

    else:
        # ---- build every operator FIELD, then gather them all at the
        # particle positions with ONE fused row-gather
        kmesh = sum(ki**2 for ki in kvec) ** 0.5
        delta = irfftn(lin_mesh)
        shear2, shear3 = shear_fields(lin_mesh, shear_comp)
        delta_nab2 = irfftn(-(kmesh**2) * lin_mesh)
        grad_fields = [irfftn(gradient_hat(kvec, i) * lin_mesh)
                       for i in range(len(kvec))]  # in h/Mpc (velocity bias)

        fields = [delta, shear2, shear3, delta_nab2, *grad_fields]
        if png_type is not None:
            trans = trans_phi2delta_interp(cosmo, kpow=kpow, bg=bg)(kmesh)
            phi = irfftn(safe_div(lin_mesh, trans))
            phi_nab2 = irfftn(-(kmesh**2) * safe_div(lin_mesh, trans))
            fields += [phi, phi_nab2]
        else:
            phi = 0.0

        if sites_shape is not None and read_order <= 2:
            # pos is the exact regular lattice: the gather degenerates to
            # strided slicing (identity at stride 1) — zero random traffic
            vals = read_sites(fields, sites_shape)
        else:
            vals = read_multi(pos, fields, read_order)
        delta_pos = vals[..., 0] * g
        shear2_pos = vals[..., 1] * g**2
        shear3_pos = vals[..., 2] * g**3
        delta_nab2_pos = vals[..., 3] * g
        delta_nabpar_pos = vals[..., 4:7]
        if png_type is not None:
            phi_pos = vals[..., 7]
            phi_nab2_pos = vals[..., 8]

    # ---- combine operators into the bias weights (renormalized)
    weights = 1.0
    weights += b1 * delta_pos

    delta2_pos = delta_pos**2
    sigma2 = delta2_pos.mean()
    delta2_pos -= sigma2
    weights += b2 * delta2_pos / 2

    shear2_pos -= 2 / 3 * sigma2  # <s^2> = 2/3 <delta^2>
    weights += bs2 * shear2_pos
    weights += b3 * (delta_pos**3 - 3 * sigma2 * delta_pos) / 6
    weights += bds2 * delta_pos * shear2_pos
    weights += bs3 * shear3_pos
    weights += bn2 * delta_nab2_pos

    if png_type is not None:
        weights += fNL_bp * phi_pos
        phi_delta_pos = phi_pos * delta_pos
        sigma_pd = phi_delta_pos.mean()
        weights += fNL_bpd * (phi_delta_pos - sigma_pd)
        # delta2_pos already renormalized -> only the cross term remains
        weights += fNL_bpd2 * (phi_pos * delta2_pos - 2 * sigma_pd * delta_pos)
        weights += fNL_bps2 * phi_pos * shear2_pos
        weights += fNL_bn2p * phi_nab2_pos

    # bnpar: higher-derivative velocity bias (separate displacement)
    dvel = bnpar * delta_nabpar_pos * growths

    return weights, dvel, phi


def b1_L2E(b1):
    return 1 + b1


def b1_E2L(b1):
    return b1 - 1


def b2_L2E(b2, b1L):
    return b2 + 8 / 21 * b1L


def b2_E2L(b2, b1L):
    return b2 - 8 / 21 * b1L


def bpd_L2E(bpd, bp):
    return bpd + bp / 2


def bpd_E2L(bpd, bp):
    return bpd - bp / 2


def b_phi(b1, p=1.0, delta_c=1.686):
    """Universal-mass-relation primordial bias: 2 dc (b1 + 1 - p)
    (Giannantonio&Porciani arXiv:0911.0017, Barreira arXiv:2107.06887)."""
    return 2 * delta_c * (b1 + 1 - p)


def b_phi_delta(b1, b2, delta_c=1.686):
    """Primordial-density bias: 2 (dc b2 - b1)."""
    return 2 * (delta_c * b2 - b1)


def fNL_bias(png, bias, p=1.0, png_type=None):
    """Resolve png_type in (None, 'fNL', 'bias') into effective fNL*b_phi and
    fNL*b_phi_delta amplitudes.

    Parity: bricks.py:493-508.
    """
    fNL, fNL_bp, fNL_bpd = png["fNL"], png["fNL_bp"], png["fNL_bpd"]
    b1, b2 = bias["b1"], bias["b2"]

    if png_type == "fNL":
        fNL_bp = fNL * b_phi(b1, p)
        fNL_bpd = fNL * b_phi_delta(b1, b2)
    elif png_type == "bias":
        fNL_bp = fNL * fNL_bp
        fNL_bpd = fNL * fNL_bpd

    png = dict(png)
    png["fNL_bp"], png["fNL_bpd"] = fNL_bp, fNL_bpd
    return png


def eulerian_bias(matter_mesh, phi_mesh, box_size, bias, png, png_type=None):
    """Renormalized Eulerian bias operators applied to the advected matter mesh
    and advected phi mesh (arXiv:1611.09787 eqs. 3.38, 7.10, 7.11).

    Parity: bricks.py:513-586.
    """
    b1, b2, bs2, bn2 = bias["b1"], bias["b2"], bias["bs2"], bias["bn2"]
    fNL, fNL_bp, fNL_bpd = png["fNL"], png["fNL_bp"], png["fNL_bpd"]
    b1, b2 = b1_L2E(b1), b2_L2E(b2, b1)
    fNL_bpd = fNL * bpd_L2E(safe_div(fNL_bpd, fNL), safe_div(fNL_bp, fNL))

    matter_mesh = matter_mesh.at[0, 0, 0].set(0.0)  # ensure zero mean
    delta = irfftn(matter_mesh)
    phi = irfftn(phi_mesh)

    mesh_shape = delta.shape
    kvec = lazy_kvec(rfftk(mesh_shape, box_size), matter_mesh)
    kmesh = sum(ki**2 for ki in kvec) ** 0.5

    weights = 1.0
    weights += b1 * delta

    if png_type is not None:
        weights += fNL_bp * phi
        phi_delta = phi * delta
        weights += fNL_bpd * (phi_delta - phi_delta.mean())

    delta2 = delta**2
    sigma2 = delta2.mean()
    weights += b2 * (delta2 - sigma2) / 2

    pot = matter_mesh * invlaplace_hat(kvec)
    shear2 = 0.0
    for i in range(len(kvec)):
        nabi = gradient_hat(kvec, i)
        shear2 += irfftn(nabi**2 * pot - matter_mesh / 3) ** 2
        for j in range(i + 1, len(kvec)):
            nabj = gradient_hat(kvec, j)
            shear2 += 2 * irfftn(nabi * nabj * pot) ** 2
    weights += bs2 * (shear2 - 2 / 3 * sigma2)

    weights += bn2 * irfftn(-(kmesh**2) * matter_mesh)
    dvel = 0.0
    return weights, dvel


# ======================================================================= lattices / geometry
def regular_pos(mesh_shape: tuple, ptcl_shape: tuple = None):
    """Regular particle lattice in cell coordinates (ptcl_shape may be coarser
    than mesh_shape).

    Built from traced iotas, NOT a numpy constant: a 224^3 lattice embedded as
    a literal would make a ~135 MB serialized program."""
    if ptcl_shape is None:
        ptcl_shape = mesh_shape
    axes = [jnp.arange(p, dtype=jnp.float32) * jnp.float32(m / p)
            for m, p in zip(mesh_shape, ptcl_shape)]
    grid = jnp.meshgrid(*axes, indexing="ij")
    return jnp.stack(grid, axis=-1).reshape(-1, len(mesh_shape))


def unif_pos(mesh_shape: tuple, ptcl_shape: tuple = None, seed=42):
    """Uniformly distributed particle positions in cell coordinates."""
    if ptcl_shape is None:
        ptcl_shape = mesh_shape
    if isinstance(seed, int):
        seed = jr.key(seed)
    return jr.uniform(seed, shape=(int(np.prod(ptcl_shape)), 3),
                      minval=0.0, maxval=np.asarray(mesh_shape, np.float32))


def sobol_pos(mesh_shape: tuple, ptcl_shape: tuple = None, seed=42):
    """Scrambled Sobol sequence of particle positions in cell coordinates."""
    if ptcl_shape is None:
        ptcl_shape = mesh_shape
    from scipy.stats import qmc
    sampler = qmc.Sobol(d=3, scramble=True, seed=seed)
    return jnp.asarray(sampler.random(n=int(np.prod(ptcl_shape))) * np.asarray(mesh_shape),
                       jnp.float32)


def rotate(rot: Rotation, x, inverse=False):
    """`rot.apply(x, inverse)` as one explicit full-precision dot, so that
    positions are never rotated in reduced precision (TF32 on GPUs)."""
    m = rot.as_matrix()
    return jnp.einsum("ij,...j->...i", m.T if inverse else m, x,
                      precision=lax.Precision.HIGHEST)


def cell2phys_pos(pos, box_center, box_rot: Rotation, box_size, mesh_shape):
    """Cell positions -> physical positions (box center + rotation applied)."""
    pos = pos * np.divide(box_size, mesh_shape).astype(pos.dtype)
    pos = pos - np.asarray(box_size, pos.dtype) / 2
    pos = rotate(box_rot, pos)
    return pos + jnp.asarray(box_center, pos.dtype)


def phys2cell_pos(pos, box_center, box_rot: Rotation, box_size, mesh_shape):
    """Physical positions -> cell positions."""
    pos = pos - jnp.asarray(box_center, pos.dtype)
    pos = rotate(box_rot, pos, inverse=True)
    pos = pos + np.asarray(box_size, pos.dtype) / 2
    return pos / np.divide(box_size, mesh_shape).astype(pos.dtype)


def cell2phys_vel(vel, box_rot: Rotation, box_size, mesh_shape):
    vel = vel * np.divide(box_size, mesh_shape).astype(vel.dtype)
    return rotate(box_rot, vel)


def phys2cell_vel(vel, box_rot: Rotation, box_size, mesh_shape):
    vel = rotate(box_rot, vel, inverse=True)
    return vel / np.divide(box_size, mesh_shape).astype(vel.dtype)


def radius_mesh(box_center, box_rot: Rotation, box_size, mesh_shape, curved_sky=True):
    """Physical distance of each mesh cell, with the memory-lean broadcast
    trick (N^3 not N^3 x 3): ||R x + c|| = ||x + R^T c||.

    Parity: bricks.py:665-686.
    """
    rvec = []
    for ax, m in enumerate(mesh_shape):
        shape = [1, 1, 1]
        shape[ax] = -1
        rvec.append(np.arange(m).reshape(shape))

    box_center = rotate(box_rot, jnp.asarray(box_center, float), inverse=True)
    if curved_sky:
        rvec = [r * b / m - b / 2 + c
                for r, m, b, c in zip(rvec, mesh_shape, box_size, box_center)]
        return sum(ri**2 for ri in rvec) ** 0.5
    los = safe_div(box_center, jnp.linalg.norm(box_center))
    rvec = [(r * b / m - b / 2 + c) * l
            for r, m, b, c, l in zip(rvec, mesh_shape, box_size, box_center, los)]
    return jnp.abs(sum(rvec))


def pos_mesh(box_center, box_rot: Rotation, box_size, mesh_shape):
    """Mesh of physical cell positions, shape (*mesh_shape, 3)."""
    pos = np.indices(mesh_shape, dtype=np.float32).reshape(3, -1).T
    pos = cell2phys_pos(jnp.asarray(pos), box_center, box_rot, box_size, mesh_shape)
    return pos.reshape(tuple(mesh_shape) + (3,))


def redges_and_scalefactors(bg: Background, rmin: float, rmax: float, n_shells: int):
    """Radial shell edges (linearly spaced in growth factor) and their
    effective scale factors."""
    gmin, gmax = bg.a2g(bg.chi2a(rmax)), bg.a2g(bg.chi2a(rmin))
    gs = jnp.linspace(gmin, gmax, n_shells + 1)
    redges = bg.a2chi(bg.g2a(gs))  # decreasing distance
    a = bg.g2a((gs[:-1] + gs[1:]) / 2)
    return redges, a


def scale_pos(pos, los, scale_par, scale_perp):
    """Scale positions along and across the line of sight."""
    pos_par = (pos * los).sum(-1, keepdims=True) * los
    pos_perp = pos - pos_par
    return pos_par * scale_par + pos_perp * scale_perp


def parperp2isoap(alpha_par, alpha_perp):
    return (alpha_par * alpha_perp**2) ** (1 / 3), alpha_par / alpha_perp


def isoap2parperp(alpha_iso, alpha_ap):
    return alpha_iso * alpha_ap ** (2 / 3), alpha_iso * alpha_ap ** (-1 / 3)


# ======================================================================= light-cone / RSD / AP
def los_scalefactor_pos(pos, box_center, box_rot: Rotation, box_size, mesh_shape,
                        bg: Background, a_obs=None, curved_sky=True):
    """Per-particle line-of-sight and scale factor for every combination of
    curved/flat sky and light-cone (a_obs None) / fixed-a.

    Parity: bricks.py:740-758.
    """
    pos = cell2phys_pos(pos, box_center, box_rot, box_size, mesh_shape)
    if curved_sky:
        los = safe_div(pos, jnp.linalg.norm(pos, axis=-1, keepdims=True))
        rpos = jnp.linalg.norm(pos, axis=-1, keepdims=True)
    else:
        los = safe_div(np.asarray(box_center), np.linalg.norm(box_center))
        rpos = jnp.abs((pos * los).sum(-1, keepdims=True))

    a = bg.chi2a(rpos) if a_obs is None else a_obs
    return los, a


def los_scalefactor_mesh(box_center, box_rot: Rotation, box_size, mesh_shape,
                         bg: Background, a_obs=None, curved_sky=True):
    """Per-cell line-of-sight and scale factor (mesh version)."""
    if curved_sky:
        pos = pos_mesh(box_center, box_rot, box_size, mesh_shape)
        los = safe_div(pos, jnp.linalg.norm(pos, axis=-1, keepdims=True))
        rmesh = jnp.linalg.norm(pos, axis=-1)
    else:
        los = safe_div(np.asarray(box_center), np.linalg.norm(box_center))
        rmesh = radius_mesh(box_center, box_rot, box_size, mesh_shape, curved_sky)

    a = bg.chi2a(rmesh) if a_obs is None else a_obs
    return los, a


def rsd(bg: Background, vel, los, a, box_rot, box_size, mesh_shape, dvel=0.0):
    """Redshift-space displacement: growth-time velocity -> physical, x D f,
    plus velocity bias, projected on the line of sight.

    Parity: bricks.py:781-792.
    """
    vel = cell2phys_vel(vel, box_rot, box_size, mesh_shape)
    vel = vel * bg.a2g(a) * bg.a2f(a) + dvel
    return (vel * los).sum(-1, keepdims=True) * los


def ap_auto(pos, los, bg: Background, bg_fid: Background, curved_sky=True):
    """Automatic Alcock-Paczynski: remap radial distances through the fiducial
    vs sampled chi(a) relation.

    Parity: bricks.py:795-814.
    """
    def alpha_fn(rpos):
        return safe_div(bg_fid.a2chi(bg.chi2a(rpos)), rpos)

    if curved_sky:
        rpos = jnp.linalg.norm(pos, axis=-1, keepdims=True)
    else:
        rpos = jnp.abs((pos * los).sum(-1, keepdims=True))
    return pos * alpha_fn(rpos)


def ap_auto_absdetjac(pos, los, bg: Background, bg_fid: Background, curved_sky=True):
    """`ap_auto` with the analytic |det Jacobian| of the remap:
    |det J| = alpha^(d-1) (alpha + r alpha').

    Parity: bricks.py:816-846.
    """
    def alpha_fn(rpos):
        return safe_div(bg_fid.a2chi(bg.chi2a(rpos)), rpos)

    if curved_sky:
        rpos = jnp.linalg.norm(pos, axis=-1, keepdims=True)
    else:
        rpos = jnp.abs((pos * los).sum(-1, keepdims=True))
    new_pos = pos * alpha_fn(rpos)

    def absdetjac_fn(r):
        alpha = alpha_fn(r)
        adj = alpha + r * grad(alpha_fn)(r)
        if curved_sky:
            adj *= alpha**2
        return adj

    return new_pos, vmap(absdetjac_fn)(rpos.squeeze(-1))


def ap_param(pos, los, alphas, curved_sky=True):
    """Parametrized AP: isotropic scaling (curved sky) or par/perp scaling."""
    if curved_sky:
        return pos * alphas["alpha_iso"]
    alpha_par, alpha_perp = isoap2parperp(alphas["alpha_iso"], alphas["alpha_ap"])
    return scale_pos(pos, los, alpha_par, alpha_perp)


def rsd_ap_auto(pos, vel, rpos, los, a, bg: Background, bg_fid: Background,
                curved_sky=True):
    """Combined RSD + automatic AP: redshift the scale factor by the LOS
    velocity then remap through the fiducial chi(a).

    Parity: bricks.py:859-875.
    """
    vel_los = (vel * los).sum(-1, keepdims=True)
    if not curved_sky:  # positions behind the line of sight
        vel_los *= jnp.sign((pos * los).sum(-1, keepdims=True))

    # a_obs = 1 / (1/a + (v/H) * (H/c))
    a = (1 / a + vel_los * jnp.sqrt(Esqr(bg.cosmo, a)) / RH) ** -1
    alpha = safe_div(bg_fid.a2chi(a), rpos)
    if curved_sky:
        return pos * alpha
    return scale_pos(pos, los, alpha, 1.0)


# ======================================================================= selection / catalogs
def radecz2cart(bg: Background, radecz: dict):
    """(RA, DEC, Z) in degrees -> cartesian Mpc/h."""
    ra = jnp.asarray(radecz["RA"])
    dec = jnp.asarray(radecz["DEC"])
    radius = bg.a2chi(1 / (1 + jnp.asarray(radecz["Z"])))
    return radecrad2cart(ra, dec, radius)


def cart2radecz(bg: Background, cart):
    """Cartesian Mpc/h -> (RA, DEC, Z) dict."""
    ra, dec, radius = cart2radecrad(cart)
    z = 1 / bg.chi2a(radius) - 1
    return {"RA": ra, "DEC": dec, "Z": z}


def count2delta(mesh, selec_mesh):
    """Counts -> overdensity imposing the global integral constraint against
    the selection.

    Parity: bricks.py:927-937.
    """
    alpha_selec = selec_mesh * mesh.mean() / selec_mesh.mean()
    return (mesh - alpha_selec) / (alpha_selec**2).mean() ** 0.5


def top_hat_selection(mesh_shape, padding=0.0, norm_order: float = np.inf,
                      pow_order: float = np.inf):
    """lp-ball selection mesh with padded fraction, normalized to unit mean
    within its support.

    Parity: bricks.py:940-967.
    """
    norm_order = float(norm_order)
    rvec = []
    for ax, m in enumerate(mesh_shape):
        shape = [1, 1, 1]
        shape[ax] = -1
        rvec.append(np.abs((np.arange(m) + 0.5) * 2 / m - 1).reshape(shape))

    if norm_order == np.inf:
        rmesh = np.maximum(np.maximum(rvec[0], rvec[1]), rvec[2])
    elif norm_order == -np.inf:
        rmesh = np.minimum(np.minimum(rvec[0], rvec[1]), rvec[2])
    else:
        rmesh = sum(ri**norm_order for ri in rvec) ** (1 / norm_order)

    r_scale = 1 / (1 + padding)
    selec = jnp.exp(-((rmesh / r_scale) ** pow_order))
    return selec / selec[selec > 0].mean()


def gen_gauss_selection(box_center, box_rot, box_size, mesh_shape, curved_sky,
                        r_loc=None, r_scale=None, order: float = 2.0):
    """Generalized-Gaussian radial selection mesh, unit mean in support.

    Parity: bricks.py:969-991.
    """
    rmesh = radius_mesh(box_center, box_rot, box_size, mesh_shape, curved_sky)
    if r_loc is None:
        r_loc = jnp.linalg.norm(jnp.asarray(box_center, float))
    if r_scale is None:
        if r_loc == 0.0:
            r_scale = np.min(box_size) / 4
        else:
            los = safe_div(np.asarray(box_center, float), np.linalg.norm(box_center))
            los = rotate(box_rot, los, inverse=True)
            r_scale = np.asarray(box_size) @ jnp.abs(los) / 4

    selec = jnp.exp(-jnp.abs((rmesh - r_loc) / r_scale) ** order)
    return selec / selec[selec > 0].mean()


def minmax_box(pos):
    """Axis-aligned box (size, center, rotvec) covering the positions."""
    low, high = pos.min(0), pos.max(0)
    return high - low, (low + high) / 2, jnp.zeros(jnp.shape(pos)[-1])


def get_mesh_shape(box_size, cell_budget, padding=0.0):
    """Mesh shape (even ints) and cell length for a box and cell budget."""
    box_size = np.multiply(box_size, 1 + padding)
    cell_length = float((np.prod(box_size) / cell_budget) ** (1 / 3))
    mesh_shape = 2 * np.rint(box_size / cell_length / 2).astype(int)
    return tuple(map(int, mesh_shape)), cell_length


def cutsky2config(data, bg: Background, cell_budget: float, padding: float = 0.0,
                  box_size=None, box_center=None, box_rotvec=None):
    """Fit box geometry to cut-sky randoms: (final_shape, cell_length, center,
    rotvec).

    Parity: bricks.py:1015-1026.
    """
    pos = radecz2cart(bg, data)
    computed = minmax_box(pos)
    provided = (box_size, box_center, box_rotvec)
    box_size, box_center, box_rotvec = (
        np.asarray(p) if p is not None else np.asarray(c)
        for p, c in zip(provided, computed))
    final_shape, cell_length = get_mesh_shape(box_size, cell_budget, padding)
    return final_shape, cell_length, box_center, box_rotvec


def cutsky2selection(data, bg: Background, mask_shape, selec_shape, paint_shape,
                     box_size, box_center, box_rotvec,
                     paint_order=2, interlace_order=2, paint_deconv=True):
    """Paint randoms -> selection mesh (unit mean in support) + binary footprint
    mask at `mask_shape`.

    Parity: bricks.py:1028-1051.
    """
    pos = radecz2cart(bg, data)
    box_rot = Rotation.from_rotvec(jnp.asarray(box_rotvec, float))
    weights = jnp.asarray(data.get("WEIGHT", np.ones(pos.shape[0])))

    pos = phys2cell_pos(pos, box_center, box_rot, box_size, selec_shape)
    selec = nufft(pos, tuple(selec_shape), paint_shape, weights=weights,
                  paint_order=paint_order, interlace_order=interlace_order,
                  paint_deconv=paint_deconv)
    selec = irfftn(selec)

    mask = paint(pos, tuple(selec_shape), weights=weights, order=paint_order) > 0
    selec = selec / selec[mask].mean()

    pos = pos * np.divide(mask_shape, selec_shape).astype(pos.dtype)
    mask = paint(pos, tuple(mask_shape), weights=weights, order=paint_order) > 0
    return selec, mask


def cutsky2count(data, bg: Background, count_shape, paint_shape,
                 box_size, box_center, box_rotvec,
                 paint_order=2, interlace_order=2, paint_deconv=True):
    """Paint a cut-sky data catalog into a count mesh.

    Parity: bricks.py:1054-1069.
    """
    pos = radecz2cart(bg, data)
    box_rot = Rotation.from_rotvec(jnp.asarray(box_rotvec, float))
    weights = jnp.asarray(data.get("WEIGHT", np.ones(pos.shape[0])))
    pos = phys2cell_pos(pos, box_center, box_rot, box_size, count_shape)
    count = nufft(pos, tuple(count_shape), paint_shape, weights=weights,
                  paint_order=paint_order, interlace_order=interlace_order,
                  paint_deconv=paint_deconv)
    return irfftn(count)


def fullsky2count(data, bg: Background, a_obs: float, los,
                  box_size, box_center, box_rotvec, final_shape, paint_shape,
                  paint_order=2, interlace_order=2, paint_deconv=True):
    """Painted count mesh from cartesian particle chunks (full-sky periodic
    box), streamed and accumulated in Fourier space, with optional catalog RSD
    from velocities at `a_obs` along `los`.

    Parity: bricks.py:1072-1103.
    """
    box_rot = Rotation.from_rotvec(jnp.asarray(box_rotvec, float))
    los = np.asarray(los)

    chunks = [data] if isinstance(data, dict) else data
    n_tracers = 0.0

    # every complex op lives inside jit; chunks accumulate as (real, imag)
    # float pairs on the host loop
    @jax.jit
    def paint_chunk(pos, weights):
        pos = phys2cell_pos(pos, box_center, box_rot, box_size, final_shape)
        k = nufft(pos, tuple(final_shape), paint_shape, weights=weights,
                  paint_order=paint_order, interlace_order=interlace_order,
                  paint_deconv=paint_deconv)
        return k.real, k.imag

    @jax.jit
    def finish(re, im):
        return irfftn(jax.lax.complex(re, im))

    count_re = count_im = 0.0
    for chunk in chunks:
        pos = jnp.asarray(np.asarray(chunk["pos"], dtype=np.float32))
        if "vel" in chunk:
            E = float(np.sqrt(Esqr(bg.cosmo, a_obs)))
            vel = np.asarray(chunk["vel"], dtype=np.float32) / (a_obs * 100 * E)  # km/s -> Mpc/h
            pos = pos + (vel * los).sum(-1, keepdims=True) * jnp.asarray(los, pos.dtype)
        weights = jnp.asarray(chunk["WEIGHT"]) if "WEIGHT" in chunk else jnp.ones(pos.shape[0])
        re, im = paint_chunk(pos, weights)
        count_re = count_re + re
        count_im = count_im + im
        n_tracers += float(jnp.sum(weights)) if "WEIGHT" in chunk else len(pos)
    count = finish(count_re, count_im)
    # nufft applies the units jacobian -> total counts are conserved
    assert np.allclose(float(count.sum()), n_tracers, rtol=1e-3), \
        f"count sum {float(count.sum())} != n_tracers {n_tracers}"
    return count


def set_radial_count(mesh, rmesh, redges, rcounts):
    """Multiply mesh by each cell's per-radial-bin count (right-closed bins
    (low, high]; cells outside every bin are left unchanged).

    Parity: bricks.py:1106-1122.

    Formulation: a piecewise-constant lookup — per-cell index arithmetic on
    the CONCRETE bin edges + one (n_bins,)-row gather of the traced counts.
    A per-bin `lax.scan` would save an (n_bins, mesh) carry stack AND a
    same-sized mask stack for the backward pass (330 bins x a local 512^3
    slab). The gather transpose is a segment-sum into the tiny (n_bins,)
    table.
    """
    redges = np.asarray(redges, np.float64)
    rcounts = jnp.asarray(rcounts)
    n_bins = rcounts.shape[0]
    assert len(redges) == n_bins + 1
    if n_bins <= 4:
        # few bins (the default synthetic/flat-sky configs have 1): a chain
        # of fused selects instead of the per-cell table gather below
        out = mesh
        for b in range(n_bins):
            rmask = (redges[b] < rmesh) & (rmesh <= redges[b + 1])
            out = jnp.where(rmask, out * rcounts[b], out)
        return out
    dr = np.diff(redges)
    if np.allclose(dr, dr[0], rtol=1e-6, atol=0.0):
        # uniform edges (register builds them with linspace): ceil maps
        # r in (r0 + i dr, r0 + (i+1) dr] -> i, exact edges downward —
        # the right-closed convention of the reference
        t = (rmesh - redges[0]) / dr[0]
        idx = jnp.ceil(t).astype(jnp.int32) - 1
    else:
        idx = jnp.searchsorted(jnp.asarray(redges, rmesh.dtype), rmesh,
                               side="left").astype(jnp.int32) - 1
    inside = (idx >= 0) & (idx < n_bins)
    mult = jnp.take(rcounts, jnp.clip(idx, 0, n_bins - 1), axis=0)
    return mesh * jnp.where(inside, mult, jnp.ones((), mesh.dtype))
