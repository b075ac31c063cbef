"""External validation of the forward model against ANALYTIC perturbation
theory — checks that would catch a shared-convention error (growth
normalization, bias convention, RSD units, PNG transfer) that internal
self-consistency tests cannot.

These are the hermetic counterparts of the reference's strongest
validations: `tests_old/test_fastpm.py:113-169` (N-body vs external FastPM
products at matched white noise) and the `valid_LBE_ZeNBu` notebook
(Lagrangian bias vs ZeNBu tree-level PT).  No external products exist in
this sandbox, so the trusted reference is tree-level perturbation theory
itself, evaluated on the SAME realization (cross/auto ratios cancel cosmic
variance to first order):

  * delta_g = b1E * delta_m + f mu^2 delta_m + O(delta^2) with
    b1E = 1 + b1L (Lagrangian->Eulerian), so at low k
      P_gl^(0) / P_ll = b1E + f/3        (cross monopole)
    and the 2nd/3rd-order LBE operators (b2, bs2, b3...) contribute NOTHING
    to the tree-level cross with a Gaussian field (Wick: <delta^2 delta> =
    <s^2 delta> = 0) — exactly the ZeNBu-style statement.
  * Kaiser auto multipoles: P0/P2 vs `metrics.kaiser_formula` (validates
    growth D(a), growth rate f(a), and the velocity->displacement RSD
    units in one shot).
  * PNG scale-dependent bias: with png_type='fNL' the b_phi phi operator
    adds fNL * b_phi / M(k, a) to the cross bias, with M = trans_phi2delta
    (arXiv:1904.08859 convention) — the 1/k^2 upturn with the right
    amplitude.

Conventions asserted against the reference implementation: unnormalized
backward-FFT mesh convention (reference utils.py:769+), D(a=1)=1 growth
normalization via sigma8 (reference nbody.py:675-808), growth-time velocity
units in `rsd` (reference bricks.py:781-792).
"""
import numpy as np
import pytest
import jax
from jax import numpy as jnp, random as jr

from montecosmo_tpu import FieldLevelModel, default_config
from montecosmo_tpu.metrics import kaiser_formula, spectrum
from montecosmo_tpu.models.bricks import b1_L2E, trans_phi2delta_interp
from montecosmo_tpu.ops.hermitian import chreshape, r2chshape

FINAL = 32
BOX = 1000.0  # Mpc/h: k_fund = 0.0063, low-k bins well below Nyquist (0.1)
A_OBS = 0.5
LOS = (0.0, 0.0, 1.0)


def make_model(**kw):
    conf = dict(default_config)
    conf.update(final_shape=3 * (FINAL,), cell_length=BOX / FINAL,
                evolution="lpt", lpt_order=1, a_obs=A_OBS, curved_sky=False,
                box_center=(0.0, 0.0, 2000.0), ap_auto=None,
                lik_type="quad_gauss", precond="real",
                init_oversamp=1.0, evol_oversamp=1.0, ptcl_oversamp=1.0,
                paint_oversamp=1.0)
    conf.update(kw)
    return FieldLevelModel(**conf)


def forward_fields(model, fid_updates, seed=0):
    """Predict gxy_mesh and the matched linear field delta_lin(a_obs) from
    the same white-noise realization (reference cosmology tracks any
    sigma8/Omega_m override so the ratio is amplitude-consistent)."""
    from montecosmo_tpu.models.bricks import get_cosmology

    fid = dict(model.fiduc)
    fid.update(fid_updates)
    params = model.reparam(fid, inv=True)
    params["white_mesh_"] = jr.normal(jr.key(seed), model.init_shape)
    pred = model.predict(seed=seed + 1, samples=params, hide_base=False,
                         hide_det=False, hide_samp=False)

    cosmo = get_cosmology(
        Omega_m=float(np.mean(fid["Omega_m"])),
        sigma8=float(np.mean(fid["sigma8"])))
    link = model.white2lin(cosmo, jnp.asarray(pred["white_mesh"]))
    link = chreshape(link, r2chshape(model.final_shape))
    delta_lin = jnp.fft.irfftn(link) * model.bg_fid.a2g(A_OBS)
    delta_g = jnp.asarray(pred["gxy_mesh"]) - 1.0
    return np.asarray(delta_g), np.asarray(delta_lin)


def low_k_bias(delta_g, delta_lin, box, kmax=0.055):
    """Cross monopole / auto monopole below kmax (cosmic variance cancels)."""
    k, pgl = spectrum(delta_g, delta_lin, box_size=box, ells=0, los=LOS,
                      include_corners=False)
    _, pll = spectrum(delta_lin, box_size=box, ells=0, los=LOS,
                      include_corners=False)
    sel = np.asarray(k) < kmax
    return np.asarray(k)[sel], (np.asarray(pgl) / np.asarray(pll))[sel]


def test_tree_level_cross_bias_and_rsd():
    """b_cross(k->0) = b1E + f/3, UNCHANGED by 2nd/3rd-order LBE operators
    (the ZeNBu tree-level statement), through the FULL production model."""
    model = make_model()
    f = float(model.bg_fid.a2f(jnp.asarray(A_OBS)))
    b1L = 0.5
    b1E = float(b1_L2E(b1L))
    expected = b1E + f / 3

    # linear bias only
    dg, dl = forward_fields(model, {"b1": b1L, "b2": 0.0, "bs2": 0.0,
                                    "b3": 0.0, "bds2": 0.0, "bs3": 0.0,
                                    "bn2": 0.0, "bnpar": 0.0})
    box = 3 * (BOX,)
    _, b_lin = low_k_bias(dg, dl, box)
    np.testing.assert_allclose(b_lin, expected, rtol=0.05)

    # higher-order operators ON: tree-level cross bias must not move
    dg2, dl2 = forward_fields(model, {"b1": b1L, "b2": 0.6, "bs2": -0.4,
                                      "b3": 0.3, "bds2": 0.2, "bs3": -0.2,
                                      "bn2": 0.0, "bnpar": 0.0})
    _, b_full = low_k_bias(dg2, dl2, box)
    np.testing.assert_allclose(b_full, expected, rtol=0.06)
    # and the two runs agree with each other even more tightly
    np.testing.assert_allclose(b_full, b_lin, rtol=0.03)


def test_kaiser_per_mode_regression():
    """Per-mode tree-level regression: delta_g(k) / delta_lin(k) = b1E +
    f mu^2 at low k, with the SAME realization in numerator and denominator
    so cosmic variance cancels exactly — a least-squares fit over modes
    recovers the growth rate f(a) (RSD displacement units) and b1E (bias +
    growth normalization) to percent level from ONE realization."""
    model = make_model()
    f_th = float(model.bg_fid.a2f(jnp.asarray(A_OBS)))
    b1L = 0.5
    b1E_th = float(b1_L2E(b1L))
    # sigma8 = 0.4: second-order Zel'dovich RSD terms (the leading
    # contamination of the tree-level fit, measured at ~8% of f at the
    # fiducial amplitude) scale as sigma8^2 -> sub-2% here
    dg, dl = forward_fields(model, {"b1": b1L, "b2": 0.0, "bs2": 0.0,
                                    "b3": 0.0, "bds2": 0.0, "bs3": 0.0,
                                    "bn2": 0.0, "bnpar": 0.0,
                                    "sigma8": 0.4}, seed=2)

    dgk = np.fft.rfftn(dg)
    dlk = np.fft.rfftn(dl)
    kf = 2 * np.pi / BOX
    kx = np.fft.fftfreq(FINAL)[:, None, None] * FINAL * kf
    ky = np.fft.fftfreq(FINAL)[None, :, None] * FINAL * kf
    kz = np.fft.rfftfreq(FINAL)[None, None, :] * FINAL * kf
    kk = np.sqrt(kx**2 + ky**2 + kz**2)
    mu2 = np.divide(kz, kk, out=np.zeros_like(kk + 0.0), where=kk > 0) ** 2

    sel = (kk > 0) & (kk < 0.06) & (np.abs(dlk) > 1e-8)
    y = (dgk[sel] / dlk[sel]).real
    x = mu2[sel]
    A = np.stack([np.ones_like(x), x], -1)
    (b_fit, f_fit), *_ = np.linalg.lstsq(A, y, rcond=None)

    assert abs(b_fit - b1E_th) < 0.03 * b1E_th, (b_fit, b1E_th)
    assert abs(f_fit - f_th) < 0.06 * f_th, (f_fit, f_th)


def test_kaiser_formula_consistency():
    """`metrics.kaiser_formula` itself agrees with a brute-force mu-grid
    average of (b + f mu^2)^2 P(k) L_ell(mu) — the analytic reference the
    estimator tests lean on is independently cross-checked."""
    from montecosmo_tpu.ops.power import lin_power

    model = make_model()
    bg = model.bg_fid
    b1E = 1.5
    kth, pth = kaiser_formula(bg, A_OBS, lin_power(model.cosmo_fid, a=1.0,
                                                   bg=bg), b1E, ells=(0, 2))
    f = float(bg.a2f(jnp.asarray(A_OBS)))
    mu = np.linspace(-1, 1, 20001)
    boost = (b1E + f * mu**2) ** 2
    l0 = np.trapezoid(boost, mu) / 2
    l2 = 5 * np.trapezoid(boost * (3 * mu**2 - 1) / 2, mu) / 2
    growth2 = float(bg.a2g(jnp.asarray(A_OBS))) ** 2
    plin = np.asarray(lin_power(model.cosmo_fid, a=1.0, bg=bg)[1]) * growth2
    np.testing.assert_allclose(np.asarray(pth[0]), l0 * plin, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(pth[1]), l2 * plin, rtol=1e-4)


def test_quadratic_operator_wick_amplitudes():
    """POSITIVE amplitude validation of the 2nd/3rd-order LBE operators
    (the tree-level cross test above only checks they vanish there): for a
    Gaussian field every operator auto/cross spectrum is an EXACT discrete
    Wick contraction of the gridded correlation function,

        P_{d2 d2}(k)   = 2 FT[xi^2]          d2 = dL^2 - <dL^2>
        P_{s2 s2}(k)   = 2 FT[sum_ijkl xi_{ij,kl}^2]
        P_{d2 s2}(k)   = 2 FT[sum_ij xi_{.,ij}^2]
        P_{d3 d3}(k)   = 6 FT[xi^3]          d3 = dL^3 - 3 sig2 dL

    with xi_{ij,kl} = iFT[K_ij K_kl P], K_ij the (traceless) shear kernel.
    A wrong sigma^2 subtraction, shear-component assembly (s_22 from the
    trace, off-diagonal doubling), factor-of-2 normalization, or growth
    scaling breaks these at O(1) — none of it is visible to the null test.
    Operators are extracted from the PRODUCTION `lagrangian_bias` brick by
    switching on one coefficient at a time and reading at the exact lattice
    (CIC at integer sites is the identity).  Reference parity: the ZeNBu
    validation of reference bricks.py:327-452 (SURVEY valid_LBE_ZeNBu)."""
    from montecosmo_tpu.models.bricks import lagrangian_bias
    from montecosmo_tpu.ops.background import Background, Planck18
    from montecosmo_tpu.ops.fourier import gradient_hat, invlaplace_hat, rfftk
    from montecosmo_tpu.ops.power import lin_power_interp

    N, BOXW, A = 32, 1000.0, 0.5
    shape = 3 * (N,)
    cosmo = Planck18()
    bg = Background.create(cosmo)
    pow_fn = lin_power_interp(cosmo)
    kvec = rfftk(shape, 3 * (BOXW,))
    kmesh = np.asarray(sum(np.asarray(ki) ** 2 for ki in kvec)) ** 0.5
    cell_per_box = (N / BOXW) ** 3
    amp = np.asarray(jax.jit(pow_fn)(jnp.asarray(kmesh)) * cell_per_box) ** 0.5
    g = float(bg.a2g(jnp.asarray(A)))

    lattice = jnp.stack(jnp.meshgrid(*[jnp.arange(float(s)) for s in shape],
                                     indexing="ij"), -1).reshape(-1, 3)
    zeros = dict(b1=0.0, b2=0.0, bs2=0.0, b3=0.0, bds2=0.0, bs3=0.0,
                 bn2=0.0, bnpar=0.0)
    png = dict(fNL_bp=0.0, fNL_bpd=0.0, fNL_bpd2=0.0, fNL_bps2=0.0,
               fNL_bn2p=0.0)

    def op_fields(seed):
        white = np.random.default_rng(seed).standard_normal(shape)
        lin = jnp.asarray(np.fft.rfftn(white) * amp, jnp.complex64)

        @jax.jit
        def extract(lin):
            out = {}
            for name, coeff in [("d2", {"b2": 2.0}), ("s2", {"bs2": 1.0}),
                                ("d3", {"b3": 6.0})]:
                w, _, _ = lagrangian_bias(cosmo, lattice, A, 3 * (BOXW,),
                                          lin, {**zeros, **coeff}, png,
                                          read_order=2, bg=bg)
                out[name] = (w - 1.0).reshape(shape)
            return out
        return {k: np.asarray(v) for k, v in extract(lin).items()}

    # exact discrete predictions from the same amplitude mesh A(k):
    # xi(r) = iFT[g^2 A^2] (unit-variance white -> <|W|^2> = N^3 cancels
    # numpy's 1/N^3 in irfftn)
    p1 = (g * amp) ** 2
    xi = np.fft.irfftn(p1)
    kern = {}
    for i in range(3):
        for j in range(3):
            # same kernel product as the brick's shear_comp: s_ij =
            # iFT[(grad_i grad_j invlap - delta_ij/3) lin]
            gg = np.asarray(gradient_hat(kvec, i) * gradient_hat(kvec, j)
                            * invlaplace_hat(kvec)).real
            kern[i, j] = gg - (1.0 / 3.0 if i == j else 0.0)
    xi_dij = {ij: np.fft.irfftn(kern[ij] * p1) for ij in kern}
    xi_ss = sum(np.fft.irfftn(kern[a] * kern[b] * p1) ** 2
                for a in kern for b in kern)
    pred = {
        "d2": np.fft.rfftn(2 * xi**2).real,
        "s2": np.fft.rfftn(2 * xi_ss).real,
        "d3": np.fft.rfftn(6 * xi**3).real,
        "d2xs2": np.fft.rfftn(2 * sum(v**2 for v in xi_dij.values())).real,
    }

    # measured power meshes averaged over seeds, binned identically
    n_seeds = 6
    meas = {k: np.zeros(kmesh.shape) for k in pred}
    for s in range(n_seeds):
        f = op_fields(s)
        # the sigma^2 subtractions make the operators mean-zero up to the
        # realization scatter of sigma-hat^2 (the auto-spectra below can't
        # see a wrong constant — it only shifts the k=0 mode)
        assert abs(f["d2"].mean()) < 0.05 * f["d2"].std(), f["d2"].mean()
        assert abs(f["s2"].mean()) < 0.05 * f["s2"].std(), f["s2"].mean()
        fk = {k: np.fft.rfftn(v - v.mean()) for k, v in f.items()}
        for k in ("d2", "s2", "d3"):
            meas[k] += (np.abs(fk[k]) ** 2 / N**3) / n_seeds
        meas["d2xs2"] += ((fk["d2"] * np.conj(fk["s2"])).real / N**3) / n_seeds

    kf = 2 * np.pi / BOXW
    edges = np.arange(1.0, N / 2, 1.0) * kf
    dig = np.digitize(kmesh.ravel(), edges)
    counts = np.bincount(dig, minlength=edges.size + 1)

    def binned(pmesh):
        return np.bincount(dig, weights=pmesh.ravel(),
                           minlength=edges.size + 1) / np.maximum(counts, 1)

    # modest-k bins: enough modes for the seed average, below the CIC-read
    # smoothing scale
    sel = slice(2, 10)
    for name, rtol in [("d2", 0.12), ("s2", 0.12), ("d3", 0.2),
                       ("d2xs2", 0.12)]:
        m, p = binned(meas[name])[sel], binned(pred[name])[sel]
        np.testing.assert_allclose(m, p, rtol=rtol, err_msg=name)


def test_png_scale_dependent_bias():
    """fNL b_phi phi operator: the cross bias acquires fNL*b_phi/M(k, a_obs)
    with M = trans_phi2delta — the 1/k^2 upturn with the PT amplitude."""
    fnl, bphi = 30.0, 2.0
    base = {"b1": 0.5, "b2": 0.0, "bs2": 0.0, "b3": 0.0, "bds2": 0.0,
            "bs3": 0.0, "bn2": 0.0, "bnpar": 0.0,
            "fNL_bpd": 0.0, "fNL_bpd2": 0.0, "fNL_bps2": 0.0, "fNL_bn2p": 0.0}
    m0 = make_model(png_type="fNL")
    dg0, dl0 = forward_fields(m0, {**base, "fNL": 0.0, "fNL_bp": bphi}, seed=3)
    dg1, dl1 = forward_fields(m0, {**base, "fNL": fnl, "fNL_bp": bphi}, seed=3)
    box = 3 * (BOX,)
    k0, b0 = low_k_bias(dg0, dl0, box, kmax=0.07)
    k1, b1 = low_k_bias(dg1, dl1, box, kmax=0.07)

    trans_fn = trans_phi2delta_interp(m0.cosmo_fid, a=A_OBS,
                                      kpow=m0.lin_kpow, bg=m0.bg_fid)
    minv = 1.0 / np.asarray(jax.jit(trans_fn)(jnp.asarray(k1, jnp.float32)))
    expected = fnl * bphi * minv

    delta_b = b1 - b0
    # scale dependence: the upturn grows toward low k like 1/M(k)
    assert delta_b[0] > 2.0 * delta_b[-1], (delta_b[0], delta_b[-1])
    np.testing.assert_allclose(delta_b, expected, rtol=0.25,
                               atol=0.05 * expected.max())
