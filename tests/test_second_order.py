"""Second-order external validation: checks tree-level PT cannot catch.

Closes a blind spot of the tree-level tests: a bug that preserves tree-level statistics — a 2LPT source coefficient or a
BullFrog kick coefficient off by a smooth factor — passes every test in
`test_external_validation.py`.  Three independent second-order anchors:

1. The 6-FFT delta2 assembly vs a brute-force Fourier mode sum of the exact
   2LPT kernel  delta2(k) = (1/2) sum_{k1+k2=k} [1 - mu^2] d(k1) d(k2)
   on a fixed realization (f64 numpy, aliasing included, so the identity is
   exact to float error).
2. The second-order growth table vs the EdS closed form D2 = -3/7 D1^2
   (and its derivative dD2/dD1 = -6/7 D1) — an independent analytic solution
   of the same ODE system `Background.create` integrates numerically.
3. BullFrog's defining property (List&Hahn arXiv:2106.00461): a DKD step
   starting exactly ON the (1+2)LPT trajectory lands exactly back on it, for
   ANY starting growth and ANY step size.  Tested two ways:
   (a) grid-free, on the two-shape model system the alpha derivation assumes
       (linear response = identity, quadratic ZA^2 source) — this is exact up
       to the lin_ratio linearization and growth-table interpolation, so any
       smooth distortion of alpha or of the g2/dg2dg tables fails it hard
       (FastPM's alpha, also a convergent integrator and hence invisible to
       convergence-order tests, misses by 4-5 orders of magnitude more);
   (b) on the real PM system, as n-step INVARIANCE of the quadratic-in-
       amplitude (eps^2 Richardson) component of the displacement — the
       statement "every step stays on the (PM-)2LPT trajectory" without
       assuming the PM force's quadratic content matches the continuum
       kernel (windows/aliasing distort it; the eps^2 component itself is
       checked against the analytic -g2*force2 only as a loose projection).

Debug forensics (round 4): the eps^2 extraction needs (i) an OFF-lattice
start — at exact lattice sites CIC painting has an |eps| kink (the kernel
apex), which the even-part trick amplifies as 1/eps — and (ii) an init force
read consistent with the in-step reads (`init_read_order=paint_order`),
since the default NGP init read is only exact ON the lattice.

Parity role model: `/root/reference/tests_old/test_fastpm.py:113-169`
(comparison against independently produced FastPM/pmesh products; those deps
are absent here, so the *equations* stand in for the products).
"""
import numpy as np
import jax
from jax import numpy as jnp

from montecosmo_tpu.ops.background import Background, Cosmology, Planck18
from montecosmo_tpu.ops.hermitian import rg2cgh
from montecosmo_tpu.ops.pm import (
    alpha_bullfrog, alpha_fastpm, delta2_source, lpt, nbody_bf, pm_forces2,
)
from montecosmo_tpu.ops.power import lin_power_mesh
from montecosmo_tpu.models.bricks import regular_pos


# ---------------------------------------------------------------- 1. delta2
def test_delta2_brute_force_kernel(rng):
    """6-FFT Hessian assembly == brute-force convolution of the exact 2LPT
    kernel (1 - mu^2)/2, zero modes excluded, aliasing included."""
    N = 8
    delta = rng.standard_normal((N, N, N))
    # Zero the Nyquist planes: the gradient kernel's Nyquist sign is pure
    # convention (fftfreq -pi vs rfftfreq +pi flips cross terms k_i k_Nyq),
    # so the identity is only convention-free off the Nyquist planes.  With
    # them zeroed the match is exact to f32 (verified ~2e-7 relative).
    dk3 = np.fft.fftn(delta)
    dk3[N // 2, :, :] = 0
    dk3[:, N // 2, :] = 0
    dk3[:, :, N // 2] = 0
    dk3[0, 0, 0] = 0
    delta = np.fft.ifftn(dk3).real

    # --- brute force, f64 numpy: delta2(k) = (1/2M) sum_{a,b: ka+kb=k (mod)}
    #     d_a d_b [1 - (ka.kb)^2/(ka^2 kb^2)]
    dk = np.fft.fftn(delta).reshape(-1)
    freq = 2 * np.pi * np.fft.fftfreq(N)
    kx, ky, kz = np.meshgrid(freq, freq, freq, indexing="ij")
    kvecs = np.stack([kx, ky, kz], 0).reshape(3, -1)          # (3, M)
    k2 = (kvecs**2).sum(0)
    idx = np.indices((N, N, N)).reshape(3, -1)                 # integer modes
    M = N**3

    out = np.zeros(M, complex)
    for a in range(M):
        if k2[a] == 0:
            continue
        dot = (kvecs[:, a, None] * kvecs).sum(0)
        kern = np.where(k2 > 0, 1.0 - dot**2 / (k2[a] * np.where(k2 > 0, k2, 1.0)), 0.0)
        tgt = (idx[:, a, None] + idx) % N
        flat = (tgt[0] * N + tgt[1]) * N + tgt[2]
        np.add.at(out, flat, 0.5 * dk[a] * dk * kern)
    delta2_bf = np.fft.ifftn(out.reshape(N, N, N) / M).real

    got = np.asarray(delta2_source(jnp.fft.rfftn(jnp.asarray(delta, jnp.float32))))
    scale = np.abs(delta2_bf).max()
    np.testing.assert_allclose(got, delta2_bf, rtol=0, atol=1e-5 * scale)


# ---------------------------------------------------------------- 2. growth
def test_growth_d2_eds():
    """EdS (Omega_m=1): the table integration must reproduce the closed forms
    D1 = a, D2 = -3/7 a^2, dD2/dD1 = -6/7 a."""
    eds = Cosmology(Omega_c=0.7, Omega_b=0.3, h=0.7, n_s=1.0, sigma8=0.8)
    bg = Background.create(eds)
    a = jnp.asarray([0.1, 0.25, 0.5, 0.8, 1.0], jnp.float32)

    np.testing.assert_allclose(np.asarray(bg.a2g(a)), np.asarray(a),
                               rtol=2e-3)
    np.testing.assert_allclose(np.asarray(bg.a2g2(a)),
                               -3.0 / 7 * np.asarray(a) ** 2, rtol=2e-3)
    np.testing.assert_allclose(np.asarray(bg.a2dg2dg(a)),
                               -6.0 / 7 * np.asarray(a), rtol=5e-3)
    # f2 = dlnD2/dlna = 2 in EdS
    np.testing.assert_allclose(np.asarray(bg.a2f2(a)), 2.0, rtol=5e-3)


def test_growth_d2_lcdm_fitting_formula():
    """LCDM: D2(a)/D1(a)^2 tracks the Bouchet+95 fitting form
    -3/7 Omega_m(a)^(-1/143) to <1% over a in [0.3, 1] (in the reference's
    normalization D2(1) = -3/7 exactly, so compare the a-dependence ratio)."""
    from montecosmo_tpu.ops.background import Omega_m_a
    cosmo = Planck18()
    bg = Background.create(cosmo)
    a = jnp.asarray([0.3, 0.5, 0.7, 1.0], jnp.float32)
    got = np.asarray(bg.a2g2(a) / bg.a2g(a) ** 2)
    fit = -3.0 / 7 * np.asarray(Omega_m_a(cosmo, a)) ** (-1.0 / 143)
    # normalize out the D2(1)=-3/7 convention: compare shape against shape
    np.testing.assert_allclose(got / got[-1], fit / fit[-1], rtol=1e-2)


# ---------------------------------------------------------------- 3. BullFrog
def _toy_step(bg, state, g0, dg, alpha_fn, q):
    """One DKD step on the two-shape model system underlying the alpha
    derivation: state = ((X1, X2), (V1, V2)) amplitudes of the ZA shape e1
    and the 2LPT shape e2; force = identity linear response + q*X1^2 in e2."""
    (x1, x2), (v1, v2) = state
    x1, x2 = x1 + v1 * dg / 2, x2 + v2 * dg / 2
    f1, f2 = x1, x2 + q * x1**2
    al = alpha_fn(bg, g0, dg)
    g1 = g0 + dg / 2
    v1, v2 = al * v1 + (1 - al) * f1 / g1, al * v2 + (1 - al) * f2 / g1
    x1, x2 = x1 + v1 * dg / 2, x2 + v2 * dg / 2
    return (x1, x2), (v1, v2)


def _toy_traj(bg, g, q):
    """The exact (1+2)LPT trajectory of the model system: X1 = g (Zel'dovich)
    and X2 = -g2(g) q (EdS check: X2'' ODE gives X2 = (3/7) g^2 q and
    g2 = -3/7 g^2, so X2 = -g2 q; general cosmology by the g2 table)."""
    one = jnp.ones_like(jnp.asarray(g))
    return (g * one, -bg.g2g2(g) * q), (one, -bg.g2dg2dg(g) * q)


def test_bullfrog_alpha_exact_on_model_system():
    """alpha_bullfrog keeps the model system exactly on the 2LPT trajectory
    for any (g0, dg) — cold start AND mid-trajectory, EdS AND LCDM — while
    alpha_fastpm (equally convergent, so invisible to order tests) misses by
    >=3 orders of magnitude.  Catches any smooth distortion of alpha or of
    the second-order growth tables."""
    q = 0.7
    eds = Cosmology(Omega_c=0.7, Omega_b=0.3, h=0.7, n_s=1.0, sigma8=0.8)
    for cosmo, tol in ((eds, 3e-4), (Planck18(), 5e-3)):
        bg = Background.create(cosmo)
        for g0, dg in ((0.0, 1.0), (0.0, 0.5), (0.3, 0.4), (0.5, 0.5)):
            g0 = jnp.asarray(g0, jnp.float32)
            dg = jnp.asarray(dg, jnp.float32)
            got = _toy_step(bg, _toy_traj(bg, g0, q), g0, dg, alpha_bullfrog, q)
            exp = _toy_traj(bg, g0 + dg, q)
            err_bf = abs(float(got[0][1] - exp[0][1]))
            assert err_bf < tol, (float(g0), float(dg), err_bf)
            # Zel'dovich amplitude is preserved exactly by construction
            np.testing.assert_allclose(float(got[0][0]), float(exp[0][0]),
                                       rtol=1e-5)
            if g0 == 0.0:  # negative control at cold start, where it's huge
                gotf = _toy_step(bg, _toy_traj(bg, g0, q), g0, dg,
                                 alpha_fastpm, q)
                err_fpm = abs(float(gotf[0][1] - exp[0][1]))
                assert err_fpm > max(0.02, 5 * err_bf), \
                    (float(dg), err_fpm, err_bf)


SHAPE = (32, 32, 32)
BOX = (400.0, 400.0, 400.0)


def _bandlimited_field(rng, kmax=4):
    """Linear field with support only at |k_i| <= kmax grid modes: keeps the
    quadratic content below Nyquist/2 so paint/read aliasing (images at
    k >= 2 k_nyq - 2 kmax) stays out of the compared band."""
    cosmo = Planck18()
    white = rg2cgh(jnp.asarray(rng.standard_normal(SHAPE), jnp.float32))
    pmesh = lin_power_mesh(cosmo, SHAPE, BOX)
    cell_vol = np.prod(np.divide(BOX, SHAPE))
    lin = np.fft.rfftn(np.asarray(jnp.fft.irfftn(white * (pmesh / cell_vol) ** 0.5)))
    n = SHAPE[0]
    kx = np.abs(np.fft.fftfreq(n) * n)
    kz = np.fft.rfftfreq(n) * n
    mask = ((kx[:, None, None] <= kmax) & (kx[None, :, None] <= kmax)
            & (kz[None, None, :] <= kmax))
    return cosmo, jnp.asarray((lin * mask).astype(np.complex64))


def _eps2_component(disp_fn, eps):
    """Quadratic-in-amplitude component by the even-part trick:
    disp(eps) + disp(-eps) = 2 eps^2 B + O(eps^4)."""
    return (disp_fn(eps) + disp_fn(-eps)) / (2 * eps**2)


def _mode_regress(got, ref):
    """Complex regression coefficient of got on ref over low-k modes of the
    3 displacement components, plus the relative residual."""
    g = np.fft.rfftn(np.asarray(got).reshape(SHAPE + (3,)), axes=(0, 1, 2))
    r = np.fft.rfftn(np.asarray(ref).reshape(SHAPE + (3,)), axes=(0, 1, 2))
    low = np.s_[:5, :5, :5]   # the band where the linear field has support
    g, r = g[low].ravel(), r[low].ravel()
    coef = np.vdot(r, g).real / np.vdot(r, r).real
    resid = np.linalg.norm(g - coef * r) / np.linalg.norm(r)
    return coef, resid


def test_bullfrog_eps2_is_step_invariant(rng):
    """On the real PM system, the quadratic-in-amplitude component of the
    BullFrog displacement is the SAME for 1, 2 and 4 steps (every step lands
    back on the PM system's own 2LPT trajectory), while FastPM's one-step
    value differs from BullFrog's by ~40% — so the check discriminates the
    alpha on the production code path (nbody_bf + bullfrog_step + lpt)."""
    cosmo, lin = _bandlimited_field(rng)
    bg = Background.create(cosmo)
    # off-lattice start: at exact sites CIC painting has an |eps| kink
    pos = regular_pos(SHAPE) + 0.5
    a1, eps = 1.0, 0.25

    from functools import partial

    @partial(jax.jit, static_argnums=(1, 2))
    def disp(eps, n_steps, use_bullfrog):
        alpha_fn = alpha_bullfrog if use_bullfrog else alpha_fastpm
        p, _ = nbody_bf(bg, eps * lin, pos, a0=0.0, a1=a1,
                        n_steps=n_steps, paint_order=2, lpt_order=1,
                        alpha_fn=alpha_fn, checkpoint=False,
                        paint_deconv=True, init_read_order=2)
        return p[0] - pos

    b1 = _eps2_component(lambda e: disp(e, 1, True), eps)
    nrm = float(jnp.linalg.norm(b1))
    for n_steps in (2, 4):
        bn = _eps2_component(lambda e: disp(e, n_steps, True), eps)
        rel = float(jnp.linalg.norm(bn - b1)) / nrm
        assert rel < 0.06, (n_steps, rel)

    # negative control: FastPM's alpha only preserves the linear growth —
    # its one-step eps^2 term must visibly differ, or this test has no power
    # to catch a wrong alpha (measured: 0.42).
    f1 = _eps2_component(lambda e: disp(e, 1, False), eps)
    rel_fpm = float(jnp.linalg.norm(f1 - b1)) / nrm
    assert rel_fpm > 0.25, rel_fpm

    # loose continuum anchor: the eps^2 component projects onto the analytic
    # 2LPT displacement -g2 * force2 with a positive O(1) coefficient (CIC
    # windows on the quadratic content keep it below 1 even deconvolved)
    ref2 = -bg.a2g2(a1) * pm_forces2(pos, lin, read_order=2)
    coef, _ = _mode_regress(b1, ref2)
    assert 0.5 < coef < 1.1, coef
