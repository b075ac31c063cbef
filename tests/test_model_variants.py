"""Model-path coverage: every likelihood family, N-body evolution, Eulerian
bias, preconditioning modes, k-cut masking, and curved-sky light-cone."""
import numpy as np
import pytest
import jax
from jax import numpy as jnp, random as jr

from montecosmo_tpu import FieldLevelModel, default_config

BASE = dict(default_config)
BASE.update(final_shape=(8, 8, 8), cell_length=40.0, evolution="kaiser",
            a_obs=0.5, curved_sky=False, box_center=(0.0, 0.0, 1000.0),
            precond="kaiser", init_oversamp=1.0, evol_oversamp=1.0,
            ptcl_oversamp=1.0, paint_oversamp=1.0, n_rbins=1)


def make(**kw):
    conf = dict(BASE)
    conf.update(kw)
    return FieldLevelModel(**conf)


def fiducial_logpdf(model, seed=0):
    params = model.reparam(dict(model.fiduc), inv=True)
    params["white_mesh_"] = jr.normal(jr.key(seed), model.init_shape)
    pred = model.predict(seed=seed + 1, samples=params, hide_base=False,
                         hide_det=False, hide_samp=False)
    params["count_mesh"] = pred["count_mesh"]
    return float(model.logpdf(params)), pred


@pytest.mark.parametrize("lik", ["poisson", "fourier_gauss", "quad_gauss",
                                 "two_quad_gauss", "shash"])
def test_likelihood_families(lik):
    model = make(lik_type=lik)
    lp, pred = fiducial_logpdf(model)
    assert np.isfinite(lp), (lik, lp)
    assert np.all(np.isfinite(np.asarray(pred["count_mesh"]))), lik


def test_nbody_evolution():
    model = make(evolution="nbody", nbody_n_steps=3, a_obs=0.5)
    lp, pred = fiducial_logpdf(model)
    assert np.isfinite(lp)
    gxy = np.asarray(pred["gxy_mesh"])
    np.testing.assert_allclose(gxy.mean(), 1.0, atol=0.3)


def test_nbody_gradient():
    model = make(evolution="nbody", nbody_n_steps=2, a_obs=0.5)
    params = model.reparam(dict(model.fiduc), inv=True)
    params["white_mesh_"] = jr.normal(jr.key(0), model.init_shape)
    pred = model.predict(seed=1, samples=params, hide_base=False,
                         hide_det=False, hide_samp=False)
    obs = {"count_mesh": pred["count_mesh"]}
    g = jax.grad(lambda p: model.logpdf({**p, **obs}))(
        {k: jnp.asarray(v) for k, v in params.items()})
    for k, v in g.items():
        assert np.all(np.isfinite(np.asarray(v))), k


def test_eulerian_bias_path():
    model = make(evolution="lpt", bias_type="eulerian", lpt_order=1)
    lp, pred = fiducial_logpdf(model)
    assert np.isfinite(lp)


def test_precond_modes():
    for precond in ("real", "fourier"):
        model = make(precond=precond)
        lp, _ = fiducial_logpdf(model)
        assert np.isfinite(lp), precond


def test_kcut_masking():
    """k-space cut: only modes below k_cut are sampled; logpdf stays finite.
    (k_nyquist = pi*8/320 ~ 0.0785 here, so the cut must sit below it.)"""
    model = make(k_cut=0.05)
    assert model.cut_mask is not None
    n_sampled = int(model.cut_mask.sum())
    assert 0 < n_sampled < np.prod(model.init_shape)
    params = model.reparam(dict(model.fiduc), inv=True)
    params["white_mesh_"] = jr.normal(jr.key(0), (n_sampled,))
    pred = model.predict(seed=1, samples=params, hide_base=False,
                         hide_det=False, hide_samp=False)
    params["count_mesh"] = pred["count_mesh"]
    assert np.isfinite(float(model.logpdf(params)))


def test_curved_sky_lightcone():
    """Curved sky + light-cone (a_obs=None): per-cell scale factors."""
    model = make(curved_sky=True, a_obs=None, box_center=(0.0, 0.0, 1500.0))
    lp, pred = fiducial_logpdf(model)
    assert np.isfinite(lp)


def test_nbody_lightcone():
    """N-body light-cone (evolution='nbody', a_obs=None): beyond-reference —
    the reference asserts this out (model.py:770).  The shell-interpolated
    N-body matches the LPT light-cone at low k (transfer ~ 1 well below
    k_nyq)."""
    from montecosmo_tpu.metrics import powtranscoh

    kw = dict(curved_sky=True, a_obs=None, box_center=(0.0, 0.0, 1500.0),
              final_shape=(16,) * 3, cell_length=25.0, lpt_order=2)
    m_nb = make(evolution="nbody", nbody_n_steps=3, nbody_a_start=0.05, **kw)
    m_lpt = make(evolution="lpt", **kw)

    lp, pred_nb = fiducial_logpdf(m_nb)
    assert np.isfinite(lp)
    _, pred_lpt = fiducial_logpdf(m_lpt)

    gxy_nb = np.asarray(pred_nb["gxy_mesh"])
    gxy_lpt = np.asarray(pred_lpt["gxy_mesh"])
    assert np.all(np.isfinite(gxy_nb))
    ks, _, trans, coh = powtranscoh(gxy_lpt, gxy_nb, m_nb.box_size)
    low = ks < 0.4 * m_nb.k_nyquist
    assert np.all(np.abs(np.asarray(trans)[low] - 1) < 0.1), trans
    assert np.all(np.asarray(coh)[low] > 0.95), coh


def test_nbody_lightcone_gradient():
    model = make(evolution="nbody", nbody_n_steps=2, curved_sky=True,
                 a_obs=None, box_center=(0.0, 0.0, 1500.0))
    params = model.reparam(dict(model.fiduc), inv=True)
    params["white_mesh_"] = jr.normal(jr.key(0), model.init_shape)
    pred = model.predict(seed=1, samples=params, hide_base=False,
                         hide_det=False, hide_samp=False)
    obs = {"count_mesh": pred["count_mesh"]}
    g = jax.grad(lambda p: model.logpdf({**p, **obs}))(
        {k: jnp.asarray(v) for k, v in params.items()})
    for k, v in g.items():
        assert np.all(np.isfinite(np.asarray(v))), k


def test_ap_param():
    model = make(ap_auto=False, evolution="lpt", lpt_order=1)
    lp, _ = fiducial_logpdf(model)
    assert np.isfinite(lp)


def test_png_fnl():
    model = make(png_type="fNL", evolution="lpt", lpt_order=1)
    lp, pred = fiducial_logpdf(model)
    assert np.isfinite(lp)


def test_paint_window_matches_scatter_model():
    """Full LPT+bias+RSD forward model: the scatter-free window paint path gives
    the same galaxy mesh and logpdf as the XLA scatter path."""
    kw = dict(evolution="lpt", lpt_order=2, paint_oversamp=2.0,
              ptcl_oversamp=1.0, evol_oversamp=2.0)
    m_win = make(paint_method="window", **kw)
    m_sc = make(paint_method="scatter", **kw)
    assert m_win.paint_lattice == (8, 8, 8) and m_sc.paint_lattice is None

    lw, pw = fiducial_logpdf(m_win)
    ls, ps = fiducial_logpdf(m_sc)
    np.testing.assert_allclose(np.asarray(pw["gxy_mesh"]),
                               np.asarray(ps["gxy_mesh"]), rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(lw, ls, rtol=1e-5)


def test_paint_auto_gate():
    """auto paints with the XLA scatter on one device and keeps a window
    geometry for mesh contexts only when the lattice divides the meshes."""
    m = make(paint_method="auto")
    assert m.paint_lattice is None and m._sharded_window[1] == (8, 8, 8)
    # the sharded window covers ~36 Mpc/h of displacement, at least 4 cells
    assert make(paint_method="auto", cell_length=5.0)._sharded_window[0] == 8
    assert make(paint_method="auto", cell_length=40.0)._sharded_window[0] == 4
    assert make(paint_method="auto", cell_length=1.0)._sharded_window[0] == 36
    # non-integer refinement -> no window geometry at all
    assert make(paint_method="auto", paint_oversamp=1.5,
                ptcl_oversamp=1.0)._sharded_window is None
