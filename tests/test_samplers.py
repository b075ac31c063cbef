"""Sampler correctness: recover moments of known targets.

MCLMC/MAMS/NUTS/HMC-within-Gibbs each sample analytically known
distributions; checks on means, variances, acceptance statistics and tuned
hyperparameters.
"""
import numpy as np
import pytest
import jax
from jax import numpy as jnp, random as jr

from montecosmo_tpu.samplers import (
    get_mclmc_run, get_mclmc_warmup, get_mams_run, get_mams_warmup,
    hmc_init, hmc_kernel, nuts_kernel, window_adaptation,
    nutswg_init, get_init_state, sampling_loop_general, optimize,
)

D = 8
SCALES = jnp.asarray(np.geomspace(0.5, 3.0, D), jnp.float32)


def logdf_gauss(x):
    z = x["x"] / SCALES
    return -0.5 * jnp.sum(z**2)


def init_pos(key=0):
    return {"x": jr.normal(jr.key(key), (D,))}


def test_mclmc_warmup_and_run():
    warmup = get_mclmc_warmup(logdf_gauss, n_steps=1000, desired_energy_var=5e-4)
    state, config = warmup(jr.key(0), init_pos())
    assert np.isfinite(float(config.step_size)) and float(config.step_size) > 0
    # L ~ sqrt(sum of variances) = sqrt(sum SCALES^2)
    L_expect = float(jnp.sqrt(jnp.sum(SCALES**2)))
    assert 0.3 * L_expect < float(config.L) < 3 * L_expect, (config.L, L_expect)

    run = get_mclmc_run(logdf_gauss, n_samples=3000, thinning=8)
    state, samples = run(jr.key(1), state, config)
    xs = np.asarray(samples["x"])
    assert xs.shape == (3000, D)
    # standardized means within MC error of correlated draws
    assert np.all(np.abs(xs.mean(0) / np.asarray(SCALES)) < 0.35)
    np.testing.assert_allclose(xs.std(0), np.asarray(SCALES), rtol=0.3)
    # energy-error control: mse_per_dim near the requested level
    mse = float(np.mean(samples["mse_per_dim"]))
    assert mse < 100 * 5e-4, mse
    assert np.all(np.asarray(samples["n_evals"]) == 16)  # 2 grads x thinning 8


def test_mclmc_warmup_f32_noise_floor():
    """A large constant |logpdf| (f32 quantization ~ ulp ~ 2 eps |logpdf|)
    must not collapse the tuned step size when desired_energy_var sits below
    the energy-measurement noise floor — the 64^3 quad-Gauss campaign
    failure mode (ss fell 5e-3 -> 4e-6 and the chains froze).  The tuner
    clamps the per-dim target to ~25x the quantization noise."""
    OFF = jnp.float32(5e6)  # ulp ~ 0.5: any de below that is pure noise

    def logdf_off(x):
        return logdf_gauss(x) - OFF

    # reference: same tight target at |logpdf| ~ 1 (floor inactive)
    _, cfg_ref = get_mclmc_warmup(
        logdf_gauss, n_steps=1000, desired_energy_var=1e-7)(
            jr.key(0), init_pos())
    _, cfg_off = get_mclmc_warmup(
        logdf_off, n_steps=1000, desired_energy_var=1e-7)(
            jr.key(0), init_pos())

    ss_ref, ss_off = float(cfg_ref.step_size), float(cfg_off.step_size)
    assert np.isfinite(ss_off) and ss_off > 0.1 * ss_ref, (ss_off, ss_ref)

    # and the chain actually moves at the clamped operating point
    _, samples = get_mclmc_run(logdf_off, n_samples=500, thinning=4)(
        jr.key(1), *get_mclmc_warmup(logdf_off, n_steps=1000,
                                     desired_energy_var=1e-7)(
            jr.key(0), init_pos()))
    xs = np.asarray(samples["x"])
    assert np.all(xs.std(0) > 0.2 * np.asarray(SCALES)), xs.std(0)


def test_mclmc_preconditioning():
    warmup = get_mclmc_warmup(logdf_gauss, n_steps=1500,
                              diagonal_preconditioning=True)
    state, config = warmup(jr.key(0), init_pos())
    # tuned inverse mass ~ the marginal variances
    invmm = np.asarray(config.inverse_mass_matrix)
    ratio = invmm / np.asarray(SCALES) ** 2
    assert np.all(ratio > 0.1) and np.all(ratio < 10), ratio


def test_mams():
    warmup = get_mams_warmup(logdf_gauss, n_steps=600)
    state, config = warmup(jr.key(0), init_pos())
    run = get_mams_run(logdf_gauss, n_samples=1500, thinning=2)
    state, samples = run(jr.key(1), state, config)
    xs = np.asarray(samples["x"])
    np.testing.assert_allclose(xs.mean(0), 0.0, atol=0.5)
    np.testing.assert_allclose(xs.std(0), np.asarray(SCALES), rtol=0.35)
    acc = float(np.mean(samples["acceptance_rate"]))
    assert 0.3 < acc <= 1.0, acc


def test_hmc_kernel():
    state = hmc_init(init_pos(), logdf_gauss)
    kernel = hmc_kernel(logdf_gauss, step_size=0.25, num_integration_steps=16)

    def step(state, key):
        state, info = kernel(key, state)
        return state, (state.position["x"], info["acceptance_rate"])

    state, (xs, accs) = jax.lax.scan(step, state, jr.split(jr.key(2), 3000))
    xs = np.asarray(xs[500:])
    assert float(np.mean(np.asarray(accs))) > 0.6
    np.testing.assert_allclose(xs.std(0), np.asarray(SCALES), rtol=0.3)


def test_nuts_kernel():
    state = hmc_init(init_pos(), logdf_gauss)
    kernel = nuts_kernel(logdf_gauss, step_size=0.4,
                         inverse_mass_matrix=jnp.ones(D))

    def step(state, key):
        state, info = kernel(key, state)
        return state, (state.position["x"], info["acceptance_rate"],
                       info["num_integration_steps"])

    state, (xs, accs, nints) = jax.lax.scan(step, state, jr.split(jr.key(3), 2000))
    xs = np.asarray(xs[200:])
    np.testing.assert_allclose(xs.mean(0), 0.0, atol=0.4)
    np.testing.assert_allclose(xs.std(0), np.asarray(SCALES), rtol=0.25)
    assert float(np.mean(np.asarray(accs))) > 0.5
    assert float(np.mean(np.asarray(nints))) > 1  # dynamic trajectories


def test_nuts_window_adaptation():
    (state, params), hist = window_adaptation(
        nuts_kernel, logdf_gauss, num_steps=600, initial_position=init_pos(),
        target_acceptance_rate=0.8, rng_key=jr.key(4))
    eps = float(params["step_size"])
    assert 0.01 < eps < 5.0, eps
    invmm = np.asarray(params["inverse_mass_matrix"])
    ratio = invmm / np.asarray(SCALES) ** 2
    assert np.all(ratio > 0.05) and np.all(ratio < 20), ratio
    # late acceptance near target
    acc = float(np.mean(np.asarray(hist["acceptance_rate"])[-100:]))
    assert 0.55 < acc <= 1.0, acc


def test_nutswg_blocked_gibbs():
    """Blocked NUTS-within-Gibbs samples a 2-block Gaussian."""
    def logdf(params):
        return (-0.5 * jnp.sum((params["mesh_"] / 2.0) ** 2)
                - 0.5 * jnp.sum(params["rest_"] ** 2))

    step_fn, init_fn, config, init_state_fn = nutswg_init(logdf)
    init = {"mesh_": jnp.zeros(6), "rest_": jnp.zeros(3)}
    state = get_init_state(init, logdf, init_fn,
                           blocks={"mesh_": ["mesh_"], "rest_": ["rest_"]})
    config = {k: {"step_size": 0.5, "inverse_mass_matrix": 1.0} for k in state}

    last, (positions, infos) = sampling_loop_general(
        jr.key(5), state, logdf, step_fn, init_fn, config, n_samples=1500)
    mesh = np.asarray(positions["mesh_"])[300:]
    rest = np.asarray(positions["rest_"])[300:]
    np.testing.assert_allclose(mesh.std(), 2.0, rtol=0.2)
    np.testing.assert_allclose(rest.std(), 1.0, rtol=0.2)
    assert int(np.sum(np.asarray(infos["n_evals"]))) > 0


def test_optimize():
    potential = lambda p: jnp.sum((p["x"] - 3.0) ** 2 * jnp.arange(1, D + 1))
    params, values = optimize(potential, init_pos(), lr0=0.3, n_epochs=400)
    np.testing.assert_allclose(np.asarray(params["x"]), 3.0, atol=0.05)
    assert float(values[-1]) < float(values[0])


def test_segmented_warmup_matches_monolithic(rng):
    """script._segmented_warmup threads the adaptation carry across chunks:
    the tuned config must match a monolithic warmup (same per-step keys;
    only f32 fusion roundoff differs across the jit boundaries)."""
    import montecosmo_tpu.script as script
    from montecosmo_tpu.parallel import map_chains
    from montecosmo_tpu.samplers import get_mclmc_warmup
    from jax import random as jr

    def logdf(params):
        x = params["x"]
        return -0.5 * jnp.sum(x ** 2) - 0.1 * jnp.sum(x ** 4)

    n_chains, n_steps = 2, 40
    pos = {"x": jnp.asarray(rng.standard_normal((n_chains, 16)), jnp.float32)}
    key = jr.key(3)

    mono = map_chains(get_mclmc_warmup(logdf, n_steps=n_steps,
                                       desired_energy_var=1e-4), n_chains)(
        jr.split(key, n_chains), pos)

    old = script.MAX_STEPS_PER_CALL
    script.MAX_STEPS_PER_CALL = 7  # uneven chunks on purpose
    try:
        seg = script._segmented_warmup(logdf, n_steps, 1e-4, False,
                                       n_chains, key, pos)
    finally:
        script.MAX_STEPS_PER_CALL = old

    # chunk boundaries change XLA fusion, so f32 roundoff accumulates
    # through the chaotic dynamics: configs agree statistically, not bitwise
    np.testing.assert_allclose(np.asarray(seg[1].step_size),
                               np.asarray(mono[1].step_size), rtol=0.05)
    np.testing.assert_allclose(np.asarray(seg[1].L),
                               np.asarray(mono[1].L), rtol=0.05)
    assert np.isfinite(np.asarray(seg[0].position["x"])).all()


def test_nuts_depth_cap_env(monkeypatch):
    """MONTECOSMO_NUTS_MAX_DOUBLINGS bounds per-step trajectory length
    (expensive-model campaigns cap the tree)."""
    monkeypatch.setenv("MONTECOSMO_NUTS_MAX_DOUBLINGS", "2")
    state = hmc_init(init_pos(), logdf_gauss)
    kernel = nuts_kernel(logdf_gauss, step_size=1e-4)  # tiny step: max depth
    _, info = jax.jit(kernel)(jr.key(0), state)
    assert int(info["num_integration_steps"]) <= 2**2 * 2

    monkeypatch.delenv("MONTECOSMO_NUTS_MAX_DOUBLINGS")
    kernel10 = nuts_kernel(logdf_gauss, step_size=1e-4)
    _, info10 = jax.jit(kernel10)(jr.key(0), state)
    assert int(info10["num_integration_steps"]) > 2**2 * 2

def test_find_reasonable_step_size():
    """Stan's bracketing initializer lands where one leapfrog step has
    ~50% acceptance, from both directions (hmc.py)."""
    from montecosmo_tpu.samplers import find_reasonable_step_size
    from montecosmo_tpu.samplers.hmc import (
        _kinetic, _leapfrog, _ravel, hmc_init)

    for eps_init in (100.0, 1e-6):
        eps = float(jax.jit(
            lambda k: find_reasonable_step_size(
                logdf_gauss, init_pos(), k, initial_step_size=eps_init)
        )(jr.key(7)))
        assert 1e-3 < eps < 50.0, (eps_init, eps)

    # the bracketed step gives a reasonable single-step acceptance
    eps = float(jax.jit(
        lambda k: find_reasonable_step_size(logdf_gauss, init_pos(), k)
    )(jr.key(7)))
    state = hmc_init(init_pos(), logdf_gauss)
    x0, unravel = _ravel(state.position)
    g0 = _ravel(state.logdensity_grad)[0]
    invmm = jnp.ones_like(x0)
    r0 = jr.normal(jr.key(7), x0.shape)  # same key as the bracket momentum
    h0 = -state.logdensity + _kinetic(r0, invmm)
    _, r1, _, ld1 = jax.jit(lambda: _leapfrog(
        x0, r0, g0, logdf_gauss, unravel, eps, invmm))()
    acc = float(jnp.exp(jnp.minimum(0.0, h0 - (-ld1 + _kinetic(r1, invmm)))))
    assert 0.2 < acc <= 1.0, (eps, acc)


def test_wa_invmm_seed():
    """window_adaptation(initial_inverse_mass_matrix=...) seeds the diagonal
    mass; with no slow window (num_steps < 20) it survives to the params."""
    seed = np.asarray(SCALES) ** 2
    (state, params), _ = window_adaptation(
        nuts_kernel, logdf_gauss, num_steps=10, initial_position=init_pos(),
        rng_key=jr.key(4), initial_inverse_mass_matrix=jnp.asarray(seed))
    np.testing.assert_allclose(np.asarray(params["inverse_mass_matrix"]),
                               seed, rtol=1e-6)


def test_adaptive_chunks():
    """Host-level adaptive program sizing (script._AdaptiveChunks): first run
    of a size is compile-laden and ignored; sizes move toward the wall-time
    target on power-of-two rungs, bounded by the cap."""
    from montecosmo_tpu.script import _AdaptiveChunks

    ch = _AdaptiveChunks(4, cap=256, target_s=16.0)
    assert ch.next(1000) == 4
    ch.update(4, 100.0)          # first run of size 4: compile, ignored
    assert ch.seg == 4
    ch.update(4, 1.0)            # 0.25 s/step -> want 64, jump bounded to 8x
    assert ch.seg == 32
    ch.update(32, 8.0)           # first run of size 32: compile, ignored
    assert ch.seg == 32
    ch.update(32, 8.0)           # 0.25 s/step -> 64
    assert ch.seg == 64
    ch.update(64, 16.0)          # first run of 64: ignored
    ch.update(64, 16.0)          # on target: stay
    assert ch.seg == 64
    ch.update(64, 0.125)         # absurdly fast: cap respected
    assert ch.seg == 256
    assert ch.next(3) == 3       # remaining bound

    ch2 = _AdaptiveChunks(32, cap=256, target_s=16.0)
    ch2.update(32, 5.0)          # compile run
    ch2.update(32, 160.0)        # 5 s/step -> shrink toward 2-4 steps
    assert ch2.seg <= 4


def test_segmented_nuts_warmup_bracket_and_seed():
    """Bracketed initial step + seeded mass: the warmup spends far fewer
    gradient evals than a blind 1e-3 cold start and still tunes correctly."""
    import montecosmo_tpu.script as script

    def logdf(params):
        z = params["white_mesh_"] / 0.1   # field block, posterior std 0.1
        return -0.5 * jnp.sum(z ** 2) - 0.5 * jnp.sum(params["b1_"] ** 2)

    n_chains, n_steps = 2, 60
    pos = {"white_mesh_": 0.1 * jr.normal(jr.key(0), (n_chains, 12)),
           "b1_": jr.normal(jr.key(1), (n_chains, 2))}

    old = script.MAX_STEPS_PER_CALL
    script.MAX_STEPS_PER_CALL = 64
    try:
        state, config, n_ev = script._segmented_nuts_warmup(
            logdf, n_steps, n_chains, jr.key(2), pos,
            initial_inverse_mass_matrix={"mesh_": 0.01 * jnp.ones(12)})
        _, _, n_ev_blind = script._segmented_nuts_warmup(
            logdf, n_steps, n_chains, jr.key(2), pos,
            initial_step_size=1e-3)
    finally:
        script.MAX_STEPS_PER_CALL = old

    assert set(state) == {"mesh_", "rest_"}
    for name in state:
        ss = np.asarray(config[name]["step_size"])
        assert np.all(ss > 1e-3), (name, ss)
        assert np.isfinite(np.asarray(
            state[name].logdensity)).all()
    # the cold start burns max-depth trees until dual averaging recovers
    assert n_ev < 0.6 * n_ev_blind, (n_ev, n_ev_blind)


def test_segmented_warmup_ckpt_resume(rng, tmp_path, monkeypatch):
    """A warmup killed mid-phase resumes from its chunk checkpoint with a
    bit-identical trajectory (the per-step key schedule is precomputed, and
    the carry is restored exactly)."""
    import montecosmo_tpu.script as script
    from jax import random as jr

    def logdf(params):
        x = params["x"]
        return -0.5 * jnp.sum(x ** 2) - 0.1 * jnp.sum(x ** 4)

    n_chains, n_steps = 2, 40
    pos = {"x": jnp.asarray(rng.standard_normal((n_chains, 16)), jnp.float32)}
    key = jr.key(3)
    ckpt = tmp_path / "warm_ckpt.h5"

    monkeypatch.setattr(script, "MAX_STEPS_PER_CALL", 7)
    monkeypatch.setenv("MONTECOSMO_RUN_CKPT_EVERY", "1")

    ref = script._segmented_warmup(logdf, n_steps, 1e-4, False,
                                   n_chains, key, pos)

    # crash after 3 chunks: the checkpoint from chunk 3 must remain
    calls = {"n": 0}
    orig_chunk = script._warmup_chunk

    def crashing_chunk(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 3:
            raise RuntimeError("simulated worker kill")
        return orig_chunk(*a, **kw)

    monkeypatch.setattr(script, "_warmup_chunk", crashing_chunk)
    with pytest.raises(RuntimeError, match="simulated"):
        script._segmented_warmup(logdf, n_steps, 1e-4, False,
                                 n_chains, key, pos, ckpt_path=ckpt)
    assert ckpt.exists()
    monkeypatch.setattr(script, "_warmup_chunk", orig_chunk)

    resumed = script._segmented_warmup(logdf, n_steps, 1e-4, False,
                                       n_chains, key, pos, ckpt_path=ckpt)
    assert not ckpt.exists()  # cleaned up after the final state save
    np.testing.assert_array_equal(np.asarray(resumed[1].step_size),
                                  np.asarray(ref[1].step_size))
    np.testing.assert_array_equal(np.asarray(resumed[0].position["x"]),
                                  np.asarray(ref[0].position["x"]))


@pytest.mark.parametrize("host_m", ["0", "4"])
def test_segmented_nuts_warmup_ckpt_resume(tmp_path, monkeypatch, host_m):
    """A NUTS warmup killed mid-block resumes from its per-block checkpoint
    with a bit-identical trajectory and evals accounting (per-step keys and
    the window schedule are precomputed from the seed).  Covers both the
    host-driven (MONTECOSMO_NUTS_EVALS_PER_PROGRAM) and the chunked branch."""
    import montecosmo_tpu.script as script

    def logdf(params):
        return -0.5 * jnp.sum(params["x_"] ** 2)

    n_chains, n_steps = 2, 24
    pos = {"x_": jnp.asarray(
        np.random.default_rng(0).standard_normal((n_chains, 4)), jnp.float32)}
    key = jr.key(5)
    ckpt = tmp_path / "warm_ckpt.h5"

    monkeypatch.setattr(script, "MAX_STEPS_PER_CALL", 6)
    monkeypatch.setenv("MONTECOSMO_RUN_CKPT_EVERY", "1")
    monkeypatch.setenv("MONTECOSMO_NUTS_EVALS_PER_PROGRAM", host_m)

    ref_s, ref_c, ref_ev = script._segmented_nuts_warmup(
        logdf, n_steps, n_chains, key, pos)

    # crash at the 3rd checkpoint write: the 2nd checkpoint must remain
    orig_h5save = script.h5save
    calls = {"n": 0}

    def crashing_h5save(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 2:
            raise RuntimeError("simulated worker kill")
        return orig_h5save(*a, **kw)

    monkeypatch.setattr(script, "h5save", crashing_h5save)
    with pytest.raises(RuntimeError, match="simulated"):
        script._segmented_nuts_warmup(logdf, n_steps, n_chains, key, pos,
                                      ckpt_path=ckpt)
    monkeypatch.setattr(script, "h5save", orig_h5save)
    assert list(tmp_path.glob("warm_ckpt_*.h5"))

    res_s, res_c, res_ev = script._segmented_nuts_warmup(
        logdf, n_steps, n_chains, key, pos, ckpt_path=ckpt)
    assert not list(tmp_path.glob("warm_ckpt_*.h5"))  # cleaned up at the end
    np.testing.assert_array_equal(np.asarray(res_c["rest_"]["step_size"]),
                                  np.asarray(ref_c["rest_"]["step_size"]))
    np.testing.assert_array_equal(
        np.asarray(res_c["rest_"]["inverse_mass_matrix"]),
        np.asarray(ref_c["rest_"]["inverse_mass_matrix"]))
    np.testing.assert_array_equal(np.asarray(res_s["rest_"].position["x_"]),
                                  np.asarray(ref_s["rest_"].position["x_"]))
    assert res_ev == ref_ev


def test_nuts_dense_metric_correlated():
    """On a strongly correlated Gaussian, dense window adaptation recovers
    the full covariance (off-diagonals included) and needs far fewer
    integration steps per transition than the diagonal metric at its own
    tuned step size — the failure mode that pins blocked-NUTS scalar
    updates at the tree-depth cap under a diagonal mass."""
    from montecosmo_tpu.samplers.hmc import window_adaptation

    rho = 0.99
    C = np.array([[1.0, rho, 0.0], [rho, 1.0, 0.0], [0.0, 0.0, 0.04]])
    Ci = jnp.asarray(np.linalg.inv(C), jnp.float32)

    def logdf(p):
        return -0.5 * p["x"] @ Ci @ p["x"]

    evals = {}
    for name, im0 in [("dense", jnp.eye(3)), ("diag", jnp.ones(3))]:
        (state, params), hist = window_adaptation(
            nuts_kernel, logdf, 400, {"x": jnp.zeros(3)}, rng_key=jr.key(1),
            initial_inverse_mass_matrix=im0)
        # post-warmup steps (final fast window): tuned operating point
        evals[name] = float(jnp.mean(hist["num_integration_steps"][-50:]))
        if name == "dense":
            est = np.asarray(params["inverse_mass_matrix"])
            assert est.shape == (3, 3)
            # correlation structure recovered (not just the diagonal)
            corr = est[0, 1] / np.sqrt(est[0, 0] * est[1, 1])
            assert corr > 0.9, corr
            assert abs(est[2, 2] - 0.04) < 0.04, est[2, 2]
    # the dense metric removes the long-trajectory regime entirely
    assert evals["dense"] < 0.5 * evals["diag"], evals


def test_laplace_seed_quadratic():
    """On a Gaussian logpdf the Laplace seed is the exact covariance, and a
    saddle direction (negative curvature) is folded positive."""
    from montecosmo_tpu.script import _laplace_seed

    C = np.array([[2.0, 0.6], [0.6, 0.5]])
    Ci = jnp.asarray(np.linalg.inv(C), jnp.float32)

    def logdf(p):
        x = jnp.stack([p["a"], p["b"]])
        return -0.5 * x @ Ci @ x + 10.0 * p["c"] ** 2   # c: negative curvature

    cov, w = _laplace_seed(logdf, {"a": jnp.asarray(0.1), "b": jnp.asarray(-0.2),
                                   "c": jnp.asarray(0.05)}, {})
    cov = np.asarray(cov, np.float64)
    np.testing.assert_allclose(cov[:2, :2], C, rtol=2e-3, atol=2e-3)
    assert cov[2, 2] > 0 and abs(cov[2, 2] - 1 / 20.0) < 1e-3  # |−20| → 1/20
    assert (w > 0).all()


def test_segmented_nuts_warmup_dense_default(monkeypatch):
    """The scalar block of the blocked warmup adapts a DENSE mass by default
    (env-gated) and captures the target's correlation; the mesh block stays
    diagonal."""
    import montecosmo_tpu.script as script

    rho = 0.95
    Ci = jnp.asarray(np.linalg.inv([[1.0, rho], [rho, 1.0]]), jnp.float32)

    def logdf(params):
        s = jnp.stack([params["om_"], params["b1_"]])
        return -0.5 * s @ Ci @ s - 0.5 * jnp.sum(params["white_mesh_"] ** 2)

    n_chains, n_steps = 2, 120
    pos = {"om_": jr.normal(jr.key(0), (n_chains,)),
           "b1_": jr.normal(jr.key(1), (n_chains,)),
           "white_mesh_": jr.normal(jr.key(2), (n_chains, 8))}

    monkeypatch.setattr(script, "MAX_STEPS_PER_CALL", 64)
    state, config, n_ev = script._segmented_nuts_warmup(
        logdf, n_steps, n_chains, jr.key(3), pos)
    assert config["mesh_"]["inverse_mass_matrix"].ndim == 2    # (C, d) diag
    rest = np.asarray(config["rest_"]["inverse_mass_matrix"])
    assert rest.shape == (n_chains, 2, 2)                      # (C, d, d) dense
    corr = rest[:, 0, 1] / np.sqrt(rest[:, 0, 0] * rest[:, 1, 1])
    assert (corr > 0.5).all(), corr

    # env off: falls back to the diagonal metric
    monkeypatch.setenv("MONTECOSMO_NUTS_DENSE_MAX", "0")
    _, config_d, _ = script._segmented_nuts_warmup(
        logdf, 40, n_chains, jr.key(3), pos)
    assert np.asarray(config_d["rest_"]["inverse_mass_matrix"]).shape \
        == (n_chains, 2)


def test_segmented_nuts_warmup_stale_ckpt(tmp_path, monkeypatch):
    """A checkpoint written under a different metric config (dense vs diag)
    is detected as stale and the block restarts instead of crashing."""
    import montecosmo_tpu.script as script

    def logdf(params):
        return -0.5 * jnp.sum(params["x_"] ** 2)

    n_chains, n_steps = 2, 24
    pos = {"x_": jnp.asarray(
        np.random.default_rng(0).standard_normal((n_chains, 4)), jnp.float32)}
    key = jr.key(5)
    ckpt = tmp_path / "warm_ckpt.h5"

    monkeypatch.setattr(script, "MAX_STEPS_PER_CALL", 6)
    monkeypatch.setenv("MONTECOSMO_RUN_CKPT_EVERY", "1")

    orig_h5save = script.h5save
    calls = {"n": 0}

    def crashing_h5save(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 2:
            raise RuntimeError("simulated worker kill")
        return orig_h5save(*a, **kw)

    monkeypatch.setattr(script, "h5save", crashing_h5save)
    with pytest.raises(RuntimeError, match="simulated"):
        script._segmented_nuts_warmup(logdf, n_steps, n_chains, key, pos,
                                      ckpt_path=ckpt)
    monkeypatch.setattr(script, "h5save", orig_h5save)

    # resume under a different metric: dense ckpt no longer matches
    monkeypatch.setenv("MONTECOSMO_NUTS_DENSE_MAX", "0")
    state, config, _ = script._segmented_nuts_warmup(
        logdf, n_steps, n_chains, key, pos, ckpt_path=ckpt)
    assert np.asarray(config["rest_"]["inverse_mass_matrix"]).shape \
        == (n_chains, 4)
    assert np.isfinite(np.asarray(state["rest_"].logdensity)).all()
