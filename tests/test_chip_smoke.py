"""The bring-up layer: `chip_smoke.py` phases at toy size, the compile-cache
helper, full-precision dots on the logpdf/sampler path, and a lean import.
The sampler and --multi phases are in test_chip_smoke_{sampler,multi}.py, so
that test workers can take them in parallel.

Precision flags are ignored by XLA:CPU, so the TF32 question (a float32 dot
without an explicit precision may run in TF32 on the GPU) is pinned here on
the jaxpr: every `dot_general` must carry Precision.HIGHEST.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax import lax, numpy as jnp, random as jr
from jax._src import core

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from montecosmo_tpu.utils import cache  # noqa: E402


# ------------------------------------------------------------ compile cache
@pytest.mark.parametrize("env", [None, "elsewhere/cache"])
def test_compile_cache_dir(monkeypatch, env):
    before = jax.config.jax_compilation_cache_dir
    if env is None:
        monkeypatch.delenv(cache.ENV_VAR, raising=False)
        assert cache.compile_cache_dir() == str(REPO / ".jax_cache")
    else:
        monkeypatch.setenv(cache.ENV_VAR, env)
        assert cache.compile_cache_dir() == env
        # JAX reads the variable itself: the helper sets no other directory
        assert cache.enable_compile_cache() == env
        assert jax.config.jax_compilation_cache_dir == before


# ------------------------------------------------------------ lean import
def test_import_leaves_out_yaml():
    code = ("import sys, montecosmo_tpu; "
            "print(sorted({'yaml', 'h5py', 'matplotlib'} & set(sys.modules)))")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ------------------------------------------------------------ dot precision
def _dot_precisions(jaxpr):
    """Precision of every dot_general in a (closed) jaxpr, nested included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for p in eqn.params.values():
            for q in (p if isinstance(p, (list, tuple)) else [p]):
                if isinstance(q, core.ClosedJaxpr):
                    out += _dot_precisions(q.jaxpr)
                elif isinstance(q, core.Jaxpr):
                    out += _dot_precisions(q)
    return out


def _model_and_params(paint_method):
    model = bench.flagship_model(16, paint_method)
    params = model.reparam(dict(model.fiduc), inv=True)
    params["white_mesh_"] = jr.normal(jr.key(0), model.init_shape)
    obs = {"count_mesh": jnp.ones(model.final_shape)}
    return model, params, obs


@pytest.mark.parametrize("what", ["logpdf-auto", "logpdf-window", "mclmc"])
def test_every_dot_is_full_precision(what):
    if what == "mclmc":
        model, params, obs = _model_and_params("auto")
        fn = chip_smoke._mclmc_chain(model, obs, n_samples=1, thinning=1)
        jaxpr = jax.make_jaxpr(fn)(jr.key(0), params)
    else:
        model, params, obs = _model_and_params(what.split("-")[1])
        jaxpr = jax.make_jaxpr(jax.value_and_grad(
            lambda q: model.logpdf({**q, **obs})))(params)
    precisions = _dot_precisions(jaxpr.jaxpr)
    assert precisions, "expected dots on this path"
    highest = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)
    assert all(p == highest for p in precisions), precisions


# ------------------------------------------------------------ chip_smoke phases
def test_check_device_raises_on_cpu():
    with pytest.raises(RuntimeError, match="not 'gpu'"):
        chip_smoke.check_device()


def test_phase_paint_16():
    res = chip_smoke.phase_paint(16, max_disp=4)
    assert res["paint_err_HIGHEST"] <= chip_smoke.WINDOW_HIGHEST_TOL
    assert set(res["ms"]) == {
        "paint_scatter", "read_gather", "paint_window_HIGHEST",
        "read_window_HIGHEST", "paint_window_HIGH", "read_window_HIGH"}


def test_phase_model_16():
    out = chip_smoke.phase_model(bench.flagship(16), n_iter=1)
    assert np.isfinite(out["logp"]) and out["eval_s"] > 0


def test_phase_crosscheck_16():
    out = chip_smoke.phase_crosscheck(16, device=jax.devices("cpu")[0])
    assert out["logp_rel"] <= chip_smoke.LOGP_RTOL
    assert out["grad_rel_l2"] <= chip_smoke.GRAD_RL2


# ------------------------------------------------------------ on the card
@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when JAX runs without one (decided here, at
    run time, never at import)."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU: run with "
                    "MONTECOSMO_TEST_PLATFORM=cuda,cpu pytest -m gpu")


@pytest.mark.gpu
def test_paint_kernels_224_on_gpu(gpu_device):
    """Window paint/read at the 128^3 model's 224^3 lattice against the XLA
    scatter/gather reference, compiled for the card (phase 2 of
    chip_smoke.py without the timing)."""
    with jax.default_device(gpu_device):
        res = chip_smoke.phase_paint(224, max_disp=9, timing=False)
    assert res["paint_err_HIGHEST"] <= chip_smoke.WINDOW_HIGHEST_TOL
    assert res["read_err_HIGHEST"] <= chip_smoke.WINDOW_HIGHEST_TOL
