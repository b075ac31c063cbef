"""paint_window parity: the scatter-free matmul paint must reproduce ops.paint
bit-for-bit (up to f32 summation order) for lattice-ordered particles within
the displacement bound, across orders, kernels, strides, and group tilings.

Parity: reference montecosmo/nbody.py:365-467 (paint) — same contract as
ops.paint, exercised through the lattice-window formulation.
"""
import numpy as np
import jax
from jax import numpy as jnp

from montecosmo_tpu.ops.paint import paint, interlace, nufft
from montecosmo_tpu.ops.paint_window import paint_window


def _lattice_pos(rng, lat, shape, max_disp, dtype=jnp.float32):
    """Lattice-ordered positions in `shape` cell units, |disp| <= max_disp."""
    stride = np.divide(shape, lat)
    sites = np.stack(np.meshgrid(*(np.arange(l) * s
                                   for l, s in zip(lat, stride)),
                                 indexing="ij"), -1).reshape(-1, 3)
    disp = rng.uniform(-max_disp, max_disp, size=sites.shape)
    return jnp.asarray(sites + disp, dtype)


def test_paint_window_matches_scatter(rng):
    shape = (16, 16, 16)
    for lat in ((16, 16, 16), (8, 8, 8)):
        pos = _lattice_pos(rng, lat, shape, max_disp=3)
        w = jnp.asarray(rng.uniform(0.5, 2.0, size=pos.shape[0]), jnp.float32)
        for order in (1, 2, 3, 4):
            ref = paint(pos % 16.0, shape, w, order)
            got = paint_window(pos, shape, lat, w, order, max_disp=3)
            np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                       rtol=2e-5, atol=2e-5,
                                       err_msg=f"lat={lat} order={order}")


def test_paint_window_kaiser_bessel(rng):
    shape = lat = (16, 16, 16)
    pos = _lattice_pos(rng, lat, shape, max_disp=2)
    for order in (3, 4):
        ref = paint(pos % 16.0, shape, 1.0, order, kernel_type="kaiser_bessel",
                    oversamp=1.5)
        got = paint_window(pos, shape, lat, 1.0, order,
                           kernel_type="kaiser_bessel", oversamp=1.5,
                           max_disp=2)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=2e-5, atol=2e-5,
                                   err_msg=f"KB order={order}")


def test_paint_window_group_tilings(rng):
    """All group tilings give identical meshes (summation-order tolerance)."""
    shape = (16, 16, 16)
    lat = (8, 8, 8)
    pos = _lattice_pos(rng, lat, shape, max_disp=4)
    ref = paint(pos % 16.0, shape, 1.0, 2)
    for group in ((2, 2, None), (4, 4, 8), (8, 8, 8), (1, 1, 1)):
        got = paint_window(pos, shape, lat, 1.0, 2, max_disp=4, group=group)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=2e-5, atol=2e-5,
                                   err_msg=f"group={group}")


def test_paint_window_grad_parity(rng):
    """Position and weight gradients match the scatter paint's."""
    shape = lat = (8, 8, 8)
    pos = _lattice_pos(rng, lat, shape, max_disp=2)
    w = jnp.asarray(rng.uniform(0.5, 2.0, size=pos.shape[0]), jnp.float32)
    probe = jnp.asarray(rng.standard_normal(shape), jnp.float32)

    ref_g = jax.grad(lambda p, w: jnp.vdot(paint(p % 8.0, shape, w, 2), probe),
                     (0, 1))(pos, w)
    win_g = jax.grad(lambda p, w: jnp.vdot(
        paint_window(p, shape, lat, w, 2, max_disp=2), probe), (0, 1))(pos, w)
    for r, g, name in zip(ref_g, win_g, ("pos", "weights")):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_paint_dispatch_via_lattice_shape(rng):
    """paint(lattice_shape=...) routes to the window path with equal output."""
    shape = lat = (8, 8, 8)
    pos = _lattice_pos(rng, lat, shape, max_disp=2)
    ref = paint(pos % 8.0, shape, 1.0, 2)
    got = paint(pos, shape, 1.0, 2, lattice_shape=lat, max_disp=2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


def test_nufft_window_path_matches(rng):
    """Full NUFFT (oversample+interlace+deconv+downsample) via the window
    path equals the scatter path; the margin covers interlacing shifts."""
    final = (8, 8, 8)
    paint_shape = (16, 16, 16)
    lat = (8, 8, 8)
    pos = _lattice_pos(rng, lat, final, max_disp=2)  # final cell units
    w = jnp.asarray(rng.uniform(0.5, 2.0, size=pos.shape[0]), jnp.float32)

    ref = nufft(pos % 8.0, final, paint_shape, weights=w, paint_order=2,
                interlace_order=2)
    got = nufft(pos, final, paint_shape, weights=w, paint_order=2,
                interlace_order=2, lattice_shape=lat, max_disp=4)
    np.testing.assert_allclose(np.asarray(jnp.fft.irfftn(got)),
                               np.asarray(jnp.fft.irfftn(ref)),
                               rtol=1e-4, atol=1e-4)


def test_paint_window_clip_conserves_mass(rng):
    """With clip=True, out-of-bound particles are clamped, not dropped."""
    shape = lat = (8, 8, 8)
    pos = _lattice_pos(rng, lat, shape, max_disp=2)
    # push a few particles far outside the bound
    pos = pos.at[:5].add(jnp.asarray([7.0, -9.0, 11.0]))
    w = jnp.asarray(rng.uniform(0.5, 2.0, size=pos.shape[0]), jnp.float32)

    dropped = paint_window(pos, shape, lat, w, 2, max_disp=2)
    clipped = paint_window(pos, shape, lat, w, 2, max_disp=2, clip=True)
    assert float(dropped.sum()) < float(w.sum()) - 1.0  # mass actually lost
    np.testing.assert_allclose(float(clipped.sum()), float(w.sum()), rtol=1e-5)
    # in-bound particles are untouched by clipping
    ref = paint(pos[5:] % 8.0, shape, w[5:], 2)
    got = paint_window(pos.at[:5].set(pos[5:10]).at[:5].set(0.0), shape, lat,
                       w.at[:5].set(0.0), 2, max_disp=2, clip=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


def test_read_window_matches_read(rng):
    from montecosmo_tpu.ops.paint import read, read_multi
    from montecosmo_tpu.ops.paint_window import read_window

    shape = (16, 16, 16)
    for lat in ((16, 16, 16), (8, 8, 8)):
        pos = _lattice_pos(rng, lat, shape, max_disp=3)
        mesh = jnp.asarray(rng.standard_normal(shape), jnp.float32)
        for order in (1, 2, 3):
            ref = read(pos % 16.0, mesh, order)
            got = read_window(pos, mesh, lat, order, max_disp=3)
            np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"lat={lat} order={order}")
    # multi-channel = read_multi
    pos = _lattice_pos(rng, (8, 8, 8), shape, max_disp=3)
    meshes = jnp.asarray(rng.standard_normal(shape + (5,)), jnp.float32)
    ref = read_multi(pos % 16.0, meshes, 2)
    got = read_window(pos, meshes, (8, 8, 8), 2, max_disp=3)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-5)


def test_read_window_grad(rng):
    """d<read(pos, m), v>/dm == paint(pos, v); pos-grads match read's."""
    from montecosmo_tpu.ops.paint import read
    from montecosmo_tpu.ops.paint_window import read_window

    shape = lat = (8, 8, 8)
    pos = _lattice_pos(rng, lat, shape, max_disp=2)
    mesh = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    v = jnp.asarray(rng.standard_normal(pos.shape[0]), jnp.float32)

    ref = jax.grad(lambda m, p: jnp.vdot(read(p % 8.0, m, 2), v),
                   (0, 1))(mesh, pos)
    got = jax.grad(lambda m, p: jnp.vdot(
        read_window(p, m, lat, 2, max_disp=2), v), (0, 1))(mesh, pos)
    for r, g, name in zip(ref, got, ("mesh", "pos")):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   rtol=2e-4, atol=2e-4, err_msg=name)
