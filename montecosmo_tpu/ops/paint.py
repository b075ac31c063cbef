"""Mass assignment: scatter (paint) / gather (read), interlacing, and NUFFT.

Formulation: the order^d stencil is a `lax.scan` whose body does ONE flat 1-D
scatter-add (or gather) over all particles — per-axis indices are
combined into a single flat int32 index so XLA emits its fastest scatter
variant, and the loop over stencil shifts is compiled once.  Positions are in
cell units with periodic wrap-around; windows are the exact order-0..4
B-splines or Kaiser-Bessel of the reference.

`read` is the adjoint of `paint` with respect to the weights (same window,
same wrap), which reverse-mode AD recovers automatically: grad of a painted
mesh w.r.t. weights is a read, and vice versa.

This scatter/gather pair is the single-device paint route of the model and
the reference that the lattice-window formulation (`ops.paint_window`, used
under a device-mesh context) is tested against.

Parity: reference `montecosmo/nbody.py:365-577` (paint/read/interlace/nufft).
"""
from functools import partial
from itertools import product

import numpy as np
from jax import lax, numpy as jnp

from montecosmo_tpu.ops.fourier import (
    irfftn, rfftn,
    bspline, kaiser_bessel, lazy_kvec, optim_kcut, rfftk, window_hat,
)
from montecosmo_tpu.ops.hermitian import chreshape, r2chshape, scale_shape


def _window_fn(order, kernel_type, oversamp):
    if kernel_type == "rectangular":
        return lambda s: bspline(s, order)
    if kernel_type == "kaiser_bessel":
        return lambda s: kaiser_bessel(s, order, optim_kcut(oversamp))
    raise ValueError(f"Unknown kernel type: {kernel_type}")


def _stencil(shape, order):
    """(order^d, d) integer stencil offsets around the base cell."""
    shifts = np.arange(order) - (order - 1) // 2
    return np.asarray(list(product(*len(shape) * (shifts,))), dtype=np.int32)


def _flat_wrapped(idx, shape):
    """Combine per-axis indices into a flat index with periodic wrap."""
    strides = np.asarray(
        [int(np.prod(shape[ax + 1:])) for ax in range(len(shape))], dtype=np.int32)
    idx = idx % np.asarray(shape, dtype=np.int32)
    return (idx * strides).sum(-1)


def paint(pos, shape: tuple, weights=1.0, order: int = 2,
          kernel_type="rectangular", oversamp=1.0, lattice_shape=None,
          max_disp=8, clip=False):
    """Scatter particle `weights` onto a mesh of `shape`.

    pos : (..., d) positions in cell units (periodically wrapped).
    lattice_shape : if given, positions are lattice-ordered with
        |pos - site| <= max_disp cells per axis, and painting runs on the
        scatter-free window path (`ops.paint_window`), which partitions
        under a device-mesh context; otherwise the XLA scatter-add below.
    Returns a real mesh of `shape`.
    """
    shape = tuple(int(s) for s in shape)
    if lattice_shape is not None:
        w = jnp.reshape(weights, (-1,)) if jnp.ndim(weights) else weights
        from montecosmo_tpu.ops.paint_window import paint_window
        return paint_window(pos.reshape(-1, len(shape)), shape, lattice_shape,
                            w, order, kernel_type, oversamp,
                            max_disp=max_disp, clip=clip)
    kernel = _window_fn(order, kernel_type, oversamp)
    round_fn = jnp.round if order % 2 else jnp.floor
    id0 = round_fn(pos).astype(jnp.int32)
    shifts = _stencil(shape, order)

    n = int(np.prod(shape))
    weights = jnp.broadcast_to(jnp.asarray(weights, pos.dtype), pos.shape[:-1])

    def step(carry, shift):
        idx = id0 + shift
        ker = kernel(idx - pos).prod(-1)
        carry = carry.at[_flat_wrapped(idx, shape).reshape(-1)].add(
            (weights * ker).reshape(-1))
        return carry, None

    mesh = lax.scan(step, jnp.zeros(n, dtype=pos.dtype), shifts)[0]
    return mesh.reshape(shape)


def read(pos, mesh, order: int = 2, kernel_type="rectangular", oversamp=1.0):
    """Gather mesh values at particle positions (adjoint of `paint`)."""
    shape = tuple(int(s) for s in mesh.shape)
    kernel = _window_fn(order, kernel_type, oversamp)
    round_fn = jnp.round if order % 2 else jnp.floor
    id0 = round_fn(pos).astype(jnp.int32)
    shifts = _stencil(shape, order)
    flat = mesh.reshape(-1)

    def step(carry, shift):
        idx = id0 + shift
        ker = kernel(idx - pos).prod(-1)
        return carry + flat[_flat_wrapped(idx, shape)] * ker, None

    out = lax.scan(step, jnp.zeros(pos.shape[:-1], dtype=mesh.dtype), shifts)[0]
    return out


def read_multi(pos, meshes, order: int = 2, kernel_type="rectangular",
               oversamp=1.0):
    """Gather SEVERAL meshes at the same positions with one row-gather per
    stencil shift.

    Fields are interleaved cell-major (shape (X, Y, Z, C)) so each gathered
    index fetches C contiguous floats.

    meshes : list/tuple of (X,Y,Z) arrays or one (X,Y,Z,C) array.
    Returns (..., C) values at the positions.
    """
    if isinstance(meshes, (list, tuple)):
        meshes = jnp.stack(meshes, axis=-1)
    shape = tuple(int(s) for s in meshes.shape[:-1])
    C = meshes.shape[-1]
    kernel = _window_fn(order, kernel_type, oversamp)
    round_fn = jnp.round if order % 2 else jnp.floor
    id0 = round_fn(pos).astype(jnp.int32)
    shifts = _stencil(shape, order)
    flat = meshes.reshape(-1, C)

    def step(carry, shift):
        idx = id0 + shift
        ker = kernel(idx - pos).prod(-1)
        return carry + flat[_flat_wrapped(idx, shape)] * ker[..., None], None

    out = lax.scan(step, jnp.zeros(pos.shape[:-1] + (C,), dtype=meshes.dtype),
                   shifts)[0]
    return out


def read_sites(meshes, sites_shape: tuple):
    """Read mesh(es) at the `regular_pos(mesh_shape, sites_shape)` lattice.

    When mesh_shape % sites_shape == 0 the sites are exact integer cells, so
    NGP/CIC reads (order <= 2) reduce to strided slicing — zero gather
    traffic, and the backward pass is a zero-insert instead of a scatter.
    Equals `read(regular_pos(shape, sites_shape), meshes, order)` for
    order in (1, 2).

    meshes : (X, Y, Z), (X, Y, Z, C), or a list of (X, Y, Z) arrays.
    Returns (prod(sites_shape),) or (prod(sites_shape), C).
    """
    if isinstance(meshes, (list, tuple)):
        meshes = jnp.stack(meshes, axis=-1)
    shape = meshes.shape[:3]
    assert all(int(m) % int(p) == 0 for m, p in zip(shape, sites_shape)), (
        f"mesh {shape} must be a multiple of the site lattice {sites_shape}")
    r = [int(m) // int(p) for m, p in zip(shape, sites_shape)]
    vals = meshes[::r[0], ::r[1], ::r[2]]
    return vals.reshape((-1,) + meshes.shape[3:])


def interlace(pos, shape: tuple, weights=1.0, paint_order: int = 2,
              interlace_order: int = 2, kernel_type="rectangular",
              paint_oversamp: float = 1.0, lattice_shape=None, max_disp=8,
              clip=False):
    """Equal-spacing interlaced painting in Fourier space.

    Paints `interlace_order` diagonally shifted clouds and accumulates their
    phase-rotated rffts, cancelling the leading aliasing images
    (Wang&Yu 2024 arXiv:2403.13561).  interlace_order >= 3 is not isotropic.
    The paint_window margin covers the sub-cell interlacing shifts, so
    `lattice_shape`/`max_disp` pass straight through.
    """
    kvec = rfftk(shape)
    shifts = jnp.arange(interlace_order) / interlace_order

    def step(carry, shift):
        mesh = paint(pos + shift, shape, weights, paint_order,
                     kernel_type=kernel_type, oversamp=paint_oversamp,
                     lattice_shape=lattice_shape, max_disp=max_disp, clip=clip)
        # separable phase exp(i s (kx+ky+kz)) = prod_i exp(i s k_i): three
        # 1-D factors traced against the scanned shift — never an N^3
        # literal in the serialized program
        phase = 1.0
        for ki in kvec:
            phase = phase * jnp.exp(1j * shift * ki)
        carry += rfftn(mesh) * phase / interlace_order
        return carry, None

    out = jnp.zeros(r2chshape(shape), dtype=jnp.result_type(pos.dtype, jnp.complex64))
    return lax.scan(step, out, shifts)[0]


def nufft(pos, final_shape: tuple, paint_shape=None, weights=1.0,
          paint_order: int = 2, interlace_order: int = 2,
          kernel_type="rectangular", paint_deconv=True, lattice_shape=None,
          max_disp=8, clip=False):
    """Non-uniform FFT: oversampled paint + interlace + window deconvolution +
    power-preserving Fourier downsample to `final_shape`.

    pos is in final-shape cell units; the units jacobian is applied so the
    irfftn of the result sums to the total particle weight.

    paint_shape : None (= final_shape), float oversampling factor, or shape.
    lattice_shape : optional particle-lattice shape for the scatter-free window
        paint (positions lattice-ordered, within max_disp PAINT cells of
        their sites; requires paint_shape to be a multiple of it).
    Returns the rfft mesh at `r2chshape(final_shape)`.
    """
    if paint_shape is None:
        paint_shape, paint_oversamp = final_shape, 1.0
    elif isinstance(paint_shape, float):
        paint_oversamp = paint_shape
        paint_shape = scale_shape(final_shape, paint_oversamp)
    elif isinstance(paint_shape, (tuple, list, np.ndarray)):
        paint_oversamp = float(np.exp(np.log(np.divide(final_shape, paint_shape)).mean()))
    else:
        raise ValueError("paint_shape must be None, a float, or a shape")

    ratio = np.divide(paint_shape, final_shape)
    pos = pos * ratio.astype(pos.dtype)  # final units -> paint units (no mutation)
    mesh = interlace(pos, tuple(paint_shape), weights, paint_order, interlace_order,
                     kernel_type=kernel_type, paint_oversamp=paint_oversamp,
                     lattice_shape=lattice_shape, max_disp=max_disp, clip=clip)
    mesh *= ratio.prod()  # units jacobian: conserve total counts

    if paint_deconv:
        kvec = lazy_kvec(rfftk(tuple(paint_shape)), mesh)
        mesh /= window_hat(kvec, paint_order, kernel_type, paint_oversamp)
    if tuple(final_shape) != tuple(paint_shape):
        mesh = chreshape(mesh, r2chshape(final_shape))
    return mesh
