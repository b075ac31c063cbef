"""Wavevector factories, Fourier filter kernels, and mass-assignment windows.

All kernel factories return *numpy* broadcast-shaped arrays ((N,1,1), (1,N,1),
(1,1,N/2+1)); XLA constant-folds them into the surrounding FFT pipelines, so a
Poisson solve + gradient is a single fused elementwise pass over the rfft mesh
(no materialized N^3 kernel tensors).

Parity: reference `montecosmo/nbody.py:50-363` (rfftk/fftk, invlaplace/gradient/
gaussian/top-hat kernels, B-spline & Kaiser-Bessel windows, deconv_paint).
"""
from functools import partial

import numpy as np
from jax import numpy as jnp

from montecosmo_tpu.utils.safe import safe_div


# ------------------------------------------------------------------ 3-D FFT entry
def _pencil_island(x, inverse):
    """Pencil shard_map island for `x` when a mesh context is active and the
    shapes divide; None -> caller falls back to the local FFT."""
    from montecosmo_tpu.parallel.context import current_mesh_context

    ctx = current_mesh_context()
    if ctx is None or x.ndim != 3:
        return None
    mesh, ax = ctx
    n_dev = mesh.shape[ax]
    if n_dev <= 1 or x.shape[0] % n_dev or x.shape[1] % n_dev:
        return None

    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from montecosmo_tpu.parallel.fft import (
        _pencil_irfftn_local, _pencil_rfftn_local,
    )

    if inverse:  # (X, Y, Hz+1) Y-pencil -> (X, Y, Z) X-slab
        return shard_map(partial(_pencil_irfftn_local, axis_name=ax),
                         mesh=mesh, in_specs=P(None, ax, None),
                         out_specs=P(ax, None, None), check_vma=False)
    return shard_map(partial(_pencil_rfftn_local, axis_name=ax),
                     mesh=mesh, in_specs=P(ax, None, None),
                     out_specs=P(None, ax, None), check_vma=False)


def rfftn(x):
    """3-D real FFT of a mesh (global-array semantics).

    Inside `parallel.context.mesh_context` this decomposes into the pencil
    shard_map island (two local 1-D FFT passes + ONE all_to_all over the
    device-mesh axis; input X-slab sharded, output Y-pencil sharded) —
    everything around it is partitioned by GSPMD from the island shardings.
    Outside a context (or on non-dividing shapes) it is `jnp.fft.rfftn`.
    """
    island = _pencil_island(x, inverse=False)
    return jnp.fft.rfftn(x) if island is None else island(x)


def irfftn(x):
    """Inverse of `rfftn` (even last extent), context-aware like it."""
    island = _pencil_island(x, inverse=True)
    return jnp.fft.irfftn(x) if island is None else island(x)


# --------------------------------------------------------------------- wavevectors
def rfftk(shape, box_size=None, dtype=np.float32):
    """Broadcast-shaped wavevectors for `rfftn`.

    In cell units (k in [-pi, pi[) by default; in physical units (h/Mpc) when
    `box_size` is given.

    Returns a tuple of arrays with shapes (N0,1,..), (1,N1,..), .., (..,Nd/2+1)
    so `sum(ki**2 for ki in kvec)` broadcasts to the full rfft mesh lazily.
    """
    dim = len(shape)
    scales = dim * (2 * np.pi,) if box_size is None else tuple(
        2 * np.pi * s / b for s, b in zip(shape, box_size))

    kvec = ()
    for ax, (s, sc) in enumerate(zip(shape, scales)):
        freq = np.fft.rfftfreq(s) if ax == dim - 1 else np.fft.fftfreq(s)
        bshape = [1] * dim
        bshape[ax] = -1
        kvec += ((freq * sc).astype(dtype).reshape(bshape),)
    return kvec


def fftk(shape, box_size=None, dtype=np.float32):
    """Broadcast-shaped wavevectors for full `fftn` (rarely needed)."""
    dim = len(shape)
    scales = dim * (2 * np.pi,) if box_size is None else tuple(
        2 * np.pi * s / b for s, b in zip(shape, box_size))

    kvec = ()
    for ax, (s, sc) in enumerate(zip(shape, scales)):
        bshape = [1] * dim
        bshape[ax] = -1
        kvec += ((np.fft.fftfreq(s) * sc).astype(dtype).reshape(bshape),)
    return kvec


def lazy_kvec(kvec, like, min_size=8_000_000):
    """Tie broadcast-shaped wavevectors to tracer `like` so downstream
    kernel algebra (sums/products over axes) stages ON DEVICE.

    Without this, kernels like 1/k^2 or sinc^n window deconvolutions are
    computed eagerly at trace time and baked into the serialized program as
    full (N, N, N/2+1) literals, which bloat every big compile.  Tying each
    1-D factor to a traced zero keeps the serialized constants 1-D; XLA
    materializes (and fuses) the N^3 kernel on device.

    Size-gated: below `min_size` broadcast elements the kernels stay eager
    compile-time constants, which are not recomputed per evaluation.  Inside
    a `parallel.context.mesh_context` the gate is ignored: literal kernel
    constants stay REPLICATED on every device (GSPMD does not slice
    literals — measured 3x full-size f32[224,224,113] constants in the 128^3
    flagship HLO at n=8), while device-staged iota kernels partition with
    their consumers.
    """
    import jax

    from montecosmo_tpu.parallel.context import current_mesh_context

    nelem = int(np.prod([max(np.shape(ki)) for ki in kvec]))
    if nelem < min_size and current_mesh_context() is None:
        return kvec
    # stop_gradient: the tie is structural only — without it, kernels like
    # sqrt(sum ki^2) would get an inf * 0 = NaN cotangent at the zero mode.
    # Scalar-index (NOT ravel) the tracer: ravel = reshape merging a
    # pencil-sharded dim — unpartitionable, GSPMD all-gathers the FULL rfft
    # mesh (34 full-size c64[224,224,113] buffers in the 128^3/n=8 HLO)
    like = jax.lax.stop_gradient(like)
    z = jnp.real(like[(0,) * jnp.ndim(like)]) * 0
    return tuple(jnp.asarray(ki) + z.astype(jnp.asarray(ki).dtype)
                 for ki in kvec)


# --------------------------------------------------------------------- filter kernels
def invlaplace_hat(kvec, fd_order=np.inf):
    """Fourier transform of the inverse Laplacian, -1/k^2 (or its finite
    difference counterpart for fd_order 2/4).  Zero mode maps to zero."""
    if fd_order == 2:
        kk = sum(2 * (jnp.cos(ki) - 1) for ki in kvec)
    elif fd_order == 4:
        kk = sum((jnp.cos(2 * ki) - 16 * jnp.cos(ki) + 15) / 6 for ki in kvec)
    elif fd_order == np.inf:
        kk = sum(ki**2 for ki in kvec)
    else:
        raise ValueError("fd_order must be 2, 4, or inf.")
    return -safe_div(1.0, kk)


def gradient_hat(kvec, direction: int, fd_order=np.inf):
    """Fourier transform of the spatial gradient along `direction`: i*k (or its
    finite-difference counterpart for fd_order 2/4)."""
    ki = kvec[direction]
    if fd_order == 2:
        ki = jnp.sin(ki)
    elif fd_order == 4:
        ki = (8 * jnp.sin(ki) - jnp.sin(2 * ki)) / 6
    elif fd_order != np.inf:
        raise ValueError("fd_order must be 2, 4, or inf.")
    return 1j * ki


def gaussian_hat(kvec, kcut=np.inf):
    """Gaussian low-pass filter with cutoff wavenumber `kcut`."""
    if kcut == np.inf:
        return 1.0
    kk = sum(ki**2 for ki in kvec)
    rcut = 2 * np.pi / kcut
    return jnp.exp(-kk * rcut**2 / 2)


def top_hat(kvec, kcut=np.inf):
    """Isotropic boolean top-hat |k| < kcut.

    Boolean on purpose: `jnp.where(top_hat(...), mesh, 0)` fuses into a select
    rather than a multiply, and the mask doubles as the sampled-mode cut mask.
    """
    if kcut == np.inf:
        return True
    kk = sum(ki**2 for ki in kvec)
    return kk < kcut**2


# --------------------------------------------------------------------- MAS windows
def bspline(s, order: int):
    """Real-space B-spline mass-assignment window of given order.

    order 0: Dirac, 1: NGP, 2: CIC, 3: TSC, 4: PCS
    (Sefusatti+2017 arXiv:1512.07295; List&Hahn 2024 arXiv:2309.10865).
    `s` is the (signed) distance to the cell center in cell units.
    """
    s = jnp.abs(s)
    if order == 0:
        return jnp.full(jnp.shape(s)[-1:], jnp.inf)
    if order == 1:
        return jnp.full(jnp.shape(s)[-1:], 1.0)
    if order == 2:
        return 1 - s
    if order == 3:
        return jnp.where(s <= 0.5, 0.75 - s**2, 0.5 * jnp.maximum(1.5 - s, 0.0)**2)
    if order == 4:
        return jnp.where(s <= 1.0,
                         (4 - 6 * s**2 + 3 * s**3) / 6,
                         jnp.maximum(2.0 - s, 0.0)**3 / 6)
    raise ValueError("B-spline order must be in 0..4.")


def bspline_hat(kvec, order: int = 2):
    """Fourier transform of the order-n B-spline window: prod_i sinc(k_i/2pi)^n."""
    out = 1.0
    for ki in kvec:
        out = out * jnp.sinc(ki / (2 * np.pi))**order
    return out


def optim_kcut(oversamp, safety=0.98):
    """Near-optimal k-cutoff for PSWF-like (Kaiser-Bessel) kernels at a given
    oversampling factor (Barnett+2019 arXiv:1808.06736)."""
    return safety * jnp.pi * (2 - 1 / oversamp)


def kaiser_bessel(s, order, kcut):
    """Kaiser-Bessel window of support `order` cells (Barnett+2019)."""
    s = s * 2 / order
    beta = kcut * order / 2
    out = jnp.i0(beta * jnp.sqrt(jnp.maximum(1 - s**2, 0.0)))
    return out / (order * jnp.sinh(beta) / beta)


def kaiser_bessel_hat(kvec, order, kcut):
    """Fourier transform of the Kaiser-Bessel window (Barnett+2019)."""
    def kernel(k, kcut):
        k = k * order / 2
        beta = kcut * order / 2
        dist = jnp.abs(beta**2 - k**2)**0.5
        bulk = jnp.sinh(dist) / dist
        tail = jnp.sin(dist) / dist
        out = jnp.where(jnp.abs(k) <= beta, bulk, tail)
        return out / (jnp.sinh(beta) / beta)

    out = 1.0
    for ki in kvec:
        out = out * kernel(ki, kcut)
    return out


def window_hat(kvec, order: int, kernel_type="rectangular", oversamp=1.0):
    """Fourier transform of the selected paint window."""
    if kernel_type == "rectangular":
        return bspline_hat(kvec, order)
    if kernel_type == "kaiser_bessel":
        return kaiser_bessel_hat(kvec, order, optim_kcut(oversamp))
    raise ValueError(f"Unknown kernel type: {kernel_type}")


def deconv_paint(mesh, order: int = 2, kernel_type="rectangular", oversamp=1.0):
    """Deconvolve a painted mesh by its paint window.

    Accepts a real mesh (adds an rfftn/irfftn pair) or an rfft mesh (single
    fused elementwise divide).
    """
    from montecosmo_tpu.ops.hermitian import ch2rshape

    if jnp.isrealobj(mesh):
        kvec = lazy_kvec(rfftk(mesh.shape), mesh)
        return irfftn(rfftn(mesh) / window_hat(kvec, order, kernel_type, oversamp))
    kvec = lazy_kvec(rfftk(ch2rshape(mesh.shape)), mesh)
    return mesh / window_hat(kvec, order, kernel_type, oversamp)
