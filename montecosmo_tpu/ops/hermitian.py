"""Hermitian real<->complex repacking and power-preserving Fourier resampling.

`rg2cgh` permutes and reweights a real Gaussian tensor into a complex Hermitian
tensor distributed exactly like `rfftn` of a white-noise field; `cgh2rg` is its
inverse.  This is how the initial-density latent is sampled in unconstrained
N(0,1) coordinates while the model consumes Fourier coefficients.

Design: the bijection is built from static slices, flips and concatenations
with numpy-precomputed weights (cached per shape), instead of a sequence of
~30 dynamic-update-slices over faces/edges/vertices.

Math (even dims, rfft layout (Nx,Ny,Nz/2+1), backward FFT convention):
  * bulk 0<kz<Hz : free complex modes; Re <- in[:,:,1:Hz], Im <- in[:,:,Hz+1:].
  * kz in {0,Hz} : 2D-Hermitian planes packed into input planes z=0 and z=Hz,
    recursively (bulk rows -> free modes, border lines -> 1D Hermitian,
    corners -> 8 self-conjugate pure-real modes with doubled variance).
  * mirror entries (the redundant half of each plane) are filled by conjugate
    symmetry so downstream irfftn sees a valid Hermitian tensor.
Variances: Re,Im ~ N(0, n/2) on free modes, Re ~ N(0, n) on self-conjugate
modes — matching rfftn(N(0,I)) exactly in distribution.

Parity: reference `montecosmo/utils.py:769-1139` (rg2cgh/cgh2rg/id_cgh/
chreshape/boxreshape/scale_shape/mesh2masked).
"""
from functools import lru_cache

import jax
import numpy as np
from jax import numpy as jnp


# ----------------------------------------------------------------------- shapes
def ch2rshape(shape):
    """Complex Hermitian (rfft) shape -> real shape (assumes even last dim)."""
    return (*shape[:-1], 2 * (shape[-1] - 1))


def r2chshape(shape):
    """Real shape -> complex Hermitian (rfft) shape."""
    return (*shape[:-1], shape[-1] // 2 + 1)


def scale_shape(shape: tuple, scale=1.0):
    """Nearest valid (even) scaled mesh shape."""
    out = 2 * np.rint(np.multiply(shape, scale) / 2).astype(int)
    return tuple(map(int, out))


# ----------------------------------------------------------------------- repack plan
_NORMS = ("backward", "ortho", "forward", "amp")


@lru_cache(maxsize=None)
def _repack_plan(shape):
    """Precompute the repack permutation for a 3D even `shape`.

    Returns numpy arrays over the rfft grid:
      rsrc, isrc : flat input index supplying the real / imag part,
      sgn        : +-1 sign of the imag part (conjugate mirrors),
      selfc      : self-conjugate (pure real, doubled variance) mask,
      canon      : canonical holder mask (True where the coefficient actually
                   owns its input degrees of freedom, False on mirrors),
    and over the flat input grid (for the inverse):
      inv_src    : flat rfft index to read,
      inv_part   : False -> real part, True -> imag part,
      inv_selfc  : cell feeds a self-conjugate coefficient.
    """
    Nx, Ny, Nz = map(int, shape)
    assert Nx % 2 == Ny % 2 == Nz % 2 == 0, "dimension lengths must be even."
    Hx, Hy, Hz = Nx // 2, Ny // 2, Nz // 2
    cshape = (Nx, Ny, Hz + 1)

    def flat(ix, iy, iz):
        return ((ix * Ny) + iy) * Nz + iz

    rsrc = np.zeros(cshape, np.int32)
    isrc = np.zeros(cshape, np.int32)
    sgn = np.ones(cshape, np.float32)
    selfc = np.zeros(cshape, bool)
    canon = np.zeros(cshape, bool)

    IX = np.arange(Nx)[:, None]
    IY = np.arange(Ny)[None, :]

    # bulk: free complex modes, one real dof pair per coefficient
    kz = np.arange(1, Hz)
    rsrc[:, :, 1:Hz] = flat(IX[..., None], IY[..., None], kz)
    isrc[:, :, 1:Hz] = flat(IX[..., None], IY[..., None], Hz + kz)
    canon[:, :, 1:Hz] = True

    # kz in {0, Hz}: 2D Hermitian planes packed into input planes z=0 and z=Hz
    for kk, zk in ((0, 0), (Hz, Hz)):
        # canonical rows 0 < j < Hy
        j = np.arange(1, Hy)
        rsrc[:, 1:Hy, kk] = flat(IX, j, zk)
        isrc[:, 1:Hy, kk] = flat(IX, Hy + j, zk)
        canon[:, 1:Hy, kk] = True
        # mirror rows Hy < j < Ny: conj of (-i, -j)
        j = np.arange(Hy + 1, Ny)
        jm = Ny - j
        im = (-IX) % Nx
        rsrc[:, Hy + 1:, kk] = flat(im, jm, zk)
        isrc[:, Hy + 1:, kk] = flat(im, Hy + jm, zk)
        sgn[:, Hy + 1:, kk] = -1.0
        # border lines j in {0, Hy}: 1D Hermitian along x
        for j in (0, Hy):
            i = np.arange(1, Hx)
            rsrc[1:Hx, j, kk] = flat(i, j, zk)
            isrc[1:Hx, j, kk] = flat(Hx + i, j, zk)
            canon[1:Hx, j, kk] = True
            i = np.arange(Hx + 1, Nx)
            im = Nx - i
            rsrc[Hx + 1:, j, kk] = flat(im, j, zk)
            isrc[Hx + 1:, j, kk] = flat(Hx + im, j, zk)
            sgn[Hx + 1:, j, kk] = -1.0
            # self-conjugate corners i in {0, Hx}
            for i in (0, Hx):
                rsrc[i, j, kk] = flat(i, j, zk)
                isrc[i, j, kk] = flat(i, j, zk)  # unused (weight 0)
                selfc[i, j, kk] = True
                canon[i, j, kk] = True

    # inverse: every input cell is owned by exactly one canonical assignment
    n = Nx * Ny * Nz
    coeff_flat = np.arange(np.prod(cshape), dtype=np.int32).reshape(cshape)
    inv_src = np.full(n, -1, np.int32)
    inv_part = np.zeros(n, bool)
    inv_selfc = np.zeros(n, bool)

    free = canon & ~selfc
    inv_src[rsrc[free]] = coeff_flat[free]
    inv_src[isrc[free]] = coeff_flat[free]
    inv_part[isrc[free]] = True
    inv_src[rsrc[selfc]] = coeff_flat[selfc]
    inv_selfc[rsrc[selfc]] = True
    assert (inv_src >= 0).all(), "repack plan does not cover all input cells"

    return dict(rsrc=rsrc, isrc=isrc, sgn=sgn, selfc=selfc, canon=canon,
                inv_src=inv_src, inv_part=inv_part, inv_selfc=inv_selfc)


def _base_weight(shape, norm):
    n = float(np.prod(shape))
    if norm == "backward":
        return (n / 2) ** 0.5
    if norm == "ortho":
        return 0.5 ** 0.5
    if norm == "forward":
        return 1 / (2 * n) ** 0.5
    if norm == "amp":
        return 1.0
    raise ValueError(f"norm must be one of {_NORMS}")


def _negx(a, axis=0):
    """Index map i -> (-i) mod N along `axis`, as slices + a flip
    (contiguous copies — no gather)."""
    head = lax_slice_axis(a, 0, 1, axis)
    tail = jnp.flip(lax_slice_axis(a, 1, None, axis), axis)
    return jnp.concatenate([head, tail], axis)


def lax_slice_axis(a, start, stop, axis):
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(start, stop)
    return a[tuple(idx)]


def _pack_line(col, Hx, corner_scale):
    """1D Hermitian line along x from a (Nx, ...) real column.

    Returns (re, im) of shape (Nx, ...): canonical 0<i<Hx from col[1:Hx]
    (re) / col[Hx+1:] (im), conjugate mirrors for i>Hx, pure-real
    (x corner_scale) self-conjugate points at i in {0, Hx}.
    """
    seg_r = col[1:Hx]
    seg_i = col[Hx + 1:]
    c0 = col[0:1] * corner_scale
    cH = col[Hx:Hx + 1] * corner_scale
    re = jnp.concatenate([c0, seg_r, cH, jnp.flip(seg_r, 0)], 0)
    im = jnp.concatenate([jnp.zeros_like(c0), seg_i, jnp.zeros_like(cH),
                          -jnp.flip(seg_i, 0)], 0)
    return re, im


def _pack_plane(p, corner_scale):
    """2D Hermitian plane (Nx, Ny) from a real (Nx, Ny) input plane.

    Canonical rows 0<j<Hy (re from p[:,1:Hy], im from p[:,Hy+1:]), conjugate
    mirror rows for j>Hy, 1D Hermitian border lines at j in {0, Hy}.
    All slices/flips/concats.
    """
    Nx, Ny = p.shape[:2]
    Hx, Hy = Nx // 2, Ny // 2

    rows_r = p[:, 1:Hy]
    rows_i = p[:, Hy + 1:]
    mir_r = _negx(jnp.flip(rows_r, 1), 0)
    mir_i = -_negx(jnp.flip(rows_i, 1), 0)

    l0_r, l0_i = _pack_line(p[:, 0], Hx, corner_scale)
    lH_r, lH_i = _pack_line(p[:, Hy], Hx, corner_scale)

    re = jnp.concatenate([l0_r[:, None], rows_r, lH_r[:, None], mir_r], 1)
    im = jnp.concatenate([l0_i[:, None], rows_i, lH_i[:, None], mir_i], 1)
    return re, im


def rg2cgh(mesh, norm="backward"):
    """Real Gaussian tensor -> complex Gaussian Hermitian tensor.

    `rg2cgh(N(0,I), norm)` is distributed exactly as `rfftn(N(0,I), norm)`,
    and with `mean, amp = cgh2rg(meank, norm), cgh2rg(ampk, 'amp')`,
    `rg2cgh(mean + amp * N(0,I), norm)` is distributed as
    `meank + ampk * rfftn(N(0,I), norm)`.

    The permutation is composed entirely of static slices, flips and
    concatenations (contiguous copies, no arbitrary-index gathers).

    norm='amp' returns the RMS amplitude of the (real, imag) source pair —
    used to transport per-mode std fields into the real packing.
    """
    shape = tuple(mesh.shape)
    Nx, Ny, Nz = shape
    assert Nx % 2 == Ny % 2 == Nz % 2 == 0, "dimension lengths must be even."
    Hz = Nz // 2
    amp = norm == "amp"
    corner_scale = 1.0 if amp else 2**0.5

    # bulk: free complex modes along z
    bulk_r = mesh[:, :, 1:Hz]
    bulk_i = mesh[:, :, Hz + 1:]
    # planes z=0 and z=Hz: 2D Hermitian packing
    p0_r, p0_i = _pack_plane(mesh[:, :, 0], corner_scale)
    pH_r, pH_i = _pack_plane(mesh[:, :, Hz], corner_scale)

    re = jnp.concatenate([p0_r[:, :, None], bulk_r, pH_r[:, :, None]], 2)
    im = jnp.concatenate([p0_i[:, :, None], bulk_i, pH_i[:, :, None]], 2)

    from montecosmo_tpu.parallel.context import constrain_mesh

    if amp:
        # RMS of the source pair; the zero imag at self-conjugate points is
        # treated as sharing the real amplitude (reference 'amp' semantics)
        im_amp = jnp.where(im == 0, re, im)
        return constrain_mesh(((re**2 + im_amp**2) / 2) ** 0.5, "pencil")
    w = _base_weight(shape, norm)
    return constrain_mesh(jax.lax.complex(re * w, im * w), "pencil")


def _unpack_line(re, im, Hx, corner_scale):
    """Inverse of `_pack_line`: (Nx,...) canonical real column."""
    return jnp.concatenate([re[0:1] / corner_scale, re[1:Hx],
                            re[Hx:Hx + 1] / corner_scale, im[1:Hx]], 0)


def _unpack_plane(re, im, corner_scale):
    """Inverse of `_pack_plane`: canonical real (Nx, Ny) plane."""
    Nx, Ny = re.shape[:2]
    Hx, Hy = Nx // 2, Ny // 2
    l0 = _unpack_line(re[:, 0], im[:, 0], Hx, corner_scale)
    lH = _unpack_line(re[:, Hy], im[:, Hy], Hx, corner_scale)
    return jnp.concatenate([l0[:, None], re[:, 1:Hy], lH[:, None],
                            im[:, 1:Hy]], 1)


def cgh2rg(meshk, norm="backward"):
    """Complex Gaussian Hermitian tensor -> real Gaussian tensor (inverse of
    `rg2cgh`; slices/flips/concats only).

    norm='amp' assigns to each real cell the real part of the coefficient it
    feeds (same amplitude for both real- and imag-part cells) — the transport
    of a per-mode std field into real packing.
    """
    shape = ch2rshape(meshk.shape)
    Nx, Ny, Nz = shape
    Hz = Nz // 2
    amp = norm == "amp"
    corner_scale = 1.0 if amp else 2**0.5

    if amp:
        re = meshk.real
        im = meshk.real
        w = 1.0
    else:
        w = _base_weight(shape, norm)
        re = meshk.real / w
        im = meshk.imag / w

    p0 = _unpack_plane(re[:, :, 0], im[:, :, 0], corner_scale)
    pH = _unpack_plane(re[:, :, Hz], im[:, :, Hz], corner_scale)
    # reassemble z order: [plane0, bulk_re(1..Hz-1), planeH, bulk_im(Hz+1..)]
    from montecosmo_tpu.parallel.context import constrain_mesh
    return constrain_mesh(
        jnp.concatenate([p0[:, :, None], re[:, :, 1:Hz], pH[:, :, None],
                         im[:, :, 1:Hz]], 2), "slab")


# ----------------------------------------------------------------------- resampling
def hermitian_symmetric(arr):
    """Hermitian symmetric of a full-FFT-indexed tensor: out[i] = conj(arr[-i mod N]).

    A tensor has Hermitian symmetry iff it equals its Hermitian symmetric.
    """
    for ax, N in enumerate(arr.shape):
        arr = jnp.take(arr, (-np.arange(N)) % N, axis=ax)
    return arr.conj()


def chreshape(mesh, shape):
    """Resample a complex Hermitian (rfft-layout) tensor to a new rfft `shape`,
    truncating or padding so that Hermitian symmetry and the mean coefficient
    power are preserved (Nyquist planes are aggregated / split with 1/sqrt(2)
    weights), and the represented density-contrast field keeps its amplitude.

    All index maps are numpy constants -> a static gather (+ scatter when
    padding) on device.
    """
    mesh = jnp.asarray(mesh)
    in_shape = tuple(mesh.shape)
    shape = tuple(shape)
    if in_shape == shape:
        return mesh
    ndim = len(shape)
    scale = np.prod(np.divide(ch2rshape(shape), ch2rshape(in_shape)))

    # 1) fold Nyquist planes of truncated axes (last axis first: its fold
    #    mirrors across the leading axes, which must still be untouched)
    for ax in reversed(range(ndim)):
        ms, s = in_shape[ax], shape[ax]
        if s >= ms:
            continue
        if ax == ndim - 1:
            plane = jnp.take(mesh, s - 1, axis=ax)
            plane = (plane + hermitian_symmetric(plane)) / 2**0.5
            mesh = mesh.at[(slice(None),) * ax + (s - 1,)].set(plane)
        else:
            pos, neg = s // 2, ms - s // 2
            folded = (jnp.take(mesh, pos, axis=ax) + jnp.take(mesh, neg, axis=ax)) / 2**0.5
            mesh = mesh.at[(slice(None),) * ax + (neg,)].set(folded)

    # 2) centered crop / pad, one axis at a time with slices + concats
    #    (contiguous copies; positive frequencies first, negative last)
    out = mesh
    for ax in range(ndim):
        ms, s = out.shape[ax], shape[ax]
        if s == ms:
            continue
        if ax == ndim - 1:
            if s < ms:
                out = lax_slice_axis(out, 0, s, ax)
            else:
                pad_shape = list(out.shape)
                pad_shape[ax] = s - ms
                out = jnp.concatenate(
                    [out, jnp.zeros(pad_shape, out.dtype)], ax)
        elif s < ms:
            out = jnp.concatenate([lax_slice_axis(out, 0, s // 2, ax),
                                   lax_slice_axis(out, ms - s // 2, None, ax)], ax)
        else:
            pad_shape = list(out.shape)
            pad_shape[ax] = s - ms
            out = jnp.concatenate([lax_slice_axis(out, 0, ms // 2, ax),
                                   jnp.zeros(pad_shape, out.dtype),
                                   lax_slice_axis(out, ms // 2, None, ax)], ax)

    # 3) split Nyquist planes of padded axes
    for ax in range(ndim):
        ms, s = in_shape[ax], shape[ax]
        if s <= ms:
            continue
        if ax == ndim - 1:
            out = out.at[(slice(None),) * ax + (ms - 1,)].divide(2**0.5)
        else:
            pos, neg = ms // 2, s - ms // 2
            out = out.at[(slice(None),) * ax + (neg,)].divide(2**0.5)
            out = out.at[(slice(None),) * ax + (pos,)].set(
                jnp.take(out, neg, axis=ax))

    from montecosmo_tpu.parallel.context import constrain_mesh
    return constrain_mesh(out * scale, "pencil")


def boxreshape(mesh, shape):
    """Real-space centered pad or crop of a tensor to `shape` (even dims)."""
    shape = np.asarray(shape)
    ms = np.asarray(mesh.shape)
    assert np.all(shape % 2 == 0) and np.all(ms % 2 == 0), "dimension lengths must be even."

    half_down = np.maximum(ms - shape, 0) // 2
    mesh = mesh[tuple(slice(h, None if h == 0 else -h) for h in half_down)]
    half_up = np.maximum(shape - np.asarray(mesh.shape), 0) // 2
    return jnp.pad(mesh, tuple((h, h) for h in half_up))


# ----------------------------------------------------------------------- masking
def mesh2masked(mesh, mask=None):
    """Extract the masked entries of a mesh (identity if mask is None)."""
    if mask is None:
        return mesh
    return mesh[..., mask]


def masked2mesh(masked, mask=None):
    """Scatter masked entries back into a zero mesh (identity if mask is None)."""
    if mask is None:
        return masked
    shape = jnp.shape(masked)[:-1] + jnp.shape(mask)
    return jnp.zeros(shape, dtype=masked.dtype).at[..., mask].set(masked)
