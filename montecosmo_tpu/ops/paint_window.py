"""Lattice-window painting: mass assignment as per-group matmuls instead of
scatters.

The model's particles originate on a regular lattice and stay in lattice
ORDER forever (LPT/PM displace them but never reorder the array), with a
bounded displacement from their home site (a few cells at production
resolutions).  That structure turns painting from a random scatter into a
dense, compiler-friendly computation:

  1. tile the lattice into (GX, GY, GZ) groups of particles;
  2. for each group, evaluate the 1-D window kernel at EVERY cell of a
     fixed window around the group (width = group span + 2*max_disp +
     kernel support) -- entries outside the kernel support are exactly 0,
     so this reproduces the stencil scatter without any indexing;
  3. contract particles against the window with ONE matmul per group:
     local[(wx,wy), wz] = sum_p (ax ox ay)[p,(wx,wy)] * (w * az)[p, wz]
     -- an (Wx*Wy, Pg) x (Pg, Wz) contraction;
  4. overlap-add the per-group local blocks into the global mesh with a
     handful of periodic rolls (sequential HBM traffic).

This replaces the ~order^3 random scatter round trips of `ops.paint` with
dense matmuls + streaming adds, and its reverse-mode gradient is again
matmuls (the VJP of step 3).  Unlike the flat scatter-add, these operations
partition with their operands under a device-mesh context, which is why the
model uses this path there (`parallel/halo.py` paints each slab's groups
locally).  On one GPU the XLA scatter is far faster (PERF.md), so the model
paints with `ops.paint` there.  Exactness: bit-for-bit the same window function as
`ops.paint.paint`; the only contract is |pos - lattice_site| <= max_disp
per axis (mass beyond the window margin is silently dropped, so callers
must bound displacements; the model gates this path on configs where the
bound holds).

Parity: reference montecosmo/nbody.py:365-467 (paint) -- same mathematical
contract, matmul formulation.
"""
from functools import partial

import numpy as np
import jax
from jax import lax, numpy as jnp

from montecosmo_tpu.ops.fourier import bspline, kaiser_bessel, optim_kcut


def _axis_window_weights(x_rel, width, order, kernel_type, oversamp):
    """(P,) positions relative to the window base -> (P, width) kernel
    weights at every window cell, exactly 0 outside the kernel support."""
    offs = jnp.arange(width, dtype=x_rel.dtype)
    s = offs[None, :] - x_rel[:, None]
    if order == 1:  # NGP: match paint()'s round-based cell choice exactly
        return (jnp.round(x_rel)[:, None] == offs[None, :]).astype(x_rel.dtype)
    if kernel_type == "rectangular":
        if order == 2:
            return jnp.maximum(1.0 - jnp.abs(s), 0.0)
        # orders 3/4 are already 0 outside support by construction
        return bspline(s, order)
    if kernel_type == "kaiser_bessel":
        # KB is nonzero at its support edge; match the scatter stencil's
        # cell set exactly: floor-based stencils cover s in (-o/2, o/2],
        # round-based (odd order) cover |s| <= o/2 (B-spline-zero there)
        w = kaiser_bessel(s, order, optim_kcut(oversamp))
        if order % 2:
            return jnp.where(jnp.abs(s) <= order / 2, w, 0.0)
        return jnp.where((s > -(order / 2)) & (s <= order / 2), w, 0.0)
    raise ValueError(f"Unknown kernel type: {kernel_type}")


def _pick_group(extent, want):
    """Largest divisor of `extent` that is <= want (>= 1)."""
    want = max(1, min(int(want), int(extent)))
    for g in range(want, 0, -1):
        if extent % g == 0:
            return g
    return 1


def _fold_axis(blocks, mesh_len, stride, base0, block_axis, win_axis):
    """Periodic overlap-add of per-group windows along one axis.

    blocks has a group axis (length n = mesh_len // stride) and a window
    axis (length W); group g's window starts at mesh cell
    g*stride + base0 (mod mesh_len).  Returns the array with those two axes
    replaced by one length-`mesh_len` axis (at position `block_axis`).
    """
    W = blocks.shape[win_axis]
    n_seg = -(-W // stride)
    pad = n_seg * stride - W
    if pad:
        pad_width = [(0, 0)] * blocks.ndim
        pad_width[win_axis] = (0, pad)
        blocks = jnp.pad(blocks, pad_width)

    # split window axis into (segment, stride); merge (group, stride) -> L
    blocks = jnp.moveaxis(blocks, (block_axis, win_axis), (0, 1))
    n = blocks.shape[0]
    rest = blocks.shape[2:]
    blocks = blocks.reshape((n, n_seg, stride) + rest)

    out = 0.0
    for c in range(n_seg):
        flat = blocks[:, c].reshape((n * stride,) + rest)
        out = out + jnp.roll(flat, base0 + c * stride, axis=0)
    return jnp.moveaxis(out, 0, block_axis)


def _window_geometry(shape, lattice_shape, order, max_disp, group):
    """Shared group/margin/window geometry (see paint_window docs)."""
    shape = tuple(int(s) for s in shape)
    lattice_shape = tuple(int(s) for s in lattice_shape)
    assert all(m % l == 0 for m, l in zip(shape, lattice_shape)), (
        f"mesh {shape} must be a multiple of lattice {lattice_shape}")
    stride = tuple(m // l for m, l in zip(shape, lattice_shape))
    H = tuple(int(h) for h in np.broadcast_to(max_disp, (3,)))
    default_g = (8, 8, _pick_group(lattice_shape[2], 64))
    G = tuple(_pick_group(l, d if g is None else g)
              for l, g, d in zip(lattice_shape, group, default_g))
    margin = tuple(h + order // 2 + 2 for h in H)
    W = tuple(g * s + 2 * m for g, s, m in zip(G, stride, margin))
    nG = tuple(l // g for l, g in zip(lattice_shape, G))
    return shape, lattice_shape, stride, H, G, margin, W, nG


def _clip_to_sites(pos, lattice_shape, stride, H):
    """Clamp displacements to +-H around the in-graph iota lattice sites.
    pos is (lattice_shape + (3,))."""
    dtype = pos.dtype
    sites = [jnp.arange(l, dtype=dtype) * s
             for l, s in zip(lattice_shape, stride)]
    return jnp.stack(
        [sites[d].reshape((-1,) + (1,) * (2 - d))
         + jnp.clip(pos[..., d] - sites[d].reshape((-1,) + (1,) * (2 - d)),
                    -H[d], H[d])
         for d in range(3)], axis=-1)


def _regroup(arr, lattice_shape, nG, G, trailing):
    """(lattice_shape + trailing) -> (n_groups, prod(G)) + trailing tiles."""
    split = (nG[0], G[0], nG[1], G[1], nG[2], G[2])
    perm = (0, 2, 4, 1, 3, 5) + tuple(range(6, 6 + len(trailing)))
    arr = arr.reshape(split + trailing).transpose(perm)
    return arr.reshape((-1, int(np.prod(G))) + trailing)


def _paint_context_island(shape, lattice_shape, order, max_disp, weights_ndim):
    """shard_map wrapper for the halo window paint when a mesh context is
    active and the slab geometry admits it; None -> caller paints locally.

    The memory point of the sharded PRODUCTION path: the per-group one-hot
    tensors of the window paint are the largest
    intermediates of the whole render, and GSPMD cannot tie their group axis
    to the device mesh — only an explicit island decomposes them 1/n.
    """
    from montecosmo_tpu.parallel.context import current_mesh_context

    ctx = current_mesh_context()
    if ctx is None:
        return None
    mesh, ax = ctx
    n_dev = mesh.shape[ax]
    if n_dev <= 1 or shape[0] % n_dev or lattice_shape[0] % n_dev:
        return None
    H = tuple(int(h) for h in np.broadcast_to(max_disp, (3,)))
    margin0 = H[0] + order // 2 + 2
    nx_local = shape[0] // n_dev
    if margin0 > nx_local:  # halo faces would wrap past the nearest neighbor
        return None

    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from montecosmo_tpu.parallel.halo import halo_paint_window_local

    def island(pos, w, **kw):
        body = partial(halo_paint_window_local, shape=shape,
                       lattice_shape=lattice_shape, axis_name=ax, **kw)
        fn = shard_map(lambda p, wt: body(p, weights=wt), mesh=mesh,
                       in_specs=(P(ax), P() if weights_ndim == 0 else P(ax)),
                       out_specs=P(ax, None, None), check_vma=False)
        return fn(pos, w)

    return island


def _paint_windows_xstream(posg, wg, bases, xoffs, *, nG, G, W, stride,
                           margin, order, kernel_type, oversamp, Pg,
                           batch_size, precision, dtype, yz_shape, ext_len,
                           init=None):
    """Overlap-add of all group windows, streamed along x.

    posg/wg/bases are flat over groups in x-major order.  The y/z axes are
    folded per x-slab of groups (static rolls); the x axis is an
    accumulating `lax.scan` over the nG[0] x-slabs into an (ext_len, Y, Z)
    buffer — group slab gx's (Wx, Y, Z) window is added at xoffs[gx] >= 0.
    Streaming bounds live memory by ONE x-slab instead of stacking every
    group's full (Wx, Wy, Wz) window (overlap^3 times the mesh — the
    dominant allocation of the whole render at production sizes).
    Periodic wrap along x is the caller's job (margin folding for the
    global path, halo exchange for the sharded path).
    """
    nyz = nG[1] * nG[2]
    posg = posg.reshape((nG[0], nyz) + posg.shape[1:])
    wg = wg.reshape((nG[0], nyz) + wg.shape[1:])
    bases = bases.reshape((nG[0], nyz, 3))

    def body(args):
        p, w, b = args
        ax = _axis_window_weights(p[:, 0] - b[0].astype(dtype), W[0], order,
                                  kernel_type, oversamp)
        ay = _axis_window_weights(p[:, 1] - b[1].astype(dtype), W[1], order,
                                  kernel_type, oversamp)
        az = _axis_window_weights(p[:, 2] - b[2].astype(dtype), W[2], order,
                                  kernel_type, oversamp)
        oh_xy = (ax[:, :, None] * ay[:, None, :]).reshape(Pg, W[0] * W[1])
        # f32 operands at `precision`: HIGHEST keeps the dot in f32; HIGH and
        # DEFAULT may run it in TF32 on GPUs (10-bit mantissa)
        return jnp.einsum("pr,pz->rz", oh_xy, az * w[:, None],
                          preferred_element_type=dtype, precision=precision)

    def xslab(args):
        px, wx, bx = args
        # checkpoint: the (Pg, Wx*Wy) one-hots are recomputed in the
        # backward pass instead of being stored for every group
        blocks = lax.map(jax.checkpoint(body), (px, wx, bx),
                         batch_size=batch_size)
        blocks = blocks.reshape((nG[1], nG[2]) + W)
        out = _fold_axis(blocks, yz_shape[1], G[2] * stride[2], -margin[2],
                         block_axis=1, win_axis=4)      # (nGy, Z, Wx, Wy)
        out = _fold_axis(out, yz_shape[0], G[1] * stride[1], -margin[1],
                         block_axis=0, win_axis=3)      # (Y, Z, Wx)
        return jnp.moveaxis(out, 2, 0)                  # (Wx, Y, Z)

    def step(carry, args):
        px, wx, bx, off = args
        blk = xslab((px, wx, bx))
        z = jnp.zeros((), off.dtype)  # match off (x64 mode: bare 0 -> int64)
        cur = lax.dynamic_slice(carry, (off, z, z), blk.shape)
        return lax.dynamic_update_slice(carry, cur + blk, (off, z, z)), None

    if init is None:
        init = jnp.zeros((ext_len,) + tuple(yz_shape), dtype)
    return lax.scan(step, init, (posg, wg, bases, xoffs))[0]


def paint_window(pos, shape: tuple, lattice_shape: tuple, weights=1.0,
                 order: int = 2, kernel_type="rectangular", oversamp=1.0,
                 max_disp=8, group=(None, None, None), batch_size=8,
                 clip=False, precision=lax.Precision.HIGHEST):
    """Scatter-free painting of lattice-ordered particles (see module doc).

    pos           : (P, 3) positions in `shape` cell units, lattice-MAJOR
                    order (reshapeable to lattice_shape + (3,)), each within
                    max_disp cells of its lattice site (unwrapped -- do NOT
                    pre-mod positions).
    shape         : output mesh shape; shape[i] % lattice_shape[i] == 0.
    lattice_shape : the particle lattice (e.g. model.ptcl_shape).
    max_disp      : per-axis displacement bound in cells (int or 3-tuple).
    group         : lattice tile per matmul; None entries take the full axis.
    clip          : clamp each displacement to +-max_disp instead of silently
                    dropping out-of-window mass — total weight is then always
                    conserved; outliers deposit at the clamped position (zero
                    position gradient there).
    precision     : matmul precision.  HIGHEST (default) agrees with the
                    scatter reference to ~3e-6 of max|mesh| on an H100;
                    HIGH runs in TF32 there, ~2e-4 of max|mesh| at 224^3
                    (PERF.md), so it is opt-in.  Accumulation stays f32 via
                    preferred_element_type.
    Returns the painted mesh, identical to `ops.paint.paint` (up to f32
    summation order) whenever the displacement bound holds.
    """
    shape = tuple(int(s) for s in shape)
    lattice_shape = tuple(int(s) for s in lattice_shape)
    island = _paint_context_island(shape, lattice_shape, order, max_disp,
                                   jnp.ndim(weights))
    if island is not None:
        return island(
            pos.reshape(-1, 3),
            jnp.asarray(weights, pos.dtype).reshape(
                (-1,) if jnp.ndim(weights) else ()),
            order=order, kernel_type=kernel_type, oversamp=oversamp,
            max_disp=max_disp, group=group, batch_size=batch_size,
            clip=clip, precision=precision)

    # group sizes in lattice units (None -> auto), margins, windows; the
    # margin covers the kernel support PLUS sub-cell interlacing shifts in
    # [0, 1) on top of max_disp (order//2 + 2 cells)
    (shape, lattice_shape, stride, H, G, margin, W,
     nG) = _window_geometry(shape, lattice_shape, order, max_disp, group)
    dtype = pos.dtype
    Pg = int(np.prod(G))

    # regroup particles (and weights) into (n_groups, Pg, ...) lattice tiles
    pos = pos.reshape(lattice_shape + (3,))
    if clip:
        pos = _clip_to_sites(pos, lattice_shape, stride, H)
    weights = jnp.broadcast_to(
        jnp.asarray(weights, dtype),
        (int(np.prod(lattice_shape)),)).reshape(lattice_shape)
    posg = _regroup(pos, lattice_shape, nG, G, (3,))
    wg = _regroup(weights, lattice_shape, nG, G, ())

    # per-group window bases (unwrapped; wrap applied on the ext buffer)
    gidx = jnp.stack(jnp.meshgrid(*(jnp.arange(n) for n in nG),
                                  indexing="ij"), -1).reshape(-1, 3)
    bases = gidx * jnp.asarray([g * s for g, s in zip(G, stride)]) \
        - jnp.asarray(margin)

    # x-streamed overlap-add into an x-extended buffer (window of x-slab gx
    # starts at gx*Gx*sx - margin, i.e. gx*Gx*sx in extended coordinates)
    m = margin[0]
    xoffs = jnp.arange(nG[0], dtype=jnp.int32) * (G[0] * stride[0])
    ext = _paint_windows_xstream(
        posg, wg, bases, xoffs, nG=nG, G=G, W=W, stride=stride,
        margin=margin, order=order, kernel_type=kernel_type,
        oversamp=oversamp, Pg=Pg, batch_size=batch_size,
        precision=precision, dtype=dtype, yz_shape=shape[1:],
        ext_len=shape[0] + 2 * m)

    # periodic wrap of the x margins (static slices; wings may wrap more
    # than once when the margin exceeds the mesh extent)
    out = ext[m:shape[0] + m]
    hi = ext[shape[0] + m:]                       # cells X, X+1, ...
    for s in range(0, m, shape[0]):
        seg = hi[s:s + shape[0]]
        out = out.at[:seg.shape[0]].add(seg)
    lo = ext[:m]                                  # cells ..., -2, -1
    e = m
    while e > 0:
        s = max(0, e - shape[0])
        out = out.at[shape[0] - (e - s):].add(lo[s:e])
        e = s
    return out


def read_window(pos, meshes, lattice_shape: tuple, order: int = 2,
                kernel_type="rectangular", oversamp=1.0, max_disp=8,
                group=(None, None, None), batch_size=8, clip=False,
                precision=lax.Precision.HIGHEST):
    """Gather-free mesh read at lattice-ordered positions (adjoint of
    `paint_window`; same contract — see the module docstring).

    Each lattice group dynamic-slices its fixed local window from a
    wrap-padded mesh (one contiguous DMA) and contracts it against the
    per-particle window weights with one matmul:
        v[p, c] = sum_z az[p, z] * [(ax*ay)[p, (wx,wy)] @ local[(wx,wy), (z,c)]]
    replacing the ~order^3 random gathers of `ops.paint.read`.

    meshes : (X, Y, Z) array, (X, Y, Z, C) array, or list of (X, Y, Z) — the
             multi-channel layout reads C fields for one matmul (same role as
             `ops.paint.read_multi`).
    Returns (P,) values, or (P, C) for multi-channel input.
    """
    if isinstance(meshes, (list, tuple)):
        meshes = jnp.stack(meshes, axis=-1)
    squeeze = meshes.ndim == 3
    if squeeze:
        meshes = meshes[..., None]
    C = meshes.shape[-1]

    (shape, lattice_shape, stride, H, G, margin, W,
     nG) = _window_geometry(meshes.shape[:-1], lattice_shape, order,
                            max_disp, group)
    dtype = pos.dtype
    Pg = int(np.prod(G))

    pos = pos.reshape(lattice_shape + (3,))
    if clip:
        pos = _clip_to_sites(pos, lattice_shape, stride, H)
    posg = _regroup(pos, lattice_shape, nG, G, (3,))

    # group window bases (unwrapped); the wrap-pad shifts starts by +margin,
    # so the padded-coordinate slice start is g * (G * stride) >= 0
    gidx = jnp.stack(jnp.meshgrid(*(jnp.arange(n) for n in nG),
                                  indexing="ij"), -1).reshape(-1, 3)
    starts = gidx * jnp.asarray([g * s for g, s in zip(G, stride)])
    bases = starts - jnp.asarray(margin)

    padded = jnp.pad(meshes, [(m, m) for m in margin] + [(0, 0)], mode="wrap")

    def body(args):
        p, st, b = args
        ax = _axis_window_weights(p[:, 0] - b[0].astype(dtype), W[0], order,
                                  kernel_type, oversamp)
        ay = _axis_window_weights(p[:, 1] - b[1].astype(dtype), W[1], order,
                                  kernel_type, oversamp)
        az = _axis_window_weights(p[:, 2] - b[2].astype(dtype), W[2], order,
                                  kernel_type, oversamp)
        local = lax.dynamic_slice(padded, (st[0], st[1], st[2], 0),
                                  (W[0], W[1], W[2], C))
        oh_xy = (ax[:, :, None] * ay[:, None, :]).reshape(Pg, W[0] * W[1])
        # (Pg, Wx*Wy) @ (Wx*Wy, Wz*C), then the z contraction
        big = jnp.einsum("pr,rz->pz", oh_xy,
                         local.reshape(W[0] * W[1], W[2] * C),
                         preferred_element_type=dtype,
                         precision=precision)
        return jnp.einsum("pz,pzc->pc", az, big.reshape(Pg, W[2], C),
                          preferred_element_type=dtype,
                          precision=precision)

    vals = lax.map(jax.checkpoint(body), (posg, starts, bases),
                   batch_size=batch_size)                 # (n_groups, Pg, C)

    # ungroup: inverse of _regroup back to lattice-major particle order
    vals = vals.reshape(nG + G + (C,)).transpose(0, 3, 1, 4, 2, 5, 6)
    vals = vals.reshape((int(np.prod(lattice_shape)), C))
    return vals[..., 0] if squeeze else vals
