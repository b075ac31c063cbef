"""Halo-exchanged mass assignment for spatially sharded particle sets.

Each device owns an X-slab of the mesh and the particles whose base cell
falls inside it.  Painting accumulates into a locally extended buffer
(slab + halo faces on both sides); the faces then go to the neighbor
slabs via two `ppermute`s and are added in.  Reading mirrors this: fetch the
neighbors' edge planes first, gather locally.

The halo width must cover the paint stencil reach: order//2 + 1 cells is
enough for B-spline orders <= 4 plus the interlacing half-cell shift.

Functions run INSIDE `shard_map` over a 1D device-mesh axis.
"""
from functools import partial
from itertools import product

import numpy as np
import jax
from jax import lax, numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from montecosmo_tpu.ops.paint import _flat_wrapped, _stencil, _window_fn


def _halo_exchange_add(buf, halo, axis_name):
    """Fold the +/- halo faces of an extended X-buffer into the neighbors."""
    p = lax.axis_size(axis_name)
    up = [(i, (i + 1) % p) for i in range(p)]
    down = [(i, (i - 1) % p) for i in range(p)]

    hi_face = buf[-halo:]           # belongs to the next slab
    lo_face = buf[:halo]            # belongs to the previous slab
    from_prev = lax.ppermute(hi_face, axis_name, up)
    from_next = lax.ppermute(lo_face, axis_name, down)

    core = buf[halo:-halo]
    core = core.at[:halo].add(from_prev)
    core = core.at[-halo:].add(from_next)
    return core


def _halo_extend(core, halo, axis_name):
    """Prepend/append the neighbors' edge planes to a local X-slab."""
    p = lax.axis_size(axis_name)
    up = [(i, (i + 1) % p) for i in range(p)]
    down = [(i, (i - 1) % p) for i in range(p)]

    lo_from_prev = lax.ppermute(core[-halo:], axis_name, up)
    hi_from_next = lax.ppermute(core[:halo], axis_name, down)
    return jnp.concatenate([lo_from_prev, core, hi_from_next], axis=0)


def halo_paint_local(pos, shape, weights=1.0, order=2, axis_name="mesh",
                     kernel_type="rectangular", oversamp=1.0, halo=None):
    """Paint locally owned particles into this device's X-slab of the GLOBAL
    `shape` mesh (call inside shard_map).

    pos : (n_local, 3) GLOBAL cell coordinates of the owned particles (their
    base cell must lie in this slab; the stencil may spill into the halo).
    Returns the local slab (X/P, Y, Z) after halo folding.
    """
    if halo is None:
        halo = order // 2 + 1
    p = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    nx_local = shape[0] // p
    assert halo <= nx_local, (
        f"halo ({halo}) must not exceed the local slab width ({nx_local}): "
        "faces would wrap past the nearest neighbor")
    local_shape = (nx_local + 2 * halo, shape[1], shape[2])

    kernel = _window_fn(order, kernel_type, oversamp)
    round_fn = jnp.round if order % 2 else jnp.floor
    # shift into extended-local coordinates (x only)
    offset = jnp.asarray([1.0, 0.0, 0.0], pos.dtype) * (
        (idx * nx_local - halo).astype(pos.dtype))
    lpos = pos - offset
    id0 = round_fn(lpos).astype(jnp.int32)
    shifts = _stencil(local_shape, order)
    weights = jnp.broadcast_to(jnp.asarray(weights, pos.dtype), pos.shape[:-1])

    n = int(np.prod(local_shape))

    def step(carry, shift):
        cell = id0 + shift
        ker = kernel(cell - lpos).prod(-1)
        # wrap only Y/Z; X stays in the extended buffer (halo covers spill)
        cx = jnp.clip(cell[..., 0], 0, local_shape[0] - 1)
        cy = cell[..., 1] % shape[1]
        cz = cell[..., 2] % shape[2]
        flat = (cx * shape[1] + cy) * shape[2] + cz
        carry = carry.at[flat.reshape(-1)].add((weights * ker).reshape(-1))
        return carry, None

    init = lax.pcast(jnp.zeros(n, pos.dtype), (axis_name,), to="varying")
    buf = lax.scan(step, init, shifts)[0].reshape(local_shape)
    return _halo_exchange_add(buf, halo, axis_name)


def halo_read_local(pos, local_mesh, order=2, axis_name="mesh",
                    kernel_type="rectangular", oversamp=1.0, halo=None):
    """Read an X-sharded mesh at locally owned GLOBAL positions (inside
    shard_map).  local_mesh : this device's (X/P, Y, Z) slab."""
    if halo is None:
        halo = order // 2 + 1
    p = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    nx_local = local_mesh.shape[0]
    shape = (nx_local * p, local_mesh.shape[1], local_mesh.shape[2])

    ext = _halo_extend(local_mesh, halo, axis_name)
    ext_shape = ext.shape

    kernel = _window_fn(order, kernel_type, oversamp)
    round_fn = jnp.round if order % 2 else jnp.floor
    offset = jnp.asarray([1.0, 0.0, 0.0], pos.dtype) * (
        (idx * nx_local - halo).astype(pos.dtype))
    lpos = pos - offset
    id0 = round_fn(lpos).astype(jnp.int32)
    shifts = _stencil(ext_shape, order)
    flat_mesh = ext.reshape(-1)

    def step(carry, shift):
        cell = id0 + shift
        ker = kernel(cell - lpos).prod(-1)
        cx = jnp.clip(cell[..., 0], 0, ext_shape[0] - 1)
        cy = cell[..., 1] % shape[1]
        cz = cell[..., 2] % shape[2]
        flat = (cx * shape[1] + cy) * shape[2] + cz
        return carry + flat_mesh[flat] * ker, None

    init = lax.pcast(jnp.zeros(pos.shape[:-1], local_mesh.dtype), (axis_name,),
                     to="varying")
    out = lax.scan(step, init, shifts)[0]
    return out


def halo_paint(pos_sharded, shape, mesh: Mesh, weights=1.0, order=2,
               axis_name="mesh", **kw):
    """Whole-array wrapper: paint particles (sharded on their leading axis by
    slab ownership) into an X-sharded mesh of global `shape`."""
    def body(pos, wgt):
        return halo_paint_local(pos, shape, weights=wgt, order=order,
                                axis_name=axis_name, **kw)

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis_name), P() if np.ndim(weights) == 0 else P(axis_name)),
        out_specs=P(axis_name, None, None))
    return fn(pos_sharded, jnp.asarray(weights, jnp.asarray(pos_sharded).dtype))


def halo_read(pos_sharded, mesh_sharded, mesh: Mesh, order=2,
              axis_name="mesh", **kw):
    """Whole-array wrapper: read an X-sharded mesh at slab-owned particles."""
    fn = jax.shard_map(
        partial(halo_read_local, order=order, axis_name=axis_name, **kw),
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name, None, None)),
        out_specs=P(axis_name))
    return fn(pos_sharded, mesh_sharded)


def halo_paint_window_local(pos, shape, lattice_shape, weights=1.0, order=2,
                            axis_name="mesh", kernel_type="rectangular",
                            oversamp=1.0, halo=None, max_disp=8,
                            group=(None, None, None), batch_size=8, clip=True,
                            precision=None):
    """Scatter-free halo painting: the slab's lattice-ordered particles are
    painted into the extended local buffer with per-group matmuls
    (`ops.paint_window` formulation), then the halo faces are exchanged
    exactly like `halo_paint_local`.

    pos           : (n_local, 3) GLOBAL cell coords of the owned particles,
                    locally lattice-ordered (reshapeable to the local lattice
                    + (3,)), each within max_disp cells of its site.
    lattice_shape : GLOBAL particle-lattice shape; its x extent is sharded
                    over the mesh axis like `shape[0]`.
    halo          : must cover the window margin: max_disp + order//2 + 2.
    Returns the local core slab (X/P, Y, Z) after halo folding, equal to
    `halo_paint_local` up to f32 summation order.
    """
    from montecosmo_tpu.ops.paint_window import (
        _clip_to_sites, _paint_windows_xstream, _pick_group, _regroup,
    )

    if precision is None:
        precision = lax.Precision.HIGHEST
    p = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    shape = tuple(int(s) for s in shape)
    lattice_shape = tuple(int(s) for s in lattice_shape)
    nx_local = shape[0] // p
    latx_local = lattice_shape[0] // p
    lat_local = (latx_local,) + lattice_shape[1:]
    stride = tuple(m // l for m, l in zip((nx_local,) + shape[1:], lat_local))
    H = tuple(int(h) for h in np.broadcast_to(max_disp, (3,)))
    margin = tuple(h + order // 2 + 2 for h in H)
    if halo is None:
        halo = margin[0]
    assert halo >= margin[0], (
        f"halo ({halo}) must cover the window margin ({margin[0]})")
    nx_ext = nx_local + 2 * halo
    dtype = pos.dtype

    default_g = (min(8, latx_local), 8, _pick_group(lat_local[2], 64))
    G = tuple(_pick_group(l, d if g is None else g)
              for l, g, d in zip(lat_local, group, default_g))
    W = tuple(g * s + 2 * m for g, s, m in zip(G, stride, margin))
    nG = tuple(l // g for l, g in zip(lat_local, G))
    Pg = int(np.prod(G))

    # extended-local coordinates: x sites at i*stride_x + halo (static)
    offset = jnp.asarray([1.0, 0.0, 0.0], dtype) * (
        (idx * nx_local - halo).astype(dtype))
    lpos = (pos - offset).reshape(lat_local + (3,))
    if clip:
        site0 = jnp.asarray([halo, 0, 0], dtype)
        lpos = _clip_to_sites(lpos - site0, lat_local, stride, H) + site0
    weights = jnp.broadcast_to(jnp.asarray(weights, dtype),
                               (int(np.prod(lat_local)),)).reshape(lat_local)
    posg = _regroup(lpos, lat_local, nG, G, (3,))
    wg = _regroup(weights, lat_local, nG, G, ())

    gidx = jnp.stack(jnp.meshgrid(*(jnp.arange(n) for n in nG),
                                  indexing="ij"), -1).reshape(-1, 3)
    # x windows start at gx*Gx*sx + halo - margin (>= 0, no wrap); y/z bases
    # are periodic exactly as in paint_window
    bases = gidx * jnp.asarray([g * s for g, s in zip(G, stride)]) \
        + jnp.asarray([halo - margin[0], -margin[1], -margin[2]])

    # x-streamed overlap-add straight into the extended local buffer (no
    # stacked per-group blocks -- see _paint_windows_xstream)
    xoffs = (jnp.arange(nG[0], dtype=jnp.int32) * (G[0] * stride[0])
             + (halo - margin[0]))
    # varying-typed scan carry: the accumulator differs per shard
    init = lax.pcast(jnp.zeros((nx_ext,) + tuple(shape[1:]), dtype),
                     (axis_name,), to="varying")
    ext = _paint_windows_xstream(
        posg, wg, bases, xoffs, nG=nG, G=G, W=W, stride=stride,
        margin=margin, order=order, kernel_type=kernel_type,
        oversamp=oversamp, Pg=Pg, batch_size=batch_size,
        precision=precision, dtype=dtype, yz_shape=shape[1:],
        ext_len=nx_ext, init=init)
    return _halo_exchange_add(ext, halo, axis_name)


def halo_paint_window(pos_sharded, shape, lattice_shape, mesh: Mesh,
                      weights=1.0, order=2, axis_name="mesh", **kw):
    """Whole-array wrapper for `halo_paint_window_local` (lattice-ordered
    particles sharded by slab on their leading axis)."""
    def body(pos, wgt):
        return halo_paint_window_local(pos, shape, lattice_shape, weights=wgt,
                                       order=order, axis_name=axis_name, **kw)

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis_name), P() if np.ndim(weights) == 0 else P(axis_name)),
        out_specs=P(axis_name, None, None))
    return fn(pos_sharded, jnp.asarray(weights, jnp.asarray(pos_sharded).dtype))
