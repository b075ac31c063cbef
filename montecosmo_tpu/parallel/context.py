"""Mesh-sharding execution context: run the PRODUCTION model decomposed.

`mesh_context(mesh)` activates spatial decomposition for the ops layer
without touching model code: inside the context, `ops.fourier.rfftn/irfftn`
on 3-D meshes route through the pencil shard_map islands (local FFTs + one
all_to_all between devices, global-array in/out semantics), while every other op is
partitioned by GSPMD from the island shardings — slices/flips/concats
(Hermitian repack, chreshape), the lattice-window paint matmuls and
overlap-add rolls, elementwise physics, reductions. This gives EXACT
semantic parity with the single-device path by construction: it is the same
code, only the FFT implementation is swapped.

    from montecosmo_tpu.parallel import context
    with context.mesh_context(mesh):           # Mesh with a 'mesh' axis
        logp = jax.jit(model.logpdf)(params)   # decomposed forward+reverse

The context is consulted at TRACE time (a contextvar), so keep the jit call
inside the `with` block. Nesting restores the previous context.

The multi-device path thus covers the full model, not a flat-sky subset —
`FieldLevelModel.logpdf` itself shards.
"""
from contextlib import contextmanager
from contextvars import ContextVar

_ACTIVE = ContextVar("montecosmo_mesh_context", default=None)


@contextmanager
def mesh_context(mesh, axis_name="mesh"):
    """Activate spatial sharding over `mesh`'s `axis_name` for ops traced
    within the block (pass mesh=None to locally deactivate)."""
    token = _ACTIVE.set(None if mesh is None else (mesh, axis_name))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def current_mesh_context():
    """(mesh, axis_name) when a mesh context is active, else None."""
    return _ACTIVE.get()


def constrain_mesh(x, layout="slab"):
    """`with_sharding_constraint` a 3-D mesh to the context's decomposition
    (no-op outside a context or on non-dividing shapes).

    layout 'slab'  : X-sharded real mesh, P(ax, None, None) — the pencil
                     islands' real-space layout;
           'pencil': Y-sharded rfft mesh, P(None, ax, None) — their Fourier
                     layout.
    GSPMD left alone replicates the repack/resample segments between FFT
    islands (measured: full-size 448^3 rfft meshes on every device at 256^3
    on virtual CPU devices); pinning the segment endpoints makes it partition
    them.
    """
    ctx = _ACTIVE.get()
    if ctx is None or getattr(x, "ndim", 0) != 3:
        return x
    mesh, ax = ctx
    n_dev = mesh.shape[ax]
    dim = 0 if layout == "slab" else 1
    if n_dev <= 1 or x.shape[dim] % n_dev:
        return x
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = P(ax, None, None) if layout == "slab" else P(None, ax, None)
    return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))
