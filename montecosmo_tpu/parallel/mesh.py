"""Device-mesh construction for chain x spatial sharding.

The reference's only distribution primitive is `pmap` over chains
(`montecosmo/script.py:13-20`).  Here distribution is first-class:
a `jax.sharding.Mesh` with a 'chains' axis (data parallel) and a 'mesh' axis
(spatial mesh decomposition) — the layout the sharded
FFT and halo painting ride on.
"""
import numpy as np
import jax
from jax.sharding import Mesh


def make_device_mesh(n_chains=None, n_mesh=None, devices=None) -> Mesh:
    """Build a ('chains', 'mesh') device mesh.

    Defaults: put everything on the 'mesh' (spatial) axis; set `n_chains` to
    carve a chain-parallel axis out of the device set.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if n_chains is None and n_mesh is None:
        n_chains, n_mesh = 1, n
    elif n_chains is None:
        n_chains = n // n_mesh
    elif n_mesh is None:
        n_mesh = n // n_chains
    assert n_chains * n_mesh == n, (n_chains, n_mesh, n)
    return Mesh(devices.reshape(n_chains, n_mesh), ("chains", "mesh"))
