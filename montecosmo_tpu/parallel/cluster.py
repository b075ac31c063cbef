"""Multi-process runtime: jax.distributed init + global meshes.

Closes the reference's acknowledged multi-host TODO
(`run/script_pipe_fpm.py:413,417` — its multi-node story was independent
SLURM jobs): here one logical device mesh spans every process of a
multi-node GPU job (or a multi-process CPU test cluster), with the 'chains'
axis varying slowest across the device list (data parallel — no mesh
collectives cross it) and the 'mesh' axis within a host, so pencil-FFT
`all_to_all` and halo `ppermute` stay on the host's own interconnect.

Typical entry:

    from montecosmo_tpu.parallel import cluster
    cluster.init_distributed(coordinator_address="host0:1234",
                             num_processes=4, process_id=rank)
    mesh = cluster.pod_mesh(n_chains=4)     # chains across hosts

Collectives on CPU test clusters go through gloo (see
tests/test_distributed.py).
"""
import numpy as np
import jax
from jax.sharding import Mesh

__all__ = ["init_distributed", "pod_mesh", "is_distributed", "process_summary"]


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, local_device_ids=None):
    """Initialize the multi-process JAX runtime (idempotent).

    Pass the coordinator address, process count and process id explicitly
    unless the cluster environment (e.g. SLURM) lets jax.distributed detect
    them. Must run before any backend initializes.
    Returns (process_id, num_processes).
    """
    from jax._src import distributed as _dist

    if _dist.global_state.client is None:
        # CPU multi-process needs an explicit collectives layer. Do NOT touch
        # jax.default_backend() here — it would initialize the backend before
        # jax.distributed.initialize. The platforms CONFIG is safe to read.
        platforms = jax.config.jax_platforms or ""
        if "cpu" in platforms:
            try:
                jax.config.update("jax_cpu_collectives_implementation", "gloo")
            except Exception:
                pass
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id,
            local_device_ids=local_device_ids)
    return jax.process_index(), jax.process_count()


def is_distributed():
    return jax.process_count() > 1


def pod_mesh(n_chains=None, n_mesh=None, devices=None) -> Mesh:
    """Global ('chains', 'mesh') device mesh over every process's devices.

    The 'chains' axis varies slowest across the global device list, so with
    devices enumerated process by process, chains land on distinct hosts
    and the spatial 'mesh' axis stays within a host.
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    if n_chains is None and n_mesh is None:
        n_chains, n_mesh = 1, n
    elif n_chains is None:
        n_chains = n // n_mesh
    elif n_mesh is None:
        n_mesh = n // n_chains
    if n_chains * n_mesh != n:
        raise ValueError(f"{n_chains} chains x {n_mesh} mesh != {n} devices")

    return Mesh(np.asarray(devices).reshape(n_chains, n_mesh),
                ("chains", "mesh"))


def process_summary():
    """One provenance line per process: id, host devices, global devices."""
    local = jax.local_devices()
    return (f"process {jax.process_index()}/{jax.process_count()}: "
            f"{len(local)} local / {len(jax.devices())} global devices "
            f"({local[0].platform})")
