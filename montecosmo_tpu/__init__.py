"""
montecosmo_tpu — a JAX framework for field-level Bayesian inference of
cosmology from galaxy surveys, run on NVIDIA GPUs.

Functionally equivalent to the reference `hsimonfroy/montecosmo` (differentiable
LPT / particle-mesh N-body forward model, EFT galaxy bias, RSD/AP, survey
selection, non-Gaussian field-level likelihoods, MCLMC/NUTS samplers), but
rebuilt from scratch:

* every hot kernel is a fused XLA pipeline (slice-based Hermitian repack,
  scan-compiled BullFrog leapfrog, stencil-scan scatter painting),
* the background cosmology (growth / distance tables) is a pure immutable
  pytree traced inside jit, so gradients flow through Omega_m end to end,
* meshes can be sharded over a `jax.sharding.Mesh` (pencil-decomposed FFT,
  halo-exchanged painting) for multi-GPU boxes, and chains are sharded with
  `jax.sharding` rather than pmap.

Subpackages
-----------
ops       : Fourier core, mass assignment, PM gravity, background cosmology.
models    : probabilistic model layer (PPL, distributions, physics bricks).
samplers  : MCLMC, MAMS, HMC/NUTS (+ within-Gibbs), adaptation, optimizers.
parallel  : device-mesh sharding, distributed FFT, chain mapping.
utils     : IO (HDF5/YAML/pickle), tree helpers, numerics helpers.
"""

__version__ = "0.1.0"

from montecosmo_tpu.models.model import FieldLevelModel, Model, default_config
