"""ShardedFieldLevelModel: the pod-scale (config 5, SURVEY §6) counterpart of
`models.model.FieldLevelModel` — same conceptual API (predict / logpdf /
potential / force), but every mesh is X-sharded over a device-mesh axis and
the forward + reverse passes run fully decomposed (pencil FFTs, halo
exchange, psum/pmean collectives; see `parallel.render`).

Scope (round 1): Gaussian and Poisson field likelihoods, survey selection
masks, 1/2LPT evolution, 3rd-order Lagrangian bias, flat-sky RSD.  PNG,
velocity bias, and the remaining non-Gaussian likelihood family stay on the
single-device FieldLevelModel path.

Parity: reference model.py:210-320 (FieldLevelModel predict/logpdf) —
re-architected for jax.sharding; the reference has no multi-device story.
"""
from functools import partial

import numpy as np
import jax
from jax import numpy as jnp, random as jr
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from montecosmo_tpu.ops.background import Background, Cosmology, Planck18
from montecosmo_tpu.ops.power import lin_power_interp
from montecosmo_tpu.parallel.render import (
    sharded_field_logpdf, sharded_lpt_observable,
)


class ShardedFieldLevelModel:
    """Field-level Bayesian model whose render and log-posterior gradient run
    decomposed over a 1-D device mesh.

    >>> mesh = Mesh(np.asarray(jax.devices()), ("mesh",))
    >>> model = ShardedFieldLevelModel((512, 512, 512), (4000.,) * 3, a_obs=0.5,
    ...                                device_mesh=mesh, bias=dict(b1=1.0))
    >>> truth = model.predict(seed=0)
    >>> logp, grad = model.potential_and_force(truth["white_mesh"],
    ...                                        truth["obs_mesh"])
    """

    def __init__(self, mesh_shape, box_size, a_obs, device_mesh: Mesh,
                 cosmology: Cosmology = None, bias=None, rsd=True,
                 lpt_order=1, noise_std=1.0, lik_type="gauss", selection=None,
                 ngbar=1.0, png=None, fNL=0.0, halo=None, paint_order=2,
                 axis_name="mesh", stoch=None, ap=None):
        self.mesh_shape = tuple(int(s) for s in mesh_shape)
        self.box_size = tuple(float(b) for b in np.broadcast_to(
            np.asarray(box_size, float), (3,)))
        self.a_obs = float(a_obs)
        self.device_mesh = device_mesh
        self.axis_name = axis_name
        self.cosmology = cosmology if cosmology is not None else Planck18()
        self.bias = dict(bias or {})
        self.rsd = bool(rsd)
        self.lpt_order = int(lpt_order)
        self.noise_std = float(noise_std)
        self.lik_type = str(lik_type)
        self.ngbar = float(ngbar)
        self.png = None if png is None else dict(png)
        self.stoch = None if stoch is None else dict(stoch)
        self.ap = None if ap is None else dict(ap)
        self.fNL = float(fNL)
        self.paint_order = int(paint_order)

        n_dev = device_mesh.shape[axis_name]
        assert self.mesh_shape[0] % n_dev == 0, (
            f"X extent {self.mesh_shape[0]} must divide over {n_dev} devices")
        nx_local = self.mesh_shape[0] // n_dev
        # halo must cover the paint stencil and fit in the slab
        self.halo = min(nx_local, 8) if halo is None else int(halo)
        assert self.halo >= paint_order // 2 + 1, "halo below stencil reach"

        self.bg = Background.create(self.cosmology)
        self.pow_interp = lin_power_interp(self.cosmology)
        self._sharding = NamedSharding(device_mesh, P(axis_name, None, None))
        self.selection = (None if selection is None
                          else jax.device_put(jnp.asarray(selection),
                                              self._sharding))
        # jitted (-logp, -grad) step, cached so repeated calls don't re-trace;
        # without the outer jit the reverse pass dispatches op-by-op
        self._pot_force = jax.jit(jax.value_and_grad(
            lambda w, o: -self.logpdf(w, o)))

    # ------------------------------------------------------------- utilities
    def shard(self, arr):
        """Place a full-size array with the model's X-slab sharding."""
        return jax.device_put(jnp.asarray(arr), self._sharding)

    def sample_white(self, seed=0):
        """X-sharded unit white-noise latent (jitted, generated in place)."""
        fn = jax.jit(lambda k: jr.normal(k, self.mesh_shape),
                     out_shardings=self._sharding)
        return fn(jr.key(seed) if isinstance(seed, int) else seed)

    # --------------------------------------------------------------- forward
    def observable(self, white):
        """Noiseless biased (RSD) density from the white latent, decomposed."""
        return sharded_lpt_observable(
            white, self.bg, self.box_size, self.a_obs, self.device_mesh,
            self.pow_interp, bias=self.bias, rsd=self.rsd, png=self.png,
            fNL=self.fNL, axis_name=self.axis_name, halo=self.halo,
            paint_order=self.paint_order, lpt_order=self.lpt_order,
            ap=self.ap)

    def predict(self, seed=0, white=None):
        """Sample (white, noiseless mean, noisy observation), all X-sharded."""
        key = jr.key(seed) if isinstance(seed, int) else seed
        kw, kn = jr.split(key)
        if white is None:
            white = self.sample_white(kw)
        mean = self.observable(white)
        sel = jnp.ones(()) if self.selection is None else self.selection
        if self.lik_type == "poisson":
            noise_fn = jax.jit(
                lambda k, m, s: jr.poisson(
                    k, jnp.maximum(self.ngbar * s * m, 1e-6)).astype(m.dtype),
                out_shardings=self._sharding)
        elif self.lik_type in ("quad_gauss", "two_quad_gauss", "shash"):
            # sample from the pointwise stochasticity family (matches the
            # likelihood in parallel/render.py::sharded_field_logpdf)
            from montecosmo_tpu.models.distributions import (
                QuadGaussian, SinhArcsinh, TwoQuadGaussian,
            )
            st = {"s_e": 1.0, "s_ed": 0.0, "s_e2": 0.0, **(self.stoch or {})}

            def _sample(k, m, s):
                loc = self.ngbar * s * m
                ssq = jnp.sqrt(jnp.maximum(s, 0.0) * self.ngbar)
                s1 = jnp.abs(st["s_e"] + st["s_ed"] * (m - 1.0)) * ssq + 1e-9
                s2 = st["s_e2"] * ssq
                if self.lik_type == "quad_gauss":
                    return QuadGaussian(loc, s1, s2).sample(k)
                if self.lik_type == "two_quad_gauss":
                    return TwoQuadGaussian(loc, s1, s2).sample(k)
                ratio = s2 / s1
                return SinhArcsinh(loc, (s1**2 + 2 * s2**2) ** 0.5,
                                   3.540 * ratio,
                                   1 + 5.884 * ratio**2).sample(k)

            noise_fn = jax.jit(_sample, out_shardings=self._sharding)
        else:
            noise_fn = jax.jit(
                lambda k, m, s: (s > 0) * (
                    s * m + self.noise_std * jr.normal(k, m.shape, m.dtype)),
                out_shardings=self._sharding)
        return {"white_mesh": white, "mean_mesh": mean,
                "obs_mesh": noise_fn(kn, mean, sel)}

    # --------------------------------------------------------------- inverse
    def logpdf(self, white, obs):
        """Replicated scalar log-posterior (prior + Gaussian likelihood)."""
        return sharded_field_logpdf(
            white, obs, self.bg, self.box_size, self.a_obs, self.device_mesh,
            self.pow_interp, bias=self.bias, rsd=self.rsd,
            noise_std=self.noise_std, lik_type=self.lik_type,
            selection=self.selection, ngbar=self.ngbar, png=self.png,
            fNL=self.fNL, axis_name=self.axis_name, halo=self.halo,
            paint_order=self.paint_order, lpt_order=self.lpt_order,
            stoch=self.stoch, ap=self.ap)

    def potential(self, white, obs):
        return -self.logpdf(white, obs)

    def potential_and_force(self, white, obs):
        """(−logp, −∇logp) — one fused decomposed forward+reverse pass."""
        return self._pot_force(white, obs)

    def logdf_fn(self, obs):
        """params-dict log-density closure for the samplers
        (`samplers.mclmc.mclmc_init` / `get_mclmc_run` / NUTS)."""
        return lambda params: self.logpdf(params["white_mesh"], obs)
