"""Field-level cosmological model: probabilistic program + handler algebra.

`Model` is a thin algebra over the native effect-handler PPL
(predict / logpdf / potential / force / trace / substitute / block / save /
load); `FieldLevelModel` is the full generative program
(prior -> evolve -> likelihood) with reparametrizations, registration, and
metric/chain wrappers.

Parity: reference `montecosmo/model.py` (default_config:34-257, Model:262-434,
FieldLevelModel:444-1477), rebuilt on the native PPL and the immutable
`Background` tables (a single Background per forward pass; no workspace
mutation inside jit).
"""
from dataclasses import asdict, dataclass
from functools import partial
from pathlib import Path
from pprint import pformat

import numpy as np
from jax import grad, lax, numpy as jnp, random as jr, vmap
from jax.scipy.spatial.transform import Rotation

import jax

from montecosmo_tpu.chains import Chains
from montecosmo_tpu.metrics import (
    distr_radial, mse_radius, mse_value, mse_wave, powtranscoh, spectrum,
)
from montecosmo_tpu.models import ppl
from montecosmo_tpu.models.bricks import (
    add_png, b1_E2L, b1_L2E, b2_E2L, b2_L2E, cell2phys_pos, cell2phys_vel,
    count2delta, cutsky2config, cutsky2count, cutsky2selection, eulerian_bias,
    fNL_bias, fullsky2count, gen_gauss_selection, get_mesh_shape, kaiser_boost,
    kaiser_model, kaiser_posterior, lagrangian_bias, lin2white, white2lin,
    los_scalefactor_mesh, los_scalefactor_pos, phys2cell_pos, phys2cell_vel,
    pos_mesh, radius_mesh, regular_pos, rotate, rsd, samp2base, samp2base_mesh,
    set_radial_count, sobol_pos, top_hat_selection, ap_auto, ap_param,
)
from montecosmo_tpu.models.distributions import (
    BlockMultivariateNormal, DetruncTruncNorm, DetruncUnif, Normal, Poisson,
    QuadGaussian, SinhArcsinh, TwoQuadGaussian,
)
from montecosmo_tpu.ops.background import Background, Cosmology, get_cosmology
from montecosmo_tpu.ops.fourier import rfftk, top_hat, irfftn, rfftn
from montecosmo_tpu.ops.hermitian import (
    ch2rshape, cgh2rg, chreshape, masked2mesh, mesh2masked, r2chshape, rg2cgh,
    scale_shape,
)
from montecosmo_tpu.ops.paint import nufft, read, read_sites
from montecosmo_tpu.ops.pm import lpt, nbody_bf, nbody_bf_lightcone
from montecosmo_tpu.ops.power import lin_power_mesh
from montecosmo_tpu.utils.io import h5load, yload, ysave
from montecosmo_tpu.utils.safe import nvmap, safe_div


default_config = {
    # Mesh and box parameters
    "final_shape": 3 * (64,),
    "cell_length": 20.0,                 # Mpc/h
    "box_center": (0.0, 0.0, 0.0),       # Mpc/h (observer at origin)
    "box_rotvec": (0.0, 0.0, 0.0),       # rotation vector (radians)
    "k_cut": np.inf,                     # h/Mpc; None -> k_nyquist
    # Init
    "png_type": None,                    # None, 'fNL', 'bias'
    # Evolution
    "evolution": "lpt",                  # kaiser, lpt, nbody
    "nbody_a_start": 0.0,
    "nbody_n_steps": 10,
    "nbody_snapshots": None,
    "lpt_order": 2,
    "paint_order": 2,
    "paint_deconv": True,
    "kernel_type": "rectangular",        # rectangular | kaiser_bessel
    "init_oversamp": 3 / 2,
    "evol_oversamp": 7 / 4,
    "ptcl_oversamp": 7 / 4,
    "paint_oversamp": 7 / 4,
    "interlace_order": 2,
    "paint_method": "auto",              # auto | window | scatter
    "max_disp": 8,                       # paint_window bound (paint cells)
    # Observable
    "observable": "field",               # field | powspec
    "poles": (0, 2, 4),
    "powspec_kedges": None,              # powspec k-bin edges / width / count
    "a_obs": None,                       # None -> light-cone
    "curved_sky": True,
    "ap_auto": None,                     # None: no AP; True: auto; False: parametric
    "register": None,                    # path to a register HDF5 file
    "n_rbins": None,
    "lik_type": "quad_gauss",            # poisson, fourier_gauss, quad_gauss,
                                         # two_quad_gauss, shash
    "bias_type": "lagrangian",           # lagrangian, eulerian
    # Latents
    "precond": "kaiser",                 # real, fourier, kaiser
    "latents": {
        "Omega_m": {"group": "cosmo", "label": r"{\Omega}_m",
                    "loc": 0.3111, "scale": 0.1, "scale_fid": 1e-2,
                    "low": 0.05, "high": 1.0},
        "sigma8": {"group": "cosmo", "label": r"{\sigma}_8",
                   "loc": 0.8102, "scale": 1e-1, "scale_fid": 1e-2,
                   "low": 0.0, "high": np.inf},
        "b1": {"group": "bias", "label": r"{b}_1",
               "loc": 1.0, "scale": 1e2, "scale_fid": 1e-2},
        "b2": {"group": "bias", "label": r"{b}_2",
               "loc": 0.0, "scale": 1e2, "scale_fid": 3e-2},
        "bs2": {"group": "bias", "label": r"{b}_{s^2}",
                "loc": 0.0, "scale": 1e2, "scale_fid": 1e-1},
        "b3": {"group": "bias", "label": r"{b}_{3}",
               "loc": 0.0, "scale": 1e2, "scale_fid": 1e0},
        "bds2": {"group": "bias", "label": r"{b}_{\delta s^2}",
                 "loc": 0.0, "scale": 1e2, "scale_fid": 1e0},
        "bs3": {"group": "bias", "label": r"{b}_{s^3}",
                "loc": 0.0, "scale": 1e2, "scale_fid": 1e0},
        "bn2": {"group": "bias", "label": r"{b}_{\nabla^2}",
                "loc": 0.0, "scale": 1e3, "scale_fid": 1e0},
        "bnpar": {"group": "bias", "label": r"{b}_{\nabla_\parallel}",
                  "loc": 0.0, "scale": 1e2, "scale_fid": 1e0},
        "fNL": {"group": "png", "label": r"{f}_\mathrm{NL}",
                "loc": 0.0, "scale": 1e4, "scale_fid": 1e2},
        "fNL_bp": {"group": "png", "label": r"{f}_\mathrm{NL} b_\phi",
                   "loc": 0.0, "scale": 1e4, "scale_fid": 3e1},
        "fNL_bpd": {"group": "png", "label": r"{f}_\mathrm{NL} b_{\phi\delta}",
                    "loc": 0.0, "scale": 1e4, "scale_fid": 3e2},
        "fNL_bpd2": {"group": "png", "label": r"{f}_\mathrm{NL} b_{\phi\delta^2}",
                     "loc": 0.0, "scale": 1e8, "scale_fid": 1e3},
        "fNL_bps2": {"group": "png", "label": r"{f}_\mathrm{NL} b_{\phi s^2}",
                     "loc": 0.0, "scale": 1e8, "scale_fid": 1e4},
        "fNL_bn2p": {"group": "png", "label": r"{f}_\mathrm{NL} b_{\nabla^2\phi}",
                     "loc": 0.0, "scale": 1e8, "scale_fid": 3e5},
        "alpha_iso": {"group": "ap", "label": r"{\alpha}_\mathrm{iso}",
                      "loc": 1.0, "scale": 1e-1, "scale_fid": 1e-2,
                      "low": 0.0, "high": np.inf},
        "alpha_ap": {"group": "ap", "label": r"{\alpha}_\mathrm{AP}",
                     "loc": 1.0, "scale": 1e-1, "scale_fid": 1e-2,
                     "low": 0.0, "high": np.inf},
        "ngbars": {"group": "syst", "label": r"{\bar{n}}_g",
                   "loc": 0.000843318125, "scale": 1e-2, "scale_fid": 1e-7,
                   "low": 0.0, "high": np.inf},
        "s_e": {"group": "stoch", "label": r"{s}_{\epsilon}",
                "loc": 1.0, "scale": 1.0, "scale_fid": 3e-3,
                "low": 0.0, "high": np.inf},
        "s_k2e": {"group": "stoch", "label": r"{s}_{k^2}",
                  "loc": 0.0, "scale": 3e2, "scale_fid": 1e1},
        "s_kmu2e": {"group": "stoch", "label": r"{s}_{k^2\mu^2}",
                    "loc": 0.0, "scale": 3e2, "scale_fid": 1e1},
        "s_ed": {"group": "stoch", "label": r"{s}_{\epsilon\delta}",
                 "loc": 0.0, "scale": 1e1, "scale_fid": 1e-2},
        "s_e2": {"group": "stoch", "label": r"{s}_{\epsilon^2}",
                 "loc": 0.0, "scale": 1e1, "scale_fid": 3e-3},
        "s_ep": {"group": "stoch", "label": r"{s}_{\epsilon\phi}",
                 "loc": 0.0, "scale": 1e5, "scale_fid": 1e2},
        "white_mesh": {"group": "init", "label": r"{\delta}_\mathrm{w}"},
    },
}


@dataclass
class Model:
    """Handler algebra over a generative `_model` function."""

    def __post_init__(self):
        self.data = {}  # observed / substituted values

    # ------------------------------------------------------------------ calls
    def _model(self, *args, **kwargs):
        raise NotImplementedError

    def model(self, *args, **kwargs):
        return self._model(*args, **kwargs)

    def reset(self):
        self.model = self._model
        self.data = {}

    def __call__(self):
        return self.model()

    def reparam(self, params, inv=False):
        return params

    def _block_det(self, model, hide_base=True, hide_det=True):
        base_names = set(self.latents.keys())
        if hide_base:
            if hide_det:
                hide_fn = lambda site: site["type"] == "deterministic"
            else:
                hide_fn = lambda site: (site["type"] == "deterministic"
                                        and site["name"] in base_names)
        else:
            if hide_det:
                hide_fn = lambda site: (site["type"] == "deterministic"
                                        and site["name"] not in base_names)
            else:
                hide_fn = lambda site: False
        return ppl.block(model, hide_fn=hide_fn)

    def predict(self, seed=42, samples=None, batch_ndim=0, hide_base=True,
                hide_det=True, hide_samp=True, from_base=False, jit=True):
        """Run the model conditioned on samples.

        samples None -> single prediction; int/tuple -> that batch shape of
        prior predictions; dict -> one prediction per sample (batch_ndim
        leading dims).  The render is jitted by default (eager dispatch
        would launch one kernel per op).
        """
        import jax as _jax

        if isinstance(seed, int):
            seed = jr.key(seed)

        def single(seed, sample={}):
            if from_base:
                sample = self.reparam(sample, inv=True)
            model = ppl.condition(self.model, data=sample)
            if hide_samp:
                model = ppl.block(model, hide=set(sample.keys()))
            model = self._block_det(model, hide_base=hide_base, hide_det=hide_det)
            tr = ppl.trace(ppl.seed(model, rng_seed=seed)).get_trace()
            return {k: v["value"] for k, v in tr.items()}

        maybe_jit = _jax.jit if jit else (lambda f: f)

        if samples is None:
            return maybe_jit(single)(seed)
        if isinstance(samples, (int, tuple)):
            if isinstance(samples, int):
                samples = (samples,)
            seeds = jr.split(seed, samples)
            return maybe_jit(nvmap(single, len(samples)))(seeds)
        if isinstance(samples, dict):
            if len(samples) == 0:
                return {}
            shape = jnp.shape(next(iter(samples.values())))[:batch_ndim]
            seeds = jr.split(seed, shape) if shape else seed
            return maybe_jit(nvmap(single, len(shape)))(seeds, samples)
        raise ValueError("samples must be None, int, tuple, or dict")

    # ------------------------------------------------------------------ densities
    def logpdf(self, params={}):
        """Joint log-probability density at `params` (E[e^logpdf] = 1).

        If `recenter_logpdf` was called, the value is shifted by a fixed
        constant (per-site zero-points) so the reduction sums O(1) terms —
        see ppl.log_density; posterior and gradients are unchanged.
        """
        return ppl.log_density(self.model, (), {}, params,
                               zero_point=getattr(self, "_lp_zero", None))[0]

    def recenter_logpdf(self, params=None, enable=True):
        """Set per-site scalar zero-points c = mean elementwise log-prob at
        `params` (typically the fiducial + observed data), making every
        subsequent `logpdf` sum (lp - c) elementwise.

        Why: at 64^3+ the joint log-density totals O(1e6-1e8) while samplers
        difference it per step; float32 quantization of the TOTAL (ulp ~
        2e-7 |logpdf|) then swamps energy-change measurements (~0.5 of pure
        noise at 64^3 — the tuner chases it into step-size collapse, and the
        MCLMC noise-floor clamp must back the energy target off to ~d-scaled
        values).  Recentring shrinks |logpdf| to ~sqrt(N), restoring the
        reference's f64 operating point (desired_energy_var 1e-7/dim,
        reference run/infer.py:53-54) in f32.  The zero-points are Python
        floats — scalar literals in every downstream jit, no device-resident
        closure constants.

        Returns the zero-point dict (or None when disabled).
        """
        if not enable:
            self._lp_zero = None
            return None

        def site_means(p):
            lps, _ = ppl.compute_log_probs(self.model, (), {}, p,
                                           sum_log_prob=False)
            return {k: jnp.mean(v) for k, v in lps.items()}

        means = jax.jit(site_means)(params if params is not None else {})
        self._lp_zero = {k: float(v) for k, v in means.items()}
        return self._lp_zero

    def potential(self, params={}):
        return -self.logpdf(params)

    def force(self, params={}):
        return grad(self.logpdf)(params)

    def value_and_grad_staged(self, jit=True):
        """logpdf value+grad as SEPARATELY-jitted stage programs.

        The monolithic `jit(value_and_grad(logpdf))` at 256^3+ meshes is one
        giant primal+tangent+transpose program; splitting at the
        evolve/likelihood seam yields 4 programs (two forward+jvp, two
        transposes) each a fraction of the size, composed eagerly through
        hand-chained VJPs (opt-in: the split holds more live memory).  Exactness: stage1 sums the log-probs of every
        latent site (prior), stage2 the observed-site log-prob — identical
        decomposition to `logpdf`'s single trace.
        """
        import jax as _jax

        def stage_lp(handler):
            zp = getattr(self, "_lp_zero", None) or {}
            lp = 0.0
            for name, site in handler._trace.items():
                if site["type"] == "sample":
                    site_lp = site["fn"].log_prob(site["value"])
                    c = zp.get(name)  # same recentring as logpdf: staged
                    # value+grad must match the monolithic one exactly
                    lp += jnp.sum(site_lp if c is None else site_lp - c)
            return lp

        def s1(params):
            h = ppl.trace(ppl.substitute(
                ppl.seed(lambda: self.evolve(self.prior()), rng_seed=0),
                data=params))
            evolved = h()
            return evolved, stage_lp(h)

        def s2(evolved, params):
            h = ppl.trace(ppl.substitute(
                ppl.seed(lambda: self.likelihood(evolved), rng_seed=0),
                data=params))
            h()
            return stage_lp(h)

        maybe_jit = _jax.jit if jit else (lambda f: f)
        f1, f2 = maybe_jit(s1), maybe_jit(s2)

        def value_and_grad(params):
            (evolved, lp1), vjp1 = _jax.vjp(f1, params)
            lp2, vjp2 = _jax.vjp(f2, evolved, params)
            one = jnp.ones(())
            dev, dp2 = vjp2(one)
            dp1 = vjp1((dev, one))[0]
            grads = _jax.tree.map(jnp.add, dp1, dp2)
            return lp1 + lp2, grads

        return value_and_grad

    def logdf_mesh(self, params={}, site="count_mesh"):
        """Per-voxel (logpdf, logcdf) of `site` at latents/observables `params`."""
        logpdfs, tr = ppl.compute_log_probs(self.model, (), {}, params,
                                            sum_log_prob=False)
        node = tr[site]
        d, value = node["fn"], node["value"]
        logcdf = d.log_cdf(value) if hasattr(d, "log_cdf") else jnp.log(d.cdf(value))
        return logpdfs[site], logcdf

    # ------------------------------------------------------------------ handlers
    def trace(self, seed):
        return ppl.trace(ppl.seed(self.model, rng_seed=seed)).get_trace()

    def seed(self, seed):
        self.model = ppl.seed(self.model, rng_seed=seed)

    def substitute(self, data={}, from_base=False):
        """Substitute random variables by values, optionally reparametrizing
        base values into sample space first.  Values accumulate in `data`."""
        if from_base:
            self.data |= data
            data = self.reparam(data, inv=True)
        self.data |= data
        self.model = ppl.condition(self.model, data=data)

    def block(self, hide_fn=None, hide=None, expose_types=None, expose=None,
              hide_base=True, hide_det=True):
        """Hide sites from traces.  The default call hides base and other
        deterministic sites (sampling configuration)."""
        if all(x is None for x in (hide_fn, hide, expose_types, expose)):
            self.model = self._block_det(self.model, hide_base=hide_base,
                                         hide_det=hide_det)
        else:
            self.model = ppl.block(self.model, hide_fn=hide_fn, hide=hide,
                                   expose_types=expose_types, expose=expose)

    def render(self, filename=None):
        """Text rendering of the model's sites (no graphviz dependency)."""
        tr = self.trace(0)
        lines = []
        for name, site in tr.items():
            kind = site["type"]
            shape = jnp.shape(site["value"])
            fn = type(site["fn"]).__name__ if site["fn"] is not None else ""
            obs = " [obs]" if site.get("is_observed") else ""
            lines.append(f"{name:>24} : {kind:<13} {fn:<18} {shape}{obs}")
        out = "\n".join(lines)
        if filename:
            Path(filename).write_text(out)
        print(out)
        return out

    def partial(self, *args, **kwargs):
        self.model = partial(self.model, *args, **kwargs)

    # ------------------------------------------------------------------ persistence
    def asdict(self):
        return asdict(self)

    def save(self, path):
        ysave(_to_yamlable(asdict(self)), path)

    @classmethod
    def load(cls, path):
        return cls(**yload(path))


def _to_yamlable(obj):
    if isinstance(obj, dict):
        return {k: _to_yamlable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_yamlable(v) for v in obj]
    if isinstance(obj, (np.ndarray, jnp.ndarray)):
        return np.asarray(obj).tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, float) and np.isinf(obj):
        return float(obj)
    return obj


@dataclass
class FieldLevelModel(Model):
    """Field-level cosmological model with Kaiser/LPT/PM evolution, Lagrangian
    or Eulerian bias, RSD/AP, survey selection, and configurable field-level
    likelihood.  See `default_config` for every knob.
    """

    # Mesh and box parameters
    final_shape: tuple
    cell_length: float
    box_center: tuple
    box_rotvec: tuple
    k_cut: float
    # Init
    png_type: str
    # Evolution
    evolution: str
    nbody_a_start: float
    nbody_n_steps: int
    nbody_snapshots: object
    lpt_order: int
    paint_order: int
    paint_deconv: bool
    kernel_type: str
    init_oversamp: float
    evol_oversamp: float
    ptcl_oversamp: float
    paint_oversamp: float
    interlace_order: int
    paint_method: str
    max_disp: int
    # Observable
    observable: str
    poles: tuple
    a_obs: object
    curved_sky: bool
    ap_auto: object
    register: object
    n_rbins: object
    lik_type: str
    bias_type: str
    # Latents
    precond: str
    latents: dict
    powspec_kedges: object = None

    def __post_init__(self):
        super().__post_init__()

        if isinstance(self.register, (str, Path)):
            # Load the register file, overriding the matching config attributes
            self.register = str(self.register)
            reg = h5load(self.register)

            for k in ("cell_length", "box_center", "box_rotvec",
                      "init_oversamp", "paint_oversamp"):
                setattr(self, k, reg[k])
            for k in ("a_obs", "curved_sky", "paint_order", "interlace_order",
                      "paint_deconv", "kernel_type"):
                if k in reg:
                    setattr(self, k, reg[k])

            self.lin_kpow = reg.get("lin_kpow")       # normalized to sigma8=1
            if self.lin_kpow is not None and isinstance(self.lin_kpow, dict):
                self.lin_kpow = (self.lin_kpow["k"], self.lin_kpow["pow"])
            self.white_mesh = reg.get("white_mesh", reg.get("white_fake"))
            if self.white_mesh is not None and np.iscomplexobj(self.white_mesh):
                self.white_mesh = jnp.asarray(self.white_mesh)
            self.selec_mesh = reg.get("selec_mesh", np.array(1.0))
            self.mask_mesh = reg.get("mask_mesh")
            if self.mask_mesh is not None:
                self.mask_mesh = np.asarray(self.mask_mesh, bool)
            if self.lik_type == "fourier_gauss":
                self.count_mesh = jax.jit(
                    lambda m: cgh2rg(rfftn(m)))(
                    jnp.asarray(np.asarray(reg["count_mesh"], np.float32)))
            else:
                self.count_mesh = mesh2masked(jnp.asarray(reg["count_mesh"]),
                                              self.mask_mesh)
            self.final_shape = np.asarray(reg["count_mesh"]).shape

            n_cells = self.count_mesh.size
            n_tracers = reg.get("n_tracers", float(np.sum(reg["count_mesh"])))
            ngbar = n_tracers / (n_cells * self.cell_length**3)
            self.latents = self.new_latents_from_loc(
                self.latents, {**reg["cosmo_fid"], "ngbars": ngbar}, update_prior=True)
        elif self.register is None:
            self.lin_kpow = None
            self.white_mesh = None
            self.count_mesh = None
            self.selec_mesh = np.array(1.0)
            self.mask_mesh = None
        else:
            raise ValueError("register must be None, str, or Path.")

        # Geometry
        self.cell_length = float(self.cell_length)
        self.box_center = np.asarray(self.box_center, float)
        self.box_rotvec = np.asarray(self.box_rotvec, float)
        self.box_rot = Rotation.from_rotvec(jnp.asarray(self.box_rotvec))

        # Shapes
        self.final_shape = tuple(map(int, self.final_shape))
        self.box_size = np.multiply(self.final_shape, self.cell_length)
        self.init_shape = scale_shape(self.final_shape, self.init_oversamp)
        self.evol_shape = scale_shape(self.final_shape, self.evol_oversamp)
        self.ptcl_shape = scale_shape(self.final_shape, self.ptcl_oversamp)
        self.paint_shape = scale_shape(self.final_shape, self.paint_oversamp)

        # Paint route.  On one device the paint and PM reads are XLA
        # scatter-add/gather (ops/paint.py): ~9x faster end to end than the
        # lattice-window matmuls at 128^3 on an H100 (PERF.md).  Under a
        # device-mesh context GSPMD cannot partition the flat scatter-add (it
        # replicates the FULL paint mesh on every device), while the window
        # matmuls (ops/paint_window, halo island) partition with their
        # operands, so `evolve` switches "auto" to the window path there.
        # Its margin covers ~36 Mpc/h of displacement (~5.5 sigma of LPT+RSD
        # at z <~ 1); clip=True clamps the far tail, mass-conserving.  The
        # window needs paint and evol meshes that are integer refinements of
        # the particle lattice.
        self.max_disp = int(self.max_disp)
        geom_ok = all(p % q == 0 for p, q in zip(self.paint_shape, self.ptcl_shape)) \
            and all(e % q == 0 for e, q in zip(self.evol_shape, self.ptcl_shape))
        paint_cell = float(np.min(np.divide(self.box_size, self.paint_shape)))
        self.paint_lattice, self._sharded_window = None, None
        if self.paint_method == "window":
            assert geom_ok, (f"paint_method='window' needs paint {self.paint_shape} "
                             f"and evol {self.evol_shape} to be multiples of "
                             f"ptcl {self.ptcl_shape}")
            self.paint_lattice = tuple(self.ptcl_shape)
        elif self.paint_method == "auto":
            if geom_ok:
                need = max(4, int(np.ceil(36.0 / paint_cell)))
                self._sharded_window = (need, tuple(self.ptcl_shape))
        elif self.paint_method != "scatter":
            raise ValueError(f"Unknown paint_method: {self.paint_method}")

        # Reads at the UNDISPLACED regular lattice (Lagrangian bias
        # operators, LPT forces) degenerate to strided slicing when the
        # evolution mesh is an integer refinement of the particle lattice
        self.evol_sites = tuple(self.ptcl_shape) if all(
            e % q == 0 for e, q in zip(self.evol_shape, self.ptcl_shape)) \
            else None

        # Scale cut
        self.k_funda = 2 * np.pi / np.min(self.box_size)
        self.k_nyquist = np.pi * np.min(np.divide(self.final_shape, self.box_size))
        if self.k_cut in (np.inf, "inf"):
            self.k_cut = np.inf
            self.cut_mask = None
        else:
            if self.k_cut is None:
                self.k_cut = float(self.k_nyquist)
            kvec = rfftk(self.init_shape, self.box_size)
            mask = jnp.broadcast_to(top_hat(kvec, self.k_cut),
                                    r2chshape(self.init_shape)).astype(float)
            self.cut_mask = np.array(cgh2rg(mask, norm="amp"), dtype=bool)

        # Latents / groups / labels
        self.latents = self._validate_latents()
        (self.n_rbins, self.rmasked, self.redges,
         self.latents["ngbars"]) = self._validate_rbins()
        self.groups = self._groups(base=True)
        self.groups_ = self._groups(base=False)
        self.labels = self._labels()

        # Fiducial quantities
        self.fiduc = self._fiduc()
        self.count_fid = np.mean(self.fiduc["ngbars"]) * self.cell_length**3
        self.cosmo_fid = get_cosmology(**{k: float(np.mean(self.fiduc[k]))
                                          for k in ("Omega_m", "sigma8")})
        self.bg_fid = Background.create(self.cosmo_fid)
        _, a = los_scalefactor_mesh(self.box_center, self.box_rot, self.box_size,
                                    self.final_shape, self.bg_fid, self.a_obs,
                                    self.curved_sky)
        self.a_fid = float(self.bg_fid.g2a(jnp.mean(self.bg_fid.a2g(a))))
        los = safe_div(self.box_center, np.linalg.norm(self.box_center))
        self.los_fid = np.asarray(rotate(self.box_rot, jnp.asarray(los), inverse=True))
        self.selec_fid = float(np.mean(np.asarray(self.selec_mesh)**2)**0.5
                               / np.mean(np.asarray(self.selec_mesh)))

        # powspec static artefacts (binning + multipole covariance Cholesky)
        # must be built EAGERLY: inside a jit trace every jnp op is staged,
        # so the host-side numpy precompute cannot run there
        self._powspec_cache = None
        if self.observable == "powspec":
            self._powspec_static()

    def __str__(self):
        out = "# CONFIG\n" + pformat({k: v for k, v in asdict(self).items()
                                      if k != "latents"}, width=1)
        out += "\n\n# INFOS\n"
        out += f"box_size:       {self.box_size} Mpc/h\n"
        out += f"k_funda:        {self.k_funda:.5f} h/Mpc\n"
        out += f"k_nyquist:      {self.k_nyquist:.5f} h/Mpc\n"
        out += f"init_shape:     {self.init_shape} cell\n"
        out += f"evol_shape:     {self.evol_shape} cell\n"
        out += f"ptcl_shape:     {self.ptcl_shape} ptcl\n"
        out += f"paint_shape:    {self.paint_shape} cell\n"
        out += f"count_fid:      {self.count_fid:.3f} gxy/cell\n"
        out += f"a_fid:          {self.a_fid:.3f}\n"
        return out

    # ------------------------------------------------------------------ program
    def _model(self, temp_prior=1.0, temp_lik=1.0):
        x = self.prior(temp=temp_prior)
        x = self.evolve(x)
        return self.likelihood(x, temp=temp_lik)

    def prior(self, temp=1.0):
        """Sample the latents in unconstrained coordinates, reparametrize into
        base space, and register the base values as deterministic sites."""
        tup = ()
        for g in ["cosmo", "bias", "png", "stoch", "ap", "syst"]:
            dic = self._sample(self.groups[g])
            dic = samp2base(dic, self.latents, inv=False, temp=temp)
            tup += ({k: ppl.deterministic(k, v) for k, v in dic.items()},)
        cosmo, bias, png, stoch, ap, syst = tup
        cosmology = get_cosmology(**cosmo)

        init = {}
        name_ = self.groups["init"][0] + "_"  # 'white_mesh_'
        # tie the per-mode scale construction to a traced latent: the kaiser
        # SNR mesh (init_shape-sized) must stage on device, not be baked as
        # a literal into the serialized program (ops.fourier.lazy_kvec)
        scale, transfer = self._precond_scale_and_transfer(
            like=cosmology.Omega_m)

        if self.cut_mask is not None:
            samp = ppl.sample(name_, Normal(0.0, scale[self.cut_mask]))
            init[name_] = masked2mesh(samp, self.cut_mask)
        else:
            init[name_] = ppl.sample(name_, Normal(0.0, scale))

        init = samp2base_mesh(init, self.precond, transfer=transfer, inv=False,
                              temp=temp)
        # keep fixed-IC constant folding from exploding compile times
        init = {k: lax.optimization_barrier(v) for k, v in init.items()}
        init = {k: ppl.deterministic(k, v) for k, v in init.items()}

        return cosmology, bias, png, stoch, ap, syst, init

    def evolve(self, params: tuple):
        """The forward model: linear field -> (Kaiser | LPT | N-body) ->
        bias -> RSD/AP -> painted galaxy mesh (1 + delta_obs)."""
        cosmology, bias, png, stoch, ap, syst, init = params
        bg = Background.create(cosmology)

        # paint-path selection is trace-time: under a mesh context the
        # scatter would replicate the full paint mesh per device
        # (unpartitionable flat scatter-add), so "auto" takes the window path
        from montecosmo_tpu.parallel.context import current_mesh_context
        paint_lattice, max_disp = self.paint_lattice, self.max_disp
        if (paint_lattice is None and current_mesh_context() is not None
                and self._sharded_window is not None):
            max_disp, paint_lattice = self._sharded_window

        init_mesh = white2lin(cosmology, init["white_mesh"], self.init_shape,
                              self.box_size, self.lin_kpow)
        init_mesh = chreshape(init_mesh, r2chshape(self.evol_shape))
        png = fNL_bias(png, bias, p=1.0, png_type=self.png_type)
        phi = 0.0

        if self.evolution == "kaiser":
            los, a = los_scalefactor_mesh(self.box_center, self.box_rot,
                                          self.box_size, self.evol_shape,
                                          bg, self.a_obs, self.curved_sky)
            cell_los = rotate(self.box_rot, jnp.asarray(los), inverse=True) \
                if jnp.ndim(los) == 1 else los
            gxy_mesh = kaiser_model(cosmology, a, init_mesh, box_size=self.box_size,
                                    b1E=b1_L2E(bias["b1"]), fNL_bp=png["fNL_bp"],
                                    png_type=self.png_type, los=cell_los,
                                    kpow=self.lin_kpow, bg=bg)

            if self.ap_auto is not None:
                # re-sample the Kaiser mesh on an AP-distorted particle grid
                pos = regular_pos(self.evol_shape, self.ptcl_shape)
                if self.evol_sites is not None and self.paint_order <= 2:
                    weights = read_sites(gxy_mesh, self.evol_sites)
                else:
                    weights = read(pos, gxy_mesh, self.paint_order)
                pos = cell2phys_pos(pos, self.box_center, self.box_rot,
                                    self.box_size, self.evol_shape)
                if self.ap_auto:
                    pos = ap_auto(pos, los, bg, self.bg_fid, self.curved_sky)
                else:
                    pos = ap_param(pos, los, ap, self.curved_sky)
                pos = phys2cell_pos(pos, self.box_center, self.box_rot,
                                    self.box_size, self.paint_shape)
                gxy_mesh = irfftn(nufft(
                    pos, self.paint_shape, None, weights=weights,
                    paint_order=self.paint_order,
                    interlace_order=self.interlace_order,
                    kernel_type=self.kernel_type, paint_deconv=self.paint_deconv,
                    lattice_shape=paint_lattice, max_disp=max_disp,
                    clip=True))
                gxy_mesh *= np.prod(np.divide(self.evol_shape, self.ptcl_shape))

            if tuple(gxy_mesh.shape) != tuple(self.final_shape):
                gxy_mesh = irfftn(chreshape(rfftn(gxy_mesh),
                                                    r2chshape(self.final_shape)))

        else:
            pos = regular_pos(self.evol_shape, self.ptcl_shape)
            _, a = los_scalefactor_pos(pos, self.box_center, self.box_rot,
                                       self.box_size, self.evol_shape,
                                       bg, self.a_obs, self.curved_sky)

            # Lagrangian bias weights at initial particle positions.
            # For large meshes, rematerialize: ~10 operator meshes otherwise
            # stay live for the backward pass (at 448^3 that alone is ~3.6 GB);
            # below that, recompute costs more than it saves (~4% at 112^3).
            use_remat = np.prod(self.evol_shape) > 4_000_000
            maybe_ckpt = jax.checkpoint if use_remat else (lambda f: f)
            # with per-operator-group remat active, an OUTER checkpoint would
            # nest remats (double recompute buffering) — use one or the other
            lbe_remat_ops = use_remat and self.evol_sites is not None
            maybe_ckpt_lbe = (lambda f: f) if lbe_remat_ops else maybe_ckpt
            lbe_weights, dvel, phi = maybe_ckpt_lbe(
                lambda im, b, p: lagrangian_bias(
                    cosmology, pos, a, self.box_size, im, b, p,
                    png_type=self.png_type, kpow=self.lin_kpow, read_order=1,
                    bg=bg, sites_shape=self.evol_sites,
                    remat_ops=lbe_remat_ops))(init_mesh, bias, png)
            if self.bias_type == "eulerian":
                if self.png_type is None:
                    phi_pos = 0.0
                elif self.evol_sites is not None:
                    phi_pos = read_sites(phi, self.evol_sites)
                else:
                    phi_pos = read(pos, phi, order=1)

            if self.png_type is not None:
                init_mesh = add_png(cosmology, png["fNL"], init_mesh,
                                    self.box_size, kpow=self.lin_kpow, bg=bg)
                init_mesh = chreshape(chreshape(init_mesh, r2chshape(self.init_shape)),
                                      r2chshape(self.evol_shape))

            if self.evolution == "lpt":
                dpos, vel = maybe_ckpt(
                    lambda im: lpt(bg, im, pos=pos, a=a,
                                   lpt_order=self.lpt_order, read_order=1,
                                   sites_shape=self.evol_sites))(init_mesh)
                pos = pos + dpos
                pos, vel = ppl.deterministic("lpt_ptcl", jnp.stack((pos, vel)))

            elif self.evolution == "nbody":
                # PM force paints run at evol resolution: rescale the window
                # bound from paint cells to evol cells
                max_disp_evol = int(np.ceil(max_disp * np.max(
                    np.divide(self.evol_shape, self.paint_shape))))
                if jnp.ndim(a) == 0:
                    pos, vel = nbody_bf(bg, init_mesh, pos=pos,
                                        a0=self.nbody_a_start,
                                        a1=a, n_steps=self.nbody_n_steps,
                                        paint_order=self.paint_order,
                                        lpt_order=self.lpt_order,
                                        paint_deconv=False,
                                        snapshots=self.nbody_snapshots,
                                        lattice_shape=paint_lattice,
                                        max_disp=max_disp_evol,
                                        sites_shape=self.evol_sites)
                else:
                    # N-body light-cone (a_obs=None): beyond-reference — the
                    # reference asserts this out (model.py:770).  Crossing
                    # growth from the LAGRANGIAN radius (same approximation
                    # the LPT light-cone path uses for its per-particle a);
                    # evolution runs to the latest crossing, each particle
                    # blended between bracketing growth-equispaced step
                    # states inside the scan (pm.nbody_bf_lightcone).
                    assert self.nbody_snapshots is None, \
                        "nbody_snapshots and N-body light-cone are exclusive"
                    g_tgt = bg.a2g(a)
                    a1 = bg.g2a(jnp.max(g_tgt))
                    pos, vel = nbody_bf_lightcone(
                        bg, init_mesh, pos=pos, g_tgt=g_tgt,
                        a0=self.nbody_a_start, a1=a1,
                        n_steps=self.nbody_n_steps,
                        paint_order=self.paint_order,
                        lpt_order=self.lpt_order, paint_deconv=False,
                        lattice_shape=paint_lattice,
                        max_disp=max_disp_evol, sites_shape=self.evol_sites)
                    pos, vel = pos[None], vel[None]
                pos, vel = ppl.deterministic("nbody_ptcl", jnp.stack((pos, vel)))
                pos, vel = pos[-1], vel[-1]
            else:
                raise ValueError(f"Unknown evolution: {self.evolution}")

            def displace(pos, vel, dvel):
                """Shared RSD/AP displacement pipeline -> paint-frame cells."""
                los, a = los_scalefactor_pos(pos, self.box_center, self.box_rot,
                                             self.box_size, self.evol_shape,
                                             bg, self.a_obs, self.curved_sky)
                pos = cell2phys_pos(pos, self.box_center, self.box_rot,
                                    self.box_size, self.evol_shape)
                dpos = rsd(bg, vel, los, a, self.box_rot, self.box_size,
                           self.evol_shape, dvel)
                pos = pos + dpos
                if self.ap_auto is not None:
                    if self.ap_auto:
                        pos = ap_auto(pos, los, bg, self.bg_fid, self.curved_sky)
                    else:
                        pos = ap_param(pos, los, ap, self.curved_sky)
                return phys2cell_pos(pos, self.box_center, self.box_rot,
                                     self.box_size, self.init_shape)

            if self.bias_type == "lagrangian":
                # checkpoint the whole observable render at large meshes: the
                # transpose then keeps only (pos, vel, dvel, weights) and
                # recomputes the RSD/AP chain and interlaced paints, instead
                # of storing every (P, 3) intermediate and per-interlace rfft
                def render_gxy(pos, vel, dvel, weights):
                    p = displace(pos, vel, dvel)
                    gxy = nufft(p, self.init_shape, tuple(self.paint_shape),
                                weights=weights,
                                paint_order=self.paint_order,
                                interlace_order=self.interlace_order,
                                kernel_type=self.kernel_type,
                                paint_deconv=self.paint_deconv,
                                lattice_shape=paint_lattice,
                                max_disp=max_disp, clip=True)
                    gxy *= np.prod(np.divide(self.init_shape, self.ptcl_shape))
                    gxy = chreshape(gxy, r2chshape(self.paint_shape))
                    return irfftn(gxy)

                gxy_mesh = maybe_ckpt(render_gxy)(pos, vel, dvel, lbe_weights)

            elif self.bias_type == "eulerian":
                pos = displace(pos, vel, dvel)
                def advect(weights):
                    mesh = nufft(pos, self.init_shape, tuple(self.paint_shape),
                                 weights=weights, paint_order=self.paint_order,
                                 interlace_order=self.interlace_order,
                                 kernel_type=self.kernel_type,
                                 paint_deconv=self.paint_deconv,
                                 lattice_shape=paint_lattice,
                                 max_disp=max_disp, clip=True)
                    mesh *= np.prod(np.divide(self.paint_shape, self.ptcl_shape))
                    return chreshape(mesh, r2chshape(self.paint_shape))

                matter_mesh = advect(1.0)
                phi_mesh = advect(phi_pos)
                weights, _ = eulerian_bias(matter_mesh, phi_mesh, self.box_size,
                                           bias, png, png_type=self.png_type)
                gxy_mesh = weights
            else:
                raise ValueError(f"Unknown bias type: {self.bias_type}")

        gxy_mesh = ppl.deterministic("gxy_mesh", gxy_mesh)
        return gxy_mesh, phi, stoch, syst  # gxy_mesh is 1 + delta_obs

    def likelihood(self, params: tuple, temp=1.0):
        """Observe the galaxy count mesh under the configured noise model."""
        gxy_mesh, phi, stoch, syst = params

        if self.observable == "powspec":
            return self._likelihood_powspec(gxy_mesh, stoch, syst, temp)
        if self.observable != "field":
            raise NotImplementedError(f"observable={self.observable}")

        rcounts = syst["ngbars"] * self.cell_length**3
        posit_fn = jnp.abs

        count_mesh = irfftn(chreshape(rfftn(gxy_mesh * self.selec_mesh),
                                              r2chshape(self.final_shape)))
        count_mesh = mesh2masked(count_mesh, self.mask_mesh)
        # radius mesh built in-graph from iotas (an N^3 numpy constant would
        # bloat the serialized program)
        rmasked = mesh2masked(self.radius_mesh(), self.mask_mesh)
        count_mesh = set_radial_count(count_mesh, rmasked, self.redges, rcounts)

        if np.ndim(self.selec_mesh) == 3:
            selec_mesh = irfftn(chreshape(rfftn(jnp.asarray(self.selec_mesh)),
                                                  r2chshape(self.final_shape)))
            selec_mesh = mesh2masked(selec_mesh, self.mask_mesh)
            selec_mesh = set_radial_count(selec_mesh, rmasked, self.redges, rcounts)
            selec_mesh = posit_fn(selec_mesh)
        else:
            selec_mesh = jnp.mean(rcounts)

        if self.png_type is not None and jnp.ndim(phi) == 3:
            phi = irfftn(chreshape(rfftn(phi),
                                           r2chshape(self.final_shape)))
            phi = mesh2masked(phi, self.mask_mesh)

        if self.lik_type == "poisson":
            count_mesh = ppl.sample("count_mesh",
                                    Poisson(posit_fn(count_mesh) ** (1 / temp)))

        elif self.lik_type == "fourier_gauss":
            assert self.mask_mesh is None, "Fourier likelihood needs a full box."
            from montecosmo_tpu.ops.fourier import lazy_kvec
            kvec = lazy_kvec(rfftk(self.final_shape, self.box_size), count_mesh)
            kmesh = sum(ki**2 for ki in kvec) ** 0.5
            mumesh = safe_div(sum(ki * li for ki, li in zip(kvec, self.los_fid)), kmesh)

            scale = posit_fn(stoch["s_e"] + stoch["s_k2e"] * kmesh**2
                             + stoch["s_kmu2e"] * (kmesh * mumesh) ** 2)
            scale = scale * selec_mesh**0.5 * temp**0.5
            scale = cgh2rg(scale.astype(jnp.complex64), norm="amp")
            count_mesh = cgh2rg(rfftn(count_mesh))
            count_mesh = ppl.sample("count_mesh", Normal(count_mesh, scale))

        elif self.lik_type in ("quad_gauss", "two_quad_gauss", "shash"):
            delta = count_mesh / selec_mesh - 1
            scale1 = posit_fn(stoch["s_e"] + stoch["s_ed"] * delta
                              + stoch["s_ep"] * phi) + 1e-9
            scale1 = scale1 * selec_mesh**0.5 * temp**0.5
            scale2 = stoch["s_e2"] * selec_mesh**0.5

            if self.lik_type == "quad_gauss":
                # NOTE: QuadGaussian has a parameter-dependent bounded support
                count_mesh = ppl.sample("count_mesh",
                                        QuadGaussian(count_mesh, scale1, scale2))
            elif self.lik_type == "two_quad_gauss":
                count_mesh = ppl.sample("count_mesh",
                                        TwoQuadGaussian(count_mesh, scale1, scale2))
            else:
                # moment-matched SHASH surrogate of QuadGaussian: mean/std
                # exact, skew/tail matched to first order in scale2/scale1
                ratio = scale2 / scale1
                count_mesh = ppl.sample("count_mesh", SinhArcsinh(
                    count_mesh, (scale1**2 + 2 * scale2**2) ** 0.5,
                    3.540 * ratio, 1 + 5.884 * ratio**2))
        else:
            raise ValueError(f"Unknown likelihood type: {self.lik_type}")

        return count_mesh

    # ------------------------------------------------------------------ powspec observable
    def _powspec_estimate(self, delta):
        """Stacked multipole spectra of a density-contrast cube: (n_ell, n_k).

        Traceable: the host-side `metrics.spectrum_plan` folds binning,
        Legendre weights and units into constants; one segment-sum on device."""
        from montecosmo_tpu.metrics import _spectrum

        _, _, pows = _spectrum(delta, box_size=self.box_size,
                               ells=tuple(self.poles),
                               kedges=self._powspec_static()["kedges"],
                               include_corners=False, los=self.los_fid)
        return jnp.stack([pows[int(l)] for l in self.poles])

    def _powspec_static(self):
        """Static powspec artefacts, computed once on host (numpy):

        * `kedges` / `kmean` — the k binning (below the mesh Nyquist),
        * `tril` — (n_k, n_ell, n_ell) Cholesky factors of the analytic
          Gaussian multipole covariance, evaluated EXACTLY on the discrete
          rfft mode grid (rather than the thin-shell continuum integral):
            C_l1l2(bin) = (2 l1 + 1)(2 l2 + 1) / N_k^2
                          sum_modes 2 w L_l1(mu) L_l2(mu) (P_fid(k, mu) + shot)^2
          with P_fid the fiducial Kaiser spectrum and shot = s_e^2 / nbar.

        Parity: the reference leaves observable='powspec' and its Grieb+2016
        covariance as a TODO (reference model.py:60); this implements it.
        """
        cache = getattr(self, "_powspec_cache", None)
        if cache is not None:
            return cache
        from montecosmo_tpu.metrics import _kmu_grid, legendre, spectrum_plan
        from montecosmo_tpu.ops.power import lin_power
        from montecosmo_tpu.utils.io import to_np

        if float(np.linalg.norm(self.los_fid)) == 0 and any(
                int(l) > 0 for l in self.poles):
            import warnings
            warnings.warn("observable='powspec' with ell>0 needs a fixed "
                          "line of sight (off-center box): los_fid is zero, "
                          "higher multipoles are estimated with mu=0.")

        box = np.broadcast_to(np.asarray(self.box_size, float), (3,))
        plan = spectrum_plan(tuple(self.final_shape), box,
                             self.powspec_kedges, ells=tuple(self.poles),
                             include_corners=False, los=self.los_fid)
        kedges, kmean, nk = plan["kedges"], plan["kmean"], plan["nmodes"]
        seg, B = plan["seg"], plan["nb"]
        kmesh, mumesh, mult = _kmu_grid(tuple(self.final_shape), box,
                                        self.los_fid)
        nk = np.maximum(nk, 1.0)

        # fiducial anisotropic galaxy power per mode (jit: one program
        # instead of per-op eager dispatch)
        ks, pows = jax.jit(lambda: lin_power(
            self.cosmo_fid, a=self.a_fid, kpow=self.lin_kpow, bg=self.bg_fid))()
        pk = np.interp(kmesh, to_np(ks), to_np(pows), left=0.0, right=0.0)
        f_fid = float(self.bg_fid.a2f(jnp.asarray(self.a_fid)))
        b1E = float(b1_L2E(np.mean(self.fiduc["b1"])))
        nbar = float(np.mean(self.fiduc["ngbars"]))
        shot = float(np.mean(self.fiduc["s_e"])) ** 2 / nbar
        ptot = (b1E + f_fid * mumesh**2) ** 2 * pk + shot

        poles = [int(l) for l in self.poles]
        legs = [legendre(l)(mumesh).reshape(-1) for l in poles]
        var = 2.0 * mult.reshape(-1) * ptot.reshape(-1) ** 2
        inbin = seg < B
        D = len(poles)
        cov = np.empty((B, D, D))
        for i, li in enumerate(poles):
            for j, lj in enumerate(poles[: i + 1]):
                cij = np.zeros(B)
                np.add.at(cij, seg[inbin], (legs[i] * legs[j] * var)[inbin])
                cij *= (2 * li + 1) * (2 * lj + 1) / nk**2
                cov[:, i, j] = cov[:, j, i] = cij
        # physical units (modes carry cell-unit power in the estimator; the
        # covariance is built directly in physical units via P_fid, nothing
        # to rescale) — ridge-regularize near-singular low-k blocks
        tr = np.trace(cov, axis1=-2, axis2=-1) / D
        cov += (1e-6 * tr[:, None, None] + 1e-30) * np.eye(D)
        tril = np.linalg.cholesky(cov)

        self._powspec_cache = {"kedges": np.asarray(kedges),
                               "kmean": np.asarray(kmean),
                               "tril": np.asarray(tril, np.float32)}
        return self._powspec_cache

    def _likelihood_powspec(self, gxy_mesh, stoch, syst, temp=1.0):
        """Gaussian multipole-spectrum likelihood with analytic per-k-bin
        multipole covariance (see `_powspec_static`)."""
        rcounts = syst["ngbars"] * self.cell_length**3
        nbar_cell = jnp.mean(rcounts)

        count_mesh = irfftn(chreshape(rfftn(gxy_mesh * self.selec_mesh),
                                      r2chshape(self.final_shape)))
        count_mesh = set_radial_count(count_mesh, self.radius_mesh(),
                                      self.redges, rcounts)
        delta = count_mesh / nbar_cell - 1.0
        pred = self._powspec_estimate(delta)

        # stochasticity enters as the (scaled) shot-noise monopole
        nbar = nbar_cell / self.cell_length**3
        shot = stoch["s_e"] ** 2 / nbar
        e0 = jnp.asarray([float(int(l) == 0) for l in self.poles])
        mean = pred + shot * e0[:, None]

        tril = jnp.asarray(self._powspec_static()["tril"]) * temp**0.5
        return ppl.sample("powspec", BlockMultivariateNormal(mean, tril))

    def powspec_obs(self, count_mesh=None):
        """Measure the observed multipoles from a registered count mesh with
        the SAME estimator as the likelihood (shape (n_ell, n_k))."""
        count_mesh = self.count_mesh if count_mesh is None else count_mesh
        if self.mask_mesh is not None and jnp.ndim(count_mesh) == 1:
            count_mesh = masked2mesh(count_mesh, self.mask_mesh)
        nbar_cell = float(np.mean(self.fiduc["ngbars"])) * self.cell_length**3
        return jax.jit(lambda c: self._powspec_estimate(c / nbar_cell - 1.0))(
            jnp.asarray(count_mesh))

    def obs_data(self):
        """{site: value} to condition the model on its registered data.

        For observable='powspec' a directly-assigned `powspec_data` (e.g. a
        self-predicted draw) takes precedence over re-measuring the
        registered count mesh."""
        if self.observable == "powspec":
            data = getattr(self, "powspec_data", None)
            return {"powspec": data if data is not None else self.powspec_obs()}
        return {"count_mesh": self.count_mesh}

    # ------------------------------------------------------------------ reparam
    def reparam(self, params: dict, fourier=True, inv=False, temp=1.0):
        """Sample-space <-> base-space transform of arbitrary param dicts."""
        params_ = self.data | params

        groups = ["cosmo", "bias", "png", "stoch", "ap", "syst", "init"]
        key = tuple([k if inv else k + "_"] for k in groups)
        key += (["*"] + ["~" + (k if inv else k + "_") for k in groups],)
        queries = Chains(params_, self.groups | self.groups_).get(key)
        cosmo_, bias_, png_, stoch_, ap_, syst_, init, rest = (q.data for q in queries)

        out = {}
        for dic in (cosmo_, bias_, png_, stoch_, ap_, syst_):
            out |= samp2base(dic, self.latents, inv=inv, temp=temp)

        if len(init) > 0:
            _, transfer = self._precond_scale_and_transfer()
            if inv and not fourier:
                init = jax.tree.map(jnp.fft.rfftn, init)
            if not inv and self.cut_mask is not None:
                init = jax.tree.map(lambda x: masked2mesh(x, self.cut_mask), init)
            init = samp2base_mesh(init, self.precond, transfer=transfer, inv=inv,
                                  temp=temp)
            if inv and self.cut_mask is not None:
                init = jax.tree.map(lambda x: mesh2masked(x, self.cut_mask), init)
            if not inv and not fourier:
                init = jax.tree.map(jnp.fft.irfftn, init)
            out |= init

        out = {k: v for k, v in out.items()
               if (k[:-1] if inv else k + "_") in params}
        rest = {k: v for k, v in rest.items() if k in params}
        return rest | out

    def reparam_b1(self, b1, sigma8, eulerian=False, inv=False):
        """sigma8-scaled b1 <-> unscaled b1 (scaling acts in Eulerian space)."""
        alpha = sigma8 / self.fiduc["sigma8"]
        if not eulerian:
            b1 = b1_L2E(b1)
        b1 = b1 * alpha if inv else b1 / alpha
        if not eulerian:
            b1 = b1_E2L(b1)
        return b1

    def reparam_b2(self, b2, b1L, sigma8, eulerian=False, inv=False):
        alpha = sigma8 / self.fiduc["sigma8"]
        if not eulerian:
            b2 = b2_L2E(b2, b1L)
        b2 = b2 * alpha**2 if inv else b2 / alpha**2
        if not eulerian:
            b2 = b2_E2L(b2, b1L)
        return b2

    def reparam_bias(self, params: dict, eulerian=False, inv=False):
        """sigma8-scaled bias <-> unscaled bias (requires 'sigma8' in scope)."""
        out = self.data | params
        sigma8 = out["sigma8"]
        if "b1" in out:
            b1_ = out["b1"]
            b1 = self.reparam_b1(b1_, sigma8, eulerian=eulerian, inv=inv)
            out["b1"] = b1
            if "b2" in out:
                b1u = b1_ if inv else b1
                b1L = b1_E2L(b1u) if eulerian else b1u
                out["b2"] = self.reparam_b2(out["b2"], b1L, sigma8,
                                            eulerian=eulerian, inv=inv)
        return params | {k: out[k] for k in params}

    # ------------------------------------------------------------------ getters
    def _validate_latents(self):
        new = {}
        for name, conf in self.latents.items():
            new[name] = conf.copy()
            loc, scale = conf.get("loc"), conf.get("scale")
            low, high = conf.get("low"), conf.get("high")
            loc_fid, scale_fid = conf.get("loc_fid"), conf.get("scale_fid")

            assert not ((loc is None) ^ (scale is None)), \
                f"latent '{name}': loc and scale must come together"
            assert not ((low is None) ^ (high is None)), \
                f"latent '{name}': low and high must come together"

            if loc is not None:  # Normal or TruncatedNormal prior
                if loc_fid is None:
                    new[name]["loc_fid"] = loc
                if scale_fid is None:
                    new[name]["scale_fid"] = scale
            elif low is not None:  # Uniform prior
                assert low <= high, f"latent '{name}': low must be <= high"
                assert np.isfinite(low) and np.isfinite(high), \
                    f"latent '{name}': uniform bounds must be finite"
                if loc_fid is None:
                    new[name]["loc_fid"] = (low + high) / 2
                if scale_fid is None:
                    new[name]["scale_fid"] = (high - low) / 12**0.5
        return new

    def _validate_rbins(self):
        rmesh = np.array(self.radius_mesh())
        rmasked = mesh2masked(rmesh, self.mask_mesh)
        rmin, rmax = rmasked.min(), rmasked.max()
        dr = 3**0.5 * self.cell_length  # minimum dr for connected shells

        n_rbins = max(int((rmax - rmin) / dr), 1) if self.n_rbins is None else self.n_rbins
        redges = np.linspace(rmin - dr / 1000, rmax + dr / 1000, n_rbins + 1)

        ngbars_conf = self.latents["ngbars"].copy()
        for attr in ("loc", "scale", "loc_fid", "scale_fid", "low", "high"):
            if attr in ngbars_conf:
                ngbars_conf[attr] = np.broadcast_to(ngbars_conf[attr], n_rbins)
        return n_rbins, rmasked, redges, ngbars_conf

    def _sample(self, names):
        """Sample latent parameters in unconstrained coordinates."""
        dic = {}
        for name in np.atleast_1d(names):
            conf = self.latents[name]
            loc, scale = conf.get("loc"), conf.get("scale")
            low, high = conf.get("low", -jnp.inf), conf.get("high", jnp.inf)
            loc_fid, scale_fid = conf["loc_fid"], conf["scale_fid"]

            if loc is not None and None not in np.atleast_1d(loc):
                if np.all(np.asarray(low) == -jnp.inf) and np.all(np.asarray(high) == jnp.inf):
                    samp = ppl.sample(name + "_",
                                      Normal((np.asarray(loc) - np.asarray(loc_fid))
                                             / np.asarray(scale_fid),
                                             np.asarray(scale) / np.asarray(scale_fid)))
                else:
                    samp = ppl.sample(name + "_", DetruncTruncNorm(
                        loc, scale, low, high, loc_fid, scale_fid))
            else:
                samp = ppl.sample(name + "_", DetruncUnif(low, high, loc_fid, scale_fid))
            dic[name + "_"] = samp
        return dic

    def _precond_scale_and_transfer(self, like=None):
        """Per-mode sampling scale and transfer for the white-field latent.

        precond 'kaiser': scale = (1 + boost^2 P / sigma_noise^2)^1/2 from the
        fiducial Kaiser SNR; transfer renormalizes to unit-power white noise.
        `like`: tracer the init_shape-sized meshes are tied to (lazy_kvec).
        """
        one = (1.0 if like is None
               else 1.0 + jnp.ravel(lax.stop_gradient(like))[0] * 0)
        if self.precond in ("real", "fourier"):
            # unit sampling scale per real dof; transfer only renormalizes to
            # unit-power white noise.  (The reference applies its Hermitian
            # amp-repack to a REAL-shaped ones array here, which only works
            # because it never runs precond != 'kaiser'.)
            scale = jnp.broadcast_to(one, tuple(self.init_shape))
            transfer = np.prod(np.divide(self.init_shape, self.box_size)) ** 0.5
            return scale, jnp.asarray(transfer)
        if self.precond == "kaiser":
            b1E_fid = b1_L2E(float(np.mean(self.fiduc["b1"])))
            boost_fid = kaiser_boost(self.cosmo_fid, self.a_fid, self.init_shape,
                                     self.box_size, b1E_fid, los=self.los_fid,
                                     bg=self.bg_fid, like=like)
            pmesh_fid = lin_power_mesh(self.cosmo_fid, self.init_shape,
                                       self.box_size, kpow=self.lin_kpow,
                                       like=like)
            pmesh_fid = pmesh_fid * np.prod(np.divide(self.init_shape, self.box_size))
            var_fid = float(np.mean(self.fiduc["s_e"])) / (self.count_fid * self.selec_fid)
            scale = (1 + boost_fid**2 / var_fid * pmesh_fid) ** 0.5
        else:
            raise ValueError(f"Unknown preconditioning: {self.precond}")

        transfer = np.prod(np.divide(self.init_shape, self.box_size)) ** 0.5 / scale
        scale = cgh2rg(scale.astype(jnp.complex64), norm="amp")
        return scale, transfer

    def _groups(self, base=True):
        groups = {}
        for name, val in self.latents.items():
            g = val["group"] if base else val["group"] + "_"
            groups.setdefault(g, []).append(name if base else name + "_")
        return groups

    def _labels(self):
        labs = {}
        for name, val in self.latents.items():
            labs[name] = val["label"]
            labs[name + "_"] = "\\tilde" + val["label"]
        return labs

    def _fiduc(self):
        return {k: v["loc_fid"] for k, v in self.latents.items() if "loc_fid" in v}

    @classmethod
    def new_latents_from_loc(cls, latents, loc: dict, update_prior: bool = False):
        """New latents config with updated fiducial (and optionally prior)
        locations."""
        new = {}
        for name, conf in latents.items():
            new[name] = conf.copy()
            if name in loc:
                new[name]["loc_fid"] = loc[name]
                if update_prior and "loc" in conf:
                    new[name]["loc"] = loc[name]
        return new

    # ------------------------------------------------------------------ data helpers
    def pos_mesh(self, shape=None):
        return pos_mesh(self.box_center, self.box_rot, self.box_size,
                        shape or self.final_shape)

    def radius_mesh(self, shape=None):
        return radius_mesh(self.box_center, self.box_rot, self.box_size,
                           shape or self.final_shape, self.curved_sky)

    def mesh2masked(self, mesh):
        return mesh2masked(mesh, self.mask_mesh)

    def masked2mesh(self, mesh):
        return masked2mesh(mesh, self.mask_mesh)

    def white2lin(self, cosmo, mesh):
        return white2lin(cosmo, mesh, self.init_shape, self.box_size, self.lin_kpow)

    def lin2white(self, cosmo, mesh):
        return lin2white(cosmo, mesh, self.init_shape, self.box_size, self.lin_kpow)

    def count2delta(self, mesh):
        """Counts -> overdensity under the global integral constraint."""
        if self.lik_type == "fourier_gauss":
            mesh = irfftn(rg2cgh(mesh))
        else:
            mesh = self.masked2mesh(mesh)

        if np.ndim(self.selec_mesh) == 3 and self.selec_mesh.shape != mesh.shape:
            selec = irfftn(chreshape(rfftn(jnp.asarray(self.selec_mesh)),
                                             r2chshape(mesh.shape)))
            selec = self.masked2mesh(self.mesh2masked(selec))
        else:
            selec = jnp.asarray(self.selec_mesh)
        return count2delta(mesh, selec)

    @classmethod
    def register_catalog(cls, cell_budget: float, cosmo_fid: Cosmology, data,
                         random=None, box_size=None, box_center=None,
                         box_rotvec=None, a_obs=None, los=None, padding: float = 0.0,
                         init_oversamp: float = 3 / 2, paint_oversamp: float = 7 / 4,
                         paint_order: int = 2, interlace_order: int = 2,
                         paint_deconv: bool = True, kernel_type: str = "rectangular"):
        """Register a particle catalog into inference-ready meshes + metadata.

        * cut-sky (`random` given): (RA, DEC, Z, WEIGHT) dicts; geometry fit to
          the randoms, selection + footprint painted from randoms, counts from
          data; light-cone, curved sky.
        * full-sky (`random` None): cartesian 'pos' (optional 'vel'/'WEIGHT')
          dict or iterable of chunk dicts; periodic box, optional catalog RSD
          at `a_obs` along `los`.
        Returns a register dict ready for `h5save` (None entries dropped).
        """
        bg = Background.create(cosmo_fid)
        cut_sky = random is not None
        if cut_sky:
            assert a_obs is None and los is None, \
                "cut-sky: a_obs and los must be None (light-cone, curved sky)"
            curved_sky = True
            final_shape, cell_length, box_center, box_rotvec = cutsky2config(
                random, bg, cell_budget, padding, box_size=box_size,
                box_center=box_center, box_rotvec=box_rotvec)
        else:
            assert a_obs is not None and los is not None and box_size is not None \
                and box_center is not None, \
                "full-sky: a_obs, los, box_size, box_center are required"
            box_rotvec = np.zeros(3) if box_rotvec is None else np.asarray(box_rotvec)
            final_shape, cell_length = get_mesh_shape(box_size, cell_budget)
            curved_sky = False

        paint_kw = dict(paint_order=paint_order, interlace_order=interlace_order,
                        paint_deconv=paint_deconv)
        box_size = np.multiply(final_shape, cell_length)
        init_shape = scale_shape(final_shape, init_oversamp)
        paint_shape = scale_shape(final_shape, paint_oversamp)

        if cut_sky:
            selec_mesh, mask_mesh = cutsky2selection(
                random, bg, mask_shape=final_shape, selec_shape=init_shape,
                paint_shape=paint_shape, box_size=box_size, box_center=box_center,
                box_rotvec=box_rotvec, **paint_kw)
            selec_mesh = irfftn(chreshape(rfftn(selec_mesh),
                                                  r2chshape(paint_shape)))
            selec_mesh, mask_mesh = np.asarray(selec_mesh), np.asarray(mask_mesh)
            count_mesh = cutsky2count(data, bg, final_shape, paint_shape,
                                      box_size=box_size, box_center=box_center,
                                      box_rotvec=box_rotvec, **paint_kw)
            n_tracers = float(np.sum(data["WEIGHT"]))
            n_randoms = float(np.sum(random["WEIGHT"]))
        else:
            count_mesh = fullsky2count(data, bg, a_obs, los=los, box_size=box_size,
                                       box_center=box_center, box_rotvec=box_rotvec,
                                       final_shape=final_shape,
                                       paint_shape=paint_shape, **paint_kw)
            box_center = np.multiply(los, float(bg.a2chi(a_obs)))
            n_tracers = float(count_mesh.sum())
            selec_mesh = mask_mesh = n_randoms = None

        return {
            "cell_length": float(cell_length),
            "box_center": np.asarray(box_center),
            "box_rotvec": np.asarray(box_rotvec),
            "init_oversamp": float(init_oversamp),
            "paint_oversamp": float(paint_oversamp),
            "cosmo_fid": {"Omega_m": float(cosmo_fid.Omega_m),
                          "sigma8": float(cosmo_fid.sigma8)},
            "count_mesh": np.asarray(count_mesh),
            "selec_mesh": None if selec_mesh is None else np.asarray(selec_mesh),
            "mask_mesh": None if mask_mesh is None else np.asarray(mask_mesh),
            "n_tracers": n_tracers, "n_randoms": n_randoms,
            "a_obs": a_obs, "curved_sky": curved_sky,
            "paint_order": int(paint_order), "interlace_order": int(interlace_order),
            "paint_deconv": bool(paint_deconv), "kernel_type": kernel_type,
            "cell_budget": float(cell_budget), "padding": float(padding),
        }

    # ------------------------------------------------------------------ metrics
    def spectrum(self, mesh0, mesh1=None, ells=0, kedges=None, include_corners=True):
        return spectrum(mesh0, mesh1=mesh1, box_size=self.box_size,
                        box_center=self.box_center, ells=ells, kedges=kedges,
                        include_corners=include_corners)

    def powtranscoh(self, mesh0, mesh1, kedges=None, include_corners=True):
        """(k, P1, (P1/P0)^1/2, P01/(P0 P1)^1/2) of mesh1 against mesh0."""
        return powtranscoh(mesh0, mesh1, box_size=self.box_size, kedges=kedges,
                           include_corners=include_corners)

    def mse_radius(self, mesh0, mesh1, cell_length=None, redges=None, aggr_fn=None,
                   from_masked=True):
        cell_length = cell_length or self.cell_length
        if not from_masked:
            mesh0 = mesh2masked(mesh0, self.mask_mesh)
            mesh1 = mesh2masked(mesh1, self.mask_mesh)
        return mse_radius(mesh0, mesh1, self.rmasked, cell_length, redges=redges,
                          aggr_fn=aggr_fn)

    def mse_value(self, mesh0, mesh1, cell_length=None, vedges=50, min_count=None,
                  aggr_fn=None):
        return mse_value(mesh0, mesh1, cell_length or self.cell_length,
                         vedges=vedges, min_count=min_count, aggr_fn=aggr_fn)

    def mse_wave(self, mesh0, mesh1, kedges=None, include_corners=True):
        return mse_wave(mesh0, mesh1, self.box_size, kedges=kedges,
                        include_corners=include_corners)

    def distr_radial(self, mesh, cell_length=None, redges=None, aggr_fn=None,
                     from_masked=True):
        cell_length = cell_length or self.cell_length
        if not from_masked:
            mesh = mesh2masked(mesh, self.mask_mesh)
        return distr_radial(mesh, self.rmasked, cell_length, redges=redges,
                            aggr_fn=aggr_fn)

    # ------------------------------------------------------------------ chains
    def load_runs(self, path, start: int, end: int, transforms=None, batch_ndim=2):
        return Chains.load_runs(path, start, end, transforms,
                                groups=self.groups | self.groups_,
                                labels=self.labels, batch_ndim=batch_ndim)

    def reparam_chains(self, chains: Chains, fourier=False, inv=False, batch_ndim=2):
        chains = chains.copy()
        chains.data = nvmap(partial(self.reparam, fourier=fourier, inv=inv),
                            batch_ndim)(chains.data)
        return chains

    def powtranscoh_chains(self, chains: Chains, mesh0, names=[], kedges=None,
                           batch_ndim=2):
        """Add 'kptc_{name}' = (k, P, transfer, coherence) of chain meshes
        against a reference mesh."""
        chains = chains.copy()
        # jit with mesh0 as an ARGUMENT, so that the reference mesh (the
        # register's ICs) is not embedded in the program as a constant.
        # lax.map (sequential), NOT nvmap: batch-vmapped small FFTs trip an
        # XLA:CPU fft-thunk layout assert (fft_thunk.cc:167 dim0-major) —
        # post-processing is not throughput-critical.
        def fn(data, m0):
            batch = jnp.shape(data)[:batch_ndim]
            flat = jnp.reshape(data, (-1,) + jnp.shape(data)[batch_ndim:])
            out = jax.lax.map(
                lambda x: self.powtranscoh(m0, x, kedges=kedges), flat)
            return jax.tree.map(
                lambda o: jnp.reshape(o, batch + jnp.shape(o)[1:]), out)

        fn = jax.jit(fn)
        for name in np.atleast_1d(names):
            chains.data[f"kptc_{name}"] = fn(chains.data[name], mesh0)
        return chains

    def kaiser_post(self, seed, base=False, temp=1.0, scale_field=1.0):
        """Draw from the analytic Kaiser posterior of the init field given the
        observed counts (+ fiducial values for latents not in data) — MCMC
        initialization."""
        delta_obs = self.count2delta(self.count_mesh)
        delta_obs = rfftn(delta_obs)
        delta_obs = chreshape(delta_obs, r2chshape(self.init_shape))

        b1E_fid = b1_L2E(float(np.mean(self.fiduc["b1"])))
        var_fid = float(np.mean(self.fiduc["s_e"])) / (self.count_fid * self.selec_fid)
        means, stds = kaiser_posterior(delta_obs, self.cosmo_fid, self.a_fid,
                                       self.box_size, var_noise=var_fid,
                                       b1E=b1E_fid, los=self.los_fid, bg=self.bg_fid)

        post_mesh = rg2cgh(jr.normal(seed, ch2rshape(means.shape)))
        post_mesh = temp**0.5 * stds * post_mesh + means
        post_mesh = lin2white(self.cosmo_fid, post_mesh, self.init_shape,
                              self.box_size, self.lin_kpow)
        # scaling down is recommended when the Kaiser approximation degrades
        post_mesh = post_mesh * scale_field

        start = {k: self.fiduc[k] for k in self.fiduc.keys() - self.data.keys()}
        start |= {k: post_mesh for k in {"white_mesh"} - self.data.keys()}
        return start if base else self.reparam(start, inv=True)
