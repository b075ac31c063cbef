"""Summary statistics: multipole power spectra, transfer/coherence, binned
MSEs, the curved-sky mu^2 operator, and chain diagnostics (ESS, Gelman-Rubin).

The spectrum estimator is a `jnp.bincount` reduction over the digitized |k|
mesh with Hermitian double-count weights — a single segmented reduction.
Bin edges and Legendre weights are numpy constants.

Parity: reference `montecosmo/metrics.py` (spectrum/_waves:60-187,
transfer/coherence/powtranscoh:190-210, bin_and_aggregate + mse_*:214-313,
kaiser_formula:349, mu2-delta operators:374-445, wigner3j_square:467-537,
multi_ess/multi_gr:565-579).  Chain diagnostics are implemented natively
(the reference used numpyro.diagnostics).
"""
import math
from functools import partial

import numpy as np
from jax import numpy as jnp
from scipy.special import factorial, legendre, lpmv

from montecosmo_tpu.ops.fourier import bspline_hat, rfftk
from montecosmo_tpu.ops.hermitian import ch2rshape
from montecosmo_tpu.utils.safe import safe_div


# ----------------------------------------------------------------------- binning
def kbin_edges(mesh_shape, box_size, kedges=None, include_corners=True):
    """Closed-form k-bin edges: [0, kmax) in steps of sqrt(d) k_fund by
    default (the minimum width for connected shells); kmax is the smallest
    axis Nyquist (include_corners=False) or the corner |k_Nyq| norm."""
    box = np.broadcast_to(np.asarray(box_size, float), (len(mesh_shape),))
    knyq = np.pi * np.asarray(mesh_shape) / box
    kmax = float(np.linalg.norm(knyq)) if include_corners else float(knyq.min())
    if not isinstance(kedges, (type(None), int, float)):
        return np.asarray(kedges)
    if kedges is None:
        n_edges = max(
            int(kmax / (len(mesh_shape) ** 0.5 * 2 * np.pi / box.min())), 1)
    elif isinstance(kedges, int):
        n_edges = kedges
    else:
        n_edges = max(int(kmax / kedges), 1)
    return np.linspace(0.0, kmax, n_edges, endpoint=False) + kmax / n_edges / 2


def _kmu_grid(mesh_shape, box_size, los=(0.0, 0.0, 0.0)):
    """Numpy |k| mesh, mu mesh, and Hermitian multiplicity over the rfft
    grid (modes with 0 < kz < Nyquist also represent their conjugates)."""
    kvec = rfftk(tuple(mesh_shape), tuple(box_size), dtype=np.float64)
    kmesh = np.sqrt(sum(ki**2 for ki in kvec))
    kpar = sum(ki * li for ki, li in zip(kvec, los))
    mumesh = np.divide(kpar, kmesh, out=np.zeros(kmesh.shape), where=kmesh > 0)
    mult = np.full(kmesh.shape, 2.0)
    mult[..., 0] = 1.0
    if mesh_shape[-1] % 2 == 0:
        mult[..., -1] = 1.0
    return kmesh, mumesh, mult


def spectrum_plan(mesh_shape, box_size=None, kedges=None, ells=(0,),
                  include_corners=True, los=(0.0, 0.0, 0.0)):
    """Host-side reduction plan for multipole spectra of an rfft mesh.

    Everything static is folded into ONE per-mode weight matrix on the host,
    so the device-side estimator is a single stacked segment-sum:
        P_ell[bin] = sum_{modes m in bin} |delta_m|^2 * wl[m, ell]
    with the Hermitian multiplicity, the (2 ell + 1) Legendre(mu) multipole
    weights, the per-bin mode normalization AND the cell -> (Mpc/h)^3 units
    all pre-folded into wl.  Out-of-range modes land in a trash segment.

    Returns a dict: seg (n_modes,) int32 bin ids (nb = trash), wl (n_modes,
    n_ell) float32, kedges, kmean, nmodes, nb.
    """
    mesh_shape = tuple(int(s) for s in mesh_shape)
    box = (np.asarray(mesh_shape, float) if box_size is None
           else np.broadcast_to(np.asarray(box_size, float),
                                (len(mesh_shape),)))
    kedges = kbin_edges(mesh_shape, box, kedges, include_corners)
    nb = len(kedges) - 1
    kmesh, mumesh, mult = _kmu_grid(mesh_shape, box, los)

    k = kmesh.reshape(-1)
    seg = np.searchsorted(kedges, k, side="right").astype(np.int32) - 1
    seg = np.where((seg < 0) | (seg >= nb), nb, seg)
    w = mult.reshape(-1)
    inbin = seg < nb

    nmodes = np.zeros(nb)
    np.add.at(nmodes, seg[inbin], w[inbin])
    ksum = np.zeros(nb)
    np.add.at(ksum, seg[inbin], (k * w)[inbin])
    kmean = ksum / np.maximum(nmodes, 1.0)

    unit = float(np.prod(box / np.asarray(mesh_shape, float) ** 2))
    inv_n = unit / np.maximum(nmodes, 1.0)
    per_mode = w * np.concatenate([inv_n, [0.0]])[seg]
    mu = np.broadcast_to(mumesh, kmesh.shape).reshape(-1)
    wl = np.stack([(2 * int(ell) + 1) * legendre(int(ell))(mu) * per_mode
                   for ell in ells], axis=-1)
    return dict(seg=seg, wl=np.asarray(wl, np.float32),
                kedges=np.asarray(kedges), kmean=kmean, nmodes=nmodes, nb=nb)


def _segment_reduce(data, seg, nb):
    """Sum `data` (n_modes, ...) into nb k-bins (+1 trash bin, dropped)."""
    import jax

    return jax.ops.segment_sum(data, jnp.asarray(seg),
                               num_segments=nb + 1)[:nb]


def _spectrum(mesh0, mesh1=None, box_size=None, box_center=(0.0, 0.0, 0.0),
              ells=0, kedges=None, include_corners=True, deconv=(0, 0),
              los=None):
    """Auto/cross multipole power spectrum of 3D fields.

    `los` overrides the box-center-derived line of sight (useful when the
    mesh axes live in a rotated box frame).  Device side: mode power times
    the plan's pre-folded weight matrix, one stacked segment-sum."""
    if los is None:
        box_center = np.asarray(box_center)
        los = safe_div(box_center, np.linalg.norm(box_center))
    if isinstance(deconv, int):
        deconv = (deconv, deconv)

    if jnp.isrealobj(mesh0):
        mesh_shape = tuple(mesh0.shape)
        mesh0 = jnp.fft.rfftn(mesh0)
    else:
        mesh_shape = ch2rshape(mesh0.shape)

    from montecosmo_tpu.ops.fourier import lazy_kvec
    kvec = lazy_kvec(rfftk(mesh_shape), mesh0)  # cell units, staged on device
    if deconv[0]:
        mesh0 = mesh0 / bspline_hat(kvec, order=deconv[0])
    if mesh1 is not None:
        if jnp.isrealobj(mesh1):
            mesh1 = jnp.fft.rfftn(mesh1)
        if deconv[1]:
            mesh1 = mesh1 / bspline_hat(kvec, order=deconv[1])

    ells_tup = tuple(int(e) for e in np.atleast_1d(ells))
    plan = spectrum_plan(mesh_shape, box_size, kedges, ells_tup,
                         include_corners, los)
    wl = jnp.asarray(plan["wl"])

    if mesh1 is None:
        power = (mesh0.real**2 + mesh0.imag**2).reshape(-1, 1)
        ptab = _segment_reduce(power * wl, plan["seg"], plan["nb"])
    else:
        cross = (mesh0 * mesh1.conj()).reshape(-1, 1)
        # stack (re, im) as a trailing real axis: one real segment-sum, then
        # the modulus per (bin, ell)
        parts = jnp.stack([cross.real * wl, cross.imag * wl], -1)
        flat = _segment_reduce(parts.reshape(parts.shape[0], -1),
                               plan["seg"], plan["nb"])
        flat = flat.reshape(plan["nb"], len(ells_tup), 2)
        ptab = jnp.hypot(flat[..., 0], flat[..., 1])

    # empty bins keep the historical 0/0 = NaN signature
    empty = jnp.asarray(plan["nmodes"] == 0)
    pows = {ell: jnp.where(empty, jnp.nan, ptab[:, i])
            for i, ell in enumerate(ells_tup)}
    kcount = plan["nmodes"]
    kmean = np.where(kcount > 0, plan["kmean"], np.nan)
    if isinstance(ells, int):
        return kcount, kmean, pows[ells]
    return kcount, kmean, pows


def spectrum(mesh0, mesh1=None, box_size=None, box_center=(0.0, 0.0, 0.0),
             ells=0, kedges=None, include_corners=True, los=None):
    """Multipole auto/cross power spectrum: (k_mean, P_ell)."""
    _, kmean, pows = _spectrum(mesh0, mesh1, box_size, box_center, ells,
                               kedges, include_corners, los=los)
    return kmean, pows


def bispectrum(mesh, box_size=None, kedges=None, open_triangles=False,
               los=(0.0, 0.0, 0.0)):
    """FFT-based binned bispectrum monopole (Scoccimarro estimator).

    Formulation: one shell-filtered inverse FFT per k-bin plus
    dense elementwise triple products — no mode gathers, no scatters.  For
    every bin triple (i <= j <= l) that can close a triangle,

        B(i, j, l) = V^2/N^9 * mean_x[F_i F_j F_l] / mean_x[I_i I_j I_l],

    where F_b = irfftn(delta_k * 1_{k in bin b}) and I_b the same filter
    applied to unit amplitudes (the discrete triangle count).  The
    normalization follows <d_k1 d_k2 d_k3> = N^9/V^2 B delta_K(k123) for
    unnormalized forward FFTs.

    open_triangles also keeps triples whose BIN CENTERS violate the
    triangle inequality but whose finite bins still contain closed
    triangles (flattened configurations).

    Returns (kmean, triples (n_tri, 3) bin indices, B (n_tri,), n_modes per
    bin).  The reference leaves bispectrum support as a TODO
    (reference model.py:60); this goes beyond it.
    """
    if jnp.isrealobj(mesh):
        mesh_shape = np.array(mesh.shape)
        mesh = jnp.fft.rfftn(mesh)
    else:
        mesh_shape = np.array(ch2rshape(mesh.shape))
    box_size = mesh_shape if box_size is None else np.asarray(box_size)

    plan = spectrum_plan(tuple(mesh_shape), box_size, kedges, ells=(0,),
                         include_corners=False, los=np.asarray(los, float))
    kedges, kmean, kcount = plan["kedges"], plan["kmean"], plan["nmodes"]
    n_bins = plan["nb"]
    seg = plan["seg"].reshape((*mesh_shape[:-1], mesh_shape[-1] // 2 + 1))

    # shell-filtered fields (n_bins small: unrolled FFTs)
    fs, ones = [], []
    for b in range(n_bins):
        mask = jnp.asarray(seg == b, mesh.real.dtype)
        fs.append(jnp.fft.irfftn(mesh * mask, tuple(mesh_shape)))
        ones.append(jnp.fft.irfftn(mask + 0j, tuple(mesh_shape)))
    fs, ones = jnp.stack(fs), jnp.stack(ones)

    # closed-triangle bin triples from the bin EDGES (conservative) or
    # centers; i <= j <= l with k_i + k_j >= k_l
    lo, hi = kedges[:-1], kedges[1:]
    triples = []
    for i in range(n_bins):
        for j in range(i, n_bins):
            for l in range(j, n_bins):
                closes = (hi[i] + hi[j] >= lo[l]) if open_triangles \
                    else (kmean[i] + kmean[j] >= kmean[l])
                if closes:
                    triples.append((i, j, l))
    triples = np.asarray(triples, np.int32).reshape(-1, 3)

    norm = float(np.prod(box_size) ** 2 / np.prod(mesh_shape) ** 3)
    n_cells = float(np.prod(mesh_shape))
    bs = []
    for i, j, l in triples:
        num = jnp.mean(fs[i] * fs[j] * fs[l])
        den = jnp.mean(ones[i] * ones[j] * ones[l])
        # den * N^9 is the DISCRETE closed-triangle count of the triple; a
        # mathematically-empty triple leaves only f32 roundoff in `den`, so
        # gate on >= 1 actual triangle instead of safe-dividing roundoff
        n_tri = den * n_cells**3
        bs.append(jnp.where(n_tri > 0.5, norm * safe_div(num, den), 0.0))
    return kmean, triples, jnp.stack(bs), kcount


def transfer(mesh0, mesh1, box_size, kedges=None, include_corners=True):
    """(P1/P0)^1/2 per k-bin."""
    pow_fn = partial(spectrum, box_size=box_size, kedges=kedges,
                     include_corners=include_corners)
    ks, pow0 = pow_fn(mesh0)
    ks, pow1 = pow_fn(mesh1)
    return ks, (pow1 / pow0) ** 0.5


def coherence(mesh0, mesh1, box_size, kedges=None, include_corners=True):
    """P01 / (P0 P1)^1/2 per k-bin."""
    pow_fn = partial(spectrum, box_size=box_size, kedges=kedges,
                     include_corners=include_corners)
    ks, pow01 = pow_fn(mesh0, mesh1)
    ks, pow0 = pow_fn(mesh0)
    ks, pow1 = pow_fn(mesh1)
    return ks, pow01 / (pow0 * pow1) ** 0.5


def powtranscoh(mesh0, mesh1, box_size, kedges=None, include_corners=True):
    """(k, P1, transfer, coherence) of mesh1 against reference mesh0."""
    pow_fn = partial(spectrum, box_size=box_size, kedges=kedges,
                     include_corners=include_corners)
    ks, pow01 = pow_fn(mesh0, mesh1)
    ks, pow0 = pow_fn(mesh0)
    ks, pow1 = pow_fn(mesh1)
    return ks, pow1, (pow1 / pow0) ** 0.5, pow01 / (pow0 * pow1) ** 0.5


# ----------------------------------------------------------------------- value binning
def bin_and_aggregate(targets, values, vedges, min_count=1, aggr_fn=None):
    """Bin `targets` by `values` and aggregate per bin (mean by default).

    If min_count is None, vedges is interpreted in quantile space.
    Returns (counts, value means, aggregated targets).
    """
    targets = np.asarray(targets).reshape(-1)
    values = np.asarray(values).reshape(-1)
    assert len(targets) == len(values), "targets and values must have same length."

    if isinstance(vedges, (int, float)):
        vmin, vmax = (0.0, 1.0) if min_count is None else (values.min(), values.max())
        if isinstance(vedges, int):
            n_vedges = vedges
        else:
            n_vedges = max(int((vmax - vmin) / vedges), 1)
        dv = (vmax - vmin) / n_vedges
        vedges = np.linspace(vmin, vmax, n_vedges, endpoint=False) + dv / 2

    if min_count is None:
        vedges = np.quantile(values, q=vedges)
        min_count = 1

    n_bins = len(vedges) + 1
    dig = np.digitize(values, vedges)
    vcount = np.bincount(dig, minlength=n_bins)[1:-1]
    keep = vcount >= min_count
    vcount = vcount[keep]
    vmean = np.bincount(dig, weights=values, minlength=n_bins)[1:-1][keep] / vcount

    if aggr_fn is None:
        taggr = np.bincount(dig, weights=targets, minlength=n_bins)[1:-1][keep] / vcount
    else:
        taggr = np.array([aggr_fn(targets[dig == i]) for i in range(1, n_bins - 1)])[keep]
    return vcount, vmean, taggr


def mse_radius(mesh0, mesh1, rmesh, cell_length, redges=None, aggr_fn=None):
    """MSE between meshes binned by radius, in (Mpc/h)^3."""
    if redges is None:
        redges = 3**0.5 * cell_length  # minimum dr for connected shells
    se = (np.asarray(mesh0) - np.asarray(mesh1)) ** 2 * cell_length**3
    return bin_and_aggregate(se, rmesh, redges, aggr_fn=aggr_fn)


def mse_value(mesh0, mesh1, cell_length, vedges, min_count=None, aggr_fn=None):
    """MSE between meshes binned by the value of mesh0, in (Mpc/h)^3."""
    se = (np.asarray(mesh0) - np.asarray(mesh1)) ** 2 * cell_length**3
    return bin_and_aggregate(se, mesh0, vedges, min_count=min_count, aggr_fn=aggr_fn)


def mse_wave(mesh0, mesh1, box_size, kedges=None, include_corners=True):
    """MSE between meshes binned by wavenumber (power of the difference)."""
    return _spectrum(mesh1 - mesh0, box_size=box_size, kedges=kedges,
                     include_corners=include_corners)


def distr_radial(mesh, rmesh, cell_length, redges=None, aggr_fn=None):
    """Radial distribution of a mesh in (h/Mpc)^3."""
    if redges is None:
        redges = 3**0.5 * cell_length
    rcount, rmean, maggr = bin_and_aggregate(mesh, rmesh, redges, aggr_fn=aggr_fn)
    return rcount, rmean, maggr / cell_length**3


def distr_angular(mesh, pos_mesh, n_costheta=12, n_phi=24, min_count=1,
                  aggr_fn=None):
    """Angular distribution of a mesh per steradian.

    Bins cells by line-of-sight direction from the observer on an
    equal-area (cos theta, phi) grid (every bin subtends 4 pi / n_bins sr)
    and aggregates the mesh per bin — the angular companion of
    `distr_radial` (the reference declares this and leaves it empty,
    reference metrics.py:555-559).

    Parameters: `pos_mesh` (..., 3) observer-centred cell positions;
    `aggr_fn` overrides the default per-bin SUM (the default yields the
    surface density d(sum mesh)/dOmega in 1/sr).

    Returns (counts, (costheta_centers, phi_centers), aggregate) with one
    entry per bin of >= min_count cells, flattened costheta-major.
    """
    mesh = np.asarray(mesh).reshape(-1)
    pos = np.asarray(pos_mesh).reshape(-1, 3)
    assert len(mesh) == len(pos), "mesh and pos_mesh must match."

    r = np.maximum(np.sqrt((pos**2).sum(-1)), 1e-30)
    cost = np.clip(pos[:, 2] / r, -1.0, 1.0)
    phi = np.arctan2(pos[:, 1], pos[:, 0])  # (-pi, pi]
    ic = np.minimum(((cost + 1.0) / 2.0 * n_costheta).astype(int),
                    n_costheta - 1)
    ip = np.minimum(((phi + np.pi) / (2 * np.pi) * n_phi).astype(int),
                    n_phi - 1)
    dig = ic * n_phi + ip
    n_bins = n_costheta * n_phi

    count = np.bincount(dig, minlength=n_bins)
    keep = count >= min_count
    solid = 4.0 * np.pi / n_bins  # equal-area binning
    if aggr_fn is None:
        aggr = np.bincount(dig, weights=mesh, minlength=n_bins) / solid
    else:
        aggr = np.array([aggr_fn(mesh[dig == i]) if keep[i] else 0.0
                         for i in range(n_bins)])

    cost_c = -1.0 + (np.arange(n_costheta) + 0.5) * 2.0 / n_costheta
    phi_c = -np.pi + (np.arange(n_phi) + 0.5) * 2.0 * np.pi / n_phi
    centers = (np.repeat(cost_c, n_phi)[keep], np.tile(phi_c, n_costheta)[keep])
    return count[keep], centers, aggr[keep]


# ----------------------------------------------------------------------- error bars
def mean_errorbar(count, std, confidence=0.95, gaussian_approx=False):
    """(lo, hi) error bar on a sample mean (Student-t unless approximated)."""
    from scipy.stats import norm, t
    if not gaussian_approx:
        df = count - 1
        lo, hi = t(df=df).interval(confidence)
        return jnp.stack((-std / df**0.5 * lo, std / df**0.5 * hi))
    hi = norm.interval(confidence)[1] * std / count**0.5
    return jnp.stack((hi, hi))


def var_errorbar(count, var, confidence=0.95, gaussian_approx=False):
    """(lo, hi) error bar on a sample variance (chi^2 unless approximated)."""
    from scipy.stats import chi2, norm
    if not gaussian_approx:
        lo, hi = chi2(df=count).interval(confidence)
        lo, hi = var * count / hi, var * count / lo
        return jnp.stack((var - lo, hi - var))
    hi = var * (2 / count) ** 0.5 * norm.interval(confidence)[1]
    return jnp.stack((hi, hi))


# ----------------------------------------------------------------------- Kaiser multipoles
def kaiser_formula(bg, a, lin_kpow, b1E, ells=0):
    """Analytic Kaiser multipoles P_ell(k) for Eulerian bias b1E."""
    ells = jnp.atleast_1d(jnp.asarray(ells))
    beta = bg.a2f(a) / b1E
    k, pows = lin_kpow
    pows = pows * bg.a2g(a) ** 2

    weights = np.ones(len(ells)) * b1E**2
    for i, ell in enumerate(ells):
        if ell == 0:
            weights[i] *= 1 + beta * 2 / 3 + beta**2 / 5
        elif ell == 2:
            weights[i] *= beta * 4 / 3 + beta**2 * 4 / 7
        elif ell == 4:
            weights[i] *= beta**2 * 8 / 35
        else:
            raise NotImplementedError(f"ell={ell} not in (0, 2, 4)")
    return k, jnp.moveaxis(pows[..., None] * weights, -1, -2)


# ----------------------------------------------------------------------- curved-sky mu^2
def real_sph_harm(l, m, theta, phi):
    """Real spherical harmonics Y(l, m) at colatitude theta, longitude phi."""
    m_abs = abs(m)
    norm = ((2 * l + 1) / (4 * np.pi) * factorial(l - m_abs) / factorial(l + m_abs)) ** 0.5
    asso = lpmv(m_abs, l, np.cos(theta))
    if m > 0:
        return 2**0.5 * norm * asso * np.cos(m * phi)
    if m < 0:
        return 2**0.5 * norm * asso * np.sin(m_abs * phi)
    return norm * asso


def naive_mu2_delta(mesh, los):
    """(k.los/|k|)^2-weighted field by two sequential mu-projections (8 FFTs)."""
    mesh_shape = ch2rshape(mesh.shape)
    kvec = rfftk(mesh_shape)
    kmesh = sum(ki**2 for ki in kvec) ** 0.5

    mu_delta = jnp.stack(
        [jnp.fft.irfftn(safe_div(kvec[i] * mesh, kmesh)) for i in range(3)], -1)
    mu_delta = jnp.fft.rfftn((mu_delta * los).sum(-1))
    mu2_delta = jnp.stack(
        [jnp.fft.irfftn(safe_div(kvec[i] * mu_delta, kmesh)) for i in range(3)], -1)
    return (mu2_delta * los).sum(-1)


def _y2_cartesian(u):
    """The five real l=2 spherical harmonics of a unit vector field
    (..., 3) in closed cartesian form — traceable (no scipy/lpmv)."""
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    c15 = 0.5 * np.sqrt(15 / np.pi)
    c5 = 0.25 * np.sqrt(5 / np.pi)
    return (c15 * x * y,                      # m = -2
            c15 * y * z,                      # m = -1
            c5 * (3 * z**2 - 1),              # m = 0 (unit vector)
            c15 * z * x,                      # m = +1
            0.5 * c15 * (x**2 - y**2))        # m = +2


def optim_mu2_delta(mesh, los):
    """mu^2-weighted field via the Y_2m decomposition of mu^2 (6 FFTs):
    mu^2 = 1/3 + 8pi/15 sum_m Y_2m(k-hat) Y_2m(r-hat)  (cf. Hand+2017).

    los : per-cell unit line-of-sight field (..., 3); may be traced (the
    light-cone makes it cosmology-dependent).  Returns (delta, mu2_delta) in
    real space.
    """
    mesh_shape = ch2rshape(mesh.shape)
    from montecosmo_tpu.ops.fourier import lazy_kvec
    kvec = lazy_kvec(rfftk(mesh_shape), mesh)
    kmesh = sum(ki**2 for ki in kvec) ** 0.5
    khat = jnp.stack(
        [safe_div(jnp.broadcast_to(ki, mesh.shape), kmesh) for ki in kvec], -1)

    ylos = _y2_cartesian(jnp.asarray(los))
    yk = _y2_cartesian(khat)

    delta = jnp.fft.irfftn(mesh)
    mu2_delta = delta / 3
    for yl, ykm in zip(ylos, yk):
        mu2_delta += 8 * np.pi / 15 * yl * jnp.fft.irfftn(ykm * mesh)
    return delta, mu2_delta


# ----------------------------------------------------------------------- window convolution
def _wigner3j_zero_sq(l1, l2, l3):
    """Exact squared Wigner 3j symbol (l1 l2 l3; 0 0 0)^2 as a Fraction.

    Closed form (Edmonds 1957 eq. 3.7.17): with 2g = l1+l2+l3 even and the
    triangle condition satisfied,
      (l1 l2 l3; 000)^2 = D * [g! / ((g-l1)! (g-l2)! (g-l3)!)]^2,
      D = (2g-2l1)! (2g-2l2)! (2g-2l3)! / (2g+1)!.
    Zero when l1+l2+l3 is odd or the triangle inequality fails.
    """
    from fractions import Fraction

    total = l1 + l2 + l3
    if total % 2 or not abs(l1 - l2) <= l3 <= l1 + l2:
        return Fraction(0)
    g = total // 2
    f = math.factorial
    D = Fraction(f(2 * (g - l1)) * f(2 * (g - l2)) * f(2 * (g - l3)),
                 f(2 * g + 1))
    binom = Fraction(f(g), f(g - l1) * f(g - l2) * f(g - l3))
    return D * binom * binom


def wigner3j_square(ellout, ellin, prefactor=True):
    """Legendre-product linearization coefficients for window convolution:
      P_ellout(x) P_ellin(x) = sum_L (2L+1) (ellout ellin L; 000)^2 P_L(x),
    optionally including the (2 ellout + 1)/(2L+1) window-matrix prefactor
    (cf. Wilson et al. 2015 eq. 2.2). Computed exactly in rational arithmetic
    from the squared 3j closed form. Returns (L values, coefficients),
    L ascending from |ellout-ellin| to ellout+ellin in steps of 2.
    Parity: reference metrics.py:467-537 (pyRSD G-function route).
    """
    from fractions import Fraction

    ells, coeffs = [], []
    for L in range(abs(ellout - ellin), ellout + ellin + 1, 2):
        c = (2 * L + 1) * _wigner3j_zero_sq(ellout, ellin, L)
        if prefactor:
            c *= Fraction(2 * ellout + 1, 2 * L + 1)
        ells.append(L)
        coeffs.append(float(c))
    return ells, coeffs


# ----------------------------------------------------------------------- chain diagnostics
def effective_sample_size(x):
    """ESS per parameter from (n_chains, n_samples, ...) draws, via the
    initial-monotone-positive-sequence autocorrelation estimator (Geyer 1992,
    as in Vehtari+2021)."""
    x = jnp.asarray(x)
    n_chains, n_samples = x.shape[:2]

    # FFT autocovariance per chain
    mean = x.mean(1, keepdims=True)
    xc = x - mean
    n_fft = int(2 ** np.ceil(np.log2(2 * n_samples)))
    f = jnp.fft.rfft(xc, n=n_fft, axis=1)
    acov = jnp.fft.irfft(f * f.conj(), n=n_fft, axis=1)[:, :n_samples].real
    acov = acov / n_samples

    within = acov[:, 0].mean(0)  # W (biased variance mean)
    var_plus = within * (n_samples - 1) / n_samples
    if n_chains > 1:
        var_plus = var_plus + x.mean(1).var(0, ddof=1)

    rho = 1.0 - (within - acov.mean(0)) / var_plus  # (n_samples, ...)
    rho = rho.at[0].set(1.0)

    # paired sums; stop at first negative pair (monotone-positive sequence)
    n_pairs = n_samples // 2
    paired = rho[: 2 * n_pairs].reshape(n_pairs, 2, *rho.shape[1:]).sum(1)
    mask = jnp.cumprod(paired > 0, axis=0)
    paired = jnp.minimum(paired, jnp.concatenate(
        [paired[:1], jnp.minimum.accumulate(paired, axis=0)[:-1]], axis=0))
    tau = -1.0 + 2.0 * (paired * mask).sum(0)
    return n_chains * n_samples / jnp.maximum(tau, 1e-8)


def gelman_rubin(x):
    """Split-free potential scale reduction factor from
    (n_chains, n_samples, ...) draws."""
    x = jnp.asarray(x)
    n_chains, n_samples = x.shape[:2]
    chain_means = x.mean(1)
    chain_vars = x.var(1, ddof=1)
    W = chain_vars.mean(0)
    B = n_samples * chain_means.var(0, ddof=1)
    var_plus = (n_samples - 1) / n_samples * W + B / n_samples
    return jnp.sqrt(var_plus / W)


def geomean(x, axis=None):
    return jnp.exp(jnp.mean(jnp.log(x), axis=axis))


def harmean(x, axis=None):
    return 1 / jnp.mean(1 / x, axis=axis)


def multi_ess(x, axis=None):
    """Harmonic-mean ESS across parameters."""
    return harmean(effective_sample_size(x), axis=axis)


def multi_gr(x, axis=None):
    """Multivariate Gelman-Rubin ~ (1 + n_c/mESS)^1/2 (arXiv:1812.09384)."""
    return jnp.mean(gelman_rubin(x) ** 2, axis=axis) ** 0.5
