"""Laplace approximation: marginal covariance of a small scalar-parameter
block given a large field, without materializing the field Hessian.

For a potential U(x, y) with Hessian blocks [[A, B], [B^T, D]] (x small,
y the field), the marginal covariance on x is the inverse Schur complement
(A - B D^-1 B^T)^-1. D is approximated by its diagonal, so the only large
objects ever formed are the (n, m) cross-derivative block and the diagonal
itself:

  * A        — dense (m, m) Hessian on the scalar block,
  * C = B^T  — ONE forward-over-reverse Jacobian of grad_y U w.r.t. x,
               materialized (n is large but m ~ tens, so n*m floats),
  * diag(D)  — exact basis probes of the y-Hessian diagonal (chunked hvp),
               or Hutchinson estimates,
  * Schur    — A minus the contraction C^T (C / diag(D)).

Functional parity with reference `montecosmo/lapprox.py:4-96`, computed
differently: the reference assembles B D^-1 B^T from m double-grad
matvecs; here the cross block is built once and the correction is a single
(m, n) @ (n, m) matmul.
"""
from jax import grad, hessian, jacfwd, linearize, lax, numpy as jnp, \
    random as jr, vmap

__all__ = ["marginal_covariance", "hessian_diag", "hessian_diag_stochastic",
           "cov_x_from_pot_x_y"]


def hessian_diag(f, y, chunk=64):
    """Exact diag of the Hessian of f at y: H_kk = (H e_k)_k by chunked hvps.

    One `linearize` builds the hvp; chunks of one-hot probes go through a
    vmapped hvp and the diagonal entries are gathered back out.
    """
    _, hvp = linearize(grad(f), y)
    n = y.shape[0]
    n_blocks = -(-n // chunk)

    def block(start):
        idx = (start + jnp.arange(chunk)) % n  # wrap: tail recomputes, cheap
        basis = (idx[:, None] == jnp.arange(n)).astype(y.dtype)
        rows = vmap(hvp)(basis)
        return jnp.take_along_axis(rows, idx[:, None], axis=1)[:, 0]

    starts = chunk * jnp.arange(n_blocks)
    return lax.map(block, starts).reshape(-1)[:n]


def hessian_diag_stochastic(f, y, n_probes=64, key=None):
    """Hutchinson estimate of diag(H): mean of r * (H r), r Rademacher."""
    if key is None or isinstance(key, int):
        key = jr.key(0 if key is None else key)
    _, hvp = linearize(grad(f), y)

    def probe(k):
        r = jr.rademacher(k, y.shape, dtype=y.dtype)
        return r * hvp(r)

    return jnp.mean(vmap(probe)(jr.split(key, n_probes)), axis=0)


def marginal_covariance(pot_fn, x, y, method="exact", chunk_size=None,
                        ridge=1e-9):
    """Marginal covariance of x under the Laplace approximation at (x, y).

    pot_fn : (x (m,), y (n,)) -> scalar potential (negative log density).
    method : 'exact' (chunked hvp probes of diag D) or 'hutchinson'.
    ridge  : added to diag(D) before inversion.
    Returns (cov_x (m, m), schur (m, m)).
    """
    m, n = x.shape[0], y.shape[0]
    chunk_size = n if chunk_size is None else chunk_size

    A = hessian(pot_fn, argnums=0)(x, y)

    pot_y = lambda yy: pot_fn(x, yy)
    if method == "exact":
        d = hessian_diag(pot_y, y, chunk=chunk_size)
    elif method == "hutchinson":
        d = hessian_diag_stochastic(pot_y, y, n_probes=chunk_size)
    else:
        raise ValueError(f"unknown method {method!r}")

    # cross block C = d(grad_y U)/dx, shape (n, m): forward over reverse —
    # m forward tangents through one reverse pass, then one f32 contraction.
    C = jacfwd(grad(pot_fn, argnums=1), argnums=0)(x, y)
    correction = jnp.dot(C.T, C / (d + ridge)[:, None],
                         precision=lax.Precision.HIGHEST)

    schur = A - correction
    schur = 0.5 * (schur + schur.T)
    return jnp.linalg.inv(schur), schur


# reference-parity alias (montecosmo/lapprox.py:4)
def cov_x_from_pot_x_y(pot_fn, x, y, method="exact", chunk_size=None,
                       eps_diag=1e-9):
    return marginal_covariance(pot_fn, x, y, method=method,
                               chunk_size=chunk_size, ridge=eps_diag)
