"""Dense linear algebra core: Cholesky-everything.

Replaces the reference's scattered ``jnp.linalg.inv`` (``spax/models.py:40``,
``spax/likelihoods.py:60``), ``slogdet`` (``spax/utils.py:38-40``) and
``neural_tangents.predict.gradient_descent_mse_ensemble``
(``spax/kernels.py:29-32``) with solve-based, matmul-shaped primitives:
one Cholesky factorization feeds the predictive mean, covariance, quadratic
form, and log-determinant.

Semantics notes for parity with the reference:

- ``gp_predict`` regularizes with ``diag_reg * mean(diag(K)) * I`` — the
  *relative* scaling used by neural_tangents' ``gradient_descent_mse_ensemble``
  default (``diag_reg_absolute_scale=False``).
- ``jitter`` is the absolute ``eps * I`` used directly by the reference
  (``spax/utils.py:26-27``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_factor, cho_solve, solve_triangular

__all__ = [
    "jitter",
    "add_jitter",
    "add_diag_reg",
    "logdet",
    "trace",
    "split_kernel",
    "cholesky",
    "chol_solve",
    "chol_append",
    "chol_logdet",
    "chol_quad_form",
    "solve_psd",
    "inv_psd",
    "pinv_psd_eigh",
    "psd_safety_lift",
    "gp_predict",
    "mvn_logpdf",
]


def jitter(num: int, eps=1e-6, dtype=jnp.float32) -> jax.Array:
    """eps * I (spax/utils.py:26-27)."""
    return eps * jnp.eye(num, dtype=dtype)


def add_jitter(mat: jax.Array, eps=1e-6) -> jax.Array:
    return mat + eps * jnp.eye(mat.shape[-1], dtype=mat.dtype)


def sym_t(k: jax.Array) -> jax.Array:
    """Free layout flip of a (bitwise-)symmetric Gram before factorization.

    XLA lays a matmul-produced Gram out column-major ({0,1}) while its
    blocked Cholesky expansion wants row-major ({1,0}); fusing Gram build
    and factorization into one jit therefore inserts a full-size
    layout-transposing copy between them. ``K.T`` on a symmetric ``K`` is
    mathematically (and — for Grams whose (i, j)/(j, i) entries run the
    same reduction order, e.g. anything built from ``x @ x.T`` — bitwise)
    a no-op that flips the requested layout instead, cancelling the copy.
    Single-device only: under GSPMD a transpose of a 2D-sharded operand
    reshards instead.
    """
    return k.T


def add_diag_reg(mat: jax.Array, diag_reg) -> jax.Array:
    """K + diag_reg * mean(diag(K)) * I — neural_tangents' relative diag_reg."""
    n = mat.shape[-1]
    scale = jnp.trace(mat, axis1=-2, axis2=-1) / n
    return mat + (diag_reg * scale)[..., None, None] * jnp.eye(n, dtype=mat.dtype)


def logdet(mat: jax.Array) -> jax.Array:
    """Summed log-determinant over leading batch dims (spax/utils.py:38-40)."""
    sign, abslogdet = jnp.linalg.slogdet(mat)
    return jnp.sum(sign * abslogdet)


def trace(mat: jax.Array) -> jax.Array:
    """Summed trace over leading batch dims (spax/utils.py:43-44)."""
    return jnp.sum(jnp.trace(mat, axis1=-2, axis2=-1))


def split_kernel(kernel: jax.Array, num_11: int):
    """2x2 block split (spax/utils.py:30-35)."""
    return (kernel[:num_11, :num_11], kernel[:num_11, num_11:],
            kernel[num_11:, :num_11], kernel[num_11:, num_11:])


def cholesky(mat: jax.Array) -> jax.Array:
    return jnp.linalg.cholesky(mat)


def chol_solve(chol: jax.Array, b: jax.Array) -> jax.Array:
    """Solve A x = b given lower Cholesky factor of A."""
    return cho_solve((chol, True), b)


def chol_logdet(chol: jax.Array) -> jax.Array:
    """log det A = 2 sum log diag(L)."""
    diag = jnp.diagonal(chol, axis1=-2, axis2=-1)
    return 2.0 * jnp.sum(jnp.log(diag), axis=-1)


def chol_quad_form(chol: jax.Array, y: jax.Array) -> jax.Array:
    """y^T A^{-1} y via one triangular solve."""
    alpha = solve_triangular(chol, y, lower=True)
    return jnp.sum(alpha * alpha, axis=-1 if y.ndim == 1 else -2)


def chol_append(chol: jax.Array, k_nb: jax.Array, k_bb: jax.Array,
                lower: bool = True) -> jax.Array:
    """Extend a Cholesky factor by m new rows/columns in O(n^2 m).

    Given the factor of ``A`` [n, n] and the blocks of the bordered matrix
    ``[[A, k_nb], [k_nb^T, k_bb]]`` (``k_nb`` [n, m], ``k_bb`` [m, m],
    already regularized), returns the factor of the extended matrix without
    refactorizing the n x n block — the serving-path primitive for growing
    a fitted GP's training set (:meth:`snngp.models.predictor.FittedSPR.extend`).

    ``lower=True`` extends L (A = L L^T); ``lower=False`` extends the UPPER
    factor U (A = U^T U, the orientation
    :func:`snngp.parallel.cholesky.inplace_blocked_cholesky` returns).
    """
    m = k_bb.shape[-1]
    if lower:
        l21 = solve_triangular(chol, k_nb, lower=True).T        # [m, n]
        s = k_bb - l21 @ l21.T
        l22 = jnp.linalg.cholesky(s)
        top = jnp.concatenate(
            [chol, jnp.zeros((chol.shape[0], m), chol.dtype)], axis=1)
        return jnp.concatenate([top, jnp.concatenate([l21, l22], axis=1)])
    u12 = solve_triangular(chol, k_nb, lower=False, trans=1)    # [n, m]
    s = k_bb - u12.T @ u12
    u22 = jnp.linalg.cholesky(s).T                              # upper
    top = jnp.concatenate([chol, u12], axis=1)
    bot = jnp.concatenate(
        [jnp.zeros((m, chol.shape[0]), chol.dtype), u22], axis=1)
    return jnp.concatenate([top, bot])


def solve_psd(mat: jax.Array, b: jax.Array) -> jax.Array:
    """PSD solve A^{-1} b (replacement for inv(A) @ b patterns)."""
    return cho_solve(cho_factor(mat, lower=True), b)


def psd_safety_lift(mat: jax.Array, mult: float = 1.0) -> jax.Array:
    """Stop-gradient diagonal lift that makes a symmetric matrix safely
    factorizable: raises its smallest eigenvalue to
    ``mult * eps_dtype * max_eig`` when it is below that floor; an exact
    no-op otherwise (boost = 0, bit parity with the unguarded path).

    Needed on design-scale inducing/posterior matrices where the deep pooled
    Myrtle kernel saturates correlations to near-rank-1 and fp32 Schur
    complements overshoot into small negative eigenvalues (observed
    min eig -1.1e-4 on the [C, B, B] posterior sampling covariance at
    nd=8192/ni=256 — a plain Cholesky there NaNs the whole ELBO; commit
    34af68c). The boost is ``stop_gradient``-ed: gradients flow
    through the matrix exactly as without the guard, so the eigh appears
    only in the (stable) forward pass.
    """
    ev = jax.lax.stop_gradient(jnp.linalg.eigvalsh(mat))
    lo, hi = ev[..., 0], ev[..., -1]
    floor = mult * jnp.finfo(mat.dtype).eps * hi
    boost = jnp.maximum(floor - lo, 0.0)
    n = mat.shape[-1]
    return mat + boost[..., None, None] * jnp.eye(n, dtype=mat.dtype)


@jax.custom_jvp
def pinv_psd_eigh(mat: jax.Array) -> jax.Array:
    """Indefinite-safe explicit PSD (pseudo-)inverse via eigh.

    neural_tangents' ``gradient_descent_mse_ensemble`` — the reference's
    predict path (``spax/kernels.py:29-32``) — eigendecomposes the
    regularized train Gram, so it stays finite on fp32 Grams whose smallest
    eigenvalue dips below the (trace-relative) regularizer, where a Cholesky
    factorization NaNs every downstream quantity (observed on design-scale
    inducing Grams). Eigenvalues are floored at
    ``max_eig * fp32-eps``: a no-op on well-conditioned input (matches the
    Cholesky inverse to fp32 noise), a bounded pseudo-inverse on
    numerically indefinite input.

    Differentiation uses the matrix-inverse rule ``d(A^-1) = -A^-1 dA A^-1``
    (a custom JVP) instead of differentiating through the eigendecomposition:
    eigh's JVP carries 1/(lambda_i - lambda_j) eigenvector terms that explode
    on the clustered near-zero spectra this function exists to handle.
    Exact wherever the floor is inactive; bounded where it is.
    """
    evals, evecs = jnp.linalg.eigh(mat)
    floor = evals[..., -1:] * jnp.finfo(mat.dtype).eps
    evals = jnp.maximum(evals, floor)
    return (evecs / evals[..., None, :]) @ jnp.swapaxes(evecs, -1, -2)


@pinv_psd_eigh.defjvp
def _pinv_psd_eigh_jvp(primals, tangents):
    (mat,), (dmat,) = primals, tangents
    inv = pinv_psd_eigh(mat)
    return inv, -inv @ dmat @ inv


def inv_psd(mat: jax.Array, chol_fn=None) -> jax.Array:
    """Explicit PSD inverse, for sites where the reference materializes
    ``jnp.linalg.inv`` (spax/models.py:40,68) and the inverse is reused against
    several right-hand sides and inside trace/einsum contractions.

    ``chol_fn`` swaps in a distributed blocked factorization
    (snngp.parallel.cholesky) so the solve scales past one chip's HBM.
    """
    n = mat.shape[-1]
    if chol_fn is not None:
        return cho_solve((chol_fn(mat), True), jnp.eye(n, dtype=mat.dtype))
    return cho_solve(cho_factor(mat, lower=True), jnp.eye(n, dtype=mat.dtype))


def gp_predict(
    kernel_fn,
    x_train: jax.Array,
    y_train: jax.Array,
    x_test: jax.Array,
    diag_reg=1e-6,
    compute_cov: bool = True,
    chol_fn=None,
) -> Tuple[jax.Array, Optional[jax.Array]]:
    """Exact NNGP posterior: mean = K*^T (K + r I)^-1 y, cov = K** - K*^T (K + r I)^-1 K*.

    Drop-in for ``neural_tangents.predict.gradient_descent_mse_ensemble(...)(
    x_test, get="nngp", compute_cov=True)`` as used at ``spax/kernels.py:29-32``
    and ``experiments/regression/find.py:73-78``, including the trace-relative
    ``diag_reg`` scaling. ``chol_fn`` swaps in a distributed blocked
    factorization of the N×N train Gram (snngp.parallel.cholesky) so the
    predictive scales past one chip's HBM.
    """
    k_dd = kernel_fn(x_train, x_train, get="nngp")
    k_td = kernel_fn(x_test, x_train, get="nngp")
    chol = (chol_fn or jnp.linalg.cholesky)(add_diag_reg(k_dd, diag_reg))
    mean = k_td @ chol_solve(chol, y_train)
    if not compute_cov:
        return mean, None
    k_tt = kernel_fn(x_test, x_test, get="nngp")
    v = solve_triangular(chol, k_td.T, lower=True)
    cov = k_tt - v.T @ v
    return mean, cov


def mvn_logpdf(y: jax.Array, cov: jax.Array, chol_fn=None) -> jax.Array:
    """Zero-mean multivariate normal log-density via one Cholesky.

    Fused replacement for ``jax.scipy.stats.multivariate_normal.logpdf``
    (``spax/likelihoods.py:25-28``): logdet from the factor diagonal and the
    quadratic form from one triangular solve. ``chol_fn`` swaps in a
    distributed factorization (snngp.parallel.cholesky) on a mesh.
    """
    n = y.shape[-1]
    chol = (chol_fn or jnp.linalg.cholesky)(cov)
    quad = chol_quad_form(chol, y)
    return -0.5 * (quad + chol_logdet(chol) + n * jnp.log(2.0 * jnp.pi))
