"""Scale-mixture process models (rebuilds ``spax/models.py``).

- :class:`SVSP` — Sparse Variational Stochastic Process: inducing-point
  variational classification; Gaussian prior -> SVGP, InverseGamma prior ->
  SVTP (``spax/models.py:15-78``).
- :class:`SPR` — Stochastic Process Regression: exact-inference regression;
  Gaussian likelihood -> GP, Student-t likelihood -> TP
  (``spax/models.py:81-120``).

Models are static configs; parameters are nested dicts threaded through pure
methods (jit/grad-friendly). Kernel Gram blocks are evaluated once per step
and shared between the inducing solve and the posterior predictive (the
reference recomputes them inside ``kernel.predict``; the matrices are
identical, so numerics are preserved while halving Gram cost).
"""

from __future__ import annotations

from typing import Dict

import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from snngp.models import params as P
from snngp.models.bijectors import positive
from snngp.ops import log_likelihood, test_log_likelihood, get_correct_count
from snngp.ops.linalg import (add_diag_reg, add_jitter, inv_psd,
                              pinv_psd_eigh, psd_safety_lift)

__all__ = ["SVSP", "SPR"]


class SVSP:
    """Sparse variational stochastic process classifier (spax/models.py:15-78)."""

    def __init__(self, prior, kernel, inducing_variable, *, num_latent_gps: int = 1,
                 eps: float = 1e-6, chol_fn=None, mesh=None, chol_block: int = 512):
        self.prior = prior
        self.kernel = kernel
        self.num_latent_gps = num_latent_gps
        self._inducing_init = jnp.asarray(inducing_variable, dtype=jnp.float32)
        self.num_inducing = self._inducing_init.shape[0]
        self._eps_init = eps
        self.bij = positive()
        # Distributed factorization hook (SURVEY.md D3): all inducing-matrix
        # solves in _posterior_pieces route through chol_fn when set.
        if chol_fn is None and mesh is not None:
            from functools import partial as _partial
            from snngp.parallel.cholesky import blocked_cholesky
            chol_fn = _partial(blocked_cholesky, block=chol_block)
        self.chol_fn = chol_fn

    def init_params(self) -> Dict:
        return {
            "kernel": self.kernel.init_params(),
            "prior": self.prior.init_params(),
            "inducing_variable": self._inducing_init,
            "q_mu": jnp.zeros((self.num_latent_gps, self.num_inducing), jnp.float32),
            "q_sqrt": P.constrained_init(
                jnp.ones((self.num_latent_gps, self.num_inducing), jnp.float32), self.bij),
            "eps": P.constrained_init(self._eps_init, self.bij),
        }

    def _posterior_pieces(self, params, x_batch):
        """Shared Gram + solve plumbing for loss/test paths.

        Returns (A_B [B,I], B_B [B,B] posterior cov, k_rel_inv, k_bi, k_ii,
        k_ii_inv, q_mu, q_sqrt) where A_B = k_bi (k_ii + eps I)^{-1}
        (absolute-eps jitter, spax/models.py:40) and
        B_B = k_bb - k_bi (k_ii + r I)^{-1} k_ib with nt-relative r
        (spax/models.py:43 via kernel.predict).

        The relative-reg solve is eigh-based: neural_tangents'
        ``gradient_descent_mse_ensemble`` (the reference's predict path)
        eigendecomposes the regularized train Gram, so it stays finite on
        fp32 Grams whose smallest eigenvalue dips below -r (where a Cholesky
        factorization NaNs the whole batch — observed on the design-scale
        synthetic pool). Eigenvalues are floored at
        max_eig * fp32-eps: a no-op on well-conditioned Grams, a bounded
        pseudo-inverse on numerically indefinite ones. When a distributed
        ``chol_fn`` is installed the factorization path is kept (eigh does
        not shard; inducing Grams at that scale are assembled sharded).
        """
        z = params["inducing_variable"]
        eps = P.constrained_read(params["eps"], self.bij)
        q_mu = params["q_mu"]
        q_sqrt = P.constrained_read(params["q_sqrt"], self.bij)
        kernel_fn = self.kernel.get_kernel_fn(params["kernel"])

        k_bi = self.kernel.K(kernel_fn, x_batch, z)          # [B, I]
        k_ii = self.kernel.K(kernel_fn, z)                   # [I, I]
        k_bb = self.kernel.K(kernel_fn, x_batch)             # [B, B]

        # psd_safety_lift: no-op while (k_ii + eps I) is numerically PD (the
        # reference's exact path, spax/models.py:40); a stop-gradient
        # diagonal lift when a training step drags the fp32 min eigenvalue
        # below -eps, where the factorization would NaN the whole ELBO
        # (observed at nd=8192/ni=256 design scale).
        k_ii_inv = inv_psd(psd_safety_lift(add_jitter(k_ii, eps)),
                           chol_fn=self.chol_fn)                 # [I, I]
        a_b = k_bi @ k_ii_inv                                # [B, I]

        if self.chol_fn is not None:
            chol_rel = self.chol_fn(add_diag_reg(k_ii, eps))
            v = solve_triangular(chol_rel, jnp.eye(k_ii.shape[0],
                                                   dtype=k_ii.dtype),
                                 lower=True)                 # [I, I]
            k_rel_inv = v.T @ v
        else:
            k_rel_inv = pinv_psd_eigh(add_diag_reg(k_ii, eps))  # [I, I]
        b_b = k_bb - k_bi @ k_rel_inv @ k_bi.T               # [B, B]
        return a_b, b_b, k_rel_inv, k_bi, k_ii, k_ii_inv, q_mu, q_sqrt

    def loss(self, params, key, x_batch, y_batch, num_train, num_samples, aux=False):
        """Negative ELBO per data point (spax/models.py:30-56)."""
        a_b, b_b, _, _, k_ii, k_ii_inv, q_mu, q_sqrt = \
            self._posterior_pieces(params, x_batch)

        mean = q_mu @ a_b.T                                   # [C, B]
        # A_B diag(q_sqrt) A_B^T + B_B, batched over classes.
        cov = jnp.einsum("ij,cj,kj->cik", a_b, q_sqrt, a_b) + b_b[None, :, :]
        # The sampler Cholesky-factorizes cov (spax/priors.py:22-26); at
        # design scale the fp32 Schur complement inside b_b overshoots to
        # min eig ~ -1e-4 on the near-rank-1 Myrtle Gram and the factor NaNs
        # the ELBO. The lift raises the spectrum floor to B*eps_f32*max_eig
        # (~1e-4 relative — statistically invisible against unit-scale
        # posterior variances) and is stop-gradient: pathwise sampling
        # gradients are untouched.
        cov = psd_safety_lift(cov, mult=cov.shape[-1])
        sampled_f = self.prior.sample_f(params["prior"], key, mean, cov, num_samples)

        ll = log_likelihood(sampled_f, y_batch)
        kl = self.prior.kl_divergence(
            params["prior"], k_ii, k_ii_inv, q_mu, q_sqrt,
            self.num_inducing, self.num_latent_gps)
        n_elbo = -ll + kl / num_train
        if aux:
            return n_elbo, (-ll, kl / num_train)
        return n_elbo

    def test_acc_nll(self, params, key, x_batch, y_batch, num_samples):
        """MC predictive NLL + correct count (spax/models.py:58-78)."""
        a_b, b_b, k_rel_inv, k_bi, _, _, q_mu, q_sqrt = \
            self._posterior_pieces(params, x_batch)

        # Posterior mean with q_mu as targets through the nt-relative solve
        # (spax/models.py:71: kernel.predict(Z, q_mu.T, x_batch)); k_bi is
        # reused from _posterior_pieces (the docstring's "evaluated once").
        mean = (k_bi @ (k_rel_inv @ q_mu.T)).T                   # [C, B]

        test_cov = jnp.einsum("ij,cj,kj->cik", a_b, q_sqrt, a_b) + b_b[None, :, :]
        sampled_f = self.prior.sample_f_iid(params["prior"], key, mean, test_cov, num_samples)

        nll = -test_log_likelihood(sampled_f, y_batch)
        correct_count = get_correct_count(sampled_f, y_batch)
        return nll, correct_count


class SPR:
    """Exact-inference stochastic process regression (spax/models.py:81-120)."""

    def __init__(self, kernel, likelihood, x_data, y_data, y_mean, y_std, *,
                 eps: float = 1e-6, mesh=None, chol_block: int = 512):
        self.kernel = kernel
        self.likelihood = likelihood
        self.x_data = jnp.asarray(x_data)
        self.y_data = jnp.asarray(y_data)
        self.y_mean = y_mean
        self.y_std = y_std
        self.num_data = self.x_data.shape[0]
        self._eps_init = eps
        self.bij = positive()
        # Distributed execution (SURVEY.md D1-D3): row-sharded Gram over the
        # mesh + blocked distributed Cholesky inside the marginal likelihood.
        self.mesh = mesh
        if mesh is not None:
            from functools import partial as _partial
            from snngp.parallel.cholesky import blocked_cholesky
            if getattr(self.likelihood, "chol_fn", None) is None:
                self.likelihood.chol_fn = _partial(blocked_cholesky,
                                                   block=chol_block)
        # The predictive path (test_nll -> kernel.predict -> gp_predict)
        # factors the same N×N train Gram; route it through the same
        # distributed factorization so prediction scales with the mesh too.
        self.chol_fn = getattr(self.likelihood, "chol_fn", None)

    def init_params(self) -> Dict:
        p = {
            "kernel": self.kernel.init_params(),
            "likelihood": self.likelihood.init_params(),
            "eps": P.constrained_init(self._eps_init, self.bij),
        }
        return p

    def _gram(self, kernel_fn):
        """Full training Gram; row-sharded over the mesh when configured.

        When ``num_data`` is not a multiple of the mesh size the rows are
        zero-padded to the next multiple and the Gram sliced back — the mesh
        path never silently degrades to a single-device Gram (which would
        reintroduce the reference's OOM-bound monolithic build,
        spax/kernels.py:23-27, exactly at the scale the mesh exists for).
        """
        if self.mesh is not None:
            from snngp.parallel.gram import sharded_gram
            n = self.num_data
            pad = (-n) % self.mesh.size
            if pad:
                x = jnp.pad(self.x_data,
                            ((0, pad),) + ((0, 0),) * (self.x_data.ndim - 1))
                return sharded_gram(kernel_fn, x, self.mesh)[:n, :n]
            return sharded_gram(kernel_fn, self.x_data, self.mesh)
        return self.kernel.K(kernel_fn, self.x_data)

    def loss(self, params):
        """Negative marginal log-likelihood / N (spax/models.py:93-98)."""
        eps = P.constrained_read(params["eps"], self.bij)
        kernel_fn = self.kernel.get_kernel_fn(params["kernel"])
        cov = self._gram(kernel_fn) + eps * jnp.eye(self.num_data)
        log_prob = self.likelihood.prior_logpdf(params["likelihood"], self.y_data, cov)
        return -log_prob / self.num_data

    def test_nll(self, params, x, y):
        """Predictive NLL on de-normalized targets (spax/models.py:100-120)."""
        eps = P.constrained_read(params["eps"], self.bij)
        kernel_fn = self.kernel.get_kernel_fn(params["kernel"])
        mean, cov = self.kernel.predict(
            kernel_fn, self.x_data, self.y_data[:, None], x, eps=eps,
            chol_fn=self.chol_fn)

        require = self.likelihood.require
        if require:
            cov_data = self.kernel.K(kernel_fn, self.x_data)
            aux_dict = dict(cov_data=cov_data, y_data=self.y_data)
            aux = tuple(aux_dict[k] for k in require)
        else:
            aux = None

        log_prob = self.likelihood.logpdf(
            params["likelihood"],
            (y * self.y_std) + self.y_mean,
            (mean.flatten() * self.y_std) + self.y_mean,
            cov * self.y_std ** 2,
            aux,
        )
        return -jnp.mean(log_prob)
