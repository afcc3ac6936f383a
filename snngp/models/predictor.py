"""Fitted-state predictor: factorize once, predict many times (serving path).

The reference evaluates its exact models by rebuilding the train Gram and
re-solving (K + eps I) on *every* call (``spax/models.py:100-120`` via
``spax/kernels.py:29-32``, which re-runs ``gradient_descent_mse_ensemble``
per test batch) — O(N^2 kernel + N^3 solve) per prediction request. For
production serving that is the wrong shape: the train-side state (Gram
factorization, solve against the targets, the Student-t data-dependent scale)
is fixed once hyperparameters are fixed.

:func:`fit_spr` runs the expensive train-side work once and returns a
:class:`FittedSPR` whose ``predict``/``test_nll`` cost only the cross-Gram
plus triangular solves — O(N * n) per request, no re-factorization. The
fitted state is a flat dict of arrays, so it jit-threads, shards, and
round-trips through ``save``/``load`` (plain ``.npz``).

Numerical contract: ``FittedSPR.test_nll`` equals ``SPR.test_nll`` (same
params, same inputs) to float32 resolution — the same Cholesky-everything
primitives are used, just hoisted out of the per-request path
(tests/test_predictor.py pins this).
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy import stats
from jax.scipy.linalg import solve_triangular

from snngp.models import params as P
from snngp.ops import get_correct_count, test_log_likelihood
from snngp.ops.linalg import (add_diag_reg, add_jitter, chol_append,
                              chol_quad_form, chol_solve, inv_psd,
                              pinv_psd_eigh)

__all__ = ["fit_spr", "FittedSPR", "fit_svsp", "FittedSVSP"]


def fit_spr(model, params, memory_lean: bool = False,
            extendable: bool = False, gram=None, var_floor: float = 0.0,
            t_jitter: float = 1e-6) -> "FittedSPR":
    """One-time train-side solve for an :class:`snngp.models.gp.SPR`.

    Computes the train Gram (row-sharded over the model's mesh when one is
    configured), its regularized Cholesky factor, the target solve, and —
    for a Student-t likelihood — the conditional-t degrees of freedom and
    data-dependent scale ``d`` (``spax/likelihoods.py:52-65``), which depend
    only on train data. Uses the model's ``chol_fn`` (distributed blocked
    factorization on a mesh) for every factorization.

    ``memory_lean=True`` targets single-device Grams too big for the
    default path's working set (which holds K plus up to two factors —
    3 n^2; at N = 50k that is 30 GB).
    The Gram is staged once to host RAM, and each factorization runs
    through :func:`snngp.parallel.cholesky.inplace_blocked_cholesky`
    (donated buffer, ~n^2 + panels peak), re-uploading K between the
    Student-t and main factorizations so only ONE full-size device buffer
    ever exists. The fitted state then carries the UPPER factor
    (``chol_lower = 0``) and every solve in :class:`FittedSPR` branches
    accordingly. Same numerics as the default path (tested to fp32
    resolution); costs two extra host<->device transfers of K.

    ``extendable=True`` caches what :meth:`FittedSPR.extend` needs to grow
    the training set incrementally in O(N^2 m): the absolute regularizer
    actually applied (the nt-relative value is resolved at fit time and
    FROZEN — later extensions reuse it rather than re-deriving it from the
    drifting mean diagonal) and, for a Student-t likelihood, the scaled-Gram
    factor (an extra [N, N] — the price of extending the data-dependent
    ``d``). Not supported together with ``memory_lean``. Size ceiling: an
    extendable Student-t fit keeps TWO resident [N, N] factors (main +
    scaled-Gram) plus the Gram during fitting — ~3 n^2 fp32. Past what the
    device holds, refit with ``memory_lean=True`` (extension at
    memory-lean scale means a fresh fit over the grown set).

    ``gram`` optionally supplies a precomputed train Gram (host numpy — e.g.
    a crash-resumable :func:`snngp.nn.full.tiled_gram` memmap — or a device
    array); the kernel is then never evaluated for the
    train block. It must equal ``K(x_data, x_data)`` for the SAME params, at
    fp32: the fitted state stores solved quantities, not the inputs, so a
    mismatched Gram yields silently wrong predictions.

    ``var_floor`` (relative to the PRIOR test variance) clips the posterior
    variance diagonal at predict time: ``var = max(var, var_floor *
    diag(k_tt))``. Default 0.0 keeps the reference's exact arithmetic. At
    north-star N the fp32 posterior variance (~1e-7 of a ~0.027-scale prior)
    sits below the cancellation noise of the [N]-long contraction and can go
    (slightly) negative — an indefinite full covariance was observed at
    N=32768 — so large-N pipelines pass ~1e-6.

    ``t_jitter`` is the absolute jitter on the scaled Gram ``(b/a) K`` whose
    factor defines the Student-t data scale ``d`` (the reference hardcodes
    1e-6, ``spax/likelihoods.py:60-62``). At reference scale leave it; at
    north-star N the Gram's own fp32 representation noise exceeds 1e-6 and
    the factorization needs a proportionally larger value to stay PSD.
    """
    if extendable and memory_lean:
        raise ValueError("extendable fits keep extra factors resident; "
                         "memory_lean exists to avoid exactly that — "
                         "pick one")
    eps = P.constrained_read(params["eps"], model.bij)
    kernel_fn = model.kernel.get_kernel_fn(params["kernel"])
    lik_params = params["likelihood"]
    require = model.likelihood.require

    if memory_lean:
        # Every solve against the full-size factor goes through the panel
        # solve: XLA's monolithic triangular_solve expander needs ~3x the
        # factor in HLO temps (a masked full-size copy + staggered scan
        # buffers — measured 12 GB at N=32768) and OOMs exactly the Grams
        # this path exists for.
        from snngp.parallel.cholesky import (blocked_triangular_solve,
                                             inplace_blocked_cholesky)

        state = {
            "y_mean": jnp.asarray(model.y_mean, jnp.float32),
            "y_std": jnp.asarray(model.y_std, jnp.float32),
            "chol_lower": jnp.asarray(0, jnp.int32),
        }
        if var_floor:
            state["var_floor"] = jnp.asarray(var_floor, jnp.float32)
        if require:  # Student-t path: two factorizations of the same Gram —
            # stage it to host once, re-upload between them, so only ONE
            # full-size device buffer ever exists.
            k_host = (np.asarray(gram) if gram is not None
                      else np.asarray(model._gram(kernel_fn)))
            a, b = model.likelihood._ab(lik_params)
            df = 2.0 * a
            scale = float(b / a)
            u_t = jax.jit(
                lambda k: inplace_blocked_cholesky(
                    add_jitter(scale * k, t_jitter)),
                donate_argnums=0)(jnp.asarray(k_host))
            at = blocked_triangular_solve(u_t, model.y_data, trans=True)
            state["d"] = df + jnp.sum(at * at)
            state["d"].block_until_ready()
            del u_t, at
            state["cond_df"] = df + model.num_data
            state["scale_ba"] = b / a
            k_dev = jnp.asarray(k_host)
        else:
            # One factorization: donate the device Gram directly — no
            # host round-trip needed (same ~n^2 peak).
            k_dev = (jnp.asarray(gram) if gram is not None
                     else model._gram(kernel_fn))
        u = jax.jit(
            lambda k: inplace_blocked_cholesky(add_diag_reg(k, eps)),
            donate_argnums=0)(k_dev)
        state["chol"] = u
        # K^{-1} y with K = U^T U: back-to-back transposed/plain upper solves.
        z = blocked_triangular_solve(u, model.y_data[:, None], trans=True)
        state["alpha"] = blocked_triangular_solve(u, z, trans=False)
        return FittedSPR(model, params, state)

    chol_fn = model.chol_fn or jnp.linalg.cholesky

    k_dd = jnp.asarray(gram) if gram is not None else model._gram(kernel_fn)
    chol = chol_fn(add_diag_reg(k_dd, eps))                     # [N, N]
    alpha = chol_solve(chol, model.y_data[:, None])             # [N, 1]

    state = {
        "chol": chol,
        "alpha": alpha,
        "y_mean": jnp.asarray(model.y_mean, jnp.float32),
        "y_std": jnp.asarray(model.y_std, jnp.float32),
    }
    if var_floor:
        state["var_floor"] = jnp.asarray(var_floor, jnp.float32)
    if extendable:  # freeze the absolute regularizer add_diag_reg applied
        state["reg"] = eps * jnp.trace(k_dd) / model.num_data

    if require:  # Student-t conditional predictive
        a, b = model.likelihood._ab(lik_params)
        df = 2.0 * a
        chol_t = chol_fn(add_jitter((b / a) * k_dd, t_jitter))
        state["d"] = df + chol_quad_form(chol_t, model.y_data)
        state["cond_df"] = df + model.num_data
        state["scale_ba"] = b / a
        if extendable:
            state["chol_t"] = chol_t

    return FittedSPR(model, params, state)


class FittedSPR:
    """Cheap repeated prediction from a one-time :func:`fit_spr` solve."""

    def __init__(self, model, params, state: Dict):
        self.model = model
        self.params = params
        self.state = state
        self._kernel_fn = model.kernel.get_kernel_fn(params["kernel"])
        self._student_t = "d" in state
        # Factor orientation is static fit-time config: resolve it ONCE here
        # (np scalar, no per-call device sync) so predict paths stay
        # jit-threadable over the array-valued state.
        cl = state.get("chol_lower")
        self._chol_lower = True if cl is None else bool(np.asarray(cl))
        self._var_floor = float(np.asarray(state.get("var_floor", 0.0)))

    # -- prediction -------------------------------------------------------

    def predict(self, x, batch: int = None):
        """De-normalized predictive mean and variance at ``x`` ([n], [n]).

        mean = K*^T (K + r I)^{-1} y via the cached solve; the variance is
        the posterior diagonal (both likelihoods' predictive densities use
        only ``diag(cov)``, ``spax/likelihoods.py:30-33,52-65``), inflated by
        the cached Student-t factor when applicable.

        ``batch`` chunks the test points: the posterior needs only the
        variance DIAGONAL, but the cancellation-safe ordering materializes a
        [c, c] test Gram per chunk — unchunked, serving n points costs
        O(n^2) kernel work for n numbers. Each diagonal element is computed
        by the same arithmetic either way (its column's solve and its own
        Gram entry), so chunked == unchunked to fp32 resolution; ~4096 keeps
        the chunk Gram at 64 MB. Don't pass ``batch`` inside jit (it's a
        Python loop).
        """
        mean_n, var_n = self._posterior(x, batch=batch)
        return self._denorm(mean_n, var_n)

    def test_nll(self, x, y, batch: int = None):
        """Predictive NLL on de-normalized targets; equals SPR.test_nll.
        ``batch`` as in :meth:`predict`."""
        mean_n, var_n = self._posterior(x, batch=batch)
        return self._score_nll(mean_n, var_n, y)

    def predict_given(self, k_td, k_tt_diag):
        """:meth:`predict` from precomputed Gram pieces: ``k_td`` [n, N] is
        K(x_test, x_train), ``k_tt_diag`` [n] the prior test variance —
        for pipelines that assemble Grams outside the kernel-fn path (the
        tiled Myrtle assembly, ``examples/cifar_myrtle.py``).

        Variance ordering caveat: with only the diagonal supplied this uses
        the streaming form ``k_tt_diag - sum(v*v)`` rather than
        ``diag(k_tt - v^T v)``; the two differ by fp32 cancellation noise
        (~1e-3 relative when the posterior variance is tiny) — pair with a
        ``var_floor`` at scale.
        """
        mean_n, var_n = self._posterior_given(k_td, k_tt_diag)
        return self._denorm(mean_n, var_n)

    def test_nll_given(self, k_td, k_tt_diag, y):
        """:meth:`test_nll` from precomputed Gram pieces (see
        :meth:`predict_given`); ``y`` is normalized like ``test_nll``'s."""
        mean_n, var_n = self._posterior_given(k_td, k_tt_diag)
        return self._score_nll(mean_n, var_n, y)

    def _denorm(self, mean_n, var_n):
        s = self.state
        mean = mean_n * s["y_std"] + s["y_mean"]
        var = var_n * s["y_std"] ** 2
        if self._student_t:
            var = (s["d"] / s["cond_df"]) * s["scale_ba"] * var
        return mean, var

    def _score_nll(self, mean_n, var_n, y):
        s = self.state
        y_den = y * s["y_std"] + s["y_mean"]
        mean = mean_n * s["y_std"] + s["y_mean"]
        var = var_n * s["y_std"] ** 2
        if self._student_t:
            sigma = jnp.sqrt((s["d"] / s["cond_df"]) * s["scale_ba"] * var)
            log_prob = stats.t.logpdf(y_den, s["cond_df"], mean, sigma)
        else:
            log_prob = stats.norm.logpdf(y_den, mean, jnp.sqrt(var))
        return -jnp.mean(log_prob)

    def extend(self, x_new, y_new) -> "FittedSPR":
        """New fitted predictor with ``m`` extra training points, without
        refactorizing: the cached factor grows by a bordered-block update
        (:func:`snngp.ops.linalg.chol_append`, O(N^2 m) vs the O((N+m)^3)
        refit), the target solve is redone against the new factor (two
        O(N^2) triangular solves), and the Student-t data-dependent scale
        ``d`` is recomputed from the extended scaled-Gram factor.

        Requires ``fit_spr(..., extendable=True)``. ``y_new`` is raw-scale;
        it is normalized with the FIT-TIME mean/std (extension grows the
        conditioning set — it does not re-standardize). The frozen fit-time
        regularizer is applied to the new diagonal block, so an extended
        predictor equals a direct factorization of the same bordered matrix
        to fp32 resolution (tests/test_predictor.py pins this).
        """
        s = self.state
        if "reg" not in s:
            raise ValueError("extend() needs fit_spr(..., extendable=True)")
        from snngp.models.gp import SPR

        model = self.model
        x_new = jnp.asarray(x_new)
        m = x_new.shape[0]
        y_n = (jnp.asarray(y_new).reshape(-1) - s["y_mean"]) / s["y_std"]

        k_nb = model.kernel.K(self._kernel_fn, model.x_data, x_new)  # [N, m]
        k_bb = model.kernel.K(self._kernel_fn, x_new)                # [m, m]
        eye_m = jnp.eye(m, dtype=k_bb.dtype)
        chol = chol_append(s["chol"], k_nb, k_bb + s["reg"] * eye_m,
                           lower=self._chol_lower)

        x_all = jnp.concatenate([model.x_data, x_new])
        y_all = jnp.concatenate([model.y_data, y_n])
        new_model = SPR(model.kernel, model.likelihood, x_all, y_all,
                        model.y_mean, model.y_std, eps=model._eps_init,
                        mesh=model.mesh)

        state = {
            "chol": chol,
            "alpha": chol_solve(chol, y_all[:, None]) if self._chol_lower
            else solve_triangular(
                chol, solve_triangular(chol, y_all[:, None], lower=False,
                                       trans=1), lower=False),
            "y_mean": s["y_mean"],
            "y_std": s["y_std"],
            "reg": s["reg"],
        }
        if "chol_lower" in s:
            state["chol_lower"] = s["chol_lower"]
        if self._student_t:
            ba = s["scale_ba"]
            chol_t = chol_append(s["chol_t"], ba * k_nb,
                                 ba * k_bb + 1e-6 * eye_m,
                                 lower=self._chol_lower)
            df = s["cond_df"] - model.num_data
            state["chol_t"] = chol_t
            # Quad form against the factor's actual orientation: lower L
            # (A = L L^T) -> ||L^{-1} y||^2; upper U (A = U^T U) ->
            # ||U^{-T} y||^2 (chol_quad_form assumes lower).
            if self._chol_lower:
                quad_t = chol_quad_form(chol_t, y_all)
            else:
                at = solve_triangular(chol_t, y_all, lower=False, trans=1)
                quad_t = jnp.sum(at * at)
            state["d"] = df + quad_t
            state["cond_df"] = df + new_model.num_data
            state["scale_ba"] = ba
        return FittedSPR(new_model, self.params, state)

    def _posterior(self, x, batch: int = None):
        """Normalized posterior mean + variance diagonal ([n], [n]).

        The variance is diag(k_tt - v^T v) — the full-covariance form
        ``gp_predict`` uses — NOT the cheaper diag(k_tt) - sum(v*v): when the
        posterior variance is tiny the subtraction cancels catastrophically
        in fp32 and the two orderings diverge at ~1e-3 relative, breaking
        parity with ``SPR.test_nll``.
        """
        if batch is not None and x.shape[0] > batch:
            parts = [self._posterior(x[i:i + batch])
                     for i in range(0, x.shape[0], batch)]
            return (jnp.concatenate([p[0] for p in parts]),
                    jnp.concatenate([p[1] for p in parts]))
        model, s = self.model, self.state
        k_td = model.kernel.K(self._kernel_fn, x, model.x_data)  # [n, N]
        mean = (k_td @ s["alpha"]).flatten()
        v = self._whiten(k_td)                                   # [N, n]
        k_tt = model.kernel.K(self._kernel_fn, x)                # [n, n]
        var = jnp.diag(k_tt - v.T @ v)
        if self._var_floor:
            var = jnp.maximum(var, self._var_floor * jnp.diag(k_tt))
        return mean, var

    def _posterior_given(self, k_td, k_tt_diag):
        """As :meth:`_posterior` from precomputed (k_td, diag(k_tt)); uses
        the streaming variance ordering (see :meth:`predict_given`)."""
        s = self.state
        mean = (k_td @ s["alpha"]).flatten()
        v = self._whiten(k_td)                                   # [N, n]
        var = k_tt_diag - jnp.sum(v * v, axis=0)
        if self._var_floor:
            var = jnp.maximum(var, self._var_floor * k_tt_diag)
        return mean, var

    def _whiten(self, k_td):
        """L^{-1} K* for the cached factor's orientation ([N, n])."""
        s = self.state
        if self._chol_lower:
            return solve_triangular(s["chol"], k_td.T, lower=True)
        # memory-lean fit stores the UPPER factor U = L^T; L^{-1} x is
        # the transposed upper solve, via the panel solve so serving a
        # north-star-size fit never materializes a factor copy.
        from snngp.parallel.cholesky import blocked_triangular_solve
        return blocked_triangular_solve(s["chol"], k_td.T, trans=True)

    # -- persistence ------------------------------------------------------

    def save(self, path):
        """Write the fitted state to ``path`` (.npz); params travel too."""
        flat = dict(self.state)
        for name, leaf in P.named_leaves(self.params):
            flat["param:" + name] = leaf
        np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})

    @classmethod
    def load(cls, path, model):
        """Rebuild from :meth:`save` output plus the (static-config) model."""
        params, state = _load_split(path)
        return cls(model, params, state)


def fit_svsp(model, params) -> "FittedSVSP":
    """One-time inducing-side solve for an :class:`snngp.models.gp.SVSP`.

    ``SVSP.test_acc_nll`` re-factorizes the I x I inducing Gram twice per
    evaluation batch (``spax/models.py:58-78`` via ``_posterior_pieces``).
    Once training is done, the inducing inputs, both factorizations, the
    explicit inverse, and the ``q_mu`` solve are all fixed — hoist them, so
    a serving request costs only the [B, I]/[B, B] cross-Grams plus one
    triangular solve.
    """
    z = params["inducing_variable"]
    eps = P.constrained_read(params["eps"], model.bij)
    q_sqrt = P.constrained_read(params["q_sqrt"], model.bij)
    kernel_fn = model.kernel.get_kernel_fn(params["kernel"])

    k_ii = model.kernel.K(kernel_fn, z)
    # Indefinite-safe relative-reg inverse (matches SVSP._posterior_pieces:
    # eigh-based like nt's predict path; Cholesky NaNs on fp32 Grams whose
    # min eigenvalue dips below the relative regularizer). A distributed
    # chol_fn keeps the factorization path.
    if model.chol_fn is not None:
        chol_rel = model.chol_fn(add_diag_reg(k_ii, eps))        # [I, I]
        v = solve_triangular(chol_rel, jnp.eye(k_ii.shape[0], dtype=k_ii.dtype),
                             lower=True)
        k_rel_inv = v.T @ v
    else:
        k_rel_inv = pinv_psd_eigh(add_diag_reg(k_ii, eps))       # [I, I]
    state = {
        "z": z,
        "k_ii_inv": inv_psd(add_jitter(k_ii, eps), chol_fn=model.chol_fn),
        "k_rel_inv": k_rel_inv,
        "w": k_rel_inv @ params["q_mu"].T,                       # [I, C]
        "q_sqrt": q_sqrt,
    }
    return FittedSVSP(model, params, state)


class FittedSVSP:
    """Cheap repeated classification from a one-time :func:`fit_svsp` solve."""

    def __init__(self, model, params, state: Dict):
        self.model = model
        self.params = params
        self.state = state
        self._kernel_fn = model.kernel.get_kernel_fn(params["kernel"])

    def predict_f(self, x):
        """Latent posterior at ``x``: mean [C, B] and covariance [C, B, B]
        (identical matrices to ``SVSP.test_acc_nll``'s internals)."""
        model, s = self.model, self.state
        k_bi = model.kernel.K(self._kernel_fn, x, s["z"])        # [B, I]
        k_bb = model.kernel.K(self._kernel_fn, x)                # [B, B]
        a_b = k_bi @ s["k_ii_inv"]                               # [B, I]
        mean = (k_bi @ s["w"]).T                                 # [C, B]
        b_b = k_bb - k_bi @ s["k_rel_inv"] @ k_bi.T
        cov = jnp.einsum("ij,cj,kj->cik", a_b, s["q_sqrt"], a_b) + b_b[None]
        return mean, cov

    def predict_proba(self, key, x, num_samples=1000):
        """Mean MC predictive class probabilities [B, C] (rows sum to 1)."""
        from jax.nn import log_softmax, logsumexp
        mean, cov = self.predict_f(x)
        f = self.model.prior.sample_f_iid(
            self.params["prior"], key, mean, cov, num_samples)   # [C, B, S]
        log_pbar = logsumexp(log_softmax(f, axis=0), axis=2) - jnp.log(num_samples)
        return jnp.exp(log_pbar).T

    def test_acc_nll(self, key, x, y, num_samples=1000):
        """MC predictive NLL + correct count; equals ``SVSP.test_acc_nll``
        (same key, same sample count)."""
        mean, cov = self.predict_f(x)
        f = self.model.prior.sample_f_iid(
            self.params["prior"], key, mean, cov, num_samples)
        return -test_log_likelihood(f, y), get_correct_count(f, y)

    def save(self, path):
        flat = dict(self.state)
        for name, leaf in P.named_leaves(self.params):
            flat["param:" + name] = leaf
        np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})

    @classmethod
    def load(cls, path, model):
        params, state = _load_split(path)
        if "k_rel_inv" not in state and "chol_rel" in state:
            # Back-compat with pre-round-5 saves (Cholesky-factor state):
            # reconstruct the explicit inverse and the q_mu solve.
            chol_rel = state.pop("chol_rel")
            v = solve_triangular(chol_rel,
                                 jnp.eye(chol_rel.shape[0], dtype=chol_rel.dtype),
                                 lower=True)
            state["k_rel_inv"] = v.T @ v
            state["w"] = state["k_rel_inv"] @ params["q_mu"].T
        return cls(model, params, state)


def _load_split(path):
    """Split a saved fitted-state .npz back into (params, state)."""
    with np.load(path) as data:
        state = {k: jnp.asarray(data[k]) for k in data.files
                 if not k.startswith("param:")}
        saved = {k[len("param:"):]: jnp.asarray(data[k])
                 for k in data.files if k.startswith("param:")}
    return P.unflatten_named(saved), state
