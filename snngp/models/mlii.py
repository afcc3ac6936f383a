"""Full-Gram ML-II: exact marginal-likelihood gradients over a tiled Gram.

The reference trains kernel scales by full-batch gradient ML-II — jax.grad
through Gram build + factorization in one differentiable computation
(``experiments/regression/train.py:61-67``) — which caps N at whatever a
single reverse-mode factorization fits in memory. At larger N the Gram is
assembled in [block, block] tiles (:func:`snngp.nn.full.tiled_gram`) and
factored by the donated in-place kernel — no reverse-mode path exists
through either. This module computes the SAME gradient in closed form:

    dL/dtheta = <G, dK/dtheta>,    G = dL/dK

where L is the exact per-datapoint marginal NLL of :meth:`SPR.loss`
(``snngp/models/gp.py``) with S = K + eps I (absolute eps, matching the
loss), and

    Gaussian   (mvn_logpdf):  G = (1/2N) (S^{-1} - alpha alpha^T)
    Student-t  (mvt, shape (b/a) S, df = 2a):
               G = (1/2N) S^{-1} - kappa alpha alpha^T,
               kappa = (a/b)(2a + N) / (2N (2a + (a/b) q))

with alpha = S^{-1} y and q = y^T alpha (derived from
d logdet S = <S^{-1}, dS> and d q = -<alpha alpha^T, dS>; the Student-t
coefficient is the chain rule through Sigma = (b/a) S of the reference's
``multivariate_t_logpdf``, ``spax/utils.py:160-183``).

The scale gradients then cost:

* ONE augmented tiled assembly per step — each tile is (K, dK/dw_std,
  dK/db_std) from two forward-mode jvp passes through the plain tier
  (:func:`jvp_aug_fn`); dK/dlast_w_std = (2/last) K is closed form and needs
  NO contraction: <S^{-1}, K> = N - eps tr(S^{-1}) and
  alpha^T K alpha = q - eps |alpha|^2.
* ONE in-place factorization (donated buffer).
* O(N^3) panel solves streaming S^{-1} column panels through the
  memory-lean triangular solve for the <S^{-1}, dK/dtheta> contractions —
  never materializing S^{-1} on device.
* eps / a / b gradients are scalar closed forms (eps: tr G; a, b: jax.grad
  of the scalar marginal as a function of (q, logdet S)).

Memory envelope: device peak is the factor (~N^2) + an [N, panel] solve
carry; the host holds the three tiled assemblies (RAM or crash-resumable
memmaps).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from snngp.models import params as P
from snngp.models.bijectors import positive

__all__ = ["marginal_nll_from_scalars", "gram_cotangent_coeffs",
           "jvp_aug_fn", "tiled_aug_gram", "full_gram_mlii_value_and_grad",
           "MLIIFullState", "mlii_fit_full"]


def marginal_nll_from_scalars(q, logdet_s, n, ab=None):
    """Per-datapoint marginal NLL as a function of the two solved scalars.

    ``q = y^T S^{-1} y`` and ``logdet_s = logdet(S)`` with ``S = K + eps I``.
    ``ab=None`` gives the Gaussian marginal (``snngp.ops.linalg.mvn_logpdf``);
    ``ab=(a, b)`` the Student-t marginal with shape ``(b/a) S`` and
    ``df = 2a`` (``snngp.ops.mvt.multivariate_t_logpdf`` — the reference's
    fork, ``spax/utils.py:160-183``). Differentiable in everything, so the
    (a, b) gradients come straight from jax.grad of this function: S does
    not depend on (a, b)."""
    n_f = jnp.asarray(n, jnp.float32)
    if ab is None:
        return (q + logdet_s + n_f * jnp.log(2.0 * jnp.pi)) / (2.0 * n_f)
    a, b = ab
    df = 2.0 * a
    half = 0.5 * (df + n_f)
    quad_sigma = (a / b) * q
    logdet_sigma = n_f * jnp.log(b / a) + logdet_s
    neg_logp = (half * jnp.log1p(quad_sigma / df)
                + 0.5 * n_f * jnp.log(df * jnp.pi)
                - gammaln(half) + gammaln(0.5 * df)
                + 0.5 * logdet_sigma)
    return neg_logp / n_f


def gram_cotangent_coeffs(q, n, ab=None):
    """(c_inv, c_aa) with ``dL/dK = c_inv S^{-1} + c_aa alpha alpha^T``
    for the per-datapoint marginal NLL of :func:`marginal_nll_from_scalars`.
    """
    n_f = float(n)
    if ab is None:
        return 1.0 / (2.0 * n_f), -1.0 / (2.0 * n_f)
    a, b = float(ab[0]), float(ab[1])
    c_aa = -(a / b) * (2.0 * a + n_f) / (
        2.0 * n_f * (2.0 * a + (a / b) * float(q)))
    return 1.0 / (2.0 * n_f), c_aa


def jvp_aug_fn(get_kernel_fn: Callable) -> Callable:
    """Augmented block function ``aug(x1, x2, w_std, b_std, last_w_std) ->
    (K, dK/dw_std, dK/db_std)`` by forward-mode ``jax.jvp`` through the
    plain kernel tier.

    ``get_kernel_fn(w_std, b_std, last_w_std) -> kernel_fn`` is the same
    builder :class:`snngp.models.kernels.NNGPKernel` takes (e.g.
    ``lambda w, b, l: arch.get_myrtle_kernel(5, w_std=w, b_std=b,
    last_w_std=l)``). Each tangent is one jvp pass, which carries a tangent
    state beside the primal through the recursion; the primal of the first
    pass is K."""

    def aug(x1, x2, w_std, b_std, last_w_std):
        w = jnp.asarray(w_std, jnp.float32)
        b = jnp.asarray(b_std, jnp.float32)
        f = lambda wv, bv: get_kernel_fn(wv, bv, last_w_std)(x1, x2,
                                                             get="nngp")
        k, dkw = jax.jvp(lambda wv: f(wv, b), (w,), (jnp.ones_like(w),))
        _, dkb = jax.jvp(lambda bv: f(w, bv), (b,), (jnp.ones_like(b),))
        return k, dkw, dkb

    return aug


def tiled_aug_gram(aug_fn: Callable, x, *, block: int, args=(),
                   resume_dir: Optional[str] = None, log=None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Assemble (K, dK/dw_std, dK/db_std) host arrays from [block, block]
    tiles of ``aug_fn(x1_block, x2_block, *args) -> (k, dkw, dkb)`` (e.g.
    :func:`jvp_aug_fn` with ``args=(w_std, b_std, last_w_std)``) through the
    library assembler :func:`snngp.nn.full.tiled_gram`: upper-triangle tiles
    only, mirrored, crash-resumable under ``resume_dir`` (files
    ``aug_<i>.npy`` and ``aug.done.npy``)."""
    from snngp.nn.full import tiled_gram
    return tiled_gram(aug_fn, jnp.asarray(x), args=args, tile=block,
                      chunk=1, resume_dir=resume_dir, name="aug", log=log)


def _f64_frob(a: np.ndarray, b: np.ndarray, chunk: int = 1 << 22) -> float:
    """<A, B> elementwise with float64 accumulation, streaming (memmap-safe).
    """
    total = 0.0
    av, bv = a.reshape(-1), b.reshape(-1)
    for s in range(0, av.shape[0], chunk):
        total += float(np.sum(av[s:s + chunk].astype(np.float64)
                              * bv[s:s + chunk].astype(np.float64)))
    return total


def _quad_host(mat: np.ndarray, vec: np.ndarray, chunk: int = 4096) -> float:
    """vec^T mat vec with float64 accumulation, row-streamed (memmap-safe)."""
    v64 = vec.astype(np.float64)
    total = 0.0
    for s in range(0, mat.shape[0], chunk):
        total += float(v64[s:s + chunk] @ (mat[s:s + chunk] @ vec)
                       .astype(np.float64))
    return total


def full_gram_mlii_value_and_grad(k, dkw, dkb, y, *, last_w_std, eps,
                                  ab=None, panel: int = 2048, log=None
                                  ) -> Tuple[float, Dict[str, float]]:
    """Exact marginal NLL + constrained-space gradients from one assembled
    augmented Gram.

    ``k``/``dkw``/``dkb`` are host [N, N] arrays (memmaps fine) from
    :func:`tiled_aug_gram`; ``eps`` is the ABSOLUTE diagonal regularizer
    (``SPR.loss`` semantics); ``ab=(a, b)`` selects the Student-t marginal.
    Returns ``(loss, grads)`` with grads over
    ``{w_std, b_std, last_w_std, eps[, a, b]}`` in CONSTRAINED space —
    chain through the bijector for unconstrained updates
    (:func:`mlii_fit_full` does).

    Device peak: one [N, N] buffer (donated into the in-place factor) plus
    an [N, panel] solve carry. S^{-1} is streamed to the host panel-by-panel
    for the two dK contractions (float64 accumulation) and never stored.
    """
    from snngp.parallel.cholesky import (blocked_triangular_solve,
                                         inplace_blocked_cholesky)

    n = k.shape[0]
    y_dev = jnp.asarray(np.asarray(y).reshape(-1), jnp.float32)

    def _factor(kd, eps_):
        return inplace_blocked_cholesky(
            kd + eps_ * jnp.eye(n, dtype=kd.dtype))

    u = jax.jit(_factor, donate_argnums=0)(
        jnp.asarray(np.asarray(k)), jnp.asarray(eps, jnp.float32))

    @jax.jit
    def _solves(u, y_dev):
        z = blocked_triangular_solve(u, y_dev, trans=True)
        alpha = blocked_triangular_solve(u, z, trans=False)
        q = jnp.dot(z, z)                      # y^T S^{-1} y = |U^{-T} y|^2
        logdet_s = 2.0 * jnp.sum(jnp.log(jnp.diagonal(u)))
        return alpha, q, logdet_s

    alpha, q, logdet_s = _solves(u, y_dev)
    alpha_h = np.asarray(alpha)
    q_f, logdet_f = float(q), float(logdet_s)

    # S^{-1} column panels: two memory-lean solves per panel, fetched to the
    # host for the dK contractions; the diagonal accumulates tr(S^{-1}).
    p = min(panel, n)

    @jax.jit
    def _sinv_panel(u, col):
        rows = jnp.arange(n)[:, None]
        cols = col + jnp.arange(p)[None, :]
        e = (rows == cols).astype(jnp.float32)
        z = blocked_triangular_solve(u, e, trans=True)
        return blocked_triangular_solve(u, z, trans=False)

    sinv_dkw = sinv_dkb = tr_sinv = 0.0
    for col in range(0, n, p):
        sp = np.asarray(_sinv_panel(u, jnp.asarray(col, jnp.int32)))
        w_eff = min(p, n - col)                # tail panel: drop pad columns
        sp = sp[:, :w_eff]
        sinv_dkw += _f64_frob(sp, dkw[:, col:col + w_eff])
        sinv_dkb += _f64_frob(sp, dkb[:, col:col + w_eff])
        tr_sinv += float(np.sum(np.diagonal(
            sp, offset=-col).astype(np.float64)[:w_eff]))
        if log is not None:
            log(f"mlii: S^-1 panel {col // p + 1}/{-(-n // p)}")
    del u

    aa_dkw = _quad_host(dkw, alpha_h)
    aa_dkb = _quad_host(dkb, alpha_h)
    aa_norm = float(np.sum(alpha_h.astype(np.float64) ** 2))

    c_inv, c_aa = gram_cotangent_coeffs(q_f, n, ab=ab)
    grads = {
        "w_std": c_inv * sinv_dkw + c_aa * aa_dkw,
        "b_std": c_inv * sinv_dkb + c_aa * aa_dkb,
        # dK/dlast = (2/last) K; <S^{-1}, K> = N - eps tr(S^{-1}) and
        # alpha^T K alpha = q - eps |alpha|^2 (S alpha = y) — no contraction.
        "last_w_std": (2.0 / float(last_w_std)) * (
            c_inv * (n - float(eps) * tr_sinv)
            + c_aa * (q_f - float(eps) * aa_norm)),
        "eps": c_inv * tr_sinv + c_aa * aa_norm,   # tr(G): dS/deps = I
    }
    if ab is None:
        loss = float(marginal_nll_from_scalars(q_f, logdet_f, n))
    else:
        scalars = jnp.asarray([ab[0], ab[1]], jnp.float32)
        loss_fn = lambda s: marginal_nll_from_scalars(
            q_f, logdet_f, n, ab=(s[0], s[1]))
        loss_v, dab = jax.value_and_grad(loss_fn)(scalars)
        loss = float(loss_v)
        grads["a"], grads["b"] = float(dab[0]), float(dab[1])
    return loss, grads


class MLIIFullState:
    """Resumable optimizer state for :func:`mlii_fit_full` (one small .npz:
    unconstrained params + Adam moments + step counter)."""

    def __init__(self, params, opt_state, step: int):
        self.params = params
        self.opt_state = opt_state
        self.step = step

    def save(self, path):
        flat = {"step": np.asarray(self.step)}
        for name, leaf in P.named_leaves(self.params):
            flat["param:" + name] = np.asarray(leaf)
        for name, leaf in P.named_leaves(self.opt_state.mu):
            flat["mu:" + name] = np.asarray(leaf)
        for name, leaf in P.named_leaves(self.opt_state.nu):
            flat["nu:" + name] = np.asarray(leaf)
        flat["opt_step"] = np.asarray(self.opt_state.step)
        np.savez(path, **flat)

    @classmethod
    def load(cls, path):
        from snngp.utils.optim import AdamState
        with np.load(path) as data:
            step = int(data["step"])
            groups = {"param": {}, "mu": {}, "nu": {}}
            for key in data.files:
                for g in groups:
                    if key.startswith(g + ":"):
                        groups[g][key[len(g) + 1:]] = jnp.asarray(data[key])
            opt = AdamState(step=jnp.asarray(data["opt_step"]),
                            mu=P.unflatten_named(groups["mu"]),
                            nu=P.unflatten_named(groups["nu"]))
        return cls(P.unflatten_named(groups["param"]), opt, step)


def mlii_fit_full(aug_fn: Callable, x, y, *, steps: int, lr: float,
                  block: int, init_hyper: Dict[str, float], eps: float,
                  ab: Optional[Tuple[float, float]] = None,
                  panel: int = 2048, resume_dir: Optional[str] = None,
                  log=print):
    """Full-Gram ML-II Adam loop at tiled scale.

    ``aug_fn(x1_blk, x2_blk, w_std, b_std, last_w_std) -> (k, dkw, dkb)``
    device tiles, e.g. ``jvp_aug_fn(lambda w, b, l:
    arch.get_myrtle_kernel(5, w_std=w, b_std=b, last_w_std=l))``. The
    hyperparameters ride as traced arguments, so every step reuses one
    compile.

    Parameters live in UNCONSTRAINED space behind the softplus bijector —
    the same storage convention as ``SPR.init_params`` — so this matches the
    reference's ``reg tr`` optimizer semantics
    (``experiments/regression/train.py:61-67``) exactly, just evaluated
    through the tiled closed-form gradient instead of reverse-mode.

    ``resume_dir`` persists both the per-step augmented assembly (tiles
    survive a crash mid-assembly) and the optimizer state npz; a re-run
    with the same directory continues from the last completed step. Each
    step's tile cache is invalidated when its parameters change (step index
    keys the subdirectory).

    Returns ``(hyper, eps, ab, losses)`` — constrained final values plus
    the per-step loss history.
    """
    import shutil
    import time

    from snngp.utils.optim import Adam

    bij = positive()
    params = {
        "kernel": {k: P.constrained_init(v, bij)
                   for k, v in init_hyper.items()},
        "eps": P.constrained_init(eps, bij),
    }
    if ab is not None:
        params["likelihood"] = {"a": P.constrained_init(ab[0], bij),
                                "b": P.constrained_init(ab[1], bij)}
    opt = Adam()
    opt_state = opt.init(params)
    start = 0
    state_path = (os.path.join(resume_dir, "mlii_state.npz")
                  if resume_dir else None)
    if state_path and os.path.exists(state_path):
        st = MLIIFullState.load(state_path)
        params, opt_state, start = st.params, st.opt_state, st.step
        log(f"mlii_fit_full: resuming at step {start}")

    def read(p):
        out = {k: float(P.constrained_read(v, bij))
               for k, v in p["kernel"].items()}
        out["eps"] = float(P.constrained_read(p["eps"], bij))
        if ab is not None:
            out["a"] = float(P.constrained_read(p["likelihood"]["a"], bij))
            out["b"] = float(P.constrained_read(p["likelihood"]["b"], bij))
        return out

    losses = []
    for step in range(start, steps):
        t0 = time.time()
        c = read(params)
        step_dir = (os.path.join(resume_dir, f"step{step:03d}")
                    if resume_dir else None)
        hyper = tuple(jnp.asarray(c[k_], jnp.float32)
                      for k_ in ("w_std", "b_std", "last_w_std"))
        k, dkw, dkb = tiled_aug_gram(aug_fn, x, block=block, args=hyper,
                                     resume_dir=step_dir, log=log)
        t_asm = time.time() - t0
        loss, g_c = full_gram_mlii_value_and_grad(
            k, dkw, dkb, y, last_w_std=c["last_w_std"], eps=c["eps"],
            ab=(c["a"], c["b"]) if ab is not None else None,
            panel=panel, log=None)
        del k, dkw, dkb

        # Constrained-space -> unconstrained-space gradients through the
        # bijector (dL/du = dL/dt * dt/du), mirroring what jax.grad of
        # SPR.loss produces on the raw params.
        def chain(raw, g):
            _, vjp = jax.vjp(bij, raw)
            return vjp(jnp.asarray(g, jnp.float32))[0]

        grads = {
            "kernel": {k_: chain(params["kernel"][k_], g_c[k_])
                       for k_ in params["kernel"]},
            "eps": chain(params["eps"], g_c["eps"]),
        }
        if ab is not None:
            grads["likelihood"] = {
                "a": chain(params["likelihood"]["a"], g_c["a"]),
                "b": chain(params["likelihood"]["b"], g_c["b"])}
        params, opt_state = opt.update(grads, opt_state, params, lr)
        losses.append(loss)
        log(f"mlii_fit_full: step {step + 1}/{steps} nll {loss:.5f} "
            f"({time.time() - t0:.1f}s, assembly {t_asm:.1f}s) -> {read(params)}")
        if state_path:
            MLIIFullState(params, opt_state, step + 1).save(state_path)
            if step_dir and os.path.isdir(step_dir):
                shutil.rmtree(step_dir)       # params changed: tiles stale

    final = read(params)
    hyper = {k_: final[k_] for k_ in ("w_std", "b_std", "last_w_std")}
    out_ab = (final["a"], final["b"]) if ab is not None else None
    return hyper, final["eps"], out_ab, losses
