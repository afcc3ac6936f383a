"""Mesh-distributed full-Gram ML-II step (SURVEY.md D2-D3 applied to the
TRAINING path).

Composes the distributed pieces the inference pipeline already uses into one
jittable training-step gradient:

- augmented Gram (K, dK/dw_std, dK/db_std) as mesh row panels — each device
  runs the augmented kernel for its row block against the full batch
  (:func:`sharded_aug_gram`, the 3-output analogue of
  :func:`snngp.parallel.sharded_gram`),
- block-cyclic distributed factorization
  (:func:`snngp.parallel.cholesky.cyclic_cholesky` — one psum per panel),
- memory-lean panel solves (:func:`blocked_triangular_solve`) for
  ``alpha = S^{-1} y``, ``q``, ``logdet``,
- the <S^{-1}, dK> / ``alpha^T dK alpha`` contractions under ``shard_map``:
  each device solves S^{-1}'s columns for ITS row indices (S^{-1} is
  symmetric, so those are its rows too), contracts them against its local
  dK row panels, and one ``psum`` reduces the six scalars.

The gradient math is the closed form of :mod:`snngp.models.mlii`
(``dL/dK = c_inv S^{-1} + c_aa alpha alpha^T``; the reference's full-batch
ML-II objective, ``experiments/regression/train.py:61-67``), evaluated
entirely on-device over the mesh — where the single-device path streams
S^{-1} panels through the host, here the panels never leave their device.

At dryrun scale each device materializes its whole [n, n/P] S^{-1} panel in
one solve; at north-star scale the same local computation chunks over
column sub-panels exactly like the single-device loop (the structure —
solve-then-contract per panel, psum at the end — is unchanged).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as Pspec

from snngp.models.mlii import marginal_nll_from_scalars
from snngp.parallel.cholesky import (blocked_triangular_solve,
                                     cyclic_cholesky)

__all__ = ["sharded_aug_gram", "distributed_mlii_value_and_grad"]


def sharded_aug_gram(aug_fn: Callable, x: jax.Array, mesh: Mesh,
                     axis_name: str = "data"):
    """(K, dK/dw_std, dK/db_std) as mesh ROW panels: device d runs the
    augmented kernel for its row block of ``x`` against the full batch.
    Same layout contract as :func:`snngp.parallel.sharded_gram` (zero
    inter-device traffic; feeds the distributed factorization without a
    relayout). ``x.shape[0]`` must divide the mesh axis (pad upstream)."""
    fn = shard_map(
        lambda xr, xf: tuple(aug_fn(xr, xf)), mesh=mesh,
        in_specs=(Pspec(axis_name), Pspec()),
        out_specs=(Pspec(axis_name),) * 3,
    )
    return fn(x, x)


def distributed_mlii_value_and_grad(
        aug_fn: Callable, x: jax.Array, y: jax.Array, mesh: Mesh, *,
        last_w_std, eps, ab: Optional[Tuple] = None,
        axis_name: str = "data", chol_block: int = 128
        ) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    """One exact full-Gram ML-II gradient step, distributed over ``mesh``.

    Returns ``(loss, grads)`` with the same contract as
    :func:`snngp.models.mlii.full_gram_mlii_value_and_grad`: per-datapoint
    marginal NLL and CONSTRAINED-space gradients over
    ``{w_std, b_std, last_w_std, eps[, a, b]}`` (``ab=(a, b)`` selects the
    Student-t marginal). Fully jittable — call under one ``jit`` so the
    shard_map collectives fuse into the step.
    """
    n = x.shape[0]
    p = mesh.shape[axis_name]
    assert n % p == 0, f"n={n} must divide the mesh axis ({p})"
    y = jnp.asarray(y, jnp.float32).reshape(-1)
    eps = jnp.asarray(eps, jnp.float32)
    last_w_std = jnp.asarray(last_w_std, jnp.float32)

    k, dkw, dkb = sharded_aug_gram(aug_fn, x, mesh, axis_name)
    s = k + eps * jnp.eye(n, dtype=k.dtype)
    lfac = cyclic_cholesky(s, mesh, block=min(chol_block, n // p),
                           axis_name=axis_name)
    u = lfac.T                               # the panel solves take U^T U

    z = blocked_triangular_solve(u, y, trans=True)
    alpha = blocked_triangular_solve(u, z, trans=False)
    q = jnp.dot(z, z)
    logdet_s = 2.0 * jnp.sum(jnp.log(jnp.diagonal(lfac)))

    def local(dkw_r, dkb_r, l_full, alpha_full):
        d = lax.axis_index(axis_name)
        ln = dkw_r.shape[0]
        rows = d * ln + jnp.arange(ln)
        e = (jnp.arange(n)[:, None] == rows[None, :]).astype(l_full.dtype)
        # S^{-1} columns for my row indices == my rows of S^{-1} (symmetry)
        w_ = lax.linalg.triangular_solve(l_full, e, left_side=True,
                                         lower=True)
        sinv_cols = lax.linalg.triangular_solve(l_full, w_, left_side=True,
                                                lower=True, transpose_a=True)
        sinv_rows = sinv_cols.T                                # [ln, n]
        tr_local = jnp.sum(sinv_cols[rows, jnp.arange(ln)])
        av = dkw_r @ alpha_full
        bv = dkb_r @ alpha_full
        a_rows = alpha_full[rows]
        outs = (jnp.sum(sinv_rows * dkw_r), jnp.sum(sinv_rows * dkb_r),
                tr_local, jnp.dot(a_rows, av), jnp.dot(a_rows, bv))
        return tuple(lax.psum(o, axis_name) for o in outs)

    contract = shard_map(
        local, mesh=mesh,
        in_specs=(Pspec(axis_name), Pspec(axis_name), Pspec(), Pspec()),
        out_specs=(Pspec(),) * 5)
    sinv_dkw, sinv_dkb, tr_sinv, aa_dkw, aa_dkb = contract(
        dkw, dkb, lfac, alpha)
    aa_norm = jnp.dot(alpha, alpha)

    n_f = jnp.asarray(n, jnp.float32)
    c_inv = 1.0 / (2.0 * n_f)
    if ab is None:
        c_aa = -c_inv
        loss = marginal_nll_from_scalars(q, logdet_s, n)
        dab = None
    else:
        a_, b_ = (jnp.asarray(ab[0], jnp.float32),
                  jnp.asarray(ab[1], jnp.float32))
        c_aa = -(a_ / b_) * (2.0 * a_ + n_f) / (
            2.0 * n_f * (2.0 * a_ + (a_ / b_) * q))
        loss, dab = jax.value_and_grad(
            lambda s_: marginal_nll_from_scalars(q, logdet_s, n,
                                                 ab=(s_[0], s_[1])))(
            jnp.stack([a_, b_]))

    grads = {
        "w_std": c_inv * sinv_dkw + c_aa * aa_dkw,
        "b_std": c_inv * sinv_dkb + c_aa * aa_dkb,
        "last_w_std": (2.0 / last_w_std) * (
            c_inv * (n_f - eps * tr_sinv) + c_aa * (q - eps * aa_norm)),
        "eps": c_inv * tr_sinv + c_aa * aa_norm,
    }
    if dab is not None:
        grads["a"], grads["b"] = dab[0], dab[1]
    return loss, grads
