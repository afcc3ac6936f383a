"""Online exact-GP/TP regression: grow the conditioning set without refits.

The reference re-solves the full train system on every evaluation
(spax/models.py:100-120) and has no way to add data to a fitted model short
of retraining from scratch. This example streams batches into a fitted
snngp predictor with :meth:`FittedSPR.extend` — each arrival costs one
bordered Cholesky update, O(N^2 m) (`snngp.ops.linalg.chol_append`), and
reports held-out NLL after every batch alongside the wall-clock of the
incremental update vs a full refit. At demo sizes both timings are
compile-dominated (each round is a new shape); the asymptotic gap is the
point — at N=16384, m=512 the extension is two O(N^2) triangular solves
where the refit re-factorizes in O(N^3).

Usage:
    python examples/online_regression.py --n0 256 --batch 64 --rounds 6
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax.numpy as jnp

from snngp.models import (GaussianLikelihood, NNGPKernel, SPR,
                          StudentTLikelihood, fit_spr)
from snngp.nn.arch import get_mlp_kernel


def make_stream(n_total, d, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n_total, d).astype(np.float32)
    w = rng.randn(d) / np.sqrt(d)
    y = (np.sin(2.0 * x @ w) + 0.05 * rng.randn(n_total)).astype(np.float32)
    return x, y


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", choices=["gp", "tp"], default="tp")
    ap.add_argument("--n0", type=int, default=256,
                    help="initial training-set size")
    ap.add_argument("--batch", type=int, default=64,
                    help="points per arriving batch")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--n-test", type=int, default=256)
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--eps", type=float, default=1e-4)
    args = ap.parse_args()

    n_total = args.n0 + args.rounds * args.batch + args.n_test
    x, y = make_stream(n_total, args.dim, seed=0)
    x_test, y_test = x[-args.n_test:], y[-args.n_test:]
    y_mean, y_std = float(y[:args.n0].mean()), float(y[:args.n0].std())

    def get_kernel_fn(w, b, l):
        return get_mlp_kernel(3, act="relu", w_std=w, b_std=b, last_w_std=l)

    kernel = NNGPKernel(get_kernel_fn, 1.5, 0.3, 1.0)
    lik = (StudentTLikelihood(2.0, 2.0) if args.method == "tp"
           else GaussianLikelihood())
    y0_n = jnp.asarray((y[:args.n0] - y_mean) / y_std)
    model = SPR(kernel, lik, jnp.asarray(x[:args.n0]), y0_n,
                y_mean, y_std, eps=args.eps)
    params = model.init_params()

    t0 = time.time()
    fitted = fit_spr(model, params, extendable=True)
    t_fit = time.time() - t0
    y_test_n = jnp.asarray((y_test - y_mean) / y_std)
    nll = float(fitted.test_nll(jnp.asarray(x_test), y_test_n))
    print(f"round 0: N={args.n0:5d}  fit {t_fit:6.2f}s  test NLL {nll:8.4f}")

    for r in range(1, args.rounds + 1):
        lo = args.n0 + (r - 1) * args.batch
        xb, yb = x[lo:lo + args.batch], y[lo:lo + args.batch]

        t0 = time.time()
        fitted = fitted.extend(jnp.asarray(xb), jnp.asarray(yb))
        float(fitted.state["alpha"][0, 0])  # force the update
        t_ext = time.time() - t0

        # full-refit control at the same size (what the reference would do)
        yn = jnp.asarray((y[:lo + args.batch] - y_mean) / y_std)
        m_ref = SPR(kernel, lik, jnp.asarray(x[:lo + args.batch]), yn,
                    y_mean, y_std, eps=args.eps)
        t0 = time.time()
        f_ref = fit_spr(m_ref, params)
        float(f_ref.state["alpha"][0, 0])
        t_refit = time.time() - t0

        nll = float(fitted.test_nll(jnp.asarray(x_test), y_test_n))
        print(f"round {r}: N={fitted.model.num_data:5d}  "
              f"extend {t_ext:6.2f}s vs refit {t_refit:6.2f}s  "
              f"test NLL {nll:8.4f}")


if __name__ == "__main__":
    main()
