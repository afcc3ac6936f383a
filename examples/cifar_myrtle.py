"""Myrtle-5 kernel regression at configurable scale: Myrtle-CNN NNGP Gram
(full spatial-covariance tier, tiled), Cholesky factorization, Student-t
predictive (BASELINE.md: "CIFAR-10 50k x 50k conv-NNGP + distributed
Cholesky + Student-t predictive").

The full-covariance state for a (t, t) tile pair at 32x32 resolution is
[t, t, 32, 32, 32, 32] (4 MB per image pair), so the Gram is assembled
tile-by-tile by the library assembler (snngp.nn.full.tiled_gram; symmetric
Grams compute only the upper triangle). With --devices the Gram's row panels
are sharded over a mesh via snngp.parallel.sharded_gram.

Usage:
    python examples/cifar_myrtle.py --n-train 128 --n-test 32 --image-size 16
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

from snngp.nn.full import get_myrtle_kernel
from snngp.utils.profiling import Profiler


def load_images(n, image_size, seed):
    """CIFAR-10 batches if cached under ./data, else seeded synthetic."""
    try:
        from snngp.data.classification import _load_cifar10_dir
        x, y, _ = _load_cifar10_dir("./data/cifar10", "train")
        x = x[:n] / 255.0
    except Exception:
        rng = np.random.RandomState(seed)
        x = rng.rand(n, 32, 32, 3)
        y = rng.randint(10, size=n)
    # Host-side resize (1-ULP match to jax.image.resize).
    from snngp.data.resize import bilinear_resize
    x = jnp.asarray(bilinear_resize(np.asarray(x, np.float32),
                                    image_size, image_size))
    return x, jnp.asarray(np.asarray(y[:n], np.float32))


def assemble(kernel_fn, x1, x2, tile, symmetric, mesh=None, chunk=8,
             resume_dir=None, name="gram"):
    """K[x1, x2] as a host array: the library tile assembler on one device,
    or [tile, n2] row strips sharded over ``mesh``."""
    from snngp.nn.full import tiled_gram

    if mesh is None:
        return tiled_gram(kernel_fn, x1, None if symmetric else x2,
                          tile=tile, chunk=chunk, resume_dir=resume_dir,
                          name=name)
    from snngp.parallel import sharded_gram
    n1, n2 = x1.shape[0], x2.shape[0]
    out = np.zeros((n1, n2), np.float32)
    strip = jax.jit(lambda a, b: sharded_gram(kernel_fn, a, mesh, x2=b))
    for i in range(0, n1, tile):
        out[i:i + tile] = np.asarray(strip(x1[i:i + tile], x2))
    return out


def mlii_fit(args, x_sub, y_sub):
    """ML-II fit of the Myrtle kernel scales + eps (+ Student-t a, b) on a
    training subset, full-batch Adam on the marginal NLL — the reference's
    ``reg tr`` recipe (regression/train.py:61-67) applied to the north-star
    conv architecture. Reverse mode runs through the memory-bounded Myrtle
    kernel (arch.get_myrtle_kernel), which tiles any block whose pixel-pair
    state exceeds the device budget."""
    import time

    from snngp.models import params as P
    from snngp.models.gp import SPR
    from snngp.models.kernels import NNGPKernel
    from snngp.models.likelihoods import (GaussianLikelihood,
                                          StudentTLikelihood)
    from snngp.nn.arch import get_myrtle_kernel as myrtle_builder
    from snngp.utils.optim import Adam

    def get_kernel_fn(w_std, b_std, last_w_std):
        return myrtle_builder(args.depth, 1, "relu", w_std=w_std, b_std=b_std,
                              last_w_std=last_w_std)

    kernel = NNGPKernel(get_kernel_fn, 1.0, 0.1, 1.0)
    lik = (StudentTLikelihood(args.alpha, args.beta)
           if args.mlii_method == "tp" else GaussianLikelihood())
    model = SPR(kernel, lik, x_sub, y_sub, 0.0, 1.0, eps=args.eps)
    params = model.init_params()
    opt = Adam()
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state):
        loss, grads = jax.value_and_grad(model.loss)(params)
        params, opt_state = opt.update(grads, opt_state, params, args.mlii_lr)
        return loss, params, opt_state

    t0 = time.time()
    for i in range(args.mlii):
        loss, params, opt_state = step(params, opt_state)
        if i % max(1, args.mlii // 8) == 0 or i == args.mlii - 1:
            print(f"[mlii] step {i + 1}/{args.mlii}: "
                  f"nll {float(loss):.4f}")
    w, b, l = kernel.get_params(params["kernel"])
    hyper = dict(w_std=float(w), b_std=float(b), last_w_std=float(l))
    eps = float(P.constrained_read(params["eps"], model.bij))
    alpha, beta = args.alpha, args.beta
    if args.mlii_method == "tp":
        a, b_ = lik._ab(params["likelihood"])
        alpha, beta = float(a), float(b_)
    print(f"[mlii] {args.mlii} steps on N={x_sub.shape[0]} in "
          f"{time.time() - t0:.1f}s -> {hyper} eps {eps:.3e}"
          + (f" a {alpha:.3f} b {beta:.3f}"
             if args.mlii_method == "tp" else ""))
    return hyper, eps, alpha, beta


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-train", type=int, default=128)
    ap.add_argument("--n-test", type=int, default=32)
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--tile", type=int, default=8,
                    help="Gram assembly tile (tile x tile image pairs per "
                         "block)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="Gram tiles per device call (one lax.scan)")
    ap.add_argument("--depth", type=int, default=5, choices=[5, 7, 10])
    ap.add_argument("--alpha", type=float, default=2.0)
    ap.add_argument("--beta", type=float, default=2.0)
    ap.add_argument("--eps", type=float, default=1e-4)
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 full-covariance state (halves tile memory; "
                         "GAP accumulates fp32)")
    ap.add_argument("--devices", type=int, default=1,
                    help="shard Gram row panels over an N-device mesh "
                         "(snngp.parallel.sharded_gram; N must divide the "
                         "data sizes)")
    ap.add_argument("--resume-gram", default="",
                    help="directory for crash-resumable Gram assembly: each "
                         "phase's Gram lives in an .npy memmap with a "
                         "block-done bitmap, flushed per chunk; re-running "
                         "with the same directory skips completed blocks")
    ap.add_argument("--mlii", type=int, default=0,
                    help="ML-II steps fitting (w_std, b_std, last_w_std, "
                         "eps[, a, b]) before building the big Gram")
    ap.add_argument("--mlii-n", type=int, default=512,
                    help="subset size for the ML-II fit (subset scope only)")
    ap.add_argument("--mlii-scope", choices=["subset", "full"],
                    default="subset",
                    help="subset: reverse-mode full-batch Adam on an "
                         "--mlii-n subset (fits whatever one reverse-mode "
                         "factorization holds). full: the EXACT full-Gram "
                         "gradient at tiled scale — one augmented assembly "
                         "(K, dK/dw, dK/db by jvp through the plain tier) + "
                         "in-place factorization + streamed S^-1 panel "
                         "contractions per step (snngp.models.mlii), the "
                         "reference's full-batch ML-II "
                         "(regression/train.py:61-67) at sizes reverse-mode "
                         "cannot touch")
    ap.add_argument("--mlii-panel", type=int, default=2048,
                    help="S^-1 panel width for the full-scope contraction")
    ap.add_argument("--mlii-method", choices=["gp", "tp"], default="tp",
                    help="marginal for the ML-II fit: Gaussian (gp) or "
                         "Student-t (tp; also learns a, b and feeds them to "
                         "the predictive)")
    ap.add_argument("--mlii-lr", type=float, default=1e-2,
                    help="Adam learning rate for the ML-II fit (the "
                         "reference regression default)")
    ap.add_argument("--chol", choices=["auto", "xla", "blocked", "inplace"],
                    default="auto",
                    help="factorization kernel: snngp's blocked right-looking"
                         " Cholesky, XLA's monolithic op, or the memory-lean"
                         " in-place kernel (donates the Gram and factors"
                         " inside its own buffer). auto = inplace at"
                         " N >= 32768 (single device), blocked at N >= 4096")
    ap.add_argument("--t-jitter", type=float, default=1e-6,
                    help="absolute jitter on the scaled Gram (b/a) K whose "
                         "factor defines the Student-t data scale d — the "
                         "reference's hardcoded 1e-6 "
                         "(spax/likelihoods.py:60-62). At large N the "
                         "Gram's fp32 representation noise exceeds 1e-6; "
                         "pass ~1e-4 there to keep the factorization PSD")
    ap.add_argument("--var-floor", type=float, default=1e-6,
                    help="posterior-variance floor relative to the prior "
                         "test variance (0 = reference's exact arithmetic; "
                         "at large N the fp32 posterior variance sits "
                         "below the cancellation noise of the [N]-long "
                         "contraction and needs the floor — see "
                         "tests/test_predictor.py::test_var_floor_f64)")
    args = ap.parse_args()

    x, y = load_images(args.n_train + args.n_test, args.image_size, seed=0)
    x_train, x_test = x[:args.n_train], x[args.n_train:]
    y_mean = jnp.mean(y[:args.n_train])
    y_std = jnp.std(y[:args.n_train])
    y_train = (y[:args.n_train] - y_mean) / y_std

    from snngp.nn.arch import get_myrtle_kernel as myrtle_builder

    hyper = dict(w_std=1.0, b_std=0.1, last_w_std=1.0)
    if args.mlii and args.mlii_scope == "full":
        from snngp.models.mlii import jvp_aug_fn, mlii_fit_full

        aug = jvp_aug_fn(lambda w, b, l: myrtle_builder(
            args.depth, 1, "relu", w_std=w, b_std=b, last_w_std=l))
        resume = (os.path.join(args.resume_gram, "mlii")
                  if args.resume_gram else None)
        hyper, args.eps, ab, _ = mlii_fit_full(
            aug, x_train, np.asarray(y_train), steps=args.mlii,
            lr=args.mlii_lr, block=args.tile, init_hyper=hyper,
            eps=args.eps,
            ab=((args.alpha, args.beta)
                if args.mlii_method == "tp" else None),
            panel=args.mlii_panel, resume_dir=resume)
        if ab is not None:
            args.alpha, args.beta = ab
    elif args.mlii:
        n_fit = min(args.mlii_n, args.n_train)
        hyper, args.eps, args.alpha, args.beta = mlii_fit(
            args, x_train[:n_fit], y_train[:n_fit])
    if args.bf16:
        kfn = get_myrtle_kernel(args.depth, 1, "relu", dtype=jnp.bfloat16,
                                **hyper)
        # bf16 Gram entries carry ~1e-2 relative noise; the solve needs a
        # matching regularizer to stay PSD.
        args.eps = max(args.eps, 1e-2)
    else:
        kfn = myrtle_builder(args.depth, 1, "relu", **hyper)
    prof = Profiler()
    mesh = None
    if args.devices > 1:
        from snngp.parallel import get_mesh
        mesh = get_mesh(args.devices)

    def gram(a, b, symmetric, name):
        return assemble(kfn, a, b, args.tile, symmetric, mesh=mesh,
                        chunk=args.chunk, resume_dir=args.resume_gram or None,
                        name=f"gram_{name}")

    with prof.phase("gram_train"):
        k_dd = gram(x_train, x_train, True, "train")
    with prof.phase("gram_cross"):
        k_td = gram(x_test, x_train, False, "cross")
    with prof.phase("gram_test"):
        k_tt = gram(x_test, x_test, True, "test")

    # Everything downstream of Gram assembly — factorization routing, the
    # Student-t two-factorization data scale d (the reference's absolute
    # t-jitter, spax/likelihoods.py:60-62), the target solve, the variance
    # floor, de-normalized conditional-t scoring — defers to the tested
    # library serving path (snngp/models/predictor.py). The memory-lean
    # branch stages the host Gram and uploads it twice (scaled-Gram factor
    # for d, then the main factor) so only ONE full-size device buffer ever
    # exists.
    from snngp.models.gp import SPR
    from snngp.models.kernels import NNGPKernel
    from snngp.models.likelihoods import StudentTLikelihood
    from snngp.models.predictor import fit_spr

    if args.chol == "inplace" and mesh is not None:
        raise SystemExit("--chol inplace is a single-device kernel (donated "
                         "fori-loop carry); with --devices use --chol "
                         "blocked, which shards under GSPMD.")
    memory_lean = (args.chol == "inplace"
                   or (args.chol == "auto" and args.n_train >= 32768
                       and mesh is None))
    chol_fn = None
    if not memory_lean and (args.chol == "blocked" or
                            (args.chol == "auto" and args.n_train >= 4096)):
        from snngp.parallel.cholesky import blocked_cholesky
        chol_fn = blocked_cholesky

    # --eps is ABSOLUTE; fit_spr applies neural_tangents' trace-relative
    # add_diag_reg, so convert: the applied regularizer is
    # eps_rel * tr(K)/N == args.eps exactly.
    tr_mean = float(np.trace(k_dd)) / args.n_train
    eps_rel = args.eps / tr_mean

    def kernel_builder(w_std, b_std, last_w_std):
        return myrtle_builder(args.depth, 1, "relu", w_std=w_std,
                              b_std=b_std, last_w_std=last_w_std)

    kernel = NNGPKernel(kernel_builder, hyper["w_std"], hyper["b_std"],
                        hyper["last_w_std"])
    lik = StudentTLikelihood(args.alpha, args.beta, chol_fn=chol_fn)
    model = SPR(kernel, lik, x_train, y_train, y_mean, y_std, eps=eps_rel,
                mesh=mesh)
    params = model.init_params()

    with prof.phase("fit"):
        fitted = fit_spr(model, params, memory_lean=memory_lean, gram=k_dd,
                         var_floor=args.var_floor, t_jitter=args.t_jitter)
        prof.observe(fitted.state["alpha"])
    if memory_lean:
        del k_dd                          # donated into the fitted factor

    y_test_n = (y[args.n_train:] - y_mean) / y_std
    with prof.phase("predictive"):
        k_td_dev = jnp.asarray(k_td)
        k_tt_diag = jnp.diagonal(jnp.asarray(k_tt))
        if args.bf16:
            # bf16 numerics: ~1e-2 relative Gram noise needs an additive
            # variance inflation the exact library scoring doesn't model —
            # score library outputs directly.
            from jax.scipy.stats import t as t_dist
            mean_d, var_d = fitted.predict_given(k_td_dev, k_tt_diag)
            var_d = var_d + 1e-2 * float(y_std) ** 2
            y_den = y_test_n * y_std + y_mean
            nll = prof.observe(-jnp.mean(t_dist.logpdf(
                y_den, fitted.state["cond_df"], mean_d, jnp.sqrt(var_d))))
        else:
            nll = prof.observe(fitted.test_nll_given(
                k_td_dev, k_tt_diag, y_test_n))

    print(prof.report())
    total = sum(prof.totals.values())
    print(f"\nN={args.n_train} Myrtle-{args.depth} ({args.image_size}x"
          f"{args.image_size}) pipeline total: {total:.2f}s  "
          f"t-predictive NLL (de-normalized, reference semantics): "
          f"{float(nll):.4f}")


if __name__ == "__main__":
    main()
