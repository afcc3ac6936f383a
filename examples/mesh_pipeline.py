"""Multi-chip north-star pipeline, end to end on a device mesh.

Runs the full distributed composition the framework is built around
(SURVEY.md D1-D3; the structure of the 50k x 50k BASELINE.json target):

    sharded NNGP Gram (rows over the mesh)      [D2]
      -> block-cyclic distributed Cholesky       [D3]
      -> Student-t conditional predictive        [C7]

with per-phase wall-clock and (optionally) a parity check against the
single-device pipeline. On a machine without several GPUs, emulate a mesh:

    python examples/mesh_pipeline.py --devices 8 --cpu --n-train 256

On a multi-GPU host, drop --cpu and the same script runs over the GPUs
(`jax.devices()` must report >= --devices; multi-host launches call
snngp.parallel.init_distributed first).

Architectures: --arch mlp (any --image-size; x is flattened) or
--arch myrtle (full spatial-covariance tier; 8x8+ square images).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="emulate the mesh with virtual CPU devices")
    ap.add_argument("--n-train", type=int, default=256)
    ap.add_argument("--n-test", type=int, default=32)
    ap.add_argument("--arch", choices=["mlp", "myrtle"], default="mlp")
    ap.add_argument("--image-size", type=int, default=8)
    ap.add_argument("--depth", type=int, default=3, help="mlp depth / myrtle {5,7,10}")
    ap.add_argument("--block", type=int, default=0,
                    help="cyclic-Cholesky panel size (0 = n_train/(4*devices))")
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--df", type=float, default=4.0, help="Student-t 2a")
    ap.add_argument("--no-parity", action="store_true",
                    help="skip the single-device reference run (large N)")
    args = ap.parse_args()

    if args.cpu:
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count={args.devices}").strip()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.scipy.linalg import cho_solve, solve_triangular

    from snngp.ops.linalg import add_jitter, chol_quad_form
    from snngp.ops.mvt import multivariate_t_logpdf
    from snngp.parallel import get_mesh, sharded_gram
    from snngp.parallel.cholesky import cyclic_cholesky

    mesh = get_mesh(args.devices)
    n_train, n_test, df = args.n_train, args.n_test, args.df
    if n_train % mesh.size:
        raise SystemExit(f"--n-train must divide the mesh size {mesh.size}")
    block = args.block or max(8, n_train // (4 * mesh.size))

    rng = np.random.RandomState(0)
    if args.arch == "myrtle":
        from snngp.nn.full import get_myrtle_kernel
        s = args.image_size
        x = jnp.asarray(rng.rand(n_train + n_test, s, s, 3), jnp.float32)
        kfn = get_myrtle_kernel(args.depth if args.depth in (5, 7, 10) else 5,
                                1, "relu", w_std=1.0, b_std=0.1, last_w_std=1.0)
    else:
        from snngp.nn import arch as _arch
        x = jnp.asarray(rng.randn(n_train + n_test, args.image_size ** 2),
                        jnp.float32)
        kfn = _arch.get_mlp_kernel(args.depth, act="relu",
                                   w_std=1.0, b_std=0.3, last_w_std=1.0)
    y = jnp.asarray(rng.randn(n_train), jnp.float32)
    xt, xs = x[:n_train], x[n_train:]

    def predictive(chol, k_td, k_tt):
        mean = k_td @ cho_solve((chol, True), y)
        v = solve_triangular(chol, k_td.T, lower=True)
        cov = k_tt - v.T @ v
        d = df + chol_quad_form(chol, y)
        t_cov = (d / (df + n_train)) * cov
        nll = -jnp.mean(multivariate_t_logpdf(
            jnp.zeros(n_test), mean, add_jitter(t_cov, 1e-4), df + n_train))
        return mean, nll

    gram_dd = jax.jit(lambda: sharded_gram(kfn, xt, mesh))
    gram_td = jax.jit(lambda: sharded_gram(kfn, xs, mesh, x2=xt))
    gram_tt = jax.jit(lambda: kfn(xs, xs, get="nngp"))
    chol_fn = jax.jit(lambda k: cyclic_cholesky(add_jitter(k, args.eps), mesh,
                                                block=block))
    pred_fn = jax.jit(predictive)

    def timed(label, fn, *a):
        t0 = time.time()
        out = jax.block_until_ready(fn(*a))
        dt = time.time() - t0
        print(f"  {label:<28s} {dt:8.2f} s")
        return out

    print(f"mesh: {mesh.devices.shape} on {jax.default_backend()}; "
          f"N={n_train} (+{n_test} test), arch={args.arch}, "
          f"cyclic block={block}")
    t_all = time.time()
    k_dd = timed("gram_train (sharded)", gram_dd)
    k_td = timed("gram_cross (sharded)", gram_td)
    k_tt = timed("gram_test", gram_tt)
    chol = timed("cyclic_cholesky", chol_fn, k_dd)
    mean, nll = timed("student-t predictive", pred_fn, chol, k_td, k_tt)
    print(f"  {'total':<28s} {time.time() - t_all:8.2f} s")
    print(f"predictive NLL: {float(nll):.6f}")

    if not args.no_parity:
        k_dd_s = kfn(xt, xt, get="nngp")
        chol_s = jnp.linalg.cholesky(add_jitter(k_dd_s, args.eps))
        mean_s, nll_s = predictive(chol_s, kfn(xs, xt, get="nngp"), k_tt)
        np.testing.assert_allclose(np.asarray(mean), np.asarray(mean_s),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(nll), float(nll_s), rtol=1e-4)
        print(f"parity vs single device: OK (NLL {float(nll_s):.6f})")


if __name__ == "__main__":
    main()
