"""Time each plain (XLA) kernel tier on the GPU and its share of the HBM
roofline.

For every Gram family the repo once had a hand-written kernel for, at the
shapes the smoke run and the CLI use: steady-state time per call (min of
``--iters`` calls, each ending in ``block_until_ready``), time per image
pair, the bytes and flops XLA's cost analysis counts for the compiled
program (the bytes its fusions read and write), and the achieved bytes/s as
a share of the H100's published 3.35 TB/s and of a measured large copy.

    python scripts/plain_tier_roofline.py [--iters 3]

Runs only on a GPU; prints the card's name and power limit first.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

from snngp.nn import arch
from snngp.utils.profiling import gpu_name_and_power_limit

# Published peaks, NVIDIA H100 SXM data sheet (dense, no sparsity).
PEAKS = {"H100": {"hbm_bytes_per_s": 3.35e12, "fp32_flops": 67e12}}


def _steady(fn, args, iters):
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def _cost(fn, args):
    cost = fn.lower(*args).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    return float(cost.get("bytes accessed", 0.0)), float(cost.get("flops", 0.0))


def cases():
    rng = np.random.RandomState(0)
    hp = dict(w_std=1.3, b_std=0.3, last_w_std=1.0)
    x_reg = jnp.asarray(rng.randn(9546, 16), jnp.float32)
    img = lambda n, s: jnp.asarray(rng.randn(n, s, s, 3), jnp.float32)
    z, xb = img(200, 32), img(100, 32)

    mlp = arch.get_mlp_kernel(4, 1, "relu", **hp)
    res = arch.get_dense_resnet_kernel(4, 1, "relu", **hp)
    cnn = arch.get_cnn_kernel(4, 10, "relu", **hp)
    wrn = arch.get_conv_resnet_kernel(1, 10, "relu", **hp)
    myr = arch.get_myrtle_kernel(5, 1, "relu", **hp)

    def mlp_grad(x):
        f = lambda w: jnp.sum(arch.get_mlp_kernel(
            4, 1, "relu", w_std=w, b_std=0.3, last_w_std=1.0)(x, x))
        return jax.grad(f)(jnp.float32(1.3))

    yield "MLP Gram 9546x9546 d16 depth 4", lambda a: mlp(a, a), (x_reg,), 9546 ** 2
    yield "MLP Gram grad (w_std), same shape", mlp_grad, (x_reg,), 9546 ** 2
    yield "dense-ResNet Gram 9546x9546 depth 4", lambda a: res(a, a), (x_reg,), 9546 ** 2
    yield "CNN Gram [100, 200] 32x32 depth 4", lambda a, b: cnn(a, b), (xb, z), 100 * 200
    yield "conv-WRN Gram [100, 200] 32x32 depth 1", lambda a, b: wrn(a, b), (xb, z), 100 * 200
    for s, n in ((16, 64), (32, 16)):
        a, b = img(n, s), img(n, s)
        yield (f"Myrtle-5 block [{n}, {n}] {s}x{s}", lambda p, q: myr(p, q),
               (a, b), n * n)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"plain_tier_roofline.py measures the GPU; JAX found "
                 f"'{dev.platform}'")
    import snngp  # noqa: F401
    print(f"device: {dev.device_kind}; nvidia-smi: {gpu_name_and_power_limit()}")
    matches = [v for k, v in PEAKS.items() if k in dev.device_kind]
    if not matches:
        sys.exit(f"no published peaks for '{dev.device_kind}'")
    peak = matches[0]

    nbytes = 4 << 30
    buf = jnp.ones(nbytes // 4, jnp.float32)
    copy = jax.jit(lambda v: v * 1.0000001)
    t = _steady(copy, (buf,), args.iters)
    copy_bw = 2 * nbytes / t
    print(f"calibration: 4 GiB read+write copy {t * 1e3:.2f} ms = "
          f"{copy_bw / 1e12:.3f} TB/s ({copy_bw / peak['hbm_bytes_per_s']:.1%}"
          f" of 3.35 TB/s)")
    del buf

    for name, fn, xs, pairs in cases():
        fn = jax.jit(fn)
        t = _steady(fn, xs, args.iters)
        nb, fl = _cost(fn, xs)
        bw = nb / t
        print(f"{name}: {t * 1e3:.3f} ms, {t / pairs * 1e6:.4f} us/pair, "
              f"{nb / 2**30:.2f} GiB moved, {fl / 1e9:.1f} GFLOP; "
              f"{bw / 1e12:.3f} TB/s = {bw / peak['hbm_bytes_per_s']:.1%} of "
              f"HBM peak, {bw / copy_bw:.1%} of copy; "
              f"{fl / t / peak['fp32_flops']:.1%} of fp32 peak", flush=True)


if __name__ == "__main__":
    main()
