"""Benchmark: N=10k NNGP Gram build + Cholesky wall-clock on one GPU.

Measures the MLP-NNGP path (one jitted computation: full depth recursion ->
Gram -> jittered Cholesky). ``vs_baseline`` compares against *layerwise
self-execution*: the same math with per-layer jit boundaries + a separate
factorization call — the structure a naive port of the reference's
neural_tangents/objax pipeline produces. It is an architectural baseline,
not a cross-framework one.

Also emits per-phase splits (Gram-only, Cholesky-only, blocked-Cholesky),
and with SNNGP_BENCH_HEAVY=1 (default) the Myrtle-5 32x32 Gram rate, the
N=50k factorization and one tiled ML-II step. Every timing ends in
``block_until_ready``; compilation is excluded (warm-up call first).

Runs only on a GPU: it exits non-zero when JAX finds another backend.
Prints the device and the card's name and power limit, then ONE JSON line:
    {"metric": ..., "value": seconds, "unit": "s", "vs_baseline": ..., ...}
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

from snngp.nn import arch
from snngp.nn.layers import Dense, Relu
from snngp.ops.linalg import add_jitter, sym_t
from snngp.utils.profiling import gpu_name_and_power_limit

N = 10_000
D = 16
DEPTH = 4
EPS = 1e-6


def _time(fn, *args, iters=3):
    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


def _rel_err(a, b):
    return float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b)))


def _heavy_metrics():
    """Myrtle-5 Gram rate at 32x32 (one [256, 256] block of the plain full
    tier, memory-bounded by arch.get_myrtle_kernel), the N=50,000 in-place
    Cholesky with a logdet gate against the exact float64 value of a
    low-rank-plus-identity matrix, and one exact tiled ML-II step at N=1024
    (Myrtle-5 16x16, Student-t marginal, jvp-based augmented Gram)."""
    import numpy as np

    from snngp.models.mlii import (full_gram_mlii_value_and_grad,
                                   jvp_aug_fn, tiled_aug_gram)
    from snngp.parallel.cholesky import inplace_blocked_cholesky

    out = {}
    key = jax.random.PRNGKey(11)

    b = 256
    xa = jax.random.uniform(key, (b, 32, 32, 3), dtype=jnp.float32)
    xb = jax.random.uniform(jax.random.PRNGKey(12), (b, 32, 32, 3),
                            dtype=jnp.float32)
    kfn = arch.get_myrtle_kernel(5, 1, "relu", w_std=1.0, b_std=0.1,
                                 last_w_std=1.0)
    best, _ = _time(jax.jit(lambda p, q: kfn(p, q)), xa, xb, iters=2)
    out["myrtle32_us_per_pair"] = best / (b * b) * 1e6

    n, d = 50_000, 64
    x = jax.random.normal(key, (n, d), dtype=jnp.float32) / np.sqrt(d)
    xh = np.asarray(x, np.float64)
    _, logdet_exact = np.linalg.slogdet(np.eye(d) + xh.T @ xh)
    build = jax.jit(lambda x: x @ x.T + jnp.eye(n, dtype=jnp.float32))
    factor = jax.jit(inplace_blocked_cholesky, donate_argnums=0)
    best, logdet = float("inf"), None
    for _ in range(2):
        k = jax.block_until_ready(build(x))
        t0 = time.perf_counter()
        u = jax.block_until_ready(factor(k))
        best = min(best, time.perf_counter() - t0)
        diag = np.asarray(jnp.diagonal(u), np.float64)
        del u, k
        logdet = 2.0 * float(np.sum(np.log(diag)))
    rel = abs(logdet - logdet_exact) / max(abs(logdet_exact), 1.0)
    assert rel < 1e-4, (
        f"N=50k factor logdet {logdet:.6f} vs exact f64 {logdet_exact:.6f} "
        f"(rel {rel:.2e})")
    out["cholesky_n50000_s"] = best
    out["cholesky_n50000_logdet_rel_err"] = rel

    rng = np.random.RandomState(3)
    xm = jnp.asarray(rng.rand(1024, 16, 16, 3), jnp.float32)
    y = np.asarray(rng.randn(1024), np.float32)
    aug = jvp_aug_fn(lambda w, b_, l: arch.get_myrtle_kernel(
        5, 1, "relu", w_std=w, b_std=b_, last_w_std=l))
    hyper = tuple(jnp.float32(v) for v in (1.0, 0.1, 1.0))

    def step():
        k, dkw, dkb = tiled_aug_gram(aug, xm, block=256, args=hyper)
        return full_gram_mlii_value_and_grad(
            k, dkw, dkb, y, last_w_std=1.0, eps=1e-4, ab=(2.0, 2.0),
            panel=1024)

    step()                                                     # compile
    t0 = time.perf_counter()
    loss, grads = step()
    out["mlii_s_per_step_n1024"] = time.perf_counter() - t0
    assert np.isfinite(loss) and all(np.isfinite(v) for v in grads.values())
    return out


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found '{dev.platform}'")
    print(f"device: {dev.platform} {dev.device_kind} x{jax.device_count()}")
    card = gpu_name_and_power_limit()
    print(f"nvidia-smi: {card}")

    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (N, D), dtype=jnp.float32)

    kernel_fn = arch.get_mlp_kernel(DEPTH, 1, "relu", w_std=1.3, b_std=0.3,
                                    last_w_std=1.0)

    @jax.jit
    def fused(x):
        # sym_t: flips the Gram's layout for the factorization instead of
        # copying it (snngp.ops.linalg.sym_t).
        k = kernel_fn(x, x, get="nngp")
        return jnp.linalg.cholesky(add_jitter(sym_t(k), EPS))

    fused_s, chol = _time(fused, x)

    gram_jit = jax.jit(lambda x: kernel_fn(x, x, get="nngp"))
    gram_s, k10 = _time(gram_jit, x)
    chol_jit = jax.jit(lambda k: jnp.linalg.cholesky(add_jitter(k, EPS)))
    chol_s, _ = _time(chol_jit, k10)
    from snngp.parallel.cholesky import blocked_cholesky
    bchol_jit = jax.jit(lambda k: blocked_cholesky(add_jitter(k, EPS), block=1024))
    bchol_s, _ = _time(bchol_jit, k10)

    # Layerwise self-execution baseline: per-layer jit boundaries (each
    # layer's [N, N] state round-trips through device memory as a separate
    # XLA computation) + separate Cholesky call — the monolithic structure
    # of spax/kernels.py:23-27. NOT a measurement of the reference stack.
    from snngp.nn.state import input_state
    stack = []
    for _ in range(DEPTH):
        stack.append(Dense(512, w_std=1.3, b_std=0.3))
        stack.append(Relu())
    stack.append(Dense(1, w_std=1.0))
    layer_fns = [jax.jit(l.kfn) for l in stack]

    def unfused(x):
        st = input_state(x, None)
        for f in layer_fns:
            st = f(st)
        return chol_jit(st.nngp)

    unfused_s, chol_ref = _time(unfused, x, iters=2)

    err = _rel_err(chol, chol_ref)
    assert err < 1e-4, f"fused/unfused mismatch: rel err {err}"

    result = {
        "metric": f"N={N} MLP-NNGP (depth {DEPTH}) Gram build + Cholesky wall-clock",
        "value": fused_s,
        "unit": "s",
        "vs_baseline": unfused_s / fused_s,
        "baseline_note": "vs layerwise self-execution (per-layer jit), not the reference stack",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": jax.device_count(), "nvidia_smi": card},
        "splits": {
            "gram_s": gram_s,
            "cholesky_xla_s": chol_s,
            "cholesky_blocked_s": bchol_s,
            "layerwise_total_s": unfused_s,
        },
    }
    if os.environ.get("SNNGP_BENCH_HEAVY", "1") != "0":
        result["heavy"] = _heavy_metrics()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
