"""Smoke run of snngp's main paths on NVIDIA GPUs, checked against plain
references.

    python chip_smoke.py            # one GPU: every phase below
    python chip_smoke.py --multi    # four GPUs: the mesh paths only, each
                                    # compared with its one-GPU result

One process runs everything; the CLI phases call ``run.main`` in-process.
One GPU, in order:

1. device: devices, ``nvidia-smi`` name and power limit, matmul precision;
2. regression: ``reg tr -m tp -dn syn-t`` then ``reg ts`` (CLI), then 5
   Adam steps of Student-t ML-II with MLP-NNGP depth 4 on seeded data at
   naval's train-split shape (9,546 x 16) through the library;
3. classification: ``cls tr -m svtp`` with ``-n cnn -nh 4`` and
   ``-n myrtle -nh 5`` on CIFAR-shaped ``synthetic32`` at the reference's
   budgets (``-nb 100 -ni 200 -ns 100 -nvs 1000``), each then ``cls ts``;
4. myrtle regression: Myrtle-5 32x32x3 Grams (2,048 train, 512 test) by the
   library tile assembler, Cholesky, Student-t predictive;
5. factorization: an N = 50,000 fp32 Gram factored by
   ``jnp.linalg.cholesky`` and ``inplace_blocked_cholesky``, log-determinant
   against the exact float64 value;
6. parity: fp32 Grams on the GPU against the same plain recursion in
   float64 on the host CPU (MLP 2,048 x 16 depth 4 relu/erf, a 64 x 64
   Myrtle-5 block at 32x32, a 128 x 128 CNN Gram at 32x32).

Exits non-zero, printing no result, when JAX's default backend is not the
GPU or when any phase fails. The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

import os
import sys

# The float64 references run on the host CPU backend; keep it beside the GPU
# when the environment names the platforms explicitly.
_plats = os.environ.get("JAX_PLATFORMS", "")
if _plats and "cpu" not in _plats.split(","):
    os.environ["JAX_PLATFORMS"] = _plats + ",cpu"

import glob  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
RUNS = os.path.join(HERE, ".runs", "chip_smoke")

# fp32 Grams at "highest" precision agree with float64 to ~1e-7 relative.
# Were float32 products run as TF32 (10-bit mantissa, unit roundoff ~5e-4),
# the first x.x^T moment alone would carry ~1e-4..1e-3 relative error and
# this bound would fail.
PARITY_RTOL = 1e-5
LOGDET_RTOL = 1e-4
MESH_RTOL = 1e-4


def result_line(devices) -> str:
    """The final JSON line: the first device's platform and kind, and the
    device count, as JAX reports them."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in float64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


class Phases:
    """Wall-clock per phase, printed as each ends."""

    def __init__(self):
        self.times = {}

    def run(self, name, fn, *args, **kwargs):
        print(f"== phase {name}", flush=True)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.times[name] = time.perf_counter() - t0
        print(f"== phase {name}: {self.times[name]:.1f} s", flush=True)
        return out


def _memory(dev):
    stats = dev.memory_stats() or {}
    return stats.get("bytes_in_use", 0), stats.get("peak_bytes_in_use", 0)


def _log_values(path, key):
    """Finite float values following ``key`` on the lines of a CLI log; the
    CLI logs a failing run's traceback and "Stopped" instead of raising."""
    with open(path) as f:
        text = f.read()
    if "Traceback" in text or "Stopped" in text:
        raise RuntimeError(f"{path} records a failed run:\n{text[-4000:]}")
    vals = [float(v) for v in re.findall(re.escape(key) + r"\s*(\S+)", text)]
    if not vals or not all(math.isfinite(v) for v in vals):
        raise RuntimeError(f"{path}: {key} values {vals} are not all finite")
    return vals


def _cli(args):
    import run
    print("   run.py " + " ".join(args), flush=True)
    run.main(args)


# ---------------------------------------------------------------------------
# one GPU
# ---------------------------------------------------------------------------

def phase_device():
    from snngp.utils.profiling import gpu_name_and_power_limit
    for d in jax.devices():
        print(f"   device {d.id}: {d.platform} {d.device_kind}")
    print(f"nvidia-smi: {gpu_name_and_power_limit()}")
    prec = jax.config.jax_default_matmul_precision
    print(f"   jax_default_matmul_precision: {prec}")
    if prec != "highest":
        raise RuntimeError(f"matmul precision is {prec!r}, not 'highest'")


def phase_regression(n=9546, d=16, steps=5):
    from snngp.models import SPR, NNGPKernel, StudentTLikelihood
    from snngp.nn import arch
    from snngp.utils import Adam

    ck = os.path.join(RUNS, "reg")
    _cli(["reg", "tr", "-m", "tp", "-dn", "syn-t", "-t", "40", "-pi", "20",
          "-vi", "20", "-eps", "1e-2", "-cr", ck, "-cn", "tp", "-q"])
    nll = _log_values(os.path.join(ck, "tp", "train.log"), "NLL:")
    print(f"   reg tr: valid NLL {nll}")
    _cli(["reg", "ts", "-cd", os.path.join(ck, "tp"), "-q"])
    nll = _log_values(os.path.join(ck, "tp", "test", "test.log"), "NLL:")
    print(f"   reg ts: test NLL {nll}")

    # Library ML-II at naval's train-split shape, seeded data.
    rng = np.random.RandomState(0)
    x = rng.randn(n, d).astype(np.float32)
    y = (np.sin(x[:, :4].sum(1)) + 0.1 * rng.standard_t(3, n)).astype(
        np.float32)

    def get_kernel_fn(w, b, l):
        return arch.get_mlp_kernel(4, act="relu", w_std=w, b_std=b,
                                   last_w_std=l)

    model = SPR(NNGPKernel(get_kernel_fn, 1.0, 0.1, 1.0),
                StudentTLikelihood(2.0, 2.0), jnp.asarray(x), jnp.asarray(y),
                0.0, 1.0, eps=1e-2)
    params = model.init_params()
    opt = Adam()
    state = opt.init(params)

    @jax.jit
    def step(params, state):
        loss, grads = jax.value_and_grad(model.loss)(params)
        params, state = opt.update(grads, state, params, 1e-2)
        return params, state, loss

    times, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, state, loss = jax.block_until_ready(step(params, state))
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"ML-II losses {losses}")
    _, peak = _memory(jax.devices()[0])
    print(f"   ML-II N={n} d={d} depth 4: losses {losses}")
    print(f"   ML-II step: first (compile) {times[0]:.3f} s, steady "
          f"{min(times[1:]):.4f} s (min of {steps - 1}); peak device memory "
          f"{peak / 2**30:.2f} GiB")


def phase_classification(networks=(("cnn", "4"), ("myrtle", "5")),
                         extra=("-nb", "100", "-ni", "200", "-ns", "100",
                                "-nvs", "1000", "-e", "1", "-nd", "1000"),
                         test_extra=("-nd", "200")):
    for net, nh in networks:
        ck = os.path.join(RUNS, "cls")
        _cli(["cls", "tr", "-m", "svtp", "-n", net, "-nh", nh, "-dn",
              "synthetic32", *extra, "-cr", ck, "-cn", net, "-q"])
        nelbo = _log_values(os.path.join(ck, net, "train.log"), "nELBO:")
        nll = _log_values(os.path.join(ck, net, "train.log"), "NLL:")
        print(f"   cls tr -n {net}: nELBO {nelbo} valid NLL {nll}")
        _cli(["cls", "ts", "-dn", "synthetic32", "-cd", os.path.join(ck, net),
              *test_extra, "-q"])
        (log,) = glob.glob(os.path.join(ck, net, "test", "*.log"))
        nll = _log_values(log, "NLL:")
        acc = _log_values(log, "ACC:")
        print(f"   cls ts -n {net}: test NLL {nll} ACC {acc}")
        _, peak = _memory(jax.devices()[0])
        print(f"   peak device memory so far {peak / 2**30:.2f} GiB")


def phase_myrtle_regression(n_train=2048, n_test=512, size=32, tile=16,
                            chunk=16, full_n=50000):
    from snngp.models import SPR, NNGPKernel, StudentTLikelihood, fit_spr
    from snngp.nn import arch
    from snngp.nn.full import tiled_gram

    # Standardized pixels; targets are the standardized mean pixel plus
    # noise, so the predictive has something to predict.
    rng = np.random.RandomState(1)
    x = rng.randn(n_train + n_test, size, size, 3).astype(np.float32)
    m = x.mean(axis=(1, 2, 3))
    y = ((m - m.mean()) / m.std() + 0.1 * rng.randn(m.size)).astype(
        np.float32)
    xt, xs = jnp.asarray(x[:n_train]), jnp.asarray(x[n_train:])
    hyper = dict(w_std=1.0, b_std=0.1, last_w_std=1.0)
    kfn = arch.get_myrtle_kernel(5, 1, "relu", **hyper)

    asm = dict(tile=tile, chunk=chunk)
    t0 = time.perf_counter()
    k_dd = tiled_gram(kfn, xt, **asm)
    k_td = tiled_gram(kfn, xs, xt, **asm)
    k_tt = tiled_gram(kfn, xs, **asm)
    t_asm = time.perf_counter() - t0
    t0 = time.perf_counter()
    k_td2 = tiled_gram(kfn, xs, xt, **asm)                 # compiled
    t_cross = time.perf_counter() - t0
    blocks = lambda m: -(-m // tile)
    cross = blocks(n_test) * blocks(n_train) * tile * tile
    print(f"   Myrtle-5 {size}x{size}: N_train={n_train}, N_test={n_test} "
          f"(cut from the workload's {full_n:,} to fit a smoke run)")
    print(f"   three Grams assembled in {t_asm:.2f} s incl. compile; cross "
          f"Gram again: {t_cross:.2f} s for {cross:,} pairs = "
          f"{t_cross / cross * 1e6:.3f} us/pair (tile {tile}, chunk {chunk})")
    if not np.array_equal(k_td, k_td2):
        raise RuntimeError("cross Gram differs between two assemblies")

    y_t = jnp.asarray(y[:n_train])
    eps = 1e-4
    model = SPR(NNGPKernel(lambda w, b, l: arch.get_myrtle_kernel(
        5, 1, "relu", w_std=w, b_std=b, last_w_std=l), **hyper),
        StudentTLikelihood(2.0, 2.0), xt, y_t, 0.0, 1.0,
        eps=eps / (float(np.trace(k_dd)) / n_train))
    t0 = time.perf_counter()
    fitted = fit_spr(model, model.init_params(), gram=k_dd, var_floor=1e-6,
                     t_jitter=1e-4)
    mean, var = fitted.predict_given(jnp.asarray(k_td),
                                     jnp.asarray(np.diagonal(k_tt)))
    nll = fitted.test_nll_given(jnp.asarray(k_td),
                                jnp.asarray(np.diagonal(k_tt)),
                                jnp.asarray(y[n_train:]))
    jax.block_until_ready((mean, var, nll))
    t_fit = time.perf_counter() - t0
    ok = (mean.shape == (n_test,) and np.all(np.isfinite(np.asarray(mean)))
          and np.all(np.asarray(var) > 0) and math.isfinite(float(nll)))
    if not ok:
        raise RuntimeError(f"Myrtle predictive: nll {float(nll)}")
    print(f"   Cholesky + Student-t predictive {t_fit:.2f} s; "
          f"test NLL {float(nll):.4f}")


def phase_factorization(n=50000, r=64):
    from snngp.parallel.cholesky import inplace_blocked_cholesky

    x = jax.random.normal(jax.random.PRNGKey(11), (n, r), jnp.float32)
    x = x / np.sqrt(r)
    xh = np.asarray(x, np.float64)
    # det(I_n + X X^T) = det(I_r + X^T X): the matrix determinant lemma.
    _, exact = np.linalg.slogdet(np.eye(r) + xh.T @ xh)
    build = jax.jit(lambda x: x @ x.T + jnp.eye(n, dtype=jnp.float32))
    logdet = lambda diag: 2.0 * float(np.sum(np.log(
        np.asarray(diag, np.float64))))
    xla = jax.jit(lambda k: jnp.diagonal(jnp.linalg.cholesky(k)))
    inplace = jax.jit(inplace_blocked_cholesky, donate_argnums=0)

    for name, fn in (("jnp.linalg.cholesky", xla),
                     ("inplace_blocked_cholesky",
                      lambda k: jnp.diagonal(inplace(k)))):
        times = []
        for _ in range(2):                      # compile, then timed
            k = jax.block_until_ready(build(x))
            t0 = time.perf_counter()
            diag = jax.block_until_ready(fn(k))
            times.append(time.perf_counter() - t0)
            del k
        rel = abs(logdet(diag) - exact) / abs(exact)
        print(f"   N={n} {name}: {times[1]:.3f} s (first call "
              f"{times[0]:.3f} s), logdet rel err {rel:.2e}")
        if not rel <= LOGDET_RTOL:
            raise RuntimeError(f"{name} logdet rel err {rel:.2e}")


def _f64_on_host(kfn, a, b, rows=None):
    """kfn(a, b) in float64 through JAX on the host CPU.

    With ``rows``, row strips of ``a`` run in parallel threads: XLA's CPU
    backend runs each call's elementwise loops on one core, and a float64
    Myrtle pair at 32x32 costs tens of milliseconds there."""
    from concurrent.futures import ThreadPoolExecutor

    cpu = jax.devices("cpu")[0]
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    rows = rows or a.shape[0]
    f = jax.jit(lambda p, q: kfn(p, q))

    def strip(i):
        # JAX's config contexts are per thread: enter them in each worker
        with jax.enable_x64(True), jax.default_device(cpu):
            out = f(a[i:i + rows], b)
            assert out.dtype == np.float64, out.dtype
            return np.asarray(out)

    with ThreadPoolExecutor(min(16, os.cpu_count() or 1)) as pool:
        return np.concatenate(list(pool.map(
            strip, range(0, a.shape[0], rows))))


def phase_parity(n_mlp=2048, d=16, n_myrtle=64, n_cnn=128, size=32):
    from snngp.nn import arch
    from snngp.nn.reference import cnn_gram_f64

    rng = np.random.RandomState(2)
    hp = dict(w_std=1.3, b_std=0.3, last_w_std=1.1)
    x = rng.randn(n_mlp, d).astype(np.float32)
    a = rng.rand(n_myrtle, size, size, 3).astype(np.float32)
    b = rng.rand(n_myrtle, size, size, 3).astype(np.float32)
    c = rng.randn(n_cnn, size, size, 3).astype(np.float32)
    f64 = lambda kfn, rows=None: lambda p, q: _f64_on_host(kfn, p, q, rows)
    cases = []
    for act in ("relu", "erf"):
        kfn = arch.get_mlp_kernel(4, 1, act, **hp)
        cases.append((f"MLP {n_mlp}x{d} depth 4 {act}", kfn, f64(kfn), x, x))
    kfn = arch.get_myrtle_kernel(5, 1, "relu", **hp)
    cases.append((f"Myrtle-5 {n_myrtle}x{n_myrtle} {size}x{size}", kfn,
                  f64(kfn, rows=1), a, b))
    # XLA's CPU backend crashes on this float64 conv graph, so the CNN's
    # host reference is the numpy enumeration of the same recursion.
    cases.append((f"CNN {n_cnn}x{n_cnn} {size}x{size} depth 4",
                  arch.get_cnn_kernel(4, 1, "relu", **hp),
                  lambda p, q: cnn_gram_f64(
                      np.asarray(p, np.float64), np.asarray(q, np.float64),
                      4, "relu", hp["w_std"], hp["b_std"], hp["last_w_std"]),
                  c, c))

    for name, kfn, ref, p, q in cases:
        got = jax.jit(lambda p, q: kfn(p, q))(jnp.asarray(p), jnp.asarray(q))
        t0 = time.perf_counter()
        err = rel_err(got, ref(p, q))
        print(f"   parity {name}: rel err {err:.2e} vs float64 (host, "
              f"{time.perf_counter() - t0:.1f} s)")
        if not err <= PARITY_RTOL:
            raise RuntimeError(f"{name}: rel err {err:.2e} > {PARITY_RTOL}")


# ---------------------------------------------------------------------------
# four GPUs (--multi)
# ---------------------------------------------------------------------------

def _describe(name, arr):
    print(f"   {name}: shape {arr.shape} sharding {arr.sharding}")


def _per_device_memory():
    for dev in jax.devices():
        used, peak = _memory(dev)
        print(f"   device {dev.id}: {used / 2**30:.2f} GiB in use, peak "
              f"{peak / 2**30:.2f} GiB")


def _check_close(name, got, want, rtol=MESH_RTOL):
    """Norm-wise: max |got - want| over all leaves of the pytree, over
    max |want|. A per-leaf ratio would amplify fp32 noise in a gradient
    component that is near zero (the Student-t a, b gradients at the
    initial point are ~1e-4 of the largest)."""
    got = np.concatenate([np.ravel(g) for g in jax.tree_util.tree_leaves(got)])
    want = np.concatenate([np.ravel(w)
                           for w in jax.tree_util.tree_leaves(want)])
    err = rel_err(got, want)
    if not err <= rtol:
        raise RuntimeError(f"{name}: mesh vs one device rel err "
                           f"{err:.2e} > {rtol}")
    print(f"   {name}: mesh vs one device rel err {err:.2e} (<= {rtol})")


def multi_regression(mesh, n=4096, d=16):
    from functools import partial

    from snngp.models import SPR, NNGPKernel, StudentTLikelihood
    from snngp.nn import arch
    from snngp.parallel.cholesky import blocked_cholesky

    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(n, d), jnp.float32)
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0]), jnp.float32)

    def make(mesh_, chol_fn):
        kernel = NNGPKernel(lambda w, b, l: arch.get_mlp_kernel(
            4, act="relu", w_std=w, b_std=b, last_w_std=l), 1.0, 0.1, 1.0)
        model = SPR(kernel, StudentTLikelihood(2.0, 2.0, chol_fn=chol_fn),
                    x, y, 0.0, 1.0, eps=1e-2)
        model.mesh = mesh_
        return model

    one = make(None, None)
    multi = make(mesh, partial(blocked_cholesky, block=512))
    params = one.init_params()
    want = jax.jit(jax.value_and_grad(one.loss))(params)
    got = jax.jit(jax.value_and_grad(multi.loss))(params)
    gram = jax.jit(lambda p: multi._gram(
        multi.kernel.get_kernel_fn(p["kernel"])))(params)
    _describe("SPR train Gram (mesh)", gram)
    print(f"   SPR ML-II loss: mesh {float(got[0]):.6f}, one device "
          f"{float(want[0]):.6f}")
    _check_close("SPR ML-II loss", got[0], want[0])
    _check_close("SPR ML-II gradients", got[1], want[1])


def multi_myrtle(mesh, n_train=2048, n_test=512, size=32, block=512):
    from jax.scipy.linalg import cho_solve, solve_triangular
    from jax.scipy.stats import t as t_dist

    from snngp.nn import arch
    from snngp.ops.linalg import add_jitter, chol_quad_form
    from snngp.parallel import sharded_gram
    from snngp.parallel.cholesky import cyclic_cholesky

    # Standardized pixels and a noise variance of 0.1 keep the Gram well
    # conditioned, so the two factorizations agree to fp32 accuracy rather
    # than to cond(K) * eps; targets that depend on the images (their
    # standardized mean pixel) give a predictive mean of order one. The NLL
    # is the per-point (marginal) Student-t score, as the library's
    # predictor reports it, so no near-singular [n_test, n_test] log-det
    # enters the comparison.
    rng = np.random.RandomState(5)
    xh = rng.randn(n_train + n_test, size, size, 3).astype(np.float32)
    m = xh[:n_train].mean(axis=(1, 2, 3))
    x = jnp.asarray(xh)
    y = jnp.asarray((m - m.mean()) / m.std(), jnp.float32)
    kfn = arch.get_myrtle_kernel(5, 1, "relu", w_std=1.0, b_std=0.1,
                                 last_w_std=1.0)
    xt, xs = x[:n_train], x[n_train:]
    df, eps = 4.0, 0.1

    def predictive(chol, k_td, k_tt_diag):
        mean = k_td @ cho_solve((chol, True), y)
        v = solve_triangular(chol, k_td.T, lower=True)
        var = k_tt_diag + eps - jnp.sum(v * v, axis=0)
        d = df + chol_quad_form(chol, y)
        scale = jnp.sqrt(d / (df + n_train) * var)
        nll = -jnp.mean(t_dist.logpdf(jnp.zeros(n_test), df + n_train,
                                      mean, scale))
        return mean, nll

    @jax.jit
    def mesh_pipeline(xt, xs):
        k_dd = sharded_gram(kfn, xt, mesh)
        k_td = sharded_gram(kfn, xs, mesh, x2=xt)
        chol = cyclic_cholesky(add_jitter(k_dd, eps), mesh, block=block)
        mean, nll = predictive(chol, k_td, jnp.diagonal(kfn(xs, xs)))
        return k_dd, mean, nll

    @jax.jit
    def single_pipeline(xt, xs):
        k_dd = kfn(xt, xt)
        chol = jnp.linalg.cholesky(add_jitter(k_dd, eps))
        mean, nll = predictive(chol, kfn(xs, xt), jnp.diagonal(kfn(xs, xs)))
        return k_dd, mean, nll

    t0 = time.perf_counter()
    k_m, mean_m, nll_m = jax.block_until_ready(mesh_pipeline(xt, xs))
    t_m = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev0 = jax.devices()[0]
    k_s, mean_s, nll_s = jax.block_until_ready(single_pipeline(
        jax.device_put(xt, dev0), jax.device_put(xs, dev0)))
    t_s = time.perf_counter() - t0
    _describe("Myrtle-5 train Gram (mesh)", k_m)
    _describe("predictive mean (mesh)", mean_m)
    print(f"   Myrtle-5 {size}x{size} N_train={n_train} N_test={n_test}: "
          f"mesh {t_m:.1f} s, one device {t_s:.1f} s (both incl. compile); "
          f"NLL mesh {float(nll_m):.5f} one {float(nll_s):.5f}")
    _check_close("Myrtle-5 Gram", k_m, k_s)
    _check_close("Myrtle-5 predictive mean", mean_m, mean_s)
    _check_close("Myrtle-5 predictive NLL", nll_m, nll_s)


def multi_svsp(mesh, batch=100, inducing=200, size=32, num_class=10):
    from jax.sharding import NamedSharding, PartitionSpec

    from snngp.models import SVSP, NNGPKernel, InverseGammaPrior
    from snngp.nn import arch

    rng = np.random.RandomState(6)
    z = rng.randn(inducing, size, size, 3).astype(np.float32)
    xb = jnp.asarray(rng.randn(batch, size, size, 3), jnp.float32)
    yb = jnp.asarray(rng.randint(num_class, size=batch))

    def gkf(w, b, l):
        return arch.get_cnn_kernel(4, num_class, "relu", w_std=w, b_std=b,
                                   last_w_std=l)

    model = SVSP(InverseGammaPrior(2.0, 2.0), NNGPKernel(gkf, 1.0, 0.3, 1.0),
                 z, num_latent_gps=num_class, eps=1e-4)
    params = model.init_params()
    key = jax.random.PRNGKey(0)
    step = jax.jit(jax.value_and_grad(
        lambda p, xb, yb: model.loss(p, key, xb, yb, 1000, 100)))
    want = step(params, xb, yb)
    row = NamedSharding(mesh, PartitionSpec("data"))
    xs, ys = jax.device_put(xb, row), jax.device_put(yb, row)
    _describe("SVSP batch (mesh)", xs)
    got = step(params, xs, ys)
    print(f"   SVSP nELBO: mesh {float(got[0]):.6f}, one device "
          f"{float(want[0]):.6f}")
    _check_close("SVSP nELBO", got[0], want[0])
    _check_close("SVSP gradients", got[1], want[1])


# ---------------------------------------------------------------------------

def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run the four-GPU mesh paths (and what they are "
                         "compared with) instead of the one-GPU phases")
    args = ap.parse_args(argv)
    # run.py parses its pre-flags from sys.argv when imported
    sys.argv = sys.argv[:1]

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX's default backend is "
              f"'{devices[0].platform}', not the GPU", file=sys.stderr)
        return 1

    import snngp  # noqa: F401  (precision and compile-cache settings)

    shutil.rmtree(RUNS, ignore_errors=True)
    os.makedirs(RUNS)
    phases = Phases()
    phases.run("device", phase_device)
    if args.multi:
        from snngp.parallel import get_mesh
        if len(devices) < 4:
            raise RuntimeError(f"--multi needs 4 GPUs, found {len(devices)}")
        mesh = get_mesh(4)
        phases.run("multi_regression", multi_regression, mesh)
        phases.run("multi_myrtle", multi_myrtle, mesh)
        phases.run("multi_svsp", multi_svsp, mesh)
        _per_device_memory()
    else:
        phases.run("regression", phase_regression)
        phases.run("classification", phase_classification)
        phases.run("myrtle_regression", phase_myrtle_regression)
        phases.run("factorization", phase_factorization)
        phases.run("parity", phase_parity)
    print("phase times (s): " + json.dumps(
        {k: round(v, 1) for k, v in phases.times.items()}))
    print(result_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
