"""Paper-figure reproduction (reference ``sample.ipynb``, component C18).

Prior/posterior correspondence between finite-network ensembles with an
inverse-gamma-mixed last-layer scale and the analytic NNGP/NTK Student-t
predictive:

- ``draw_sinx``: exact NNGP posterior (Gaussian) vs the conditional Student-t
  posterior with df = 2 alpha + N and data-dependent scale (notebook cell 3).
- ``draw_corr(part)``: ensemble of finite nets (last-layer scale sampled as
  sqrt(InvGamma(alpha, beta))) under {initial | last-layer-trained |
  full-trained} vs the Student-t marginal predicted by the scale-mixture
  theory at matching (nngp | nngp-posterior | ntk-posterior) covariance
  (notebook cells 1-2, 9).

Everything runs on the snngp engine (no neural_tangents). Run as a script to
write PNGs + print the per-figure ensemble-vs-analytic correspondence
(Kolmogorov-Smirnov statistic) — the numeric check the notebook does by eye.
"""

from __future__ import annotations

import os
import sys

# Allow `python examples/paper_figures.py` without installing the package.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from scipy import stats as osp

import jax
import jax.numpy as jnp
from jax import random

from snngp.nn import layers as L
from snngp.ops import gp_predict
from snngp.ops.linalg import add_jitter

WIDTH = 512


def target_fn(x):
    return jnp.sin(x)


def _erf_net(last_w_std, w_std=8.0, b_std=0.05, width=WIDTH):
    return L.serial(
        L.Dense(width, w_std=w_std, b_std=b_std), L.Erf(),
        L.Dense(width, w_std=w_std, b_std=b_std), L.Erf(),
        L.Dense(width, w_std=w_std, b_std=b_std), L.Erf(),
        L.Dense(1, w_std=last_w_std),
    )


def _kernel_fn(w_std=8.0, b_std=0.05, last_w_std=1.0):
    return L.kernel_fn_of(_erf_net(last_w_std, w_std, b_std))


def _sample_last_scale(key, alpha, beta):
    """sigma = sqrt(InvGamma(alpha, beta)) (notebook sample_network)."""
    return jnp.sqrt(beta / random.gamma(key, a=alpha))


def _make_dataset(seed=10, train_num=5, test_num=40, noise_scale=0.1):
    key = random.PRNGKey(seed)
    key, x_key, y_key = random.split(key, 3)
    start, stop = -np.pi, np.pi
    x_train = random.uniform(x_key, minval=start, maxval=stop, shape=(train_num, 1))
    y_train = target_fn(x_train) + noise_scale * random.normal(y_key, (train_num, 1))
    x_test = jnp.linspace(start, stop, num=test_num)[:, None]
    return key, x_train, y_train, x_test, target_fn(x_test)


# ---------------------------------------------------------------------------
# Finite-network ensemble members
# ---------------------------------------------------------------------------

def _init_net(key, alpha, beta, width=WIDTH):
    key_s, key_p = random.split(key)
    sigma = _sample_last_scale(key_s, alpha, beta)
    net = _erf_net(sigma, width=width)
    _, params = net.init(key_p, (-1, 1))
    return net, params


def sample_network(key, alpha, beta, x_test, width=WIDTH):
    net, params = _init_net(key, alpha, beta, width)
    return net.apply(params, x_test)


def _sgd_train(net, params, x_train, y_train, steps, lr, last_only):
    def loss(p):
        return 0.5 * jnp.mean((net.apply(p, x_train) - y_train) ** 2)

    grad_fn = jax.grad(loss)

    def body(p, _):
        g = grad_fn(p)
        if last_only:
            g = tuple(jax.tree.map(lambda a: a * 0.0, gi) if i < len(g) - 1 else gi
                      for i, gi in enumerate(g))
        p = jax.tree.map(lambda a, b: a - lr * b, p, g)
        return p, None

    params, _ = jax.lax.scan(body, params, None, length=steps)
    return params


def trained_network(key, alpha, beta, x_train, y_train, x_test, steps, lr,
                    last_only, width=WIDTH):
    net, params = _init_net(key, alpha, beta, width)
    params = _sgd_train(net, params, x_train, y_train, steps, lr, last_only)
    return net.apply(params, x_test)


# ---------------------------------------------------------------------------
# Figures
# ---------------------------------------------------------------------------

def draw_sinx(train_num=5, test_num=40, alpha=1.0, beta=1.0, seed=10,
              noise_scale=0.1):
    """GP vs conditional Student-t posterior on y = sin x (notebook cell 3)."""
    _, x_train, y_train, x_test, y_test = _make_dataset(seed, train_num,
                                                        test_num, noise_scale)
    kfn = _kernel_fn(w_std=1.0, b_std=0.05)
    mean, cov = gp_predict(kfn, x_train, y_train, x_test, diag_reg=1e-4)
    mean = np.asarray(mean).reshape(-1)
    std = np.sqrt(np.diag(np.asarray(cov)))

    k_tr = np.asarray(kfn(x_train, x_train, get="nngp"))
    nu = 2 * alpha + train_num
    y = np.asarray(y_train)
    d = nu + float(y.T @ np.linalg.solve(k_tr + 1e-4 * np.eye(train_num), y))
    p = nu + train_num
    t_std = np.sqrt(np.diag(beta / alpha * d / p * np.asarray(cov)))

    return dict(x_train=np.asarray(x_train), y_train=np.asarray(y_train),
                x_test=np.asarray(x_test).reshape(-1),
                y_test=np.asarray(y_test).reshape(-1),
                gp_mean=mean, gp_std=std, t_mean=mean, t_std=t_std, nu=nu)


def draw_corr(part, train_num=5, test_num=40, alpha=1.0, beta=1.0, seed=10,
              noise_scale=0.1, learning_rate=1e-3, ensemble_size=500,
              train_steps=10000, map_batch=50, width=WIDTH):
    """Ensemble marginal at a test point vs the analytic Student-t
    (notebook cells 1-2): part in {initial, last, full}."""
    key, x_train, y_train, x_test, _ = _make_dataset(seed, train_num,
                                                     test_num, noise_scale)
    nu = 2 * alpha

    if part == "initial":
        kfn = _kernel_fn(last_w_std=1.0)
        mu = jnp.zeros(test_num)
        cov = beta / alpha * kfn(x_test, x_test, get="nngp")
    elif part == "last":
        kfn = _kernel_fn()
        mean, cov1 = gp_predict(kfn, x_train, y_train, x_test, diag_reg=1e-4)
        mu, cov = mean.flatten(), beta / alpha * cov1
    elif part == "full":
        # NTK-mode posterior: gradient-descent-trained ensemble converges to
        # the NTK predictive (notebook uses get="ntk").
        kfn = _kernel_fn()
        theta_dd = kfn(x_train, x_train, get="ntk")
        theta_td = kfn(x_test, x_train, get="ntk")
        k_tt = kfn(x_test, x_test, get="nngp")
        k_td = kfn(x_test, x_train, get="nngp")
        k_dd = kfn(x_train, x_train, get="nngp")
        a = jnp.linalg.solve(add_jitter(theta_dd, 1e-4 * jnp.trace(theta_dd) / train_num),
                             jnp.eye(train_num))
        mu = (theta_td @ a @ y_train).flatten()
        m = theta_td @ a
        cov1 = (k_tt - m @ k_td.T - k_td @ m.T + m @ k_dd @ m.T)
        cov = beta / alpha * cov1
    else:
        raise ValueError(part)

    std = jnp.sqrt(jnp.diag(cov))

    keys = random.split(key, ensemble_size)
    if part == "initial":
        fn = lambda k: sample_network(k, alpha, beta, x_test, width)
    else:
        fn = lambda k: trained_network(k, alpha, beta, x_train, y_train, x_test,
                                       train_steps, learning_rate,
                                       last_only=(part == "last"), width=width)
    # Host-chunked vmap: one device dispatch per map_batch members, which
    # bounds the memory of the vmapped training loops and reports progress
    # per chunk instead of one computation of members x train_steps.
    bs = min(map_batch, ensemble_size)
    vfn = jax.jit(jax.vmap(fn))
    chunks = [np.asarray(vfn(keys[i:i + bs]))
              for i in range(0, ensemble_size, bs)]
    samples = np.squeeze(np.concatenate(chunks), axis=2).T  # [test_num, S]

    return dict(samples=samples, nu=nu, mu=np.asarray(mu),
                std=np.asarray(std))


def ks_correspondence(result, idx):
    """KS statistic between ensemble marginal and the analytic Student-t."""
    s = result["samples"][idx]
    return osp.kstest(
        s, "t", args=(result["nu"], result["mu"][idx], result["std"][idx])
    ).statistic


def main(outdir="figures", ensemble_size=500, train_steps=10000, map_batch=50,
         width=WIDTH):
    import os
    os.makedirs(outdir, exist_ok=True)

    sinx = draw_sinx(alpha=2.0, beta=2.0)
    print(f"sinx: GP std[20]={sinx['gp_std'][20]:.4f}  "
          f"t std[20]={sinx['t_std'][20]:.4f}  (nu={sinx['nu']})")

    results = {}
    for part, a, b in [("initial", 2.0, 2.0), ("last", 2.0, 2.0),
                       ("full", 1.0, 1.0)]:
        r = draw_corr(part, alpha=a, beta=b, ensemble_size=ensemble_size,
                      train_steps=train_steps, map_batch=map_batch, width=width)
        idx = 21 if part != "last" else 20
        ks = ks_correspondence(r, idx)
        print(f"{part:8s}: KS(ensemble, analytic t) at test idx {idx}: {ks:.4f}")
        results[part] = (r, idx, ks)

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 5, figsize=(17.5, 3.5))
        ax = axes[0]
        ax.scatter(sinx["x_train"], sinx["y_train"], color="r")
        ax.plot(sinx["x_test"], sinx["y_test"], "k--", label="sin x")
        ax.plot(sinx["x_test"], sinx["gp_mean"], "g", label="Gaussian")
        ax.fill_between(sinx["x_test"], sinx["gp_mean"] - 2 * sinx["gp_std"],
                        sinx["gp_mean"] + 2 * sinx["gp_std"], color="g", alpha=0.1)
        ax.legend(loc="upper left")
        ax = axes[1]
        ax.scatter(sinx["x_train"], sinx["y_train"], color="r")
        ax.plot(sinx["x_test"], sinx["y_test"], "k--", label="sin x")
        ax.plot(sinx["x_test"], sinx["t_mean"], "g", label="Student's t")
        ax.fill_between(sinx["x_test"], sinx["t_mean"] - 2 * sinx["t_std"],
                        sinx["t_mean"] + 2 * sinx["t_std"], color="g", alpha=0.1)
        ax.legend(loc="upper left")

        for axi, (part, (r, idx, _)) in zip(axes[2:], results.items()):
            u = np.linspace(-10, 10, 200)
            axi.hist(r["samples"][idx], bins=40, density=True, alpha=0.6,
                     label="Sampled")
            axi.plot(u, osp.t.pdf(u, r["nu"], loc=r["mu"][idx],
                                  scale=r["std"][idx]),
                     linewidth=3, label="Predicted")
            axi.set_title(part)
            axi.legend(loc="upper right")
        fig.tight_layout()
        path = os.path.join(outdir, "corr.png")
        fig.savefig(path, dpi=120)
        print(f"wrote {path}")
    except ImportError:
        print("matplotlib unavailable; skipped figure rendering")


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="figures")
    ap.add_argument("--ensemble-size", type=int, default=500)
    ap.add_argument("--train-steps", type=int, default=10000)
    ap.add_argument("--map-batch", type=int, default=50,
                    help="ensemble members per vmapped device call")
    ap.add_argument("--width", type=int, default=WIDTH,
                    help="finite-network width (512 = notebook; wider "
                         "shrinks the finite-width gap the KS test detects)")
    a = ap.parse_args()
    main(a.outdir, a.ensemble_size, a.train_steps, a.map_batch, a.width)
