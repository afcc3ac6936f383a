"""Burr-XII importance-sampling hyperparameter grid search (regression `find`).

Rebuilds ``experiments/regression/find.py``: for each (w_std, b_std) the NNGP
train Gram is built once; for each eps the exact GP predictive is formed; the
Gaussian NLL is scored directly, and for each (alpha, beta) the Student-t
predictive NLL is estimated by self-normalized importance sampling over the
Burr-XII mixing scale q.

Differences from the reference (numerics preserved):

- The Burr-XII draws stay host-side scipy with ``random_state=101`` (parity
  with the reference's MT19937 stream, ``find.py:172``), but the entire
  (alpha, beta, q) lattice NLL evaluation is vectorized into one jitted
  device computation instead of a nested Python loop with per-draw host
  chatter (``find.py:169-191``).
- ``inv`` / scipy mvn logpdf are replaced by one Cholesky shared by the
  quadratic form and the log-determinant.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.nn import logsumexp
from jax.scipy import stats

from scipy import stats as scipy_stats

from snngp.data.regression import DATASETS
from snngp.ops import gp_predict
from snngp.ops.linalg import chol_logdet, chol_quad_form
from snngp.utils import Logger, get_context_summary

WSL = [1, 1.4, 2]
BSL = [0, 0.3, 1]
EL = [float(f"1e{v}") for v in range(-6, 5)]
AL = [1, 2, 3]
BL = [1, 2, 3]


def add_subparser(subparsers):
    parser = subparsers.add_parser("find", aliases=["fd"])
    parser.set_defaults(func=main)

    parser.add_argument("-n",   "--network",     choices=["resnet", "mlp"], default=None)
    parser.add_argument("-dn",  "--data-name",   choices=DATASETS, required=True)
    parser.add_argument("-dr",  "--data-root",   type=str, default="./data")
    parser.add_argument("-cd",  "--ckpt-dir",    type=str, required=True)

    parser.add_argument("-vp",  "--valid-prop",  type=float, default=0.1)
    parser.add_argument("-nd",  "--num-data",    type=int, default=None)

    parser.add_argument("-al",  "--alpha-list",  type=float, nargs="+", default=AL)
    parser.add_argument("-bl",  "--beta-list",   type=float, nargs="+", default=BL)
    parser.add_argument("-el",  "--eps-list",    type=float, nargs="+", default=EL)

    parser.add_argument("-nh",  "--num-hiddens", type=int, default=4)
    parser.add_argument("-act", "--activation",  choices=["erf", "relu"], default="relu")
    parser.add_argument("-wsl", "--w-std-list",  type=float, nargs="+", default=WSL)
    parser.add_argument("-bsl", "--b-std-list",  type=float, nargs="+", default=BSL)

    parser.add_argument("-ns",  "--num-is-samples", type=int, default=1000)
    parser.add_argument("-smp", "--sampler",     choices=["scipy", "device"],
                        default="scipy",
                        help="Burr-XII mixing draws: host scipy (stream-parity "
                             "with the reference, find.py:172) or on-device "
                             "inverse-CDF (whole alpha/beta lattice vectorized)")
    parser.add_argument("-s",   "--seed",        type=int, default=10)
    parser.add_argument("-q",   "--quite",       default=False, action="store_true")
    parser.add_argument("-c",   "--comment",     type=str, default="")


def _format_table(table, rows, cols):
    """(alpha x beta) NLL table as aligned text: beta across, alpha down."""
    cells = [[""] + [str(c) for c in cols]]
    cells += [[str(r)] + [f"{v:.4f}" for v in row]
              for r, row in zip(rows, np.asarray(table, np.float64))]
    width = max(len(c) for line in cells for c in line)
    return "\n".join(" ".join(c.rjust(width) for c in line) for line in cells)


@jax.jit
def _gaussian_nll(y, mean, cov):
    sigma = jnp.sqrt(jnp.diag(cov))
    return -jnp.mean(stats.norm.logpdf(y, mean, sigma))


def _burr12_icdf(u, c, d):
    """Burr-XII inverse CDF: x = ((1-u)^(-1/d) - 1)^(1/c)."""
    return ((1.0 - u) ** (-1.0 / d) - 1.0) ** (1.0 / c)


@functools.partial(jax.jit, static_argnums=(3,))
def _tnll_lattice_device(key, alphas, betas, num_samples, quad, logdet_term,
                         num_train, y_, mean_, std_diag, y_std):
    """Full (alpha, beta) lattice of Student-t predictive NLLs in one jitted
    computation: device Burr-XII draws + self-normalized importance weights.
    Replaces the reference's per-cell host loop (find.py:169-191)."""
    u = jax.random.uniform(key, (num_samples,), minval=1e-7, maxval=1.0 - 1e-7)

    def cell(a, b):
        q = _burr12_icdf(u, a, b)
        lp = (logdet_term - 0.5 * quad / q - 0.5 * num_train * jnp.log(q))
        w = jnp.exp(lp - jnp.max(lp))
        w_bar = w / jnp.sum(w)
        std = jnp.sqrt(q)[:, None] * std_diag[None, :]
        log_probs = jnp.log(w_bar + 1e-24)[:, None] + stats.norm.logpdf(
            y_, mean_, std * y_std)
        return -jnp.mean(logsumexp(log_probs, axis=0))

    return jax.vmap(lambda a: jax.vmap(lambda b: cell(a, b))(betas))(alphas)


@jax.jit
def _tnll_lattice(sample_q, log_prior_over_q, quad, logdet_term, num_train,
                  y_, mean_, std_diag, y_std):
    """Vectorized Student-t predictive NLL for one (alpha, beta) cell.

    sample_q: [S] Burr-XII mixing draws; quad: y^T (K+eps I)^{-1} y;
    logdet_term: -(1/2) log det(K+eps I) - (N/2) log 2pi.
    """
    minus_quad_half = -0.5 * quad
    log_prob_data = (logdet_term + minus_quad_half / sample_q
                     - 0.5 * num_train * jnp.log(sample_q))
    prob_data = jnp.exp(log_prob_data - jnp.max(log_prob_data))
    w = prob_data * log_prior_over_q  # prior pdf / proposal pdf == 1 elementwise
    w_bar = w / jnp.sum(w)
    std = jnp.sqrt(sample_q)[:, None] * std_diag[None, :]
    log_probs = jnp.log(w_bar + 1e-24)[:, None] + stats.norm.logpdf(
        y_, mean_, std * y_std)
    return -jnp.mean(logsumexp(log_probs, axis=0))


def main(args):
    logger = Logger(args.ckpt_dir, quite=args.quite)
    logger.log(get_context_summary(args, {}))

    try:
        from snngp.cli.regression import _load_splits, _resolve_network

        (x_train, y_train), (x_valid, y_valid), (x_test, y_test), (y_std, y_mean) = \
            _load_splits(args.data_name, args.data_root, args.seed)
        num_train = x_train.shape[0]

        network, base_kernel_fn = _resolve_network(args.network)
        args.network = network

        x, y = x_test, y_test
        y_ = (y * y_std) + y_mean

        min_t, min_tv = None, float("inf")
        min_g, min_gv = None, float("inf")

        il, jl, kl = len(args.w_std_list), len(args.b_std_list), len(args.eps_list)
        total = il * jl * kl
        minus_log_two_pi = -(num_train / 2) * np.log(2 * np.pi)

        for i, w_std in enumerate(args.w_std_list):
            for j, b_std in enumerate(args.b_std_list):
                kernel_fn = base_kernel_fn(
                    args.num_hiddens, act=args.activation,
                    w_std=w_std, b_std=b_std, last_w_std=1.)
                cov_data = jax.jit(lambda a, b: kernel_fn(a, b, get="nngp"))(
                    x_train, x_train)

                for k, eps in enumerate(args.eps_list):
                    mean, cov = gp_predict(kernel_fn, x_train, y_train[:, None],
                                           x, diag_reg=eps)
                    mean_ = (mean.flatten() * y_std) + y_mean
                    cov_ = cov * y_std ** 2

                    gnll = _gaussian_nll(y_, mean_, cov_)
                    if gnll < min_gv:
                        min_g, min_gv = (w_std, b_std, eps), float(gnll)

                    # Fused marginal pieces: one Cholesky gives both the
                    # quadratic form and the log-determinant (the reference
                    # does inv + scipy logpdf, find.py:164-168).
                    cov_data_eps = cov_data + np.eye(num_train) * eps
                    chol = jnp.linalg.cholesky(cov_data_eps)
                    if bool(jnp.any(jnp.isnan(chol))):
                        # PSD-singular in fp32: fall back to the eigh
                        # pseudo-determinant path (the reference scores these
                        # cells via scipy allow_singular=True, find.py:158;
                        # see PARITY.md "known deltas").
                        evals, evecs = jnp.linalg.eigh(cov_data_eps)
                        keep = evals > 1e-10 * jnp.max(evals)
                        safe = jnp.where(keep, evals, 1.0)
                        z = evecs.T @ y_train
                        quad = jnp.sum(jnp.where(keep, z * z / safe, 0.0))
                        logdet = jnp.sum(jnp.where(keep, jnp.log(safe), 0.0))
                        logdet_term = minus_log_two_pi - 0.5 * logdet
                    else:
                        quad = chol_quad_form(chol, y_train)
                        logdet_term = minus_log_two_pi - 0.5 * chol_logdet(chol)
                    std_diag = jnp.sqrt(jnp.diag(cov))

                    if args.sampler == "device":
                        tbl = _tnll_lattice_device(
                            jax.random.PRNGKey(101),
                            jnp.asarray(args.alpha_list, jnp.float32),
                            jnp.asarray(args.beta_list, jnp.float32),
                            args.num_is_samples, quad, logdet_term, num_train,
                            y_, mean_, std_diag, y_std)
                        table = [[float(v) for v in row] for row in tbl]
                        for ai, a in enumerate(args.alpha_list):
                            for bi, b in enumerate(args.beta_list):
                                if table[ai][bi] < min_tv:
                                    min_t = (w_std, b_std, a, b, eps)
                                    min_tv = table[ai][bi]
                    else:
                        table = []
                        for a in args.alpha_list:
                            col = []
                            for b in args.beta_list:
                                sample_q = scipy_stats.burr12.rvs(
                                    c=a, d=b, loc=0., scale=1.,
                                    size=args.num_is_samples, random_state=101)
                                # prior pdf / proposal pdf cancel exactly
                                # (same Burr-XII; find.py:177-181).
                                ones = jnp.ones_like(jnp.asarray(sample_q))
                                tnll = _tnll_lattice(
                                    jnp.asarray(sample_q, jnp.float32), ones,
                                    quad, logdet_term, num_train,
                                    y_, mean_, std_diag, y_std)
                                if tnll < min_tv:
                                    min_t = (w_std, b_std, a, b, eps)
                                    min_tv = float(tnll)
                                col.append(float(tnll))
                            table.append(col)

                    logger.log(f"\n{w_std}-{b_std}-{eps}: "
                               f"{i * jl * kl + j * kl + k + 1} / {total} "
                               f"({i+1}/{il}, {j+1}/{jl}, {k+1}/{kl})")
                    logger.log(f"{_format_table(table, args.alpha_list, args.beta_list)}\n")
                    logger.log(f"({min_t}): {min_tv:.4f}")
                    logger.log(f"({min_g}): {min_gv:.4f}")

        logger.log(f"({min_t}): {min_tv:.4f}")
        logger.log(f"({min_g}): {min_gv:.4f}")

    except KeyboardInterrupt:
        raise
    except Exception:
        import traceback
        logger.log(f"\n{traceback.format_exc()}\nStopped")
    finally:
        logger.close()
