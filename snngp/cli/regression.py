"""Regression subcommands: train / test / find.

Rebuilds ``experiments/regression/{train,test,find}.py`` with the same flag
schema, data pipeline (double seeded permutation at ``train.py:97-109`` —
parity depends on byte-identical order), run-budget defaults, plateau LR
policy, best-valid checkpoint gating, and restore-by-suffix test path.
"""

from __future__ import annotations

import math
import os
from datetime import datetime

import numpy as np

import jax
import jax.numpy as jnp

from snngp.models import SPR, NNGPKernel, GaussianLikelihood, StudentTLikelihood
from snngp.models.params import get_by_suffix, assign_by_suffix
from snngp.nn.arch import get_mlp_kernel, get_dense_resnet_kernel
from snngp.data.regression import DATASETS, get_dataset, permute_dataset, split_dataset
from snngp.utils import (
    Adam, SGD, Checkpointer, Logger, ReduceLROnPlateau, get_context_summary,
    load_named,
)


def add_subparser(subparsers):
    parser = subparsers.add_parser("regression", aliases=["reg"])
    sub = parser.add_subparsers(metavar="ops")
    _add_train_parser(sub)
    _add_test_parser(sub)
    _add_predict_parser(sub)
    from snngp.cli.find import add_subparser as add_find
    add_find(sub)


# ---------------------------------------------------------------------------
# train (experiments/regression/train.py)
# ---------------------------------------------------------------------------

def _add_train_parser(subparsers):
    parser = subparsers.add_parser("train", aliases=["tr"])
    parser.set_defaults(func=train_main)

    parser.add_argument("-m",   "--method",         choices=["gp", "tp"], required=True)
    parser.add_argument("-n",   "--network",        choices=["resnet", "mlp"], default=None)
    parser.add_argument("-dn",  "--data-name",      choices=DATASETS, required=True)
    parser.add_argument("-dr",  "--data-root",      type=str, default="./data")
    parser.add_argument("-cr",  "--ckpt-root",      type=str, default="./_ckpt")
    parser.add_argument("-cn",  "--ckpt-name",      type=str, default=None)

    parser.add_argument("-vp",  "--valid-prop",     type=float, default=0.1)
    parser.add_argument("-nd",  "--num-data",       type=int, default=None)

    parser.add_argument("-a",   "--alpha",          type=float, default=2.)
    parser.add_argument("-b",   "--beta",           type=float, default=2.)

    parser.add_argument("-nh",  "--num-hiddens",    type=int, default=4)
    parser.add_argument("-act", "--activation",     choices=["erf", "relu"], default="relu")
    parser.add_argument("-ws",  "--w-std",          type=float, default=1.)
    parser.add_argument("-bs",  "--b-std",          type=float, default=1e-8)
    parser.add_argument("-ls",  "--last-w-std",     type=float, default=1.)
    parser.add_argument("-eps", "--epsilon",        type=float, default=1e-6)

    parser.add_argument("-opt", "--optimizer",      choices=["adam", "sgd"], default="adam")
    parser.add_argument("-lr",  "--lr",             type=float, default=1e-2)
    parser.add_argument("-lrd", "--lr-decay",       type=float, default=0.5)
    parser.add_argument("-lrt", "--lr-threshold",   type=float, default=1e-4)
    parser.add_argument("-lrp", "--lr-patience",    type=int, default=5)
    parser.add_argument("-t",   "--max-steps",      type=int, default=30000)

    parser.add_argument("-rs",  "--resume",         default=False, action="store_true",
                        help="resume from <ckpt_dir>/resume.state (params, "
                             "optimizer state, LR schedule, step counter)")
    parser.add_argument("-prof", "--profile",       default=False, action="store_true",
                        help="accumulate per-phase wall-clock (train/valid/"
                             "test) and log the report at the end")
    parser.add_argument("-sck", "--scan-chunk",     type=int, default=1,
                        help="steps per device roundtrip via lax.scan "
                             "(amortizes host dispatch; must divide print/"
                             "valid intervals; 1 = reference-faithful loop)")
    parser.add_argument("-s",   "--seed",           type=int, default=10)
    parser.add_argument("-pi",  "--print-interval", type=int, default=100)
    parser.add_argument("-vi",  "--valid-interval", type=int, default=500)
    parser.add_argument("-q",   "--quite",          default=False, action="store_true")
    parser.add_argument("-c",   "--comment",        type=str, default="")


def _load_splits(data_name, data_root, seed):
    """Shared data assembly: seed-10 permutation, 0.8/0.1/0.1 split, then the
    seeded train/valid re-permutation (reference train.py:97-109)."""
    x, y = get_dataset(name=data_name, root=data_root)
    x, y = permute_dataset(x, y, seed=10)
    splits = split_dataset(x, y, train=0.8, valid=0.1, test=0.1)
    (x_train, y_train), (x_valid, y_valid), (x_test, y_test), (y_std, y_mean) = splits

    num_train = x_train.shape[0]
    x_tv = np.concatenate([x_train, x_valid], axis=0)
    y_tv = np.concatenate([y_train, y_valid], axis=0)
    x_tv, y_tv = permute_dataset(x_tv, y_tv, seed=seed)
    x_train, x_valid = x_tv[:num_train], x_tv[num_train:]
    y_train, y_valid = y_tv[:num_train], y_tv[num_train:]

    to_j = lambda a: jnp.array(a, dtype=jnp.float32)
    return ((to_j(x_train), to_j(y_train)), (to_j(x_valid), to_j(y_valid)),
            (to_j(x_test), to_j(y_test)), (to_j(y_std), to_j(y_mean)))


def _resolve_network(network):
    if network is None or network == "mlp":
        return "mlp", get_mlp_kernel
    if network == "resnet":
        return "resnet", get_dense_resnet_kernel
    raise ValueError(f"Unsupported network '{network}'")


def _build_model(args_like, x_train, y_train, y_mean, y_std):
    network, base_kernel_fn = _resolve_network(args_like["network"])

    def get_kernel_fn(w_std, b_std, last_w_std):
        return base_kernel_fn(
            args_like["num_hiddens"], act=args_like["activation"],
            w_std=w_std, b_std=b_std, last_w_std=last_w_std,
        )

    kernel = NNGPKernel(get_kernel_fn, args_like["w_std"], args_like["b_std"],
                        args_like["last_w_std"])
    if args_like["method"] == "gp":
        likelihood = GaussianLikelihood()
    elif args_like["method"] == "tp":
        likelihood = StudentTLikelihood(args_like["alpha"], args_like["beta"])
    else:
        raise ValueError(f"Unsupported method '{args_like['method']}'")

    return SPR(kernel, likelihood, x_train, y_train, y_mean, y_std,
               eps=args_like["epsilon"]), network


def train_main(args):
    if not args.ckpt_name:
        args.ckpt_name = f"{args.data_name}/{args.method}"
        args.ckpt_name += f"/nh{args.num_hiddens}-ws{args.w_std:.1f}-bs{args.b_std:.1f}-ls{args.last_w_std:.1f}"
        if args.method == "tp":
            args.ckpt_name += f"-a{args.alpha:.1f}-b{args.beta:.1f}"
        args.ckpt_name += f"/{args.comment or datetime.now().strftime('%y%m%d%H%M')}"

    ckpt_dir = os.path.join(os.path.expanduser(args.ckpt_root), args.ckpt_name)
    checkpointer = Checkpointer(ckpt_dir)
    logger = Logger(ckpt_dir, quite=args.quite)

    try:
        (x_train, y_train), (x_valid, y_valid), (x_test, y_test), (y_std, y_mean) = \
            _load_splits(args.data_name, args.data_root, args.seed)
        num_train, num_valid = x_train.shape[0], x_valid.shape[0]

        network, _ = _resolve_network(args.network)
        args.network = network
        model, _ = _build_model(vars(args), x_train, y_train, y_mean, y_std)

        n_mesh = int(os.environ.get("SNNGP_MESH_DEVICES", "1"))
        if n_mesh > 1:
            from snngp.parallel import get_mesh
            model.mesh = get_mesh(n_mesh)
            from functools import partial
            from snngp.parallel.cholesky import blocked_cholesky
            model.likelihood.chol_fn = partial(blocked_cholesky, block=512)
            logger.log(f"Mesh: {n_mesh} devices (sharded Gram + blocked Cholesky)")
        params = model.init_params()

        optimizer = Adam() if args.optimizer == "adam" else SGD()
        opt_state = optimizer.init(params)
        scheduler = ReduceLROnPlateau(lr=args.lr, factor=args.lr_decay,
                                      patience=args.lr_patience)

        from snngp.utils import save_training_state, load_training_state
        resume_path = os.path.join(ckpt_dir, "resume.state")
        start_step = 0
        if args.resume and os.path.isfile(resume_path):
            params, opt_state, rmeta = load_training_state(
                resume_path, params, opt_state)
            start_step = int(rmeta["step"])
            scheduler.lr = float(rmeta["lr"])
            scheduler.best = float(rmeta["sched_best"])
            scheduler.num_bad_epochs = int(rmeta["sched_bad"])
            scheduler.last_epoch = int(rmeta["sched_epoch"])
            checkpointer.best_loss = float(rmeta["best_loss"])
            logger.log(f"Resumed from {resume_path} at step {start_step}")

        @jax.jit
        def train_step(params, opt_state, lr):
            loss, grads = jax.value_and_grad(model.loss)(params)
            params, opt_state = optimizer.update(grads, opt_state, params, lr)
            return params, opt_state, loss

        # Chunked variant: run `chunk` steps per device call. For small
        # problems the per-step host dispatch can dominate wall-clock;
        # lax.scan amortizes it without changing the math (lr is constant
        # inside a chunk; the plateau schedule only updates at valid
        # intervals, which chunk boundaries align to).
        chunk = max(1, args.scan_chunk)
        if chunk > 1:
            if args.print_interval % chunk or args.valid_interval % chunk:
                raise SystemExit("--scan-chunk must divide print/valid intervals")

            @jax.jit
            def train_chunk(params, opt_state, lr):
                def body(carry, _):
                    p, o = carry
                    loss, grads = jax.value_and_grad(model.loss)(p)
                    p, o = optimizer.update(grads, o, p, lr)
                    return (p, o), loss
                (params, opt_state), losses = jax.lax.scan(
                    body, (params, opt_state), None, length=chunk)
                return params, opt_state, losses[-1]

        valid_step = jax.jit(lambda p: model.test_nll(p, x_valid, y_valid))
        test_step = jax.jit(lambda p: model.test_nll(p, x_test, y_test))

        from snngp.utils.profiling import Profiler
        prof = Profiler() if args.profile else None

        np.save(os.path.join(ckpt_dir, "meta.npy"),
                dict(args={k: v for k, v in vars(args).items() if k != "func"}))
        logger.log(get_context_summary(args, dict(num_train=num_train, num_valid=num_valid)))

        valid_nll = valid_step(params)
        test_nll = test_step(params)
        logger.log(f"[{0:5d}] NLL: {valid_nll:.5f}  TEST: {test_nll:.5f}")

        best_step, best_nll, best_test_nll, best_print_str = 0, valid_nll, test_nll, ""
        print_str = ""
        checkpointer.step(0, float(valid_nll), params)

        from snngp.utils.training import tqdm
        for i in tqdm(range(start_step + chunk, args.max_steps + 1, chunk),
                      desc="Train", ncols=0, disable=args.quite):
            if prof is not None:
                with prof.phase("train", sync_on=params):
                    if chunk > 1:
                        params, opt_state, nll = train_chunk(params, opt_state, scheduler.lr)
                    else:
                        params, opt_state, nll = train_step(params, opt_state, scheduler.lr)
            elif chunk > 1:
                params, opt_state, nll = train_chunk(params, opt_state, scheduler.lr)
            else:
                params, opt_state, nll = train_step(params, opt_state, scheduler.lr)

            if i % args.print_interval == 0:
                ws, bs, ls = (float(v) for v in model.kernel.get_params(params["kernel"]))
                eps = float(model.bij(params["eps"]))
                if args.method == "tp":
                    ia = float(model.likelihood.bij(params["likelihood"]["a"]))
                    ib = float(model.likelihood.bij(params["likelihood"]["b"]))
                    print_str = (f"nll: {nll:.5f}  ws: {ws:.4f}  bs: {bs:.3E}  "
                                 f"ls: {ls:.4f}  a: {ia:.4f}  b: {ib:.4f}  e: {eps:.3E}")
                else:
                    print_str = (f"nll: {nll:.5f}  ws: {ws:.4f}  bs: {bs:.3E}  "
                                 f"ls: {ls:.4f}  e: {eps:.3E}")
                logger.log(f"[{i:5d}] {print_str}", is_tqdm=True)

            if i % args.valid_interval == 0:
                if prof is not None:
                    with prof.phase("valid"):
                        valid_nll = prof.observe(valid_step(params))
                    with prof.phase("test"):
                        test_nll = prof.observe(test_step(params))
                else:
                    valid_nll = valid_step(params)
                    test_nll = test_step(params)
                logger.log(f"[{i:5d}] NLL: {valid_nll:.5f}  TEST: {test_nll:.5f}", is_tqdm=True)
                reduced = scheduler.step(valid_nll)
                updated = checkpointer.step(i, float(valid_nll), params)
                save_training_state(resume_path, params, opt_state, dict(
                    step=i, lr=scheduler.lr, sched_best=scheduler.best,
                    sched_bad=scheduler.num_bad_epochs,
                    sched_epoch=scheduler.last_epoch,
                    best_loss=checkpointer.best_loss))

                if updated:
                    logger.log(f"[{i:5d}] Updated  NLL: {valid_nll:.5f}  TEST: {test_nll:.5f}",
                               is_tqdm=True)
                    best_step, best_nll, best_test_nll = i, valid_nll, test_nll
                    best_print_str = print_str

                if reduced:
                    logger.log(f"LR reduced to {scheduler.lr:.6f}", is_tqdm=True)
                    if scheduler.lr < args.lr_threshold:
                        break

                if math.isnan(float(valid_nll)):
                    break

        logger.log(f"\n[{best_step:5d}] NLL: {best_nll:.5f}  TEST: {best_test_nll:.5f}  {best_print_str}\n")
        if prof is not None:
            logger.log(prof.report())

    except KeyboardInterrupt:
        raise
    except Exception:
        import traceback
        logger.log(f"\n{traceback.format_exc()}\nStopped")
    finally:
        logger.close()


# ---------------------------------------------------------------------------
# test (experiments/regression/test.py)
# ---------------------------------------------------------------------------

def _add_test_parser(subparsers):
    parser = subparsers.add_parser("test", aliases=["ts"])
    parser.set_defaults(func=test_main)

    parser.add_argument("-dr", "--data-root",  type=str, default="./data")
    parser.add_argument("-cd", "--ckpt-dir",   type=str, required=True)
    parser.add_argument("-ci", "--ckpt-index", type=int, default=None)
    parser.add_argument("-vp", "--valid-prop", type=float, default=0.1)
    parser.add_argument("-nd", "--num-data",   type=int, default=None)
    parser.add_argument("-s",  "--seed",       type=int, default=10)
    parser.add_argument("-q",  "--quite",      default=False, action="store_true")


def _restore_model(args):
    """Checkpoint restore shared by test/predict: latest (or -ci) .npz +
    meta.npy context -> (model, params, splits, context). Restore is
    by-variable-name suffix with the reference's back-compat fallbacks
    (regression/test.py:38-43,89-99)."""
    if args.ckpt_index is None:
        indices = Checkpointer.list_indices(args.ckpt_dir)
        if not indices:
            raise SystemExit(f"no checkpoints (*.npz) found in {args.ckpt_dir}")
        args.ckpt_index = indices[-1]

    named = load_named(os.path.join(args.ckpt_dir,
                                    Checkpointer.FILE_FORMAT.format(args.ckpt_index)))
    context = np.load(os.path.join(args.ckpt_dir, "meta.npy"),
                      allow_pickle=True).item()["args"]

    splits = _load_splits(context["data_name"], args.data_root, args.seed)
    (x_train, y_train), _, _, (y_std, y_mean) = splits

    a = get_by_suffix(named, "a")
    b = get_by_suffix(named, "b")
    w_std = get_by_suffix(named, "w_std")
    b_std = get_by_suffix(named, "b_std")
    last_w_std = get_by_suffix(named, "last_w_std")
    eps = get_by_suffix(named, "eps")
    if eps is None:
        eps = get_by_suffix(named, "diag_reg")
    if last_w_std is None:
        last_w_std = np.array(context["last_w_std"])

    args_like = dict(context)
    args_like["epsilon"] = 1.0
    if context["method"] == "tp":
        args_like["alpha"], args_like["beta"] = 1.0, 1.0
    model, _ = _build_model(args_like, x_train, y_train, y_mean, y_std)
    params = model.init_params()

    # Values in the checkpoint are raw (unconstrained), assigned directly
    # like objax .assign (regression/test.py:118-131).
    for key, value in [("eps", eps), ("w_std", w_std), ("b_std", b_std),
                       ("last_w_std", last_w_std), ("a", a), ("b", b)]:
        if value is not None:
            assign_by_suffix(params, key, value)

    return model, params, splits, context


def test_main(args):
    logger = Logger(os.path.join(args.ckpt_dir, "test"), "test.log", quite=args.quite)

    try:
        model, params, splits, _ = _restore_model(args)
        _, _, (x_test, y_test), _ = splits

        test_nll = jax.jit(lambda p: model.test_nll(p, x_test, y_test))(params)
        logger.log(f"NLL: {test_nll:.5f}")

    except KeyboardInterrupt:
        raise
    except Exception:
        import traceback
        logger.log(f"\n{traceback.format_exc()}\nStopped")
    finally:
        logger.close()


# ---------------------------------------------------------------------------
# predict (serving path; beyond the reference, which only has test)
# ---------------------------------------------------------------------------

def _add_predict_parser(subparsers):
    parser = subparsers.add_parser("predict", aliases=["pr"])
    parser.set_defaults(func=predict_main)

    parser.add_argument("-dr", "--data-root",  type=str, default="./data")
    parser.add_argument("-cd", "--ckpt-dir",   type=str, required=True)
    parser.add_argument("-ci", "--ckpt-index", type=int, default=None)
    parser.add_argument("-s",  "--seed",       type=int, default=10)
    parser.add_argument("-i",  "--input",      type=str, default=None,
                        help=".npy of raw inputs in the dataset's original "
                             "feature space (normalized with the train-split "
                             "stats); default = held-out test split")
    parser.add_argument("-o",  "--output",     type=str, default=None,
                        help="output .npz of de-normalized (mean, var); "
                             "default <ckpt_dir>/predictions.npz")
    parser.add_argument("-fs", "--fitted-state", type=str, default=None,
                        help="path for the fitted solve cache: loaded if it "
                             "exists, written after fitting otherwise — "
                             "repeat predictions skip the N x N factorization")
    parser.add_argument("-ax", "--add-x", type=str, default=None,
                        help=".npy of raw inputs to ADD to the conditioning "
                             "set before predicting (normalized with the "
                             "train-split stats): grows the cached factor in "
                             "O(N^2 m) via chol_append instead of an "
                             "O((N+m)^3) refit; the extension itself is "
                             "in-process, but a non-extendable -fs cache is "
                             "refit once and rewritten as extendable")
    parser.add_argument("-ay", "--add-y", type=str, default=None,
                        help=".npy of raw-scale targets for --add-x")
    parser.add_argument("-q",  "--quite",      default=False, action="store_true")


def _train_x_stats(data_name, data_root):
    """(x_mean, x_std) of the train split — the exact stats split_dataset
    normalized with (data.py:277-282), for normalizing raw serving inputs."""
    x, y = get_dataset(name=data_name, root=data_root)
    x, _ = permute_dataset(x, y, seed=10)
    x_train = x[:int(0.8 * len(x))]
    return np.mean(x_train, axis=0), np.std(x_train, axis=0)


def predict_main(args):
    from snngp.models import FittedSPR, fit_spr

    logger = Logger(os.path.join(args.ckpt_dir, "predict"), "predict.log",
                    quite=args.quite)
    try:
        model, params, splits, context = _restore_model(args)
        _, _, (x_test, y_test), _ = splits

        want_extend = args.add_x is not None or args.add_y is not None
        if want_extend and not (args.add_x and args.add_y):
            raise ValueError("--add-x and --add-y go together")

        if args.fitted_state and os.path.exists(args.fitted_state):
            fitted = FittedSPR.load(args.fitted_state, model)
            logger.log(f"loaded fitted state from {args.fitted_state}")
        else:
            fitted = fit_spr(model, params, extendable=want_extend)
            if args.fitted_state:
                fitted.save(args.fitted_state)
                logger.log(f"saved fitted state to {args.fitted_state}")

        if want_extend:
            if "reg" not in fitted.state:
                logger.log("cached fitted state is not extendable; "
                           "refitting with extendable=True")
                fitted = fit_spr(model, params, extendable=True)
                if args.fitted_state:
                    # Refresh the cache so subsequent --add-x calls load the
                    # extendable state instead of repeating the O(N^3) refit.
                    fitted.save(args.fitted_state)
                    logger.log(f"refreshed {args.fitted_state} with the "
                               "extendable fit")
            x_mean, x_std = _train_x_stats(context["data_name"],
                                           args.data_root)
            x_add = jnp.asarray(
                np.nan_to_num((np.load(args.add_x) - x_mean) / x_std),
                jnp.float32)
            y_add = jnp.asarray(np.load(args.add_y), jnp.float32)
            fitted = fitted.extend(x_add, y_add)
            logger.log(f"extended conditioning set by {x_add.shape[0]} "
                       f"-> {fitted.model.num_data} points (in-process)")

        if args.input:
            x_raw = np.load(args.input)
            x_mean, x_std = _train_x_stats(context["data_name"], args.data_root)
            x_in = jnp.asarray(np.nan_to_num((x_raw - x_mean) / x_std),
                               jnp.float32)
            y_eval = None
        else:
            x_in, y_eval = x_test, y_test

        mean, var = jax.jit(fitted.predict)(x_in)
        out = args.output or os.path.join(args.ckpt_dir, "predictions.npz")
        np.savez(out, mean=np.asarray(mean), var=np.asarray(var))
        logger.log(f"predicted {mean.shape[0]} points -> {out}")
        if y_eval is not None:
            nll = jax.jit(fitted.test_nll)(x_in, y_eval)
            logger.log(f"NLL: {float(nll):.5f}")

    except KeyboardInterrupt:
        raise
    except Exception:
        import traceback
        logger.log(f"\n{traceback.format_exc()}\nStopped")
    finally:
        logger.close()
