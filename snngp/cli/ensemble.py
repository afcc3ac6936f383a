"""Finite-width CNN ensemble baseline: train / test.

Rebuilds ``experiments/ensemble/{train,test}.py``: finite CNNs via the
engine's init/apply tier (replacing ``stax.serial`` init/apply,
``ensemble/train.py:57-65``); "tp" mode draws ``last_w_std ~
sqrt(InvGamma(alpha, beta))`` once per member; cross-entropy SGD/Adam with
best-valid ``.npy`` saves; test averages member logits.
"""

from __future__ import annotations

import glob
import os
from datetime import datetime

import numpy as np

import jax
import jax.numpy as jnp
from jax import random

from snngp.nn.arch import get_cnn_layer
from snngp.data.classification import get_train_dataset, get_test_dataset
from snngp.utils import Adam, SGD, DataLoader, Logger, get_context_summary


def add_subparser(subparsers):
    parser = subparsers.add_parser("ensemble", aliases=["ens"])
    sub = parser.add_subparsers(metavar="ops")
    _add_train_parser(sub)
    _add_test_parser(sub)


def _add_train_parser(subparsers):
    parser = subparsers.add_parser("train", aliases=["tr"])
    parser.set_defaults(func=train_main)

    parser.add_argument("-m",   "--method",       choices=["gp", "tp"], required=True)
    parser.add_argument("-n",   "--network",      choices=["cnn", "resnet"], default="cnn")
    parser.add_argument("-dr",  "--data-root",    type=str, default="./data")
    parser.add_argument("-dn",  "--data-name",    required=True)
    parser.add_argument("-cr",  "--ckpt-root",    type=str, default="./_ckpt/ens")
    parser.add_argument("-cn",  "--ckpt-name",    type=str, default=None)

    parser.add_argument("-vp",  "--valid-prop",   type=float, default=0.1)
    parser.add_argument("-nd",  "--num-data",     type=int, default=None)
    parser.add_argument("-nb",  "--num-batch",    type=int, default=250)

    parser.add_argument("-a",   "--alpha",        type=float, default=2.)
    parser.add_argument("-b",   "--beta",         type=float, default=2.)

    parser.add_argument("-nh",  "--num-hiddens",  type=int, default=4)
    parser.add_argument("-nc",  "--num-channels", type=int, default=32)
    parser.add_argument("-act", "--activation",   choices=["erf", "relu"], default="relu")
    parser.add_argument("-ws",  "--w-std",        type=float, default=1.)
    parser.add_argument("-bs",  "--b-std",        type=float, default=0.)
    parser.add_argument("-eps", "--epsilon",      type=float, default=1e-6)

    parser.add_argument("-opt", "--optimizer",    choices=["adam", "sgd"], default="adam")
    parser.add_argument("-lr",  "--lr",           type=float, default=1e-2)
    parser.add_argument("-e",   "--max-epoch",    type=int, default=100)

    parser.add_argument("-s",   "--seed",         type=int, default=10)
    parser.add_argument("-q",   "--quite",        default=False, action="store_true")
    parser.add_argument("-c",   "--comment",      type=str, default="")
    parser.add_argument("-mp",  "--matmul-precision",
                        choices=["highest", "high", "default"],
                        default="highest",
                        help="matmul precision for the finite-network "
                        "train/valid steps. snngp pins 'highest' (true "
                        "fp32) globally because GP Grams need it, but "
                        "finite-SGD ensemble training does not: 'default' "
                        "lets XLA use the GPU's TF32 tensor-core matmuls "
                        "at NN-training-grade numerics. 'highest' matches "
                        "the reference's fp32 CUDA training bit-for-ulp")


def invgamma(key, alpha, beta):
    """sqrt of an inverse-gamma draw (ensemble/train.py:52-54)."""
    return float(np.sqrt(beta / np.asarray(random.gamma(key, a=alpha))))


def get_cnn(num_hiddens, num_channels, num_class, w_std=1., b_std=0., last_w_std=1.,
            act="relu"):
    """Finite-width CNN via the engine's init/apply tier (ensemble/train.py:57-65)."""
    layer = get_cnn_layer(num_hiddens, num_class, act, w_std, b_std, last_w_std,
                          channels=num_channels)
    return layer.init, jax.jit(layer.apply)


def cross_entropy(logits, y):
    return -jnp.mean(jax.nn.log_softmax(logits) * y)


def train_main(args):
    # Scope the precision override to this driver: jitted steps trace
    # (and therefore bake in the precision) inside the context.
    with jax.default_matmul_precision(args.matmul_precision):
        return _train_main(args)


def _train_main(args):
    dataset = get_train_dataset(
        name=args.data_name, root=args.data_root,
        num_data=args.num_data, valid_prop=args.valid_prop,
        normalize=True, onehot=True, seed=args.seed,
    )
    (x_train, y_train), (x_valid, y_valid), (num_class, data_name, data_msg) = dataset
    num_train, num_valid = x_train.shape[0], x_valid.shape[0]

    if not args.ckpt_name:
        args.ckpt_name = f"{data_name}/{args.method}-{args.network}"
        args.ckpt_name += f"/nh{args.num_hiddens}-nc{args.num_channels}"
        if args.method == "tp":
            args.ckpt_name += f"-a{args.alpha:.0f}-b{args.beta:.0f}"
        args.ckpt_name += f"/{args.comment or datetime.now().strftime('%y%m%d%H%M')}"

    ckpt_dir = os.path.join(os.path.expanduser(args.ckpt_root), args.ckpt_name)
    os.makedirs(ckpt_dir, exist_ok=True)
    logger = Logger(ckpt_dir, quite=args.quite)

    try:
        key = random.PRNGKey(args.seed)

        if args.method == "gp":
            last_w_std = 1.
        else:
            last_w_std = invgamma(key, args.alpha, args.beta)

        net_kwargs = dict(
            num_hiddens=args.num_hiddens, num_channels=args.num_channels,
            num_class=num_class, w_std=args.w_std, b_std=args.b_std,
            last_w_std=last_w_std,
        )
        init_fn, apply_fn = get_cnn(**net_kwargs, act=args.activation)

        np.save(os.path.join(ckpt_dir, "meta.npy"),
                {k: v for k, v in vars(args).items() if k != "func"})
        logger.log(get_context_summary(args, dict(
            num_class=num_class, num_train=num_train, num_valid=num_valid,
            data_name=data_name, data_msg=data_msg, last_w_std=last_w_std,
        )))

        optimizer = Adam() if args.optimizer == "adam" else SGD()
        _, params = init_fn(key, (-1,) + x_train.shape[1:])
        opt_state = optimizer.init(params)

        @jax.jit
        def train_step(params, opt_state, x_batch, y_batch):
            def loss_fn(p):
                return cross_entropy(apply_fn(p, x_batch), y_batch)
            v, g = jax.value_and_grad(loss_fn)(params)
            params, opt_state = optimizer.update(g, opt_state, params, args.lr)
            return params, opt_state, v

        @jax.jit
        def valid_step(params, x_batch, y_batch):
            logits = apply_fn(params, x_batch)
            nll = cross_entropy(logits, y_batch)
            corrects = jnp.sum(jnp.argmax(logits, axis=-1) == jnp.argmax(y_batch, axis=-1))
            return nll, corrects

        train_loader = DataLoader(x_train, y_train, batch_size=args.num_batch, shuffle=True)
        valid_loader = DataLoader(x_valid, y_valid, batch_size=args.num_batch, shuffle=False)

        def valid_epoch(params):
            total_nll, total_corrects = 0., 0
            for xb, yb in valid_loader:
                nll, c = valid_step(params, jnp.asarray(xb), jnp.asarray(yb))
                total_nll += float(nll) * xb.shape[0]
                total_corrects += int(c)
            return (total_nll / valid_loader.num_data,
                    total_corrects * 100 / valid_loader.num_data)

        valid_nll, valid_acc = valid_epoch(params)
        logger.log(f"[{0:3d}]  Valid NLL: {valid_nll:.6f}  Valid ACC: {valid_acc:.2f}")
        best_epoch, best_nll, best_acc = 0, valid_nll, valid_acc

        from snngp.utils.training import tqdm, trange
        for epoch in trange(1, args.max_epoch + 1, desc="Epoch", ncols=0,
                            disable=args.quite):
            total_nll = 0.
            for xb, yb in tqdm(train_loader, desc="Train", leave=False, ncols=0,
                               disable=args.quite):
                params, opt_state, nll = train_step(params, opt_state,
                                                    jnp.asarray(xb), jnp.asarray(yb))
                total_nll += float(nll) * xb.shape[0]
            train_nll = total_nll / train_loader.num_data
            logger.log(f"[{epoch:3d}]  Train NLL: {train_nll:.6f}", is_tqdm=True)

            valid_nll, valid_acc = valid_epoch(params)
            logger.log(f"[{epoch:3d}]  Valid NLL: {valid_nll:.6f}  Valid ACC: {valid_acc:.2f}",
                       is_tqdm=True)

            if valid_nll < best_nll:
                best_epoch, best_nll, best_acc = epoch, valid_nll, valid_acc
                # Pre-allocated object array: np.array((pytree, list)) would
                # recurse when len(params) == len(net_kwargs) (e.g. nh=2
                # gives 6 layers vs 6 kwargs) and mangle the pytree.
                blob = np.empty(2, dtype=object)
                blob[0] = jax.device_get(params)
                blob[1] = list(net_kwargs.values())
                np.save(os.path.join(ckpt_dir, f"{epoch:03d}.npy"), blob,
                        allow_pickle=True)
                logger.log(f"[{epoch:3d}]  Updated  NLL: {valid_nll:.6f}  ACC: {valid_acc:.2f}",
                           is_tqdm=True)

        logger.log(f"[{best_epoch:3d}]  Valid NLL: {best_nll:.6f}  Valid ACC: {best_acc:.2f}")

    except KeyboardInterrupt:
        raise
    except Exception:
        import traceback
        logger.log(f"\n{traceback.format_exc()}\nStopped")
    finally:
        logger.close()


def _add_test_parser(subparsers):
    parser = subparsers.add_parser("test", aliases=["ts"])
    parser.set_defaults(func=test_main)
    parser.add_argument("-mp", "--matmul-precision",
                        choices=["highest", "high", "default"],
                        default="highest",
                        help="matmul precision for member-logit evaluation "
                        "(see ens tr -mp)")

    parser.add_argument("-dr", "--data-root", type=str, default="./data")
    parser.add_argument("-dn", "--data-name", required=True)
    parser.add_argument("-cd", "--ckpt-dir",  type=str, required=True, nargs="+")
    parser.add_argument("-nd", "--num-data",  type=int, default=None)
    parser.add_argument("-nb", "--num-batch", type=int, default=100)
    parser.add_argument("-q",  "--quite",     default=False, action="store_true")


def test_main(args):
    with jax.default_matmul_precision(args.matmul_precision):
        return _test_main(args)


def _test_main(args):
    (x_test, y_test), (num_class, data_name) = get_test_dataset(
        name=args.data_name, root=args.data_root,
        num_data=args.num_data, onehot=True, normalize=True,
    )

    apply_fns, paramss = [], []
    for ckpt_dir in args.ckpt_dir:
        ckpts = sorted(glob.glob(os.path.join(ckpt_dir, "*.npy")))
        ckpts = [c for c in ckpts if not c.endswith("meta.npy")]
        if not ckpts:
            raise FileNotFoundError(
                f"no member checkpoints (*.npy) under '{ckpt_dir}' — pass the "
                f"run directory itself (ckpt_root/ckpt_name), one per member")
        last_ckpt = ckpts[-1]
        params, net_args = np.load(last_ckpt, allow_pickle=True)
        # Back-compat: checkpoints written by the old recursing np.array save
        # hold the layer tuple as an object ndarray; rewrap as a tuple.
        if isinstance(params, np.ndarray) and params.dtype == object:
            params = tuple(params)
        apply_fns.append(get_cnn(*net_args)[1])
        paramss.append(params)

    test_loader = DataLoader(x_test, y_test, batch_size=args.num_batch, shuffle=False)

    nll, corrects = 0., 0
    from snngp.utils.training import tqdm
    for xb, yb in tqdm(test_loader, desc="Test", leave=False, ncols=0,
                       disable=args.quite):
        xb = jnp.asarray(xb)
        logits = [np.asarray(fn(p, xb))[None] for fn, p in zip(apply_fns, paramss)]
        logits = np.mean(np.vstack(logits), axis=0)
        nll += float(cross_entropy(jnp.asarray(logits), jnp.asarray(yb))) * xb.shape[0]
        corrects += int(np.sum(np.argmax(logits, axis=1) == np.argmax(yb, axis=1)))

    test_nll = nll / test_loader.num_data
    test_acc = corrects * 100 / test_loader.num_data
    print(f"{test_nll = :.6f}   {test_acc = :.2f}")
