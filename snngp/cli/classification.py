"""Classification subcommands: train / test (sparse variational SVGP/SVTP).

Rebuilds ``experiments/classification/{train,test}.py``: class-proportional
inducing-point init, optional two-LR split (prior vs rest), svtp last_w_std
freeze, minibatch ELBO epochs with per-epoch valid NLL/ACC, plateau LR,
best-NLL checkpoints, and the MC test path with 10k samples.
"""

from __future__ import annotations

import os
from datetime import datetime

import numpy as np

import jax
import jax.numpy as jnp
from jax import random

from snngp.models import SVSP, NNGPKernel, GaussianPrior, InverseGammaPrior
from snngp.models.params import get_by_suffix
from snngp.nn.arch import get_cnn_kernel, get_conv_resnet_kernel
from snngp.data.classification import get_train_dataset, get_test_dataset
from snngp.data.resize import bilinear_resize
from snngp.utils import (
    Adam, SGD, Checkpointer, DataLoader, Logger, ReduceLROnPlateau,
    get_context_summary, load_named, name_mask,
)


def add_subparser(subparsers):
    parser = subparsers.add_parser("classification", aliases=["cls"])
    sub = parser.add_subparsers(metavar="ops")
    _add_train_parser(sub)
    _add_test_parser(sub)
    _add_predict_parser(sub)


def _add_train_parser(subparsers):
    parser = subparsers.add_parser("train", aliases=["tr"])
    parser.set_defaults(func=train_main)

    parser.add_argument("-m",   "--method",           choices=["svgp", "svtp"], required=True)
    parser.add_argument("-n",   "--network",          choices=["cnn", "resnet", "myrtle"], default="cnn",
                        help="kernel architecture; 'myrtle' (beyond the "
                             "reference) is the pooled Myrtle-CNN NNGP on "
                             "the memory-bounded full spatial tier — "
                             "inducing inputs stay fixed at their "
                             "class-proportional init and -nh selects the "
                             "Myrtle depth (5/7/10)")
    parser.add_argument("-dr",  "--data-root",        type=str, default="./data")
    parser.add_argument("-dn",  "--data-name",        required=True)
    parser.add_argument("-cr",  "--ckpt-root",        type=str, default="./_ckpt/cls")
    parser.add_argument("-cn",  "--ckpt-name",        type=str, default=None)

    parser.add_argument("-vp",  "--valid-prop",       type=float, default=0.1)
    parser.add_argument("-nd",  "--num-data",         type=int, default=None)
    parser.add_argument("-nb",  "--num-batch",        type=int, default=100)
    parser.add_argument("-ni",  "--num-inducing",     type=int, default=200)
    parser.add_argument("-ns",  "--num-sample",       type=int, default=100)
    parser.add_argument("-nvs", "--num-valid-sample", type=int, default=1000)

    parser.add_argument("-a",   "--alpha",            type=float, default=2.)
    parser.add_argument("-b",   "--beta",             type=float, default=2.)

    parser.add_argument("-nh",  "--num-hiddens",      type=int, default=4)
    parser.add_argument("-act", "--activation",       choices=["erf", "relu"], default="relu")
    parser.add_argument("-ws",  "--w-std",            type=float, default=1.)
    parser.add_argument("-bs",  "--b-std",            type=float, default=1e-8)
    parser.add_argument("-ls",  "--last-w-std",       type=float, default=1.)
    parser.add_argument("-eps", "--epsilon",          type=float, default=1e-6)

    parser.add_argument("-opt", "--optimizer",        choices=["adam", "sgd"], default="adam")
    parser.add_argument("-lr",  "--lr",               type=float, default=1e-2)
    parser.add_argument("-lr2", "--lr2",              type=float, default=None)
    parser.add_argument("-lrd", "--lr-decay",         type=float, default=0.5)
    parser.add_argument("-lrt", "--lr-threshold",     type=float, default=1e-4)
    parser.add_argument("-lrp", "--lr-patience",      type=int, default=5)
    parser.add_argument("-e",   "--max-epoch",        type=int, default=300)
    parser.add_argument("-r",   "--resize",           type=int, default=1)

    # long-only: a short "-fi" would be swallowed by run.py's pre-parser as
    # "-f i" (the same prefix collision the --devices flag documents)
    parser.add_argument("--freeze-inducing",  default=False, action="store_true",
                        help="mask the inducing inputs out of the optimizer "
                             "for ANY network (the myrtle kernel always "
                             "does); isolates the cost of frozen inducing "
                             "inputs within one architecture — pair a cnn "
                             "run with/without it to quantify the myrtle "
                             "convention's deviation from the reference's "
                             "trainable inducing "
                             "(classification/train.py:186-190)")
    parser.add_argument("-rs",  "--resume",           default=False, action="store_true",
                        help="resume from <ckpt_dir>/resume.state")
    parser.add_argument("-sck", "--scan-epoch",       default=False, action="store_true",
                        help="run each epoch's full-size batches inside one "
                             "lax.scan roundtrip (amortizes host dispatch; "
                             "identical math incl. the per-batch PRNG split; "
                             "within-epoch progress logs are skipped)")
    parser.add_argument("-s",   "--seed",             type=int, default=10)
    parser.add_argument("-q",   "--quite",            default=False, action="store_true")
    parser.add_argument("-c",   "--comment",          type=str, default="")


def _base_kernel(network):
    if network is None or network == "cnn":
        return "cnn", get_cnn_kernel
    if network == "myrtle":
        from snngp.nn.arch import get_myrtle_kernel
        return "myrtle", get_myrtle_kernel
    return "resnet", get_conv_resnet_kernel


def _make_model(method, network, num_hiddens, activation, w_std, b_std,
                last_w_std, alpha, beta, num_class, inducing_points, epsilon,
                get_kernel_fn=None):
    if get_kernel_fn is None:
        _, base_kernel_fn = _base_kernel(network)

        if network == "myrtle":
            # Pooled Myrtle-CNN NNGP (beyond the reference's cnn/resnet
            # surface, nt_kernels.py:34-80). num_hiddens selects the Myrtle
            # depth. The inducing inputs stay at their class-proportional
            # init: train_main masks them out of the optimizer.
            if num_hiddens not in (5, 7, 10):
                raise ValueError(
                    "-n myrtle uses -nh/--num-hiddens as the Myrtle depth: "
                    f"one of 5, 7, 10 (got {num_hiddens})")

            def get_kernel_fn(w, b, l):
                return base_kernel_fn(num_hiddens, num_class, activation,
                                      w_std=w, b_std=b, last_w_std=l)
        else:
            def get_kernel_fn(w, b, l):
                return base_kernel_fn(num_hiddens, num_class, activation,
                                      w_std=w, b_std=b, last_w_std=l)

    if method == "svgp":
        kernel = NNGPKernel(get_kernel_fn, w_std, b_std, last_w_std)
        prior = GaussianPrior()
    elif method == "svtp":
        # svtp fixes last_w_std = 1 (classification/train.py:181).
        kernel = NNGPKernel(get_kernel_fn, w_std, b_std, 1.)
        prior = InverseGammaPrior(alpha, beta)
    else:
        raise ValueError(f"Unsupported method '{method}'")

    return SVSP(prior, kernel, inducing_points, num_latent_gps=num_class,
                eps=epsilon)


def train_main(args):
    # Fail fast (before the logging try-block) on an invalid Myrtle depth.
    if args.network == "myrtle" and args.num_hiddens not in (5, 7, 10):
        raise ValueError(
            "-n myrtle uses -nh/--num-hiddens as the Myrtle depth: "
            f"one of 5, 7, 10 (got {args.num_hiddens})")

    dataset = get_train_dataset(
        name=args.data_name, root=args.data_root,
        num_data=args.num_data, valid_prop=args.valid_prop,
        normalize=True, seed=args.seed,
    )
    (x_train, y_train), (x_valid, y_valid), (num_class, data_name, data_msg) = dataset
    num_train, num_valid = x_train.shape[0], x_valid.shape[0]

    if not args.ckpt_name:
        args.ckpt_name = f"{data_name}/{args.method}-{args.network}"
        args.ckpt_name += f"/ni{args.num_inducing}-nh{args.num_hiddens}"
        if args.method == "svtp":
            args.ckpt_name += f"-a{args.alpha:.1f}-b{args.beta:.1f}"
        args.ckpt_name += f"/{args.comment or datetime.now().strftime('%y%m%d%H%M')}"

    ckpt_dir = os.path.join(os.path.expanduser(args.ckpt_root), args.ckpt_name)
    checkpointer = Checkpointer(ckpt_dir, keep_ckpts=20)
    logger = Logger(ckpt_dir, quite=args.quite)

    try:
        h, w, c = x_train.shape[1:]
        if args.resize > 1:
            new_h, new_w = h // args.resize, w // args.resize
            # Host-side resize (matches jax.image.resize to 1 ULP,
            # snngp/data/resize.py): the data layer stays in numpy.
            x_train = bilinear_resize(x_train, new_h, new_w)
            x_valid = bilinear_resize(x_valid, new_h, new_w)
            logger.log(f"Resized to ({h}, {w}, {c}) -> ({new_h}, {new_w}, {c})")

        args.network, _ = _base_kernel(args.network)

        # Class-proportional inducing-point init (classification/train.py:186-190).
        label_class = np.array([np.sum(y_train == ci) for ci in range(num_class)])
        num_inducing_class = np.round(
            args.num_inducing * label_class / label_class.sum()).astype(int).tolist()
        inducing_points = np.concatenate(
            [x_train[y_train == ci][:ni]
             for ci, ni in zip(range(num_class), num_inducing_class)], axis=0)
        args.num_inducing = inducing_points.shape[0]

        model = _make_model(args.method, args.network, args.num_hiddens,
                            args.activation, args.w_std, args.b_std,
                            args.last_w_std, args.alpha, args.beta,
                            num_class, inducing_points, args.epsilon)
        params = model.init_params()

        # Mesh: GSPMD-partition the ELBO over the minibatch rows (D4). The
        # math (incl. the correlated [C,B,B] posterior sampling) is identical;
        # XLA inserts the collectives. Batches must divide the mesh size.
        batch_sharding = None
        n_mesh = int(os.environ.get("SNNGP_MESH_DEVICES", "1"))
        if n_mesh > 1:
            from jax.sharding import NamedSharding, PartitionSpec
            from snngp.parallel import get_mesh
            mesh = get_mesh(n_mesh)
            batch_sharding = NamedSharding(mesh, PartitionSpec("data"))
            logger.log(f"Mesh: {n_mesh} devices (batch-sharded ELBO)")

        def shard_batch(xb, yb):
            if batch_sharding is not None and xb.shape[0] % n_mesh == 0:
                return (jax.device_put(xb, batch_sharding),
                        jax.device_put(yb, batch_sharding))
            return xb, yb

        # Trainable masks: svtp freezes last_w_std (classification/train.py:216).
        if args.method == "svtp":
            base_pred = lambda n: "last_w_std" not in n
        else:
            base_pred = lambda n: True
        # Myrtle: inducing inputs are fixed at their class-proportional
        # init; only the kernel scales, prior and variational parameters
        # train.
        if args.network == "myrtle":
            _method_pred = base_pred
            base_pred = lambda n: _method_pred(n) and "inducing_variable" not in n
            logger.log("Myrtle kernel: inducing inputs fixed at their "
                       "class-proportional init")
        elif getattr(args, "freeze_inducing", False):
            # Opt-in for cnn/resnet: same optimizer mask the myrtle kernel
            # applies implicitly — the controlled arm for measuring the
            # frozen-inducing cost at equal budget.
            _method_pred = base_pred
            base_pred = lambda n: _method_pred(n) and "inducing_variable" not in n
            logger.log("--freeze-inducing: inducing inputs fixed at their "
                       "class-proportional init")

        opt_cls = Adam if args.optimizer == "adam" else SGD
        if args.lr2:
            # Two optimizers: non-prior params at lr1, prior params at lr2.
            # NB: the reference's lr2 split does NOT apply the svtp
            # last_w_std freeze (classification/train.py:228-229 builds
            # train_vars1 from all non-prior vars) — quirk preserved. The
            # myrtle inducing freeze is ours (no reference analogue), so it
            # DOES apply here.
            if args.network == "myrtle" or getattr(args, "freeze_inducing",
                                                   False):
                mask1 = name_mask(params, lambda n: "prior" not in n
                                  and "inducing_variable" not in n)
            else:
                mask1 = name_mask(params, lambda n: "prior" not in n)
            mask2 = name_mask(params, lambda n: "prior" in n)
            optimizer1, optimizer2 = opt_cls(mask=mask1), opt_cls(mask=mask2)
            opt_state1, opt_state2 = optimizer1.init(params), optimizer2.init(params)

            @jax.jit
            def train_step(params, opt_state1, opt_state2, key, x_batch, y_batch, lr1, lr2):
                loss, grads = jax.value_and_grad(model.loss)(
                    params, key, x_batch, y_batch, num_train, args.num_sample)
                params, opt_state1 = optimizer1.update(grads, opt_state1, params, lr1)
                params, opt_state2 = optimizer2.update(grads, opt_state2, params, lr2)
                return params, opt_state1, opt_state2, loss

            @jax.jit
            def scan_epoch_step(params, opt_state1, opt_state2, key, xs, ys, lr1, lr2):
                def body(carry, batch):
                    p, o1, o2, k = carry
                    k, bk = random.split(k)
                    xb, yb = batch
                    loss, grads = jax.value_and_grad(model.loss)(
                        p, bk, xb, yb, num_train, args.num_sample)
                    p, o1 = optimizer1.update(grads, o1, p, lr1)
                    p, o2 = optimizer2.update(grads, o2, p, lr2)
                    return (p, o1, o2, k), loss
                (params, opt_state1, opt_state2, key), losses = jax.lax.scan(
                    body, (params, opt_state1, opt_state2, key), (xs, ys))
                return params, opt_state1, opt_state2, key, losses

            opt_states = [opt_state1, opt_state2]
        else:
            mask = name_mask(params, base_pred)
            optimizer = opt_cls(mask=mask)
            opt_state = optimizer.init(params)

            @jax.jit
            def train_step(params, opt_state, key, x_batch, y_batch, lr):
                loss, grads = jax.value_and_grad(model.loss)(
                    params, key, x_batch, y_batch, num_train, args.num_sample)
                params, opt_state = optimizer.update(grads, opt_state, params, lr)
                return params, opt_state, loss

            @jax.jit
            def scan_epoch_step(params, opt_state, key, xs, ys, lr):
                def body(carry, batch):
                    p, o, k = carry
                    k, bk = random.split(k)
                    xb, yb = batch
                    loss, grads = jax.value_and_grad(model.loss)(
                        p, bk, xb, yb, num_train, args.num_sample)
                    p, o = optimizer.update(grads, o, p, lr)
                    return (p, o, k), loss
                (params, opt_state, key), losses = jax.lax.scan(
                    body, (params, opt_state, key), (xs, ys))
                return params, opt_state, key, losses

            opt_states = [opt_state]

        @jax.jit
        def valid_step(params, key, x_batch, y_batch):
            return model.test_acc_nll(params, key, x_batch, y_batch, args.num_valid_sample)

        scheduler = ReduceLROnPlateau(lr=args.lr, factor=args.lr_decay,
                                      patience=args.lr_patience)

        from snngp.utils import save_training_state, load_training_state
        resume_path = os.path.join(ckpt_dir, "resume.state")
        start_epoch = 0
        if args.resume and os.path.isfile(resume_path):
            params, opt_states, rmeta = load_training_state(
                resume_path, params, opt_states)
            start_epoch = int(rmeta["epoch"])
            scheduler.lr = float(rmeta["lr"])
            scheduler.best = float(rmeta["sched_best"])
            scheduler.num_bad_epochs = int(rmeta["sched_bad"])
            scheduler.last_epoch = int(rmeta["sched_epoch"])
            checkpointer.best_loss = float(rmeta["best_loss"])
            logger.log(f"Resumed from {resume_path} at epoch {start_epoch}")

        def train_log(i, nelbo, log=True):
            ws, bs, ls = (float(v) for v in model.kernel.get_params(params["kernel"]))
            eps = float(model.bij(params["eps"]))
            if args.method == "svtp":
                ia = float(model.prior.bij(params["prior"]["a"]))
                ib = float(model.prior.bij(params["prior"]["b"]))
                print_str = (f"nELBO: {nelbo:.5f}  ws: {ws:.4f}  bs: {bs:.3E}  "
                             f"a: {ia:.4f}  b: {ib:.4f}  e: {eps:.3E}")
            else:
                print_str = (f"nELBO: {nelbo:.5f}  ws: {ws:.4f}  bs: {bs:.3E}  "
                             f"ls: {ls:.4f}  e: {eps:.3E}")
            if log:
                logger.log(f"       [{i:4d}]  {print_str}", is_tqdm=True)
            return print_str

        np.save(os.path.join(ckpt_dir, "meta.npy"),
                {k: v for k, v in vars(args).items() if k != "func"})
        logger.log(get_context_summary(args, dict(
            num_class=num_class, num_train=num_train, num_valid=num_valid,
            data_name=data_name, data_msg=data_msg,
            num_inducing=args.num_inducing, inducing_points=num_inducing_class,
        )))

        train_loader = DataLoader(x_train, y_train, batch_size=args.num_batch,
                                  shuffle=True, seed=args.seed)
        valid_loader = DataLoader(x_valid, y_valid, batch_size=args.num_batch,
                                  shuffle=False)

        def valid_epoch(key, params):
            total_nll, total_corrects = 0.0, 0
            from snngp.utils.training import tqdm
            for x_batch, y_batch in tqdm(valid_loader, desc="Valid", leave=False,
                                         ncols=0, disable=args.quite):
                key, split_key = random.split(key)
                nll, corrects = valid_step(params, split_key,
                                           jnp.asarray(x_batch), jnp.asarray(y_batch))
                total_nll += float(nll) * x_batch.shape[0]
                total_corrects += int(corrects)
            return (total_nll / valid_loader.num_data,
                    total_corrects * 100 / valid_loader.num_data)

        key = random.PRNGKey(args.seed)
        valid_nll, valid_acc = valid_epoch(key, params)
        logger.log(f"[{0:3d}]  NLL: {valid_nll:.5f}  ACC: {valid_acc:.2f}")

        best_epoch, best_nll, best_acc, best_print_str = 0, valid_nll, valid_acc, ""
        checkpointer.step(0, valid_nll, params)

        from snngp.utils.training import tqdm, trange
        for epoch in trange(start_epoch + 1, args.max_epoch + 1, desc="Epoch",
                            ncols=0, disable=args.quite):
            key, split_key = random.split(key)

            # train epoch (classification/train.py:91-108)
            total_nelbo, ekey = 0.0, split_key
            log_interval = max(len(train_loader) // 4, 1)
            if args.scan_epoch:
                # Stack this epoch's full-size batches (same shuffle order)
                # and run them in one lax.scan; a ragged last batch is
                # processed with the per-batch step. The per-batch PRNG split
                # inside scan matches the host loop's split sequence exactly.
                batches = list(train_loader)
                full = [(x, y) for x, y in batches if x.shape[0] == args.num_batch]
                rest = [(x, y) for x, y in batches if x.shape[0] != args.num_batch]
                if full:
                    xs = jnp.stack([jnp.asarray(x) for x, _ in full])
                    ys = jnp.stack([jnp.asarray(y) for _, y in full])
                    if args.lr2:
                        params, *opt_states, ekey, losses = scan_epoch_step(
                            params, *opt_states, ekey, xs, ys,
                            scheduler.lr, args.lr2)
                    else:
                        params, opt_states[0], ekey, losses = scan_epoch_step(
                            params, opt_states[0], ekey, xs, ys, scheduler.lr)
                    total_nelbo += float(jnp.sum(losses)) * args.num_batch
                for x_batch, y_batch in rest:
                    ekey, bkey = random.split(ekey)
                    xb, yb = jnp.asarray(x_batch), jnp.asarray(y_batch)
                    if args.lr2:
                        params, *opt_states, nelbo = train_step(
                            params, *opt_states, bkey, xb, yb,
                            scheduler.lr, args.lr2)
                    else:
                        params, opt_states[0], nelbo = train_step(
                            params, opt_states[0], bkey, xb, yb, scheduler.lr)
                    total_nelbo += float(nelbo) * x_batch.shape[0]
            else:
                for idx, (x_batch, y_batch) in enumerate(tqdm(
                        train_loader, desc="Train", leave=False, ncols=0,
                        total=len(train_loader), disable=args.quite)):
                    ekey, bkey = random.split(ekey)
                    xb, yb = shard_batch(jnp.asarray(x_batch), jnp.asarray(y_batch))
                    if args.lr2:
                        params, *opt_states, nelbo = train_step(
                            params, *opt_states, bkey, xb, yb, scheduler.lr, args.lr2)
                    else:
                        params, opt_states[0], nelbo = train_step(
                            params, opt_states[0], bkey, xb, yb, scheduler.lr)
                    total_nelbo += float(nelbo) * x_batch.shape[0]
                    if (idx + 1) % log_interval == 0:
                        train_log(idx + 1, float(nelbo))
            train_nelbo = total_nelbo / train_loader.num_data
            logger.log(f"[{epoch:3d}]  nELBO: {train_nelbo:.5f}", is_tqdm=True)

            valid_nll, valid_acc = valid_epoch(split_key, params)
            logger.log(f"[{epoch:3d}]  NLL: {valid_nll:.5f}  ACC: {valid_acc:.2f}",
                       is_tqdm=True)

            updated = checkpointer.step(epoch, valid_nll, params)
            if updated:
                best_epoch, best_nll, best_acc = epoch, valid_nll, valid_acc
                best_print_str = train_log(epoch, train_nelbo, log=False)
                logger.log(f"[{epoch:3d}]  Updated  NLL: {valid_nll:.5f}  "
                           f"ACC: {valid_acc:.2f}", is_tqdm=True)

            save_training_state(resume_path, params, opt_states, dict(
                epoch=epoch, lr=scheduler.lr, sched_best=scheduler.best,
                sched_bad=scheduler.num_bad_epochs,
                sched_epoch=scheduler.last_epoch,
                best_loss=checkpointer.best_loss))

            reduced = scheduler.step(valid_nll)
            if reduced:
                logger.log(f"[{epoch:3d}]  LR reduced to {scheduler.lr:.6f}", is_tqdm=True)
                if scheduler.lr < args.lr_threshold:
                    break

        logger.log(f"[{best_epoch:3d}]  NLL: {best_nll:.5f}  ACC: {best_acc:.2f}  {best_print_str}")

    except KeyboardInterrupt:
        raise
    except Exception:
        import traceback
        logger.log(f"\n{traceback.format_exc()}\nStopped")
    finally:
        logger.close()


# ---------------------------------------------------------------------------
# test (experiments/classification/test.py)
# ---------------------------------------------------------------------------

def _add_test_parser(subparsers):
    parser = subparsers.add_parser("test", aliases=["ts"])
    parser.set_defaults(func=test_main)

    parser.add_argument("-dr", "--data-root",  type=str, default="./data")
    parser.add_argument("-dn", "--data-name",  required=True)
    parser.add_argument("-cd", "--ckpt-dir",   type=str, required=True)
    parser.add_argument("-ci", "--ckpt-index", type=int, default=None)
    parser.add_argument("-nd", "--num-data",   type=int, default=None)
    parser.add_argument("-nb", "--num-batch",  type=int, default=100)
    parser.add_argument("-ns", "--num-sample", type=int, default=10000)
    parser.add_argument("-s",  "--seed",       type=int, default=10)
    parser.add_argument("-q",  "--quite",      default=False, action="store_true")


def _restore_svsp(args, num_class):
    """Checkpoint restore shared by test/predict: latest (or -ci) .npz +
    meta.npy -> (model, params, context). Raw (unconstrained) values restored
    directly (classification/test.py:129-144)."""
    if args.ckpt_index is None:
        indices = Checkpointer.list_indices(args.ckpt_dir)
        if not indices:
            raise SystemExit(f"no checkpoints (*.npz) found in {args.ckpt_dir}")
        args.ckpt_index = indices[-1]

    named = load_named(os.path.join(args.ckpt_dir,
                                    Checkpointer.FILE_FORMAT.format(args.ckpt_index)))
    context = np.load(os.path.join(args.ckpt_dir, "meta.npy"),
                      allow_pickle=True).item()

    a = get_by_suffix(named, "a")
    b = get_by_suffix(named, "b")
    w_std = get_by_suffix(named, "w_std")
    b_std = get_by_suffix(named, "b_std")
    last_w_std = get_by_suffix(named, "last_w_std")
    inducing_points = get_by_suffix(named, "inducing_variable")
    q_mu = get_by_suffix(named, "q_mu")
    q_sqrt = get_by_suffix(named, "q_sqrt")

    method = context["method"]
    if last_w_std is None:
        last_w_std = np.array(context["last_w_std"])

    model = _make_model(method, context["network"], context["num_hiddens"],
                        context["activation"], 0., 0., 0.,
                        context.get("alpha", 2.), context.get("beta", 2.),
                        num_class, inducing_points, 1e-6)
    params = model.init_params()
    params["kernel"]["w_std"] = jnp.asarray(w_std)
    params["kernel"]["b_std"] = jnp.asarray(b_std)
    params["kernel"]["last_w_std"] = jnp.asarray(last_w_std)
    params["q_mu"] = jnp.asarray(q_mu)
    params["q_sqrt"] = jnp.asarray(q_sqrt)
    # NB: eps is deliberately NOT restored — the reference's classification
    # test evaluates with the constructor default eps=1e-6
    # (classification/test.py:129-144 restores only a/b/scales/q_mu/q_sqrt).
    if method == "svtp":
        params["prior"]["a"] = jnp.asarray(a)
        params["prior"]["b"] = jnp.asarray(b)
    return model, params, context


def _resize_to_inducing(x, inducing_points):
    """Resize inputs to the inducing-point resolution
    (classification/test.py:112-114); host-side (snngp/data/resize.py)."""
    h, w, c = inducing_points.shape[1:]
    return bilinear_resize(x, h, w)


def test_main(args):
    (x_test, y_test), (num_class, data_name) = get_test_dataset(
        name=args.data_name, root=args.data_root,
        num_data=args.num_data, normalize=True,
    )

    model, params, context = _restore_svsp(args, num_class)
    method, network = context["method"], context["network"]

    log_dir = os.path.join(args.ckpt_dir, "test")
    log_name = f"{method}-{network}-{data_name.replace('/', '-')}-{args.ckpt_index}.log"
    logger = Logger(log_dir, log_name, quite=args.quite)

    x_test = _resize_to_inducing(x_test, params["inducing_variable"])

    logger.log(f"Data: {data_name}")
    logger.log(f"Epoch: {args.ckpt_index}")

    @jax.jit
    def test_step(params, key, x_batch, y_batch):
        return model.test_acc_nll(params, key, x_batch, y_batch, args.num_sample)

    test_loader = DataLoader(x_test, y_test, batch_size=args.num_batch, shuffle=False)

    key = random.PRNGKey(args.seed)
    nll_sum, corrects = 0.0, 0
    from snngp.utils.training import tqdm
    for x_batch, y_batch in tqdm(test_loader, desc="Test", leave=False, ncols=0,
                                 disable=args.quite):
        key, split_key = random.split(key)
        nll, cc = test_step(params, split_key, jnp.asarray(x_batch), jnp.asarray(y_batch))
        nll_sum += float(nll) * x_batch.shape[0]
        corrects += int(cc)

    test_nll = nll_sum / test_loader.num_data
    test_acc = corrects * 100 / test_loader.num_data
    logger.log(f"NLL: {test_nll:.5f}  ACC: {test_acc:.2f}\n")
    logger.close()


# ---------------------------------------------------------------------------
# predict (serving path; beyond the reference, which only has test)
# ---------------------------------------------------------------------------

def _add_predict_parser(subparsers):
    parser = subparsers.add_parser("predict", aliases=["pr"])
    parser.set_defaults(func=predict_main)

    parser.add_argument("-dr", "--data-root",  type=str, default="./data")
    parser.add_argument("-dn", "--data-name",  required=True)
    parser.add_argument("-cd", "--ckpt-dir",   type=str, required=True)
    parser.add_argument("-ci", "--ckpt-index", type=int, default=None)
    parser.add_argument("-nd", "--num-data",   type=int, default=None)
    parser.add_argument("-nb", "--num-batch",  type=int, default=100)
    parser.add_argument("-ns", "--num-sample", type=int, default=10000)
    parser.add_argument("-i",  "--input",      type=str, default=None,
                        help=".npy of [N, H, W, C] images already normalized "
                             "like the training data; default = test split")
    parser.add_argument("-o",  "--output",     type=str, default=None,
                        help="output .npz of class probabilities [N, C]; "
                             "default <ckpt_dir>/predictions.npz")
    parser.add_argument("-s",  "--seed",       type=int, default=10)
    parser.add_argument("-q",  "--quite",      default=False, action="store_true")


def predict_main(args):
    from snngp.models import fit_svsp

    (x_test, y_test), (num_class, data_name) = get_test_dataset(
        name=args.data_name, root=args.data_root,
        num_data=args.num_data, normalize=True,
    )
    model, params, context = _restore_svsp(args, num_class)

    logger = Logger(os.path.join(args.ckpt_dir, "predict"), "predict.log",
                    quite=args.quite)
    try:
        if args.input:
            x_in, y_eval = np.load(args.input), None
        else:
            x_in, y_eval = x_test, y_test
        x_in = _resize_to_inducing(x_in, params["inducing_variable"])

        fitted = fit_svsp(model, params)

        @jax.jit
        def proba_step(key, x_batch):
            return fitted.predict_proba(key, x_batch, args.num_sample)

        @jax.jit
        def eval_step(key, x_batch, y_batch):
            return fitted.test_acc_nll(key, x_batch, y_batch, args.num_sample)

        key = random.PRNGKey(args.seed)
        probas, nll_sum, corrects = [], 0.0, 0
        for start in range(0, x_in.shape[0], args.num_batch):
            stop = min(start + args.num_batch, x_in.shape[0])
            xb = jnp.asarray(x_in[start:stop])
            key, split_key = random.split(key)
            probas.append(np.asarray(proba_step(split_key, xb)))
            if y_eval is not None:
                yb = jnp.asarray(y_eval[start:stop])
                nll, cc = eval_step(split_key, xb, yb)
                nll_sum += float(nll) * xb.shape[0]
                corrects += int(cc)

        proba = np.concatenate(probas, axis=0)
        out = args.output or os.path.join(args.ckpt_dir, "predictions.npz")
        np.savez(out, proba=proba, label=np.argmax(proba, axis=1))
        logger.log(f"predicted {proba.shape[0]} points -> {out}")
        if y_eval is not None:
            n = x_in.shape[0]
            logger.log(f"NLL: {nll_sum / n:.5f}  ACC: {corrects * 100 / n:.2f}\n")

    except KeyboardInterrupt:
        raise
    except Exception:
        import traceback
        logger.log(f"\n{traceback.format_exc()}\nStopped")
    finally:
        logger.close()
