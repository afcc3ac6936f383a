"""scikit-learn-style estimator facade over the snngp model layer.

The reference exposes its models only through the experiment CLI
(``experiments/regression/train.py``, ``classification/train.py``); library
users have to re-assemble kernels, likelihoods, optimizers, and the
normalization conventions by hand. These two estimators package the same
pipeline behind the fit/predict contract every sklearn user knows:

- :class:`SNNGPRegressor` — exact-inference NNGP regression (``SPR``,
  reference ``spax/models.py:81-120``) with ``method="gp"`` (Gaussian) or
  ``"tp"`` (Student-t scale mixture), optional ML-II hyperparameter
  training, and O(N x n) repeated prediction through the fitted-state
  predictor (:mod:`snngp.models.predictor`).
- :class:`SNNGPClassifier` — sparse variational classification (``SVSP``,
  reference ``spax/models.py:15-78``) with ``method="svgp"``/``"svtp"``,
  minibatch ELBO training, and MC ``predict_proba``.

Both follow sklearn conventions: ``__init__`` only stores hyperparameters,
``fit`` returns ``self``, learned attributes end in ``_``, and
``get_params``/``set_params`` make them clone-/grid-search-compatible.
sklearn itself is NOT required.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import random

from snngp.models import (SPR, SVSP, GaussianLikelihood, GaussianPrior,
                          InverseGammaPrior, NNGPKernel, StudentTLikelihood)
from snngp.models.predictor import fit_spr, fit_svsp
from snngp.utils.optim import Adam, SGD

__all__ = ["SNNGPRegressor", "SNNGPClassifier"]


class _EstimatorBase:
    """Minimal sklearn estimator protocol (no sklearn dependency)."""

    _param_names: tuple = ()

    def get_params(self, deep: bool = True):
        return {k: getattr(self, k) for k in self._param_names}

    def set_params(self, **kwargs):
        for k, v in kwargs.items():
            if k not in self._param_names:
                raise ValueError(f"Invalid parameter {k!r} for "
                                 f"{type(self).__name__}")
            setattr(self, k, v)
        return self

    def __repr__(self):
        args = ", ".join(f"{k}={getattr(self, k)!r}" for k in self._param_names)
        return f"{type(self).__name__}({args})"


class SNNGPRegressor(_EstimatorBase):
    """Exact NNGP / Student-t process regression with fit/predict semantics.

    Parameters mirror ``reg tr`` flags (reference
    ``regression/train.py:27-58``): ``method`` gp|tp, ``network``
    mlp|resnet, depth/activation/scale hyperparameters, ``alpha``/``beta``
    for the Student-t scale mixture, jitter ``eps``. ``max_steps > 0`` runs
    full-batch ML-II on the marginal likelihood (Adam/SGD on the scale
    scalars, likelihood params, and eps — exactly the CLI's training loss);
    ``max_steps=0`` keeps the constructor hyperparameters.

    ``fit`` normalizes targets (train mean/std, like the reference data
    pipeline) and hoists the O(N^3) train-side solve into a fitted
    predictor, so ``predict``/``score`` cost O(N x n) per call.

    ``seed`` is accepted for sklearn grid-search compatibility but unused:
    exact-inference fitting is deterministic (closed-form Gram + full-batch
    ML-II from a deterministic init).
    """

    _param_names = ("method", "network", "num_hiddens", "activation",
                    "w_std", "b_std", "last_w_std", "alpha", "beta", "eps",
                    "optimizer", "lr", "max_steps", "normalize_y", "seed",
                    "extendable")

    def __init__(self, method="tp", network="mlp", num_hiddens=4,
                 activation="relu", w_std=1.0, b_std=1e-8, last_w_std=1.0,
                 alpha=2.0, beta=2.0, eps=1e-6, optimizer="adam", lr=1e-2,
                 max_steps=0, normalize_y=True, seed=10, extendable=False):
        self.method = method
        self.network = network
        self.num_hiddens = num_hiddens
        self.activation = activation
        self.w_std = w_std
        self.b_std = b_std
        self.last_w_std = last_w_std
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        self.optimizer = optimizer
        self.lr = lr
        self.max_steps = max_steps
        self.normalize_y = normalize_y
        self.seed = seed
        self.extendable = extendable

    # -- sklearn protocol --------------------------------------------------

    def fit(self, X, y):
        from snngp.cli.regression import _build_model

        X = jnp.asarray(np.asarray(X, np.float32))
        y = np.asarray(y, np.float32).reshape(-1)
        if self.normalize_y:
            y_mean, y_std = float(y.mean()), float(y.std() or 1.0)
        else:
            y_mean, y_std = 0.0, 1.0
        y_n = jnp.asarray((y - y_mean) / y_std)

        cfg = dict(network=self.network, num_hiddens=self.num_hiddens,
                   activation=self.activation, w_std=self.w_std,
                   b_std=self.b_std, last_w_std=self.last_w_std,
                   method=self.method, alpha=self.alpha, beta=self.beta,
                   epsilon=self.eps)
        model, _ = _build_model(cfg, X, y_n, y_mean, y_std)
        params = model.init_params()

        if self.max_steps:
            opt = Adam() if self.optimizer == "adam" else SGD()
            opt_state = opt.init(params)

            @jax.jit
            def step(params, opt_state):
                loss, grads = jax.value_and_grad(model.loss)(params)
                params, opt_state = opt.update(grads, opt_state, params,
                                               self.lr)
                return params, opt_state, loss

            for _ in range(self.max_steps):
                params, opt_state, loss = step(params, opt_state)
            self.final_loss_ = float(loss)

        self.model_ = model
        self.params_ = params
        self.fitted_ = fit_spr(model, params, extendable=self.extendable)
        return self

    def add_data(self, X, y):
        """Grow the fitted training set incrementally (O(N^2 m), no refit).

        Requires ``extendable=True`` at construction. New targets are
        normalized with the FIT-TIME statistics; hyperparameters are not
        re-trained (call ``fit`` on the combined data for that).
        """
        self.fitted_ = self.fitted_.extend(
            jnp.asarray(np.asarray(X, np.float32)),
            jnp.asarray(np.asarray(y, np.float32).reshape(-1)))
        self.model_ = self.fitted_.model
        return self

    def predict(self, X, return_std: bool = False):
        """De-normalized predictive mean (and optionally its std)."""
        mean, var = self.fitted_.predict(jnp.asarray(np.asarray(X, np.float32)))
        if return_std:
            return np.asarray(mean), np.asarray(jnp.sqrt(var))
        return np.asarray(mean)

    def score(self, X, y):
        """R^2 of the predictive mean (sklearn regressor convention)."""
        y = np.asarray(y, np.float64).reshape(-1)
        pred = np.asarray(self.predict(X), np.float64)
        ss_res = float(((y - pred) ** 2).sum())
        ss_tot = float(((y - y.mean()) ** 2).sum())
        return 1.0 - ss_res / ss_tot if ss_tot else 0.0

    def neg_log_likelihood(self, X, y):
        """Mean predictive NLL on raw-scale targets (the paper's metric)."""
        s = self.fitted_.state
        y_n = (jnp.asarray(np.asarray(y, np.float32).reshape(-1))
               - s["y_mean"]) / s["y_std"]
        return float(self.fitted_.test_nll(
            jnp.asarray(np.asarray(X, np.float32)), y_n))


class SNNGPClassifier(_EstimatorBase):
    """Sparse variational NNGP / Student-t process classification.

    Parameters mirror ``cls tr`` flags (reference
    ``classification/train.py``): ``method`` svgp|svtp, conv ``network``
    cnn|resnet|myrtle (images; myrtle freezes the inducing inputs and takes
    scalar-only kernel gradients, see ``cls tr -n myrtle``) or the mlp
    kernel for flat features via
    ``network="mlp"``, inducing-point count, ELBO MC sample count, and the
    minibatch SGD schedule. ``fit`` uses the reference's class-proportional
    inducing initialization, trains the ELBO with Adam/SGD, and hoists the
    inducing-side solves into a fitted predictor for serving-cost
    ``predict_proba``.
    """

    _param_names = ("method", "network", "num_hiddens", "activation",
                    "w_std", "b_std", "last_w_std", "alpha", "beta", "eps",
                    "num_inducing", "num_samples", "batch_size", "epochs",
                    "optimizer", "lr", "seed")

    def __init__(self, method="svtp", network="cnn", num_hiddens=4,
                 activation="relu", w_std=1.0, b_std=0.0, last_w_std=1.0,
                 alpha=2.0, beta=2.0, eps=1e-6, num_inducing=100,
                 num_samples=100, batch_size=64, epochs=10,
                 optimizer="adam", lr=1e-2, seed=10):
        self.method = method
        self.network = network
        self.num_hiddens = num_hiddens
        self.activation = activation
        self.w_std = w_std
        self.b_std = b_std
        self.last_w_std = last_w_std
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        self.num_inducing = num_inducing
        self.num_samples = num_samples
        self.batch_size = batch_size
        self.epochs = epochs
        self.optimizer = optimizer
        self.lr = lr
        self.seed = seed

    def _make_kernel_builder(self, num_class):
        if self.network == "mlp":
            from snngp.nn.arch import get_mlp_kernel

            def get_kernel_fn(w, b, l):
                return get_mlp_kernel(self.num_hiddens, num_class,
                                      self.activation, w_std=w, b_std=b,
                                      last_w_std=l)
        elif self.network == "myrtle":
            # Same convention as `cls tr -n myrtle`: the inducing inputs are
            # frozen at their class-proportional init by the optimizer mask
            # in fit.
            if self.num_hiddens not in (5, 7, 10):
                raise ValueError(
                    "network='myrtle' uses num_hiddens as the Myrtle depth: "
                    f"one of 5, 7, 10 (got {self.num_hiddens})")
            from snngp.cli.classification import _base_kernel
            _, base = _base_kernel(self.network)

            def get_kernel_fn(w, b, l):
                return base(self.num_hiddens, num_class, self.activation,
                            w_std=w, b_std=b, last_w_std=l)
        else:
            from snngp.cli.classification import _base_kernel
            _, base = _base_kernel(self.network)

            def get_kernel_fn(w, b, l):
                return base(self.num_hiddens, num_class, self.activation,
                            w_std=w, b_std=b, last_w_std=l)
        return get_kernel_fn

    def fit(self, X, y):
        X = np.asarray(X, np.float32)
        y = np.asarray(y).reshape(-1).astype(np.int32)
        self.classes_ = np.unique(y)
        num_class = len(self.classes_)
        y_idx = np.searchsorted(self.classes_, y).astype(np.int32)

        # Class-proportional inducing init (classification/train.py:186-190):
        # the FIRST per_class[c] points of each class, deterministically —
        # the reference's (and `cls tr`'s) exact convention, so facade and
        # CLI produce identical inits for the same data/seed.
        counts = np.bincount(y_idx, minlength=num_class)
        per_class = np.round(self.num_inducing * counts / counts.sum()
                             ).astype(int)
        z = np.concatenate([
            X[y_idx == c][:max(per_class[c], 1)]
            for c in range(num_class)], axis=0)

        # Shared with the CLI so the svgp/svtp conventions (incl. the svtp
        # last_w_std=1 freeze) live in exactly one place.
        from snngp.cli.classification import _make_model
        model = _make_model(
            self.method, self.network, self.num_hiddens, self.activation,
            self.w_std, self.b_std, self.last_w_std, self.alpha, self.beta,
            num_class, jnp.asarray(z), self.eps,
            get_kernel_fn=self._make_kernel_builder(num_class))
        params = model.init_params()
        opt_cls = Adam if self.optimizer == "adam" else SGD
        if self.network == "myrtle":
            from snngp.utils.optim import name_mask
            opt = opt_cls(mask=name_mask(
                params, lambda n: "inducing_variable" not in n))
        else:
            opt = opt_cls()
        opt_state = opt.init(params)
        num_train = X.shape[0]

        @jax.jit
        def step(params, opt_state, key, xb, yb):
            loss, grads = jax.value_and_grad(model.loss)(
                params, key, xb, yb, num_train, self.num_samples)
            params, opt_state = opt.update(grads, opt_state, params, self.lr)
            return params, opt_state, loss

        key = random.PRNGKey(self.seed)
        xj, yj = jnp.asarray(X), jnp.asarray(y_idx)
        loss = jnp.asarray(float("nan"))
        for _ in range(self.epochs):
            key, pkey = random.split(key)
            order = np.asarray(random.permutation(pkey, num_train))
            for lo in range(0, num_train, self.batch_size):
                idx = order[lo:lo + self.batch_size]
                key, skey = random.split(key)
                params, opt_state, loss = step(
                    params, opt_state, skey, xj[idx], yj[idx])
        self.final_loss_ = float(loss)

        self.model_ = model
        self.params_ = params
        self.fitted_ = fit_svsp(model, params)
        self._predict_key = random.PRNGKey(self.seed + 1)
        return self

    def predict_proba(self, X, num_samples: int = 1000):
        """Mean MC predictive class probabilities [n, n_classes]."""
        proba = self.fitted_.predict_proba(
            self._predict_key, jnp.asarray(np.asarray(X, np.float32)),
            num_samples=num_samples)
        return np.asarray(proba)

    def predict(self, X):
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)]

    def score(self, X, y):
        """Accuracy (sklearn classifier convention)."""
        y = np.asarray(y).reshape(-1)
        return float((self.predict(X) == y).mean())
