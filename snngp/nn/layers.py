"""Compositional NNGP/NTK layers (replacement for neural_tangents.stax).

Each layer is a :class:`Layer` with

- ``kfn``:   closed-form covariance recursion ``KernelState -> KernelState``
- ``init``:  finite-width parameter init ``(key, in_shape) -> (out_shape, params)``
- ``apply``: finite-width forward ``(params, x) -> y``

using the NTK parameterization (weights ~ N(0,1) scaled by ``W_std/sqrt(fan_in)``,
bias ~ N(0,1) scaled by ``b_std``), matching ``stax.Dense``/``stax.Conv`` as used
by the reference (``experiments/nt_kernels.py``, ``experiments/ensemble/train.py:57-65``).

Closed forms implemented here (with citations to the reference's use sites):

- Dense(w, b):   K' = w^2 K + b^2                                  (affine)
- Conv 3x3:      K' = w^2 * patch_mean(K) + b^2     (i.i.d. filter offsets only
                 couple equal offsets across the two inputs -> stencil average)
- Relu:          arccos kernel  K' = sqrt(v1 v2)/(2pi) (sin t + (pi - t) cos t)
- Erf:           arcsin kernel  K' = (2/pi) asin(2K / sqrt((1+2v1)(1+2v2)))
- Flatten:       spatial mean (exact for Flatten+Dense readout)
- FanOut/parallel/FanInSum/Identity: residual-branch bookkeeping
  (cross terms vanish because branch output layers have independent zero-mean
  weights; used by the WideResNet/dense-ResNet builders,
  ``experiments/nt_kernels.py:48-103``).

NTK recursion: affine: T' = K' + w^2 T; nonlinearity: T' = T * E[phi'(u)phi'(v)].
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from snngp.nn.state import KernelState, input_state

__all__ = [
    "Layer",
    "Dense",
    "Conv",
    "Relu",
    "Erf",
    "Flatten",
    "Identity",
    "FanOut",
    "FanInSum",
    "AvgPool",
    "GlobalAvgPool",
    "serial",
    "parallel",
    "kernel_fn_of",
]


def _is_full(k) -> bool:
    """True when k is a full spatial-covariance state (snngp.nn.full).

    Every layer's kfn is polymorphic over the two kernel-state tiers: the
    matched-pixel KernelState (exact for Flatten readouts, cheap) and the
    FullKernelState pixel-pair covariance (exact for pooled readouts). One
    composed Layer therefore serves both tiers — pick per call via
    ``kernel_fn_of(layer, full=True)``. Duck-typed on the ``cov1`` field to
    avoid a circular import with snngp.nn.full.
    """
    return hasattr(k, "cov1")


@dataclasses.dataclass(frozen=True)
class Layer:
    kfn: Callable[[Any], Any]
    init: Callable[[jax.Array, Tuple[int, ...]], Tuple[Tuple[int, ...], Any]]
    apply: Callable[[Any, jax.Array], jax.Array]


# ---------------------------------------------------------------------------
# Affine layers
# ---------------------------------------------------------------------------

def Dense(out_dim: int, w_std, b_std=0.0) -> Layer:
    """Fully-connected layer, NTK parameterization (stax.Dense analogue)."""

    def kfn(k: KernelState) -> KernelState:
        if _is_full(k):
            from snngp.nn import full as F
            return F.DenseF(w_std, b_std)(k)
        w2 = w_std * w_std
        b2 = b_std * b_std
        nngp = w2 * k.nngp + b2
        ntk = None if k.ntk is None else nngp + w2 * k.ntk
        return KernelState(
            nngp=nngp, var1=w2 * k.var1 + b2, var2=w2 * k.var2 + b2, ntk=ntk
        )

    def init(key, in_shape):
        d = in_shape[-1]
        kw, kb = jax.random.split(key)
        w = jax.random.normal(kw, (d, out_dim))
        b = jax.random.normal(kb, (out_dim,))
        return in_shape[:-1] + (out_dim,), (w, b)

    def apply(params, x):
        w, b = params
        d = x.shape[-1]
        return (w_std / jnp.sqrt(d)) * (x @ w) + b_std * b

    return Layer(kfn, init, apply)


def _patch_mean(img: jax.Array, filter_shape, strides) -> jax.Array:
    """SAME-padded stencil mean over filter offsets, [..., H, W] -> [..., H', W'].

    Equivalent to a depthwise all-ones conv / filter_count with zero padding,
    replicating lax.conv SAME alignment (which stax.Conv uses underneath).
    """
    batch_shape = img.shape[:-2]
    h, w = img.shape[-2:]
    x = img.reshape((-1, h, w, 1))
    kern = jnp.ones(filter_shape + (1, 1), img.dtype) / (filter_shape[0] * filter_shape[1])
    out = lax.conv_general_dilated(
        x, kern, window_strides=strides, padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    return out.reshape(batch_shape + out.shape[1:3])


def Conv(out_chan: int, filter_shape=(3, 3), strides=(1, 1), padding: str = "SAME",
         w_std=1.0, b_std=0.0) -> Layer:
    """2D convolution, NTK parameterization (stax.Conv analogue).

    Matched-pixel covariance recursion: with i.i.d. filter weights only equal
    offsets couple across the two inputs, so
    ``K'[i, j, p] = w^2 * mean_d K[i, j, s*p + d] + b^2`` (zeros off the edge).
    """
    if padding != "SAME":
        raise NotImplementedError("only SAME padding (all reference archs use SAME)")

    def kfn(k: KernelState) -> KernelState:
        if _is_full(k):
            from snngp.nn import full as F
            return F.ConvF(filter_shape, strides, w_std, b_std)(k)
        if not k.spatial:
            raise ValueError("Conv requires spatial kernel state ([N,H,W,C] inputs)")
        w2 = w_std * w_std
        b2 = b_std * b_std
        nngp = w2 * _patch_mean(k.nngp, filter_shape, strides) + b2
        var1 = w2 * _patch_mean(k.var1, filter_shape, strides) + b2
        var2 = w2 * _patch_mean(k.var2, filter_shape, strides) + b2
        ntk = None if k.ntk is None else nngp + w2 * _patch_mean(k.ntk, filter_shape, strides)
        return KernelState(nngp=nngp, var1=var1, var2=var2, ntk=ntk)

    def init(key, in_shape):
        c = in_shape[-1]
        kw, kb = jax.random.split(key)
        w = jax.random.normal(kw, filter_shape + (c, out_chan))
        b = jax.random.normal(kb, (out_chan,))
        h, wdim = in_shape[-3:-1]
        oh = -(-h // strides[0])
        ow = -(-wdim // strides[1])
        return in_shape[:-3] + (oh, ow, out_chan), (w, b)

    def apply(params, x):
        w, b = params
        fan_in = filter_shape[0] * filter_shape[1] * x.shape[-1]
        y = lax.conv_general_dilated(
            x, w, window_strides=strides, padding="SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        )
        return (w_std / jnp.sqrt(fan_in)) * y + b_std * b

    return Layer(kfn, init, apply)


# ---------------------------------------------------------------------------
# Nonlinearities (dual activations with custom JVPs for gram-diagonal safety)
# ---------------------------------------------------------------------------

_TINY = 1e-30


@jax.custom_jvp
def _relu_t(nngp, v1, v2):
    """Arccos kernel T(K) = E[relu(u) relu(v)] for (u,v) ~ N(0, [[v1,K],[K,v2]])."""
    s = jnp.sqrt(jnp.maximum(v1 * v2, _TINY))
    c = jnp.clip(nngp / s, -1.0, 1.0)
    theta = jnp.arccos(c)
    return (s * jnp.sin(theta) + (jnp.pi - theta) * nngp) / (2.0 * jnp.pi)


@_relu_t.defjvp
def _relu_t_jvp(primals, tangents):
    # Analytic derivatives are finite at c = +-1 (gram diagonal), where naive
    # autodiff through arccos produces NaN: dT/dK = (pi - theta)/(2 pi),
    # dT/dv1 = sin(theta) v2 / (4 pi s), symmetrically for v2.
    nngp, v1, v2 = primals
    dk, dv1, dv2 = tangents
    s = jnp.sqrt(jnp.maximum(v1 * v2, _TINY))
    c = jnp.clip(nngp / s, -1.0, 1.0)
    theta = jnp.arccos(c)
    sin_t = jnp.sin(theta)
    out = (s * sin_t + (jnp.pi - theta) * nngp) / (2.0 * jnp.pi)
    d_out = ((jnp.pi - theta) / (2.0 * jnp.pi)) * dk \
        + (sin_t * v2 / (4.0 * jnp.pi * s)) * dv1 \
        + (sin_t * v1 / (4.0 * jnp.pi * s)) * dv2
    return out, d_out


def _relu_tdot(nngp, v1, v2):
    """E[relu'(u) relu'(v)] = P(u>0, v>0) = (pi - theta) / (2 pi)."""
    s = jnp.sqrt(jnp.maximum(v1 * v2, _TINY))
    c = jnp.clip(nngp / s, -1.0, 1.0)
    return (jnp.pi - jnp.arccos(c)) / (2.0 * jnp.pi)


def _outer(v1, v2, spatial: bool):
    """Broadcast var1 [N1,...] and var2 [N2,...] against nngp [N1,N2,...]."""
    if spatial:
        return v1[:, None, :, :], v2[None, :, :, :]
    return v1[:, None], v2[None, :]


def Relu() -> Layer:
    def kfn(k: KernelState) -> KernelState:
        if _is_full(k):
            from snngp.nn import full as F
            return F.ActF("relu")(k)
        b1, b2 = _outer(k.var1, k.var2, k.spatial)
        nngp = _relu_t(k.nngp, b1, b2)
        ntk = None if k.ntk is None else k.ntk * _relu_tdot(k.nngp, b1, b2)
        return KernelState(nngp=nngp, var1=k.var1 / 2.0, var2=k.var2 / 2.0, ntk=ntk)

    def init(key, in_shape):
        return in_shape, ()

    def apply(params, x):
        return jnp.maximum(x, 0.0)

    return Layer(kfn, init, apply)


def _erf_t(nngp, v1, v2):
    """Arcsin kernel T(K) = E[erf(u) erf(v)] = (2/pi) asin(2K / sqrt((1+2v1)(1+2v2)))."""
    denom = jnp.sqrt((1.0 + 2.0 * v1) * (1.0 + 2.0 * v2))
    return (2.0 / jnp.pi) * jnp.arcsin(jnp.clip(2.0 * nngp / denom, -1.0, 1.0))


def _erf_tdot(nngp, v1, v2):
    """E[erf'(u) erf'(v)] = (4/pi) / sqrt((1+2v1)(1+2v2) - 4K^2)."""
    det = (1.0 + 2.0 * v1) * (1.0 + 2.0 * v2) - 4.0 * nngp * nngp
    return (4.0 / jnp.pi) / jnp.sqrt(jnp.maximum(det, _TINY))


def Erf() -> Layer:
    def kfn(k: KernelState) -> KernelState:
        if _is_full(k):
            from snngp.nn import full as F
            return F.ActF("erf")(k)
        b1, b2 = _outer(k.var1, k.var2, k.spatial)
        nngp = _erf_t(k.nngp, b1, b2)
        ntk = None if k.ntk is None else k.ntk * _erf_tdot(k.nngp, b1, b2)
        var1 = _erf_t(k.var1, k.var1, k.var1)
        var2 = _erf_t(k.var2, k.var2, k.var2)
        return KernelState(nngp=nngp, var1=var1, var2=var2, ntk=ntk)

    def init(key, in_shape):
        return in_shape, ()

    def apply(params, x):
        return jax.scipy.special.erf(x)

    return Layer(kfn, init, apply)


# ---------------------------------------------------------------------------
# Shape / branching layers
# ---------------------------------------------------------------------------

def Flatten() -> Layer:
    """Spatial mean readout (exact for Flatten -> Dense; stax.Flatten analogue)."""

    def kfn(k: KernelState) -> KernelState:
        if _is_full(k):
            from snngp.nn import full as F
            return F.FlattenF()(k) if k.spatial else k
        if not k.spatial:
            return k
        return KernelState(
            nngp=jnp.mean(k.nngp, axis=(-2, -1)),
            var1=jnp.mean(k.var1, axis=(-2, -1)),
            var2=jnp.mean(k.var2, axis=(-2, -1)),
            ntk=None if k.ntk is None else jnp.mean(k.ntk, axis=(-2, -1)),
        )

    def init(key, in_shape):
        if len(in_shape) == 2:
            return in_shape, ()
        n = in_shape[0]
        flat = 1
        for s in in_shape[1:]:
            flat *= s
        return (n, flat), ()

    def apply(params, x):
        return x.reshape((x.shape[0], -1))

    return Layer(kfn, init, apply)


def AvgPool(window=(2, 2), strides=None) -> Layer:
    """Non-overlapping average pooling (stax.AvgPool analogue; the reference
    comments it out at ``experiments/nt_kernels.py:75``).

    Kernel recursion exists only on the full spatial-covariance tier
    (``kernel_fn_of(layer, full=True)``); pooling mixes different pixels, so
    the matched-pixel state cannot express it exactly.
    """
    if strides is not None and tuple(strides) != tuple(window):
        raise NotImplementedError("only window == strides pooling")
    win = window[0]

    def kfn(k):
        if _is_full(k):
            from snngp.nn import full as F
            return F.AvgPoolF(window)(k)
        raise NotImplementedError(
            "exact NNGP average pooling requires the full spatial-covariance "
            "tier: build the kernel with kernel_fn_of(layer, full=True)")

    def init(key, in_shape):
        n, h, w, c = in_shape
        return (n, h // win, w // win, c), ()

    def apply(params, x):
        n, h, w, c = x.shape
        return x.reshape(n, h // win, win, w // win, win, c).mean(axis=(2, 4))

    return Layer(kfn, init, apply)


def GlobalAvgPool() -> Layer:
    """Global average pool over spatial dims.

    Kernel recursion exists only on the full spatial-covariance tier
    (``kernel_fn_of(layer, full=True)``): exact global pooling needs the
    cross-pixel covariance the matched-pixel state drops. The reference never
    enables pooling (``experiments/nt_kernels.py:75`` comments AvgPool out);
    the finite-width path works on either tier.
    """

    def kfn(k: KernelState) -> KernelState:
        if _is_full(k):
            from snngp.nn import full as F
            return F.GlobalAvgPoolF()(k)
        raise NotImplementedError(
            "exact NNGP global pooling requires the full spatial-covariance "
            "tier: build the kernel with kernel_fn_of(layer, full=True)"
        )

    def init(key, in_shape):
        return (in_shape[0], in_shape[-1]), ()

    def apply(params, x):
        return jnp.mean(x, axis=(1, 2))

    return Layer(kfn, init, apply)


def Identity() -> Layer:
    return Layer(lambda k: k, lambda key, s: (s, ()), lambda p, x: x)


def FanOut(n: int) -> Layer:
    def kfn(k):
        return tuple(k for _ in range(n))

    def init(key, in_shape):
        return tuple(in_shape for _ in range(n)), ()

    def apply(params, x):
        return tuple(x for _ in range(n))

    return Layer(kfn, init, apply)


def FanInSum() -> Layer:
    """Sum of parallel branches.

    Kernels add: branch outputs have zero cross-covariance because every
    weighted branch ends in an independent zero-mean affine layer, and the
    identity shortcut is uncorrelated with any weighted branch's output
    (the standard residual NNGP bookkeeping used by stax.FanInSum).
    """

    def kfn(ks):
        nngp = sum(k.nngp for k in ks)
        ntk = None if ks[0].ntk is None else sum(k.ntk for k in ks)
        if _is_full(ks[0]):
            return type(ks[0])(nngp, sum(k.cov1 for k in ks),
                               sum(k.cov2 for k in ks), ntk)
        var1 = sum(k.var1 for k in ks)
        var2 = sum(k.var2 for k in ks)
        return KernelState(nngp=nngp, var1=var1, var2=var2, ntk=ntk)

    def init(key, in_shapes):
        return in_shapes[0], ()

    def apply(params, xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out

    return Layer(kfn, init, apply)


def serial(*layers: Layer) -> Layer:
    def kfn(k):
        for layer in layers:
            k = layer.kfn(k)
        return k

    def init(key, in_shape):
        params = []
        shape = in_shape
        for layer in layers:
            key, sub = jax.random.split(key)
            shape, p = layer.init(sub, shape)
            params.append(p)
        return shape, tuple(params)

    def apply(params, x):
        for layer, p in zip(layers, params):
            x = layer.apply(p, x)
        return x

    return Layer(kfn, init, apply)


def parallel(*layers: Layer) -> Layer:
    def kfn(ks):
        return tuple(layer.kfn(k) for layer, k in zip(layers, ks))

    def init(key, in_shapes):
        shapes, params = [], []
        for layer, s in zip(layers, in_shapes):
            key, sub = jax.random.split(key)
            so, p = layer.init(sub, s)
            shapes.append(so)
            params.append(p)
        return tuple(shapes), tuple(params)

    def apply(params, xs):
        return tuple(layer.apply(p, x) for layer, p, x in zip(layers, params, xs))

    return Layer(kfn, init, apply)


def kernel_fn_of(layer: Layer, full: bool = False, dtype=None):
    """Turn a composed Layer into ``kernel_fn(x1, x2=None, get="nngp")``.

    Mirrors the neural_tangents ``kernel_fn`` call surface used at
    ``spax/kernels.py:23-27``. ``get`` may be "nngp", "ntk", or a tuple.

    ``full=True`` runs the same composed Layer on the full spatial-covariance
    tier (snngp.nn.full) — required for pooled readouts (AvgPool /
    GlobalAvgPool), exact for everything; ``dtype`` optionally stores the 6-D
    state in bf16 at scale. The default matched-pixel tier is exact for
    Flatten readouts and far cheaper.
    """

    def kernel_fn(x1, x2=None, get="nngp"):
        want = (get,) if isinstance(get, str) else tuple(get)
        need_ntk = "ntk" in want
        if full:
            from snngp.nn.full import full_input_state
            state = layer.kfn(full_input_state(x1, x2, ntk=need_ntk,
                                               dtype=dtype))
        else:
            state = layer.kfn(input_state(x1, x2, ntk=need_ntk))
        outs = []
        for g in want:
            if g == "nngp":
                outs.append(state.nngp)
            elif g == "ntk":
                outs.append(state.ntk)
            else:
                raise ValueError(f"unknown get={g!r}")
        return outs[0] if isinstance(get, str) else tuple(outs)

    return kernel_fn
