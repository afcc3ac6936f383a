"""Architecture builders (replacement for experiments/nt_kernels.py).

Each ``get_*_kernel`` mirrors the corresponding reference builder
(``experiments/nt_kernels.py:21-103``) and returns a ``kernel_fn(x1, x2,
get="nngp")`` closure over the (possibly traced) scale hyperparameters, so that
ML-II gradients flow through the full layer recursion exactly as in the
reference (``spax/kernels.py:37-41``).

``get_*_layer`` variants return the composed :class:`snngp.nn.layers.Layer`
(giving access to finite-width init/apply for the ensemble baseline,
reference ``experiments/ensemble/train.py:57-65``).
"""

from __future__ import annotations

import math

from snngp.nn import layers as L

__all__ = [
    "get_act",
    "get_mlp_kernel",
    "get_cnn_kernel",
    "get_conv_resnet_kernel",
    "get_dense_resnet_kernel",
    "get_myrtle_kernel",
    "pair_tiles",
    "state_budget",
    "get_mlp_layer",
    "get_cnn_layer",
    "get_conv_resnet_layer",
    "get_dense_resnet_layer",
    "KERNELS",
]


def get_act(act: str) -> L.Layer:
    if act == "relu":
        return L.Relu()
    if act == "erf":
        return L.Erf()
    raise KeyError(f"Unsupported act '{act}'")


def get_mlp_layer(num_hiddens, num_class=1, act="relu", w_std=1.0, b_std=0.0,
                  last_w_std=1.0, width=512) -> L.Layer:
    """N x [Dense(512) + act] + Dense(num_class)  (nt_kernels.py:21-31)."""
    stack = []
    for _ in range(num_hiddens):
        stack.append(L.Dense(width, w_std=w_std, b_std=b_std))
        stack.append(get_act(act))
    stack.append(L.Dense(num_class, w_std=last_w_std))
    return L.serial(*stack)


def get_cnn_layer(num_hiddens, num_class=1, act="relu", w_std=1.0, b_std=0.0,
                  last_w_std=1.0, channels=1) -> L.Layer:
    """N x [Conv3x3 SAME + act] + Flatten + Dense  (nt_kernels.py:34-45)."""
    stack = []
    for _ in range(num_hiddens):
        stack.append(L.Conv(channels, (3, 3), (1, 1), "SAME", w_std=w_std, b_std=b_std))
        stack.append(get_act(act))
    stack.append(L.Flatten())
    stack.append(L.Dense(num_class, w_std=last_w_std))
    return L.serial(*stack)


def get_conv_resnet_layer(num_hiddens, num_class, act="relu", w_std=1.0,
                          b_std=0.0, last_w_std=1.0, k=1) -> L.Layer:
    """WideResNet NNGP: FanOut/parallel/FanInSum residual blocks, 4 groups with
    stride-2 downsampling (nt_kernels.py:48-80). Channel counts only affect the
    finite-width path (the kernel recursion is width-independent)."""
    act_layer = lambda: get_act(act)

    def block(channels, strides=(1, 1), channel_mismatch=False):
        main = L.serial(
            act_layer(), L.Conv(channels, (3, 3), strides, "SAME", w_std=w_std, b_std=b_std),
            act_layer(), L.Conv(channels, (3, 3), (1, 1), "SAME", w_std=w_std, b_std=b_std),
        )
        shortcut = (L.Identity() if not channel_mismatch
                    else L.Conv(channels, (3, 3), strides, "SAME", w_std=w_std, b_std=b_std))
        return L.serial(L.FanOut(2), L.parallel(main, shortcut), L.FanInSum())

    def group(n, channels, strides=(1, 1)):
        blocks = [block(channels, strides, channel_mismatch=True)]
        for _ in range(n - 1):
            blocks.append(block(channels, (1, 1)))
        return L.serial(*blocks)

    return L.serial(
        L.Conv(16, (3, 3), (1, 1), "SAME", w_std=w_std, b_std=b_std),
        group(num_hiddens, int(8 * k)),
        group(num_hiddens, int(16 * k), (2, 2)),
        group(num_hiddens, int(32 * k), (2, 2)),
        group(num_hiddens, int(64 * k), (2, 2)),
        L.Flatten(),
        L.Dense(num_class, w_std=last_w_std),
    )


def get_dense_resnet_layer(num_hiddens, num_class=1, act="relu", w_std=1.0,
                           b_std=0.0, last_w_std=1.0, width=512) -> L.Layer:
    """Dense residual blocks (nt_kernels.py:83-103)."""

    def res_block():
        return L.serial(
            L.FanOut(2),
            L.parallel(
                L.serial(get_act(act), L.Dense(width, w_std=w_std, b_std=b_std)),
                L.Identity(),
            ),
            L.FanInSum(),
        )

    stack = [L.Dense(width, w_std=w_std, b_std=b_std)]
    stack += [res_block() for _ in range(num_hiddens)]
    stack += [get_act(act), L.Dense(num_class, w_std=last_w_std)]
    return L.serial(*stack)


def _as_kernel_fn(builder):
    def get_kernel(num_hiddens, num_class=1, act="relu", w_std=1.0, b_std=0.0,
                   last_w_std=1.0, **kw):
        layer = builder(num_hiddens, num_class, act, w_std, b_std, last_w_std, **kw)
        return L.kernel_fn_of(layer)

    return get_kernel


# kernel_fn builders on the matched-pixel tier: same arguments as the layer
# builders above.
get_mlp_kernel = _as_kernel_fn(get_mlp_layer)
get_cnn_kernel = _as_kernel_fn(get_cnn_layer)
get_conv_resnet_kernel = _as_kernel_fn(get_conv_resnet_layer)
get_dense_resnet_kernel = _as_kernel_fn(get_dense_resnet_layer)


# Bytes of full-tier pixel-pair state one Myrtle block may hold where the
# device reports no memory limit (the CPU backend).
FIXED_STATE_BUDGET = 1 << 30
# Share of the device's memory limit one block's pixel-pair state may take.
# The forward keeps about three copies of the state alive (input moment,
# padded stencil input, activation output) and a rematerialized backward
# about twice that, so 1/16 leaves room for the rest of the program.
STATE_BUDGET_SHARE = 16


def state_budget() -> int:
    """Per-block budget for the full tier's [n1, n2, hw, hw] state: a share
    of the default device's ``memory_stats()["bytes_limit"]``, or
    :data:`FIXED_STATE_BUDGET` where the device reports none."""
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return int(limit) // STATE_BUDGET_SHARE if limit else FIXED_STATE_BUDGET


def pair_tiles(n1: int, n2: int, hw: int, budget: int):
    """Tile shape (t1, t2) for a Myrtle block whose full-tier state
    (4 * n1 * n2 * hw^2 bytes) exceeds ``budget``; None when it fits.

    The tile is as square as the budget allows, so the per-tile recompute
    of each side's [t, hw, hw] self-covariance stays a small share."""
    per_pair = 4 * hw * hw
    if per_pair * n1 * n2 <= budget:
        return None
    pairs = max(1, budget // per_pair)
    t1 = max(1, min(n1, math.isqrt(pairs)))
    t2 = max(1, min(n2, pairs // t1))
    return t1, t2


def _pair_tiled(fn, x1, x2, t1, t2, symmetric):
    """fn(x1, x2) as a ``lax.map`` over [t1, t2] pair tiles, each under
    ``jax.checkpoint``: forward and reverse mode both hold one tile's state
    at a time. Symmetric blocks compute the upper-triangle tiles only and
    mirror them (t1 == t2 there)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    from snngp.nn.full import pad_rows

    n1, n2 = x1.shape[0], x2.shape[0]
    a = pad_rows(x1, t1).reshape((-1, t1) + x1.shape[1:])
    b = pad_rows(x2, t2).reshape((-1, t2) + x2.shape[1:])
    m1, m2 = a.shape[0], b.shape[0]
    if symmetric:
        ii, jj = np.triu_indices(m1)
    else:
        ii, jj = (g.ravel() for g in np.indices((m1, m2)))
    tile_fn = jax.checkpoint(lambda ij: fn(a[ij[0]], b[ij[1]]))
    tiles = lax.map(tile_fn, (jnp.asarray(ii, jnp.int32),
                              jnp.asarray(jj, jnp.int32)))   # [P, t1, t2]
    if symmetric:
        slot = np.zeros((m1, m1), np.int32)
        slot[ii, jj] = np.arange(ii.size)
        slot[jj, ii] = np.arange(ii.size)
        lower = np.tril(np.ones((m1, m1), bool), -1)[:, :, None, None]
        grid = tiles[slot]                                   # [m1, m1, t, t]
        grid = jnp.where(lower, jnp.swapaxes(grid, -1, -2), grid)
    else:
        grid = tiles.reshape(m1, m2, t1, t2)
    out = grid.transpose(0, 2, 1, 3).reshape(m1 * t1, m2 * t2)
    return out[:n1, :n2]


def get_myrtle_kernel(depth=5, num_class=1, act="relu", w_std=1.0, b_std=0.0,
                      last_w_std=1.0):
    """Myrtle-{5,7,10} kernel_fn on the full spatial-covariance tier (2x2
    average pooling + GAP, :mod:`snngp.nn.full`), bounded in memory.

    The full tier holds a [n1, n2, hw, hw] pixel-pair state: 4 MB per image
    pair at 32x32. An nngp block whose state exceeds :func:`state_budget`
    runs as a checkpointed ``lax.map`` over pair tiles (:func:`pair_tiles`),
    so a [200, 200] SVSP inducing Gram at 32x32 (160 GB of state) trains on
    one device; smaller blocks run in one piece."""
    from snngp.nn.full import get_myrtle_kernel as _full_myrtle
    ref_fn = _full_myrtle(depth, num_class, act, w_std=w_std, b_std=b_std,
                          last_w_std=last_w_std)

    def kernel_fn(x1, x2=None, get="nngp"):
        symmetric = x2 is None or x2 is x1
        x2_eff = x1 if x2 is None else x2
        if get == "nngp" and x1.ndim == 4:
            hw = x1.shape[1] * x1.shape[2]
            tiles = pair_tiles(x1.shape[0], x2_eff.shape[0], hw,
                               state_budget())
            if tiles is not None:
                t1, t2 = tiles
                if symmetric:
                    t1 = t2 = min(t1, t2)
                fn = lambda a, b: ref_fn(a, b, get="nngp")
                return _pair_tiled(fn, x1, x2_eff, t1, t2, symmetric)
        return ref_fn(x1, x2, get=get)

    return kernel_fn


KERNELS = {
    "mlp": get_mlp_kernel,
    "cnn": get_cnn_kernel,
    "resnet-conv": get_conv_resnet_kernel,
    "resnet-dense": get_dense_resnet_kernel,
    "myrtle": get_myrtle_kernel,
}
