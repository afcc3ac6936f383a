"""Full spatial-covariance NNGP/NTK tier — pooled conv architectures.

The matched-pixel tier (snngp/nn/layers.py) is exact only for Flatten
readouts. Average pooling mixes *different* pixels of the same input, so the
recursion must carry the full pixel-pair covariance:

    nngp: [N1, N2, H, W, H, W]   (p1 in input-1, p2 in input-2)
    cov1: [N1, H, W, H, W]       (same-input pixel-pair covariance)
    cov2: [N2, H, W, H, W]

Closed forms (all same-offset: i.i.d. filter taps only couple equal offsets):

- Conv:     K'[p1, p2] = w^2/F * sum_d K[s p1 + d, s p2 + d] + b^2
- Act:      elementwise in (p1, p2) with variances at the spatial diagonal
- AvgPool:  independent window means over p1 and p2
- GAP:      mean over all (p1, p2) -> dense [N1, N2]
- Flatten:  mean over the diagonal p1 == p2 (consistent with the cheap tier)

This is the representation behind Myrtle-style CIFAR kernels (used by
``get_myrtle_kernel``); the reference never enables pooling
(``experiments/nt_kernels.py:75``), so this tier is a framework extension
required by the north-star benchmark (BASELINE.md).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = ["FullKernelState", "full_input_state", "ConvF", "ActF", "AvgPoolF",
           "GlobalAvgPoolF", "FlattenF", "DenseF", "serial_f",
           "full_kernel_fn", "get_myrtle_kernel", "pad_rows", "tiled_gram"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FullKernelState:
    nngp: jax.Array            # [N1, N2, H, W, H, W] or [N1, N2] after readout
    cov1: jax.Array            # [N1, H, W, H, W] or [N1]
    cov2: jax.Array            # [N2, H, W, H, W] or [N2]
    ntk: Optional[jax.Array] = None

    @property
    def spatial(self) -> bool:
        return self.nngp.ndim == 6


def full_input_state(x1: jax.Array, x2: Optional[jax.Array], *, ntk: bool = False,
                     dtype=None) -> FullKernelState:
    """``dtype=jnp.bfloat16`` halves the (dominant) [N1,N2,H,W,H,W] state
    memory — an opt-in scale knob for Myrtle-size workloads (moments are
    contracted in fp32 before the cast)."""
    if x2 is None:
        x2 = x1
    nngp = jnp.einsum("iabc,jdec->ijabde", x1, x2) / x1.shape[-1]
    cov1 = jnp.einsum("iabc,idec->iabde", x1, x1) / x1.shape[-1]
    cov2 = jnp.einsum("iabc,idec->iabde", x2, x2) / x2.shape[-1]
    if dtype is not None:
        nngp, cov1, cov2 = (nngp.astype(dtype), cov1.astype(dtype),
                            cov2.astype(dtype))
    return FullKernelState(nngp, cov1, cov2,
                           jnp.zeros_like(nngp) if ntk else None)


def _same_pads(size: int, filt: int, stride: int) -> Tuple[int, int, int]:
    """lax SAME padding: (pad_low, pad_high, out_size)."""
    out = -(-size // stride)
    pad = max((out - 1) * stride + filt - size, 0)
    return pad // 2, pad - pad // 2, out


def _conv_pair(k: jax.Array, filter_shape, strides) -> jax.Array:
    """Same-offset stencil mean over the last two spatial *pairs*.

    k: [..., H, W, H, W]; output [..., H', W', H', W'].
    """
    fh, fw = filter_shape
    sh, sw = strides
    h, w = k.shape[-4], k.shape[-3]
    plh, phh, oh = _same_pads(h, fh, sh)
    plw, phw, ow = _same_pads(w, fw, sw)
    pads = [(0, 0)] * (k.ndim - 4) + [(plh, phh), (plw, phw)] * 2
    kp = jnp.pad(k, pads)
    acc = None
    for dh in range(fh):
        for dw in range(fw):
            sl = kp[..., dh:dh + sh * (oh - 1) + 1:sh,
                    dw:dw + sw * (ow - 1) + 1:sw,
                    dh:dh + sh * (oh - 1) + 1:sh,
                    dw:dw + sw * (ow - 1) + 1:sw]
            acc = sl if acc is None else acc + sl
    return acc / (fh * fw)


def ConvF(filter_shape=(3, 3), strides=(1, 1), w_std=1.0, b_std=0.0):
    w2, b2 = w_std * w_std, b_std * b_std

    def kfn(k: FullKernelState) -> FullKernelState:
        nngp = w2 * _conv_pair(k.nngp, filter_shape, strides) + b2
        cov1 = w2 * _conv_pair(k.cov1, filter_shape, strides) + b2
        cov2 = w2 * _conv_pair(k.cov2, filter_shape, strides) + b2
        ntk = (None if k.ntk is None
               else nngp + w2 * _conv_pair(k.ntk, filter_shape, strides))
        return FullKernelState(nngp, cov1, cov2, ntk)

    return kfn


def _diag_var(cov: jax.Array) -> jax.Array:
    """[N, H, W, H, W] -> [N, H, W] spatial-diagonal variance."""
    return jnp.einsum("nijij->nij", cov)


def ActF(act: str):
    from snngp.nn.layers import _relu_t, _relu_tdot, _erf_t, _erf_tdot
    t_fn = {"relu": _relu_t, "erf": _erf_t}[act]
    td_fn = {"relu": _relu_tdot, "erf": _erf_tdot}[act]

    def kfn(k: FullKernelState) -> FullKernelState:
        v1 = _diag_var(k.cov1)   # [N1, H, W]
        v2 = _diag_var(k.cov2)
        b1 = v1[:, None, :, :, None, None]
        b2 = v2[None, :, None, None, :, :]
        nngp = t_fn(k.nngp, b1, b2)
        ntk = None if k.ntk is None else k.ntk * td_fn(k.nngp, b1, b2)
        s1a = v1[:, :, :, None, None]
        s1b = v1[:, None, None, :, :]
        cov1 = t_fn(k.cov1, s1a, s1b)
        s2a = v2[:, :, :, None, None]
        s2b = v2[:, None, None, :, :]
        cov2 = t_fn(k.cov2, s2a, s2b)
        return FullKernelState(nngp, cov1, cov2, ntk)

    return kfn


def _pool_axis_pair(k: jax.Array, window: int, offset: int) -> jax.Array:
    """Non-overlapping window mean over spatial axes (offset, offset+1)."""
    shape = k.shape
    h, w = shape[offset], shape[offset + 1]
    assert h % window == 0 and w % window == 0, "AvgPool requires divisibility"
    new = shape[:offset] + (h // window, window, w // window, window) + shape[offset + 2:]
    return k.reshape(new).mean(axis=(offset + 1, offset + 3))


def AvgPoolF(window=(2, 2), strides=None):
    """Non-overlapping average pooling (window == strides, the Myrtle case)."""
    if strides is not None and tuple(strides) != tuple(window):
        raise NotImplementedError("only window == strides pooling")
    win = window[0]
    if window[0] != window[1]:
        raise NotImplementedError("square windows only")

    def pool_pairs(k, first_spatial_axis):
        k = _pool_axis_pair(k, win, first_spatial_axis)
        k = _pool_axis_pair(k, win, first_spatial_axis + 2)
        return k

    def kfn(k: FullKernelState) -> FullKernelState:
        nngp = pool_pairs(k.nngp, 2)
        cov1 = pool_pairs(k.cov1, 1)
        cov2 = pool_pairs(k.cov2, 1)
        ntk = None if k.ntk is None else pool_pairs(k.ntk, 2)
        return FullKernelState(nngp, cov1, cov2, ntk)

    return kfn


def GlobalAvgPoolF():
    def kfn(k: FullKernelState) -> FullKernelState:
        # Accumulate the big spatial reduction in at least fp32 (bf16 state
        # mode); float64 states stay float64.
        f32 = lambda a: a.astype(jnp.promote_types(a.dtype, jnp.float32))
        nngp = jnp.mean(f32(k.nngp), axis=(2, 3, 4, 5))
        cov1 = jnp.mean(f32(k.cov1), axis=(1, 2, 3, 4))
        cov2 = jnp.mean(f32(k.cov2), axis=(1, 2, 3, 4))
        ntk = None if k.ntk is None else jnp.mean(f32(k.ntk), axis=(2, 3, 4, 5))
        return FullKernelState(nngp, cov1, cov2, ntk)

    return kfn


def FlattenF():
    """Diagonal-pixel mean: consistent with the cheap tier's Flatten."""

    def kfn(k: FullKernelState) -> FullKernelState:
        nngp = jnp.mean(jnp.einsum("mnijij->mnij", k.nngp), axis=(2, 3))
        cov1 = jnp.mean(_diag_var(k.cov1), axis=(1, 2))
        cov2 = jnp.mean(_diag_var(k.cov2), axis=(1, 2))
        ntk = (None if k.ntk is None
               else jnp.mean(jnp.einsum("mnijij->mnij", k.ntk), axis=(2, 3)))
        return FullKernelState(nngp, cov1, cov2, ntk)

    return kfn


def DenseF(w_std=1.0, b_std=0.0):
    w2, b2 = w_std * w_std, b_std * b_std

    def kfn(k: FullKernelState) -> FullKernelState:
        nngp = w2 * k.nngp + b2
        ntk = None if k.ntk is None else nngp + w2 * k.ntk
        return FullKernelState(nngp, w2 * k.cov1 + b2, w2 * k.cov2 + b2, ntk)

    return kfn


def serial_f(*kfns):
    def kfn(k):
        for f in kfns:
            k = f(k)
        return k

    return kfn


def full_kernel_fn(composed, dtype=None):
    def kernel_fn(x1, x2=None, get="nngp"):
        want = (get,) if isinstance(get, str) else tuple(get)
        state = composed(full_input_state(x1, x2, ntk="ntk" in want,
                                          dtype=dtype))
        outs = []
        for g in want:
            outs.append(state.nngp if g == "nngp" else state.ntk)
        return outs[0] if isinstance(get, str) else tuple(outs)

    return kernel_fn


def pad_rows(x: jax.Array, multiple: int) -> jax.Array:
    """Pad the leading axis up to a multiple by repeating the last row.

    Repeated real rows (not zeros) keep every padded Gram entry finite: a
    zero input has zero variance, and the ReLU/erf duals divide by the
    square root of the variances, so zero padding would put NaN into
    gradients even though the padded outputs are sliced away."""
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    return jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1), mode="edge")


@functools.lru_cache(maxsize=32)
def _chunk_runner(kernel_fn, tile: int, multi: bool):
    """One jitted ``lax.scan`` over a chunk of tile pairs per (kernel_fn,
    tile): repeated assemblies with the same kernel_fn (e.g. one per ML-II
    step, hyperparameters passed as traced ``args``) reuse the compile."""
    from jax import lax

    @jax.jit
    def run(a_all, b_all, idx, args):                      # idx [chunk, 2]
        def step(_, ij):
            a = lax.dynamic_slice_in_dim(a_all, ij[0] * tile, tile)
            b = lax.dynamic_slice_in_dim(b_all, ij[1] * tile, tile)
            out = kernel_fn(a, b, *args)
            return None, tuple(out) if multi else (out,)
        return lax.scan(step, None, idx)[1]                # n_out x [chunk, t, t]

    return run


def tiled_gram(kernel_fn, x1, x2=None, *, args=(), tile: int = 32,
               chunk: int = 8, resume_dir: Optional[str] = None,
               name: str = "gram", log=None):
    """Assemble an [N1, N2] Gram on the host from [tile, tile] blocks.

    ``kernel_fn(a, b, *args)`` returns one [tile, tile] block, or a tuple of
    them (e.g. the augmented ``(K, dK/dw_std, dK/db_std)`` of
    :func:`snngp.models.mlii.jvp_aug_fn`); every output is assembled.
    ``args`` are traced, so new hyperparameter values do not recompile.
    ``chunk`` blocks run per device call inside one ``lax.scan``, and chunk
    c + 1 is enqueued before chunk c is copied to the host, so the host copy
    overlaps device work. The inputs are padded to a tile multiple with
    :func:`pad_rows`, so any N compiles exactly one chunk program.

    Symmetric inputs (``x2 is None``) compute only the upper-triangle blocks
    and mirror them. Each output must then be symmetric, which holds for K
    and for its derivatives in any scalar hyperparameter.

    ``resume_dir`` makes the assembly crash-resumable: output i lives in the
    ``.npy`` memmap ``<resume_dir>/<name>.npy`` (``<name>_<i>.npy`` for a
    tuple) next to a block bitmap ``<name>.done.npy``, both flushed after
    every chunk. A re-run with the same directory skips finished blocks.

    Returns one host array, or a tuple matching ``kernel_fn``'s outputs.
    """
    import os

    import numpy as np

    symmetric = x2 is None
    x2_eff = x1 if symmetric else x2
    n1, n2 = x1.shape[0], x2_eff.shape[0]
    a_pad = pad_rows(jnp.asarray(x1), tile)
    b_pad = a_pad if symmetric else pad_rows(jnp.asarray(x2_eff), tile)
    nb1, nb2 = a_pad.shape[0] // tile, b_pad.shape[0] // tile
    todo = [(i, j) for i in range(nb1)
            for j in range(i if symmetric else 0, nb2)]

    probe = jax.eval_shape(kernel_fn, a_pad[:tile], b_pad[:tile], *args)
    multi = isinstance(probe, (tuple, list))
    n_out = len(probe) if multi else 1

    done = None
    if resume_dir is None:
        outs = [np.zeros((n1, n2), np.float32) for _ in range(n_out)]
    else:
        os.makedirs(resume_dir, exist_ok=True)
        paths = [os.path.join(resume_dir, f"{name}_{k}.npy" if multi
                              else f"{name}.npy") for k in range(n_out)]
        done_path = os.path.join(resume_dir, f"{name}.done.npy")
        if os.path.exists(done_path) and all(map(os.path.exists, paths)):
            outs = [np.lib.format.open_memmap(p, mode="r+") for p in paths]
            done = np.load(done_path)
            if outs[0].shape != (n1, n2) or done.shape[0] != len(todo):
                raise ValueError(
                    f"{resume_dir} holds a {outs[0].shape} Gram with a "
                    f"{done.shape[0]}-block bitmap; expected {(n1, n2)} and "
                    f"{len(todo)} blocks (different data or tile size)")
            if log is not None:
                log(f"tiled_gram: resuming {name}, {int(done.sum())}/"
                    f"{len(todo)} blocks already done")
        else:
            outs = [np.lib.format.open_memmap(p, mode="w+", dtype=np.float32,
                                              shape=(n1, n2)) for p in paths]
            done = np.zeros(len(todo), bool)
            np.save(done_path, done)

    run_chunk = _chunk_runner(kernel_fn, tile, multi)

    def commit(blocks, pending_ids, k):
        blocks = [np.asarray(b) for b in blocks]
        for c, t in enumerate(pending_ids):
            i, j = todo[t]
            h, w = min(tile, n1 - i * tile), min(tile, n2 - j * tile)
            for out, blk in zip(outs, blocks):
                piece = blk[c, :h, :w]
                out[i * tile:i * tile + h, j * tile:j * tile + w] = piece
                if symmetric and j > i:
                    out[j * tile:j * tile + w, i * tile:i * tile + h] = piece.T
        if done is not None:
            for out in outs:
                out.flush()
            done[pending_ids] = True
            np.save(done_path, done)
        if log is not None and (k % 8 == 0 or pending_ids[-1] == left[-1]):
            log(f"tiled_gram: {name} block {pending_ids[-1] + 1}/{len(todo)}")

    left = [t for t in range(len(todo)) if done is None or not done[t]]
    pending = None
    for c in range(0, len(left), chunk):
        ids = left[c:c + chunk]
        idx = np.asarray([todo[t] for t in ids]
                         + [todo[ids[-1]]] * (chunk - len(ids)), np.int32)
        blocks = run_chunk(a_pad, b_pad, idx, tuple(args))  # async dispatch
        if pending is not None:
            commit(*pending)
        pending = (blocks, ids, c // chunk)
    if pending is not None:
        commit(*pending)
    return tuple(outs) if multi else outs[0]


def get_myrtle_kernel(depth: int = 5, num_class: int = 1, act: str = "relu",
                      w_std: float = 1.0, b_std: float = 0.0,
                      last_w_std: float = 1.0, dtype=None):
    """Myrtle-family CNN kernel (Shankar et al. 2020): conv/relu stacks with
    2x2 average pools, global average pool readout.

    depth in {5, 7, 10} selects the Myrtle-5/7/10 conv counts (1/2/3 convs
    per pooling group).
    """
    per_group = {5: (1, 1, 1), 7: (2, 2, 1), 10: (3, 3, 2)}[depth]
    conv = lambda: ConvF((3, 3), (1, 1), w_std, b_std)
    relu = lambda: ActF(act)

    stack = [conv(), relu()]
    for g, reps in enumerate(per_group):
        for _ in range(reps - 1 if g == 0 else reps):
            stack += [conv(), relu()]
        stack += [AvgPoolF((2, 2))]
    stack += [GlobalAvgPoolF(), DenseF(last_w_std)]
    return full_kernel_fn(serial_f(*stack), dtype=dtype)
