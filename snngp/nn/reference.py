"""Float64 numpy enumerations of the MLP and CNN NNGP recursions.

Independent of JAX: the references the fuzz tests and the on-card parity
check (``chip_smoke.py``) compare the fp32 kernel tiers against. Layer
conventions are those of :mod:`snngp.nn.arch` (NTK parameterization, SAME
3x3 convolutions, Flatten then a bias-free Dense readout).
"""

import numpy as np

__all__ = ["dual_f64", "mlp_gram_f64", "cnn_gram_f64"]


def dual_f64(act, k, v1, v2):
    """Dual activation in float64: relu arc-cosine / erf arc-sine forms."""
    if act == "relu":
        s = np.sqrt(v1 * v2)
        theta = np.arccos(np.clip(k / s, -1.0, 1.0))
        return (s * np.sin(theta) + (np.pi - theta) * k) / (2 * np.pi)
    return (2 / np.pi) * np.arcsin(
        np.clip(2 * k / np.sqrt((1 + 2 * v1) * (1 + 2 * v2)), -1.0, 1.0))


def mlp_gram_f64(x1, x2, depth, act, w, b, l):
    """MLP NNGP enumerated layer by layer in float64 numpy."""
    d = x1.shape[1]
    k, v1, v2 = x1 @ x2.T / d, (x1 * x1).sum(1) / d, (x2 * x2).sum(1) / d
    for _ in range(depth):
        k, v1, v2 = (w * w * k + b * b, w * w * v1 + b * b,
                     w * w * v2 + b * b)
        k = dual_f64(act, k, v1[:, None], v2[None, :])
        v1, v2 = dual_f64(act, v1, v1, v1), dual_f64(act, v2, v2, v2)
    return l * l * k


def _patch_mean_f64(a):
    """3x3 SAME stencil mean over the last two (pixel) axes, zeros outside."""
    h, w_ = a.shape[-2:]
    p = np.pad(a, [(0, 0)] * (a.ndim - 2) + [(1, 1), (1, 1)])
    return sum(p[..., i:i + h, j:j + w_] for i in range(3)
               for j in range(3)) / 9.0


def cnn_gram_f64(x1, x2, depth, act, w, b, l):
    """Matched-pixel CNN NNGP (Conv3x3 SAME + act, Flatten, Dense) in
    float64 numpy, pixel by pixel."""
    c = x1.shape[-1]
    k = np.einsum("ihwc,jhwc->ijhw", x1, x2) / c
    v1 = np.einsum("ihwc,ihwc->ihw", x1, x1) / c
    v2 = np.einsum("ihwc,ihwc->ihw", x2, x2) / c
    for _ in range(depth):
        k = w * w * _patch_mean_f64(k) + b * b
        v1 = w * w * _patch_mean_f64(v1) + b * b
        v2 = w * w * _patch_mean_f64(v2) + b * b
        k = dual_f64(act, k, v1[:, None], v2[None, :])
        v1, v2 = dual_f64(act, v1, v1, v1), dual_f64(act, v2, v2, v2)
    return l * l * k.mean(axis=(2, 3))
