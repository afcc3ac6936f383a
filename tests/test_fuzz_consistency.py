"""Randomized consistency: for random shapes/hyperparameters the plain tier
agrees with a float64 enumeration, and the full-covariance tier with the
matched-pixel tier — the cheap invariant that guards every kernel rewrite."""

import jax.numpy as jnp
import numpy as np
import pytest

from snngp.nn import arch
from snngp.nn import full as F
from snngp.nn.layers import kernel_fn_of
from snngp.nn.reference import cnn_gram_f64, mlp_gram_f64


@pytest.mark.parametrize("seed", range(4))
def test_mlp_gram_fuzz_vs_f64_enumeration(seed):
    """Random shapes, depths and scales: the fp32 MLP Gram equals the
    float64 layer-by-layer enumeration."""
    rng = np.random.RandomState(seed)
    n1, n2 = int(rng.randint(3, 40)), int(rng.randint(3, 40))
    d = int(rng.randint(2, 20))
    depth = int(rng.randint(1, 5))
    act = ["relu", "erf"][seed % 2]
    w, b, l = rng.uniform(0.3, 2.0, 3)
    x1, x2 = rng.randn(n1, d), rng.randn(n2, d)
    kfn = arch.get_mlp_kernel(depth, 1, act, w_std=w, b_std=b, last_w_std=l)
    got = kfn(jnp.asarray(x1, jnp.float32), jnp.asarray(x2, jnp.float32))
    np.testing.assert_allclose(np.asarray(got),
                               mlp_gram_f64(x1, x2, depth, act, w, b, l),
                               rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("seed", range(3))
def test_cnn_gram_fuzz_vs_f64_enumeration(seed):
    """Random image shapes, depths and scales: the fp32 matched-pixel CNN
    Gram equals the float64 pixel-by-pixel enumeration."""
    rng = np.random.RandomState(100 + seed)
    n1, n2 = int(rng.randint(3, 16)), int(rng.randint(3, 16))
    h, w_ = int(rng.randint(3, 9)), int(rng.randint(3, 9))
    c = int(rng.randint(1, 4))
    depth = int(rng.randint(1, 4))
    act = ["relu", "erf"][seed % 2]
    w, b, l = rng.uniform(0.3, 1.8, 3)
    x1, x2 = rng.randn(n1, h, w_, c), rng.randn(n2, h, w_, c)
    kfn = arch.get_cnn_kernel(depth, 1, act, w_std=w, b_std=b, last_w_std=l)
    got = kfn(jnp.asarray(x1, jnp.float32), jnp.asarray(x2, jnp.float32))
    np.testing.assert_allclose(np.asarray(got),
                               cnn_gram_f64(x1, x2, depth, act, w, b, l),
                               rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("seed", range(3))
def test_full_tier_vs_diag_tier_fuzz(seed):
    """Flatten-readout CNNs: full spatial tier must equal matched-pixel tier
    for random shapes/strides."""
    rng = np.random.RandomState(200 + seed)
    n = int(rng.randint(2, 6))
    h = int(rng.randint(4, 9))
    c = int(rng.randint(1, 3))
    w, b = rng.uniform(0.5, 1.5, 2)
    stride = int(rng.choice([1, 2]))
    x = jnp.asarray(rng.randn(n, h, h, c), jnp.float32)

    from snngp.nn import layers as L
    diag = L.serial(L.Conv(1, (3, 3), (stride, stride), "SAME", w_std=w, b_std=b),
                    L.Relu(),
                    L.Conv(1, (3, 3), (1, 1), "SAME", w_std=w, b_std=b),
                    L.Erf(), L.Flatten(), L.Dense(1, w_std=1.0))
    K_d = kernel_fn_of(diag)(x, None, get="nngp")

    fullk = F.serial_f(F.ConvF((3, 3), (stride, stride), w, b), F.ActF("relu"),
                       F.ConvF((3, 3), (1, 1), w, b), F.ActF("erf"),
                       F.FlattenF(), F.DenseF(1.0))
    K_f = F.full_kernel_fn(fullk)(x, x, get="nngp")
    np.testing.assert_allclose(np.asarray(K_f), np.asarray(K_d),
                               rtol=2e-5, atol=2e-6)
