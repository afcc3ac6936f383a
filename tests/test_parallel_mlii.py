"""Distributed full-Gram ML-II step (snngp/parallel/mlii.py) vs the
single-device closed form (snngp/models/mlii.py) on the emulated 8-device
CPU mesh — SURVEY.md D2-D3 applied to the TRAINING path (VERDICT r4 #4).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from snngp.models.mlii import (full_gram_mlii_value_and_grad, jvp_aug_fn,
                               tiled_aug_gram)
from snngp.nn import arch
from snngp.parallel import get_mesh
from snngp.parallel.mlii import (distributed_mlii_value_and_grad,
                                 sharded_aug_gram)

DEPTH, ACT = 3, "relu"
HYPER = dict(w_std=1.3, b_std=0.4, last_w_std=0.9)
EPS0 = 3e-2


def _aug_builder(w_std, b_std, last_w_std):
    aug = jvp_aug_fn(lambda w, b, l: arch.get_mlp_kernel(
        DEPTH, 1, ACT, w_std=w, b_std=b, last_w_std=l))
    hyper = tuple(jnp.asarray(v, jnp.float32)
                  for v in (w_std, b_std, last_w_std))
    return lambda x1, x2: aug(x1, x2, *hyper)


def _data(n=64, d=6, seed=0):
    rng = np.random.RandomState(seed)
    return (jnp.asarray(rng.randn(n, d), jnp.float32),
            jnp.asarray(rng.randn(n), jnp.float32))


@pytest.fixture(scope="module")
def mesh():
    if jax.device_count() < 8:
        pytest.skip("needs the 8-device CPU mesh")
    return get_mesh(8)


def test_sharded_aug_gram_matches_dense(mesh):
    x, _ = _data()
    aug = _aug_builder(**HYPER)
    want = aug(x, x)
    got = jax.jit(lambda xx: sharded_aug_gram(aug, xx, mesh))(x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ab", [None, (2.0, 1.5)])
def test_distributed_mlii_matches_single_device(mesh, ab):
    """Gradient parity: the mesh step (sharded aug Gram -> cyclic Cholesky
    -> blocked panel solves -> shard_map contractions) equals the
    single-device tiled closed form on identical data."""
    x, y = _data()
    aug = _aug_builder(**HYPER)

    k, dkw, dkb = tiled_aug_gram(aug, np.asarray(x), block=16)
    loss_want, g_want = full_gram_mlii_value_and_grad(
        k, dkw, dkb, np.asarray(y), last_w_std=HYPER["last_w_std"],
        eps=EPS0, ab=ab, panel=24)

    loss_got, g_got = jax.jit(
        lambda xx, yy: distributed_mlii_value_and_grad(
            aug, xx, yy, mesh, last_w_std=HYPER["last_w_std"], eps=EPS0,
            ab=ab, chol_block=4))(x, y)

    assert np.isclose(float(loss_got), loss_want, rtol=1e-5)
    names = ["w_std", "b_std", "last_w_std", "eps"] + (
        ["a", "b"] if ab else [])
    for name in names:
        np.testing.assert_allclose(float(g_got[name]), g_want[name],
                                   rtol=2e-4, atol=1e-7,
                                   err_msg=f"grad {name}")
