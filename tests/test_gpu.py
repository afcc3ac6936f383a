"""On-card checks of the plain tiers: each Gram compiled for the GPU equals
the same Gram on the host CPU. Marked ``gpu``; the ``gpu`` fixture skips
them where JAX finds no GPU. Run on a GPU machine with
``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu -p no:xdist``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from snngp.nn import arch

HP = dict(w_std=1.3, b_std=0.3, last_w_std=1.1)


def _on(dev, fn, *xs):
    return np.asarray(jax.jit(fn)(*(jax.device_put(jnp.asarray(x), dev)
                                    for x in xs)))


@pytest.mark.gpu
@pytest.mark.parametrize("name,kfn,shape", [
    ("mlp", arch.get_mlp_kernel(4, 1, "relu", **HP), (256, 16)),
    ("cnn", arch.get_cnn_kernel(4, 1, "erf", **HP), (32, 32, 32, 3)),
    ("myrtle", arch.get_myrtle_kernel(5, 1, "relu", **HP), (8, 32, 32, 3)),
])
def test_gram_on_gpu_matches_cpu(gpu, name, kfn, shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    got = _on(gpu, lambda a: kfn(a, a), x)
    want = _on(jax.devices("cpu")[0], lambda a: kfn(a, a), x)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
