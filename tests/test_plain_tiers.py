"""The plain kernel tiers as the only tiers: scale gradients of every family
against float64 central differences of the same recursion."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from snngp.nn import arch

HYPER = (1.3, 0.4, 0.9)

# (builder, kwargs, input shape): small enough to differentiate on CPU, deep
# enough to cross every layer type of the family at least once.
FAMILIES = {
    "mlp": (arch.get_mlp_kernel, dict(num_hiddens=3), (5, 7)),
    "dense-resnet": (arch.get_dense_resnet_kernel, dict(num_hiddens=2),
                     (5, 7)),
    "cnn": (arch.get_cnn_kernel, dict(num_hiddens=2), (3, 5, 5, 2)),
    "conv-resnet": (arch.get_conv_resnet_kernel, dict(num_hiddens=1),
                    (3, 8, 8, 2)),
    "myrtle": (arch.get_myrtle_kernel, dict(depth=5), (3, 8, 8, 2)),
}


def _loss(name, act, x1, x2, cot):
    builder, kw, _ = FAMILIES[name]

    def f(w, b, l):
        kfn = builder(act=act, w_std=w, b_std=b, last_w_std=l, **kw)
        return jnp.sum(cot * kfn(x1, x2))

    return f


@pytest.mark.parametrize("act", ["relu", "erf"])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_scale_grads_match_f64_central_differences(name, act):
    """jax.grad of <cot, K> in float32 w.r.t. (w_std, b_std, last_w_std)
    equals float64 central differences of the same plain recursion."""
    shape = FAMILIES[name][2]
    rng = np.random.RandomState(sum(map(ord, name + act)))
    x1 = rng.randn(*shape)
    x2 = rng.randn(*((shape[0] + 1,) + shape[1:]))
    cot = rng.randn(shape[0], shape[0] + 1)

    f32 = _loss(name, act, jnp.asarray(x1, jnp.float32),
                jnp.asarray(x2, jnp.float32), jnp.asarray(cot, jnp.float32))
    got = np.asarray(jax.jit(jax.grad(f32, argnums=(0, 1, 2)))(*HYPER))

    with jax.enable_x64(True):
        f64 = jax.jit(_loss(name, act, jnp.asarray(x1), jnp.asarray(x2),
                            jnp.asarray(cot)))
        h = 1e-6
        want = []
        for i in range(3):
            up = list(HYPER)
            dn = list(HYPER)
            up[i] += h
            dn[i] -= h
            want.append((float(f64(*up)) - float(f64(*dn))) / (2 * h))
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-5 * np.max(np.abs(want)))
