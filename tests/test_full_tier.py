"""Full spatial-covariance tier tests: agreement with the matched-pixel tier
on Flatten readouts, and finite-width MC validation of pooled readouts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from snngp.nn import arch, layers as L
from snngp.nn import full as F


def test_full_tier_matches_diag_tier_on_flatten_cnn():
    x = jax.random.normal(jax.random.PRNGKey(0), (3, 6, 6, 2))
    w, b, l = 1.1, 0.3, 0.9
    diag_kfn = arch.get_cnn_kernel(2, 1, "relu", w_std=w, b_std=b, last_w_std=l)
    K_diag = diag_kfn(x, x, get="nngp")

    full = F.serial_f(
        F.ConvF((3, 3), (1, 1), w, b), F.ActF("relu"),
        F.ConvF((3, 3), (1, 1), w, b), F.ActF("relu"),
        F.FlattenF(), F.DenseF(l),
    )
    K_full = F.full_kernel_fn(full)(x, x, get="nngp")
    np.testing.assert_allclose(np.asarray(K_full), np.asarray(K_diag),
                               rtol=1e-5, atol=1e-6)


def test_full_tier_strided_conv_matches_diag_tier():
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 8, 8, 1))
    w, b = 1.0, 0.2
    diag = L.serial(L.Conv(1, (3, 3), (2, 2), "SAME", w_std=w, b_std=b),
                    L.Relu(), L.Flatten(), L.Dense(1, w_std=1.0))
    K_diag = L.kernel_fn_of(diag)(x, None, get="nngp")
    full = F.serial_f(F.ConvF((3, 3), (2, 2), w, b), F.ActF("relu"),
                      F.FlattenF(), F.DenseF(1.0))
    K_full = F.full_kernel_fn(full)(x, x, get="nngp")
    np.testing.assert_allclose(np.asarray(K_full), np.asarray(K_diag),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.slow
def test_pooled_kernel_matches_finite_width_mc():
    """GAP readout needs cross-pixel covariance — the full tier's reason to
    exist. Validate against a finite-width MC ensemble."""
    x = jax.random.normal(jax.random.PRNGKey(2), (3, 4, 4, 2))
    w, b = 1.2, 0.2

    full = F.serial_f(F.ConvF((3, 3), (1, 1), w, b), F.ActF("relu"),
                      F.GlobalAvgPoolF(), F.DenseF(1.0))
    K = F.full_kernel_fn(full)(x, x, get="nngp")

    conv = L.Conv(384, (3, 3), (1, 1), "SAME", w_std=w, b_std=b)
    relu = L.Relu()

    def sample(key):
        _, p = conv.init(key, x.shape)
        z = relu.apply((), conv.apply(p, x))
        return jnp.mean(z, axis=(1, 2))  # GAP -> [N, C]

    keys = jax.random.split(jax.random.PRNGKey(3), 600)
    outs = jax.lax.map(sample, keys, batch_size=60)  # [S, N, C]
    K_mc = jnp.einsum("snc,smc->nm", outs, outs) / (outs.shape[0] * outs.shape[-1])
    np.testing.assert_allclose(np.asarray(K), np.asarray(K_mc), atol=0.05)


@pytest.mark.slow
def test_avg_pool_f_matches_finite_width_mc():
    x = jax.random.normal(jax.random.PRNGKey(4), (2, 4, 4, 1))
    w = 1.0

    full = F.serial_f(F.ConvF((3, 3), (1, 1), w, 0.0), F.ActF("erf"),
                      F.AvgPoolF((2, 2)), F.FlattenF(), F.DenseF(1.0))
    K = F.full_kernel_fn(full)(x, x, get="nngp")

    conv = L.Conv(384, (3, 3), (1, 1), "SAME", w_std=w, b_std=0.0)

    def sample(key):
        _, p = conv.init(key, x.shape)
        z = jax.scipy.special.erf(conv.apply(p, x))
        z = z.reshape(2, 2, 2, 2, 2, -1).mean(axis=(2, 4))  # 2x2 avg pool
        return z.reshape(2, -1)  # flatten

    keys = jax.random.split(jax.random.PRNGKey(5), 600)
    outs = jax.lax.map(sample, keys, batch_size=60)
    # Flatten + Dense normalizes by the full flattened dim (pixels * channels).
    K_mc = jnp.einsum("snc,smc->nm", outs, outs) / (outs.shape[0] * outs.shape[-1])
    np.testing.assert_allclose(np.asarray(K), np.asarray(K_mc), atol=0.05)


@pytest.mark.slow
def test_myrtle_kernel_runs_and_is_psd():
    x = jax.random.normal(jax.random.PRNGKey(6), (4, 8, 8, 3))
    kfn = F.get_myrtle_kernel(5, 10, "relu", w_std=1.0, b_std=0.1, last_w_std=1.0)
    K = kfn(x, x, get="nngp")
    assert K.shape == (4, 4)
    np.testing.assert_allclose(np.asarray(K), np.asarray(K).T, rtol=1e-5)
    assert np.linalg.eigvalsh(np.asarray(K)).min() > -1e-5


@pytest.mark.slow
def test_myrtle_sharded_gram_matches_dense():
    """Full-tier kernel_fn composes with the row-sharded Gram builder
    (pure jnp ops shard cleanly under shard_map)."""
    from snngp.parallel import get_mesh, sharded_gram
    x = jax.random.normal(jax.random.PRNGKey(7), (16, 8, 8, 3))
    kfn = F.get_myrtle_kernel(5, 1, "relu", w_std=1.0, b_std=0.1, last_w_std=1.0)
    mesh = get_mesh(8)
    got = sharded_gram(kfn, x, mesh)
    expect = kfn(x, x, get="nngp")
    np.testing.assert_allclose(np.asarray(got), np.asarray(expect),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.slow
def test_myrtle_bf16_state_close_to_fp32():
    """bf16 full-covariance state (the Myrtle memory knob) tracks fp32 to
    bf16 precision; GAP accumulates in fp32."""
    x = jax.random.normal(jax.random.PRNGKey(8), (4, 8, 8, 3))
    k32 = F.get_myrtle_kernel(5, 1, "relu", 1.0, 0.1, 1.0)(x, x, get="nngp")
    k16 = F.get_myrtle_kernel(5, 1, "relu", 1.0, 0.1, 1.0,
                              dtype=jnp.bfloat16)(x, x, get="nngp")
    assert k16.dtype == jnp.float32  # GAP re-promotes
    np.testing.assert_allclose(np.asarray(k16), np.asarray(k32),
                               rtol=3e-2, atol=1e-3)


@pytest.mark.slow
def test_scan_tiled_gram_matches_monolithic():
    """Chunked lax.scan tile assembly (symmetric + cross, ragged tail
    chunk) equals the one-shot full-tier Gram."""
    from snngp.nn.full import get_myrtle_kernel, tiled_gram

    x = jax.random.normal(jax.random.PRNGKey(31), (12, 8, 8, 3), jnp.float32)
    kfn = get_myrtle_kernel(5, 1, "relu", w_std=1.0, b_std=0.1, last_w_std=1.0)
    want = np.asarray(kfn(x, x, get="nngp"))
    got = tiled_gram(kfn, x, tile=4, chunk=4)
    np.testing.assert_allclose(got, want, atol=1e-5)

    x2 = jax.random.normal(jax.random.PRNGKey(32), (8, 8, 8, 3), jnp.float32)
    want = np.asarray(kfn(x, x2, get="nngp"))
    got = tiled_gram(kfn, x, x2, tile=4, chunk=4)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.slow
def test_layer_dsl_composes_with_full_tier():
    """One composed Layer serves both kernel tiers (VERDICT r1 weak #7):
    pooled architectures via kernel_fn_of(layer, full=True) match the
    dedicated full-tier builder, and Flatten-readout architectures agree
    across tiers (both exact there)."""
    x = jax.random.normal(jax.random.PRNGKey(41), (5, 8, 8, 3), jnp.float32)

    net = L.serial(
        L.Conv(1, (3, 3), (1, 1), "SAME", w_std=1.0, b_std=0.1), L.Relu(),
        L.AvgPool((2, 2)),
        L.Conv(1, (3, 3), (1, 1), "SAME", w_std=1.0, b_std=0.1), L.Relu(),
        L.AvgPool((2, 2)),
        L.Conv(1, (3, 3), (1, 1), "SAME", w_std=1.0, b_std=0.1), L.Relu(),
        L.AvgPool((2, 2)),
        L.GlobalAvgPool(), L.Dense(1, w_std=1.0))
    got = L.kernel_fn_of(net, full=True)(x, x, get="nngp")
    want = F.get_myrtle_kernel(5, 1, "relu", w_std=1.0, b_std=0.1,
                               last_w_std=1.0)(x, x, get="nngp")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-6)

    # WRN with FanOut residuals + Flatten: exact on both tiers -> must agree.
    lay = arch.get_conv_resnet_layer(1, 2, "relu", 1.0, 0.1, 1.0)
    km = L.kernel_fn_of(lay)(x, x, get="nngp")
    kf = L.kernel_fn_of(lay, full=True)(x, x, get="nngp")
    np.testing.assert_allclose(np.asarray(km), np.asarray(kf), atol=1e-5)

    # NTK agrees across tiers on a Flatten readout too.
    lay2 = arch.get_cnn_layer(2, 1, "erf", 1.1, 0.2, 0.9)
    tm = L.kernel_fn_of(lay2)(x, x, get="ntk")
    tf = L.kernel_fn_of(lay2, full=True)(x, x, get="ntk")
    np.testing.assert_allclose(np.asarray(tm), np.asarray(tf), atol=1e-4)


@pytest.mark.slow
def test_avgpool_layer_finite_width():
    """L.AvgPool finite apply is the exact window mean; cheap-tier kfn raises."""
    x = jax.random.normal(jax.random.PRNGKey(42), (2, 4, 4, 3), jnp.float32)
    pool = L.AvgPool((2, 2))
    _, params = pool.init(jax.random.PRNGKey(0), x.shape)
    out = pool.apply(params, x)
    assert out.shape == (2, 2, 2, 3)
    np.testing.assert_allclose(np.asarray(out[0, 0, 0, 0]),
                               np.asarray(x[0, :2, :2, 0].mean()), rtol=1e-6)
    with pytest.raises(NotImplementedError):
        L.kernel_fn_of(pool)(x, x, get="nngp")
