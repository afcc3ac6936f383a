"""The memory-bounded Myrtle rule (snngp.nn.arch.get_myrtle_kernel): tile
choice from a budget, the budget from the device, and tiled vs one-piece
values and gradients."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from snngp.nn import arch


@pytest.mark.parametrize("n1,n2,hw,budget,want", [
    (4, 4, 64, 4 * 4 * 4 * 64 * 64, None),          # exactly fits
    (100, 200, 1024, 4 * 1024 * 1024 * 900, (30, 30)),
    (3, 500, 256, 4 * 256 * 256 * 60, (3, 20)),     # short side caps t1
    (10, 10, 1024, 1, (1, 1)),                      # budget under one pair
])
def test_pair_tiles_from_budget(n1, n2, hw, budget, want):
    assert arch.pair_tiles(n1, n2, hw, budget) == want


def test_state_budget_reads_device_limit(monkeypatch):
    class Dev:
        def __init__(self, stats):
            self.stats = stats

        def memory_stats(self):
            return self.stats

    monkeypatch.setattr(jax, "devices",
                        lambda *a: [Dev({"bytes_limit": 64 << 30})])
    assert arch.state_budget() == (64 << 30) // arch.STATE_BUDGET_SHARE
    monkeypatch.setattr(jax, "devices", lambda *a: [Dev(None)])
    assert arch.state_budget() == arch.FIXED_STATE_BUDGET


def _myrtle_pair(monkeypatch, budget):
    from snngp.nn.full import get_myrtle_kernel as full_myrtle
    monkeypatch.setattr(arch, "state_budget", lambda: budget)
    kw = dict(w_std=1.2, b_std=0.3, last_w_std=0.8)
    return arch.get_myrtle_kernel(5, 1, "relu", **kw), full_myrtle(
        5, 1, "relu", **kw)


@pytest.mark.parametrize("symmetric", [False, True])
def test_myrtle_tiled_matches_one_piece(monkeypatch, symmetric):
    """A budget of a few pairs forces the lax.map tile path (ragged tiles,
    and the upper-triangle mirror for K(x, x)); values equal the one-piece
    full tier."""
    rng = np.random.RandomState(3)
    x1 = jnp.asarray(rng.rand(7, 8, 8, 3), jnp.float32)
    x2 = x1 if symmetric else jnp.asarray(rng.rand(5, 8, 8, 3), jnp.float32)
    tiled, full = _myrtle_pair(monkeypatch, budget=4 * 64 * 64 * 6)
    assert arch.pair_tiles(7, x2.shape[0], 64, 4 * 64 * 64 * 6) == (2, 3)
    if symmetric:       # K(x, x): the same traced array on both sides
        got = jax.jit(lambda a: tiled(a, a))(x1)
    else:
        got = jax.jit(lambda a, b: tiled(a, b))(x1, x2)
    want = jax.jit(full)(x1, x2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    if symmetric:
        # off-diagonal tiles are mirrored bitwise; diagonal tiles carry the
        # one-piece tier's own rounding asymmetry
        np.testing.assert_allclose(np.asarray(got), np.asarray(got).T,
                                   rtol=1e-6)


def test_myrtle_tiled_gradients_match_one_piece(monkeypatch):
    """Reverse mode through the checkpointed tile map gives the one-piece
    gradients in the scales AND in the inputs (SVSP inducing points)."""
    rng = np.random.RandomState(4)
    x1 = jnp.asarray(rng.rand(5, 8, 8, 2), jnp.float32)
    x2 = jnp.asarray(rng.rand(4, 8, 8, 2), jnp.float32)
    cot = jnp.asarray(rng.randn(5, 4), jnp.float32)
    from snngp.nn.full import get_myrtle_kernel as full_myrtle
    monkeypatch.setattr(arch, "state_budget", lambda: 4 * 64 * 64 * 4)

    def loss(builder, x, w, b):
        return jnp.sum(cot * builder(5, 1, "relu", w_std=w, b_std=b)(x, x2))

    args = (x1, jnp.float32(1.1), jnp.float32(0.2))
    got = jax.jit(jax.grad(lambda *a: loss(arch.get_myrtle_kernel, *a),
                           argnums=(0, 1, 2)))(*args)
    want = jax.jit(jax.grad(lambda *a: loss(full_myrtle, *a),
                            argnums=(0, 1, 2)))(*args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-5, atol=1e-7)


def test_myrtle_ntk_request_bypasses_tiling(monkeypatch):
    """Only nngp blocks are tiled; an ntk request runs the full tier."""
    tiled, full = _myrtle_pair(monkeypatch, budget=1)
    x = jnp.asarray(np.random.RandomState(5).rand(2, 8, 8, 1), jnp.float32)
    ntk = lambda fn: jax.jit(lambda a: fn(a, None, get="ntk"))(x)
    np.testing.assert_allclose(np.asarray(ntk(tiled)), np.asarray(ntk(full)),
                               rtol=1e-6)
