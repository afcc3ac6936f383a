"""Full-Gram tiled ML-II (snngp/models/mlii.py) vs jax.grad of SPR.loss.

The tiled closed-form gradient must equal the reference's differentiable
path — jax.grad through Gram build + factorization
(``experiments/regression/train.py:61-67`` via ``spax/models.py:93-98``) —
at sizes where both run. The MLP NNGP family (pure-jnp reference recursion)
keeps the kernel evaluation cheap on CPU; the machinery is kernel-agnostic
(the Myrtle pipeline plugs in the same jvp-based augmented block).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from snngp.models import params as P
from snngp.models.bijectors import positive
from snngp.models.gp import SPR
from snngp.models.kernels import NNGPKernel
from snngp.models.likelihoods import GaussianLikelihood, StudentTLikelihood
from snngp.models.mlii import (full_gram_mlii_value_and_grad, jvp_aug_fn,
                               mlii_fit_full, tiled_aug_gram)
from snngp.nn import arch

DEPTH = 3
ACT = "relu"


def _builder(w, b, l):
    return arch.get_mlp_kernel(DEPTH, 1, ACT, w_std=w, b_std=b, last_w_std=l)


AUG = jvp_aug_fn(_builder)


def _aug_builder(w_std, b_std, last_w_std):
    """(k, dkw, dkb) tiles via forward-mode through the plain recursion at
    fixed hyperparameters."""
    hyper = tuple(jnp.asarray(v, jnp.float32)
                  for v in (w_std, b_std, last_w_std))
    return jax.jit(lambda x1, x2: AUG(x1, x2, *hyper))


def _unconstrained_grads(g_c, params, ab):
    """Chain constrained-space scalar grads through the bijector, mirroring
    mlii_fit_full, to compare against jax.grad of SPR.loss."""
    bij = positive()

    def chain(raw, g):
        _, vjp = jax.vjp(bij, raw)
        return float(vjp(jnp.asarray(g, jnp.float32))[0])

    out = {k: chain(params["kernel"][k], g_c[k])
           for k in ("w_std", "b_std", "last_w_std")}
    out["eps"] = chain(params["eps"], g_c["eps"])
    if ab is not None:
        out["a"] = chain(params["likelihood"]["a"], g_c["a"])
        out["b"] = chain(params["likelihood"]["b"], g_c["b"])
    return out


HYPER = dict(w_std=1.3, b_std=0.4, last_w_std=0.9)
EPS0 = 3e-2
A0, B0 = 2.0, 1.5


def _data(n=96, d=6, seed=0):
    rng = np.random.RandomState(seed)
    return (jnp.asarray(rng.randn(n, d), jnp.float32),
            jnp.asarray(rng.randn(n), jnp.float32))


@pytest.mark.parametrize("method", ["gp", "tp"])
def test_full_gram_mlii_matches_dense_grad(method):
    x, y = _data()
    n = x.shape[0]
    kernel = NNGPKernel(_builder, **HYPER)
    lik = (StudentTLikelihood(A0, B0) if method == "tp"
           else GaussianLikelihood())
    model = SPR(kernel, lik, x, y, 0.0, 1.0, eps=EPS0)
    params = model.init_params()
    loss_want, g_want = jax.value_and_grad(model.loss)(params)

    aug = _aug_builder(**HYPER)
    k, dkw, dkb = tiled_aug_gram(aug, x, block=32)
    # Assembly parity: mirrored tiles must equal the dense Gram.
    k_dense = np.asarray(model._gram(kernel.get_kernel_fn(params["kernel"])))
    np.testing.assert_allclose(k, k_dense, rtol=2e-6, atol=1e-6)

    ab = (A0, B0) if method == "tp" else None
    loss_got, g_c = full_gram_mlii_value_and_grad(
        k, dkw, dkb, y, last_w_std=HYPER["last_w_std"], eps=EPS0, ab=ab,
        panel=40)  # non-dividing panel exercises the tail slice

    assert np.isclose(loss_got, float(loss_want), rtol=1e-5)
    g_got = _unconstrained_grads(g_c, params, ab)
    names = ["w_std", "b_std", "last_w_std", "eps"] + (
        ["a", "b"] if ab else [])
    for name in names:
        if name in ("a", "b"):
            want = float(g_want["likelihood"][name])
        elif name == "eps":
            want = float(g_want["eps"])
        else:
            want = float(g_want["kernel"][name])
        assert np.isclose(g_got[name], want, rtol=2e-3, atol=1e-6), (
            f"{method} d/d{name}: tiled {g_got[name]:.6g} vs dense {want:.6g}")


def test_mlii_fit_full_matches_dense_adam(tmp_path):
    """Two Adam steps through the tiled gradient == two Adam steps through
    jax.grad of SPR.loss (same optimizer implementation, same lr) — the
    end-to-end check that the full-Gram path IS the reference's reg-tr
    recipe at tiled scale. Also exercises resume: step 1 and step 2 run as
    separate invocations sharing a resume_dir."""
    from snngp.utils.optim import Adam

    x, y = _data(n=64)
    kernel = NNGPKernel(_builder, **HYPER)
    model = SPR(kernel, StudentTLikelihood(A0, B0), x, y, 0.0, 1.0, eps=EPS0)
    params = model.init_params()
    opt = Adam()
    opt_state = opt.init(params)
    lr = 5e-2
    for _ in range(2):
        grads = jax.grad(model.loss)(params)
        params, opt_state = opt.update(grads, opt_state, params, lr)
    want_w = float(P.constrained_read(params["kernel"]["w_std"], model.bij))
    want_eps = float(P.constrained_read(params["eps"], model.bij))
    want_a = float(P.constrained_read(params["likelihood"]["a"], model.bij))

    rdir = str(tmp_path / "mlii")
    quiet = lambda *_args, **_kw: None
    mlii_fit_full(AUG, x, y, steps=1, lr=lr, block=32,
                  init_hyper=dict(HYPER), eps=EPS0, ab=(A0, B0),
                  panel=64, resume_dir=rdir, log=quiet)
    hyper, eps_f, ab_f, losses = mlii_fit_full(
        AUG, x, y, steps=2, lr=lr, block=32,
        init_hyper=dict(HYPER), eps=EPS0, ab=(A0, B0),
        panel=64, resume_dir=rdir, log=quiet)
    assert len(losses) == 1            # resumed: only step 2 ran
    assert np.isclose(hyper["w_std"], want_w, rtol=1e-3)
    assert np.isclose(eps_f, want_eps, rtol=1e-3)
    assert np.isclose(ab_f[0], want_a, rtol=1e-3)


def test_jvp_aug_fn_matches_jacfwd():
    """The jvp-based augmented block equals K and its forward-mode
    Jacobian in (w_std, b_std) from jax.jacfwd, for a symmetric and a cross
    block."""
    x, _ = _data(n=24)
    x2 = x[:10] * 0.7
    w, b, l = (jnp.float32(v) for v in (1.3, 0.4, 0.9))
    for a, c in ((x, x), (x, x2)):
        k, dkw, dkb = AUG(a, c, w, b, l)
        f = lambda wb: _builder(wb[0], wb[1], l)(a, c)
        jac = jax.jacfwd(f)(jnp.stack([w, b]))            # [n1, n2, 2]
        np.testing.assert_allclose(k, f(jnp.stack([w, b])), rtol=1e-6)
        np.testing.assert_allclose(dkw, jac[..., 0], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(dkb, jac[..., 1], rtol=1e-5, atol=1e-6)


def test_tiled_aug_gram_args_reuse_compile():
    """Hyperparameters passed as traced args: a second assembly with new
    values reuses the compiled chunk program and matches fixed-value
    tiles."""
    from snngp.nn import full as F

    x, _ = _data(n=40)
    hyper = [jnp.float32(v) for v in (1.3, 0.4, 0.9)]
    first = tiled_aug_gram(AUG, x, block=16, args=tuple(hyper))
    run = F._chunk_runner(AUG, 16, True)
    size = run._cache_size()
    hyper[0] = jnp.float32(1.1)
    got = tiled_aug_gram(AUG, x, block=16, args=tuple(hyper))
    assert run._cache_size() == size
    want = tiled_aug_gram(_aug_builder(1.1, 0.4, 0.9), x, block=16)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, rtol=1e-6)
    assert not np.allclose(first[1], got[1])


def test_tiled_aug_gram_resume(tmp_path):
    """A partially-assembled augmented Gram resumes from its bitmap and
    finishes identical to a fresh assembly."""
    x, _ = _data(n=64)
    aug = _aug_builder(**HYPER)
    rdir = str(tmp_path / "aug")
    k0, dkw0, dkb0 = tiled_aug_gram(aug, x, block=32)

    # Fresh resumable assembly, then clobber one tile's done bit + data.
    k1, _, _ = tiled_aug_gram(aug, x, block=32, resume_dir=rdir)
    done_path = f"{rdir}/aug.done.npy"
    done = np.load(done_path)
    done[1] = False
    np.save(done_path, done)
    kmap = np.lib.format.open_memmap(f"{rdir}/aug_0.npy", mode="r+")
    kmap[:32, 32:] = -1.0
    kmap.flush()
    del kmap

    k2, dkw2, dkb2 = tiled_aug_gram(aug, x, block=32, resume_dir=rdir)
    np.testing.assert_allclose(np.asarray(k2), k0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(dkw2), dkw0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(dkb2), dkb0, rtol=1e-6)
