"""The library tile assembler (snngp.nn.full.tiled_gram): symmetric mirror,
ragged padding, multi-output blocks, and the crash-resume bitmap."""

import numpy as np
import pytest

import jax.numpy as jnp

from snngp.nn import arch
from snngp.nn.full import pad_rows, tiled_gram

KFN = arch.get_mlp_kernel(2, 1, "relu", w_std=1.2, b_std=0.3, last_w_std=0.9)


def _x(n, seed=0, d=5):
    return jnp.asarray(np.random.RandomState(seed).randn(n, d), jnp.float32)


def test_pad_rows_repeats_last_row():
    x = _x(5)
    p = pad_rows(x, 4)
    assert p.shape == (8, 5)
    np.testing.assert_array_equal(p[:5], x)
    np.testing.assert_array_equal(p[5:], np.repeat(x[-1:], 3, axis=0))
    assert pad_rows(x, 5) is x


@pytest.mark.parametrize("n1,n2,tile,chunk", [(20, None, 8, 3),
                                              (20, 13, 8, 4),
                                              (16, 16, 4, 100)])
def test_tiled_equals_untiled(n1, n2, tile, chunk):
    """Symmetric (upper triangle mirrored) and cross Grams with ragged tiles
    and a ragged last chunk equal the one-call Gram."""
    x1 = _x(n1)
    x2 = None if n2 is None else _x(n2, seed=1)
    got = tiled_gram(KFN, x1, x2, tile=tile, chunk=chunk)
    want = np.asarray(KFN(x1, x1 if x2 is None else x2))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if x2 is None:      # mirrored off-diagonal blocks are bitwise transposes
        np.testing.assert_array_equal(got[:tile, tile:], got[tile:, :tile].T)


def test_tiled_multi_output_and_args():
    """A block function returning a tuple assembles every output; traced
    args reach it."""
    x = _x(12)

    def fn(a, b, s):
        k = KFN(a, b)
        return k, s * k

    k, ks = tiled_gram(fn, x, args=(jnp.float32(3.0),), tile=5, chunk=2)
    np.testing.assert_allclose(ks, 3.0 * k, rtol=1e-6)
    np.testing.assert_allclose(k, np.asarray(KFN(x, x)), rtol=1e-6,
                               atol=1e-7)


def test_tiled_resume_bitmap(tmp_path):
    """A run that lost some blocks recomputes only those; the finished
    memmap equals a fresh assembly; a different size is refused."""
    x = _x(24)
    want = tiled_gram(KFN, x, tile=8, chunk=2)
    rdir = str(tmp_path)
    got = tiled_gram(KFN, x, tile=8, chunk=2, resume_dir=rdir, name="k")
    np.testing.assert_array_equal(np.asarray(got), want)

    done = np.load(f"{rdir}/k.done.npy")
    assert done.all() and done.shape == (6,)          # 3 x 3 upper triangle
    done[[1, 4]] = False
    np.save(f"{rdir}/k.done.npy", done)
    gram = np.lib.format.open_memmap(f"{rdir}/k.npy", mode="r+")
    gram[:8, 8:16] = -1.0                               # block (0, 1)
    gram[8:16, 16:] = -1.0                              # block (1, 2)
    gram.flush()
    del gram

    got = tiled_gram(KFN, x, tile=8, chunk=1, resume_dir=rdir, name="k")
    np.testing.assert_array_equal(np.asarray(got)[:8, 8:16], want[:8, 8:16])
    np.testing.assert_array_equal(np.asarray(got), want)
    assert np.load(f"{rdir}/k.done.npy").all()
    with pytest.raises(ValueError, match="different data or tile size"):
        tiled_gram(KFN, x[:16], tile=8, resume_dir=rdir, name="k")
