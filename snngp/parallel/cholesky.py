"""Blocked / distributed Cholesky factorization (SURVEY.md D3).

Two distributed flavors of the right-looking blocked algorithm, replacing the
reference's monolithic ``jnp.linalg.cholesky`` / ``inv`` / ``slogdet`` call
sites (spax/models.py:40, spax/utils.py:39,138) at large N:

- ``blocked_cholesky`` under ``pjit`` with row-sharded operands: GSPMD
  partitions the trailing updates and inserts one [rest, b] panel all-gather
  per step over the device interconnect.
- ``cyclic_cholesky``: explicit ScaLAPACK-style 1D block-cyclic column
  distribution under ``shard_map`` — balanced trailing updates regardless of
  how far the factorization has progressed, exactly one psum (a ring
  all-reduce) per panel step.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as Pspec

from snngp.parallel.mesh import row_sharding

__all__ = ["blocked_cholesky", "inplace_blocked_cholesky",
           "blocked_triangular_solve", "cyclic_cholesky",
           "distributed_cholesky"]


def _dividing_block(n: int, target: int = 1024, floor: int = 128):
    """Largest block <= target that divides n, or None if all are < floor.

    The memory-lean kernels identity-pad non-block-multiple sizes, and the
    pad is a full-size copy — exactly what they exist to avoid. At
    north-star sizes the caller rarely controls n to be a power of two
    (e.g. CIFAR-10's 50,000), so when the default block doesn't divide n we
    prefer a slightly smaller one that does (50,000 -> 1,000) over a 10 GB
    pad copy. Below ``floor`` the panel matmuls get too skinny to run at
    matmul rate and padding wins again.
    """
    for b in range(min(target, n), floor - 1, -1):
        if n % b == 0:
            return b
    return None


@partial(jax.jit, static_argnames=("block", "panel_inverse"))
def blocked_cholesky(a: jax.Array, block: Optional[int] = None,
                     panel_inverse: bool = False) -> jax.Array:
    """Lower Cholesky factor of PSD ``a`` via right-looking block panels.

    The block count is static, so the panel loop unrolls with *statically
    shrinking* trailing updates restricted to the lower-triangular block
    columns (right-looking factorization never reads above the diagonal):
    ~n^3/6 multiplies total — LAPACK potrf's leading term — instead of the
    n^3 a full-width masked update costs or the n^3/3 of a full-square syrk.
    Every step is matmul/solve-shaped, and under pjit with row-sharded
    operands GSPMD partitions each trailing update across the mesh with one
    [rest, b] panel all-gather per step.

    Non-multiple sizes are identity-padded ([[A, 0], [0, I]] factors to
    [[L, 0], [0, I]]) and sliced back. Equivalent to ``jnp.linalg.cholesky``
    up to float error.

    ``panel_inverse=True`` computes the panel as ``A21 @ L11^{-T}`` (one
    [b, b] triangular inverse + a pure matmul) instead of the [rest, b]
    triangular solve — the MAGMA-style trtri+gemm panel, trading a bounded
    extra rounding term (||inv|| ~ cond(L11), benign for the jittered PSD
    Grams this factors) for a plain matmul on the tall operand.

    ``block=None`` (default) picks 512 grown so the panel count stays <= 24:
    the unrolled panel loops emit O(nb^2/2) HLO ops and XLA compile time
    scales with them. An explicit ``block`` is respected verbatim (tests
    exercise many-panel configurations deliberately).
    """
    n0 = a.shape[-1]
    if block is None:
        block = 512
        if n0 // block > 24:
            per_panel = -(-n0 // 24)              # ceil(n0 / 24)
            block = -(-per_panel // 256) * 256    # round up to 256 multiple
    block = min(block, n0)
    pad = (-n0) % block
    if pad:
        a = jnp.pad(a, ((0, pad), (0, pad)))
        a = a.at[jnp.arange(n0, n0 + pad), jnp.arange(n0, n0 + pad)].set(1.0)
    n = a.shape[-1]
    nb = n // block

    out = jnp.zeros_like(a)
    work = a
    eye = jnp.eye(block, dtype=a.dtype) if panel_inverse else None
    for k in range(nb):
        # work is the trailing submatrix from offset k*block on.
        lkk = jnp.linalg.cholesky(work[:block, :block])
        strip = lkk
        if k + 1 < nb:
            if panel_inverse:
                # trtri + gemm: L21 = A21 L11^{-T}; the tall operand runs
                # as a plain matmul instead of a [rest, b] trsm.
                inv_t = lax.linalg.triangular_solve(
                    lkk, eye, left_side=False, lower=True, transpose_a=True)
                panel = work[block:, :block] @ inv_t
            else:
                # rows below the diagonal block: solve L21 L11^T = A21.
                panel = lax.linalg.triangular_solve(
                    lkk, work[block:, :block], left_side=False, lower=True,
                    transpose_a=True)
            strip = jnp.concatenate([lkk, panel], axis=0)
            rest = work[block:, block:]
            # Lower-triangular syrk: update block-column c only from its
            # diagonal block down; the stale upper triangle is never read.
            for c in range(rest.shape[0] // block):
                pc = panel[c * block:(c + 1) * block]          # [b, b]
                upd = panel[c * block:] @ pc.T                 # [rest-c*b, b]
                rest = lax.dynamic_update_slice(
                    rest,
                    lax.dynamic_slice(rest, (c * block, c * block),
                                      upd.shape) - upd,
                    (c * block, c * block))
            work = rest
        out = lax.dynamic_update_slice(out, strip, (k * block, k * block))
    return out[:n0, :n0]


@partial(jax.jit, static_argnames=("block",), donate_argnums=0)
def inplace_blocked_cholesky(a: jax.Array,
                             block: Optional[int] = None) -> jax.Array:
    """Memory-lean blocked Cholesky: factors ``a`` inside its own buffer.

    Right-looking panel factorization structured as a ``lax.fori_loop``
    whose carry IS the [n, n] matrix — XLA updates while-loop carries in
    place, so peak HBM is ~n^2 + a few [n, b] panels, instead of the ~2-3
    n^2 of any out-of-place kernel (a flat unrolled update chain was tried
    first and still OOMed at 18 GB: buffer assignment left a full-matrix
    layout copy / 49.9% heap fragmentation; the loop-carry form is the
    aliasing XLA actually guarantees).

    At n = 50000 a fp32 Gram is 10 GB: ``jnp.linalg.cholesky`` (or any
    out-of-place kernel) needs input + output, this kernel about one copy.
    Matches the reference's factorization sites (spax/models.py:40,
    spax/utils.py:138).

    Loop bodies need static slice shapes, so every step works on fixed-size
    full-width [b, n] ROW panels with column masks. Row panels are the
    layout-critical choice: they are contiguous in the default row-major
    layout, so the loop carry keeps the donated buffer's layout and no
    full-matrix layout-conversion copy is inserted (the column-panel form
    made XLA pick a column-major carry and transpose-copy the full input —
    a second out-of-memory mode). Consequently the kernel
    computes the UPPER factor U = L^T (A = U^T U, row panels of U are
    column panels of L): the solved panel is zeroed left of the diagonal
    block, which makes the trailing updates mask-free (zero columns
    contribute zero update) and leaves the buffer exactly
    upper-triangular on exit — no final masking pass. The fixed-width
    updates spend ~3x the multiplies of the shrinking-slice form; the
    kernel trades them for memory. The dynamic loop also compiles in
    seconds (no unrolling: O(1) HLO ops).

    The caller's array is invalidated (donated). Returns the UPPER
    Cholesky factor ``u`` with the strict lower triangle zeroed —
    ``u.T`` is ``jnp.linalg.cholesky``'s lower factor; solve with
    ``cho_solve((u, False), y)`` / ``solve_triangular(u, y, lower=False,
    trans=1)``, and ``logdet = 2 sum(log(diag(u)))``. (Returning U rather
    than transposing to L is deliberate: at the sizes this kernel exists
    for, a final transpose is another full-size buffer.)
    Non-block-multiple sizes are identity-padded and sliced back (the pad
    briefly doubles peak memory — at the sizes where this kernel matters,
    pass a block that divides n, e.g. the default 1024/2048 for n a
    multiple of 4096).
    """
    n0 = a.shape[-1]
    if block is None:
        block = _dividing_block(n0) or min(1024, n0)
    block = min(block, n0)
    pad = (-n0) % block
    if pad:
        a = jnp.pad(a, ((0, pad), (0, pad)))
        a = a.at[jnp.arange(n0, n0 + pad), jnp.arange(n0, n0 + pad)].set(1.0)
    n = a.shape[-1]
    nb = n // block
    cols = lax.iota(jnp.int32, n)[None, :]                     # [1, n]

    # [nb, b, n] view of the row-major buffer (a bitcast, not a copy).
    # Leading-dim dynamic_update_slice on a loop carry is the dus pattern
    # XLA's copy-insertion provably keeps in place: measured temp memory is
    # ~3 [b, n] panels, where interior-offset [b, n] updates on the flat
    # [n, n] carry still left a full-matrix copy.
    a3 = a.reshape(nb, block, n)

    def step(k, a3):
        off = k * block
        row = lax.dynamic_slice(a3, (k, 0, 0), (1, block, n))[0]
        lkk = jnp.linalg.cholesky(
            lax.dynamic_slice(row, (0, off), (block, block)))
        # U_kk^T U_k,rest = A_k,rest with U_kk^T = lkk: a left-side lower
        # trsm solves each column independently; columns outside the
        # right-of-panel region are solved too and then masked off.
        sol = lax.linalg.triangular_solve(
            lkk, row, left_side=True, lower=True)
        right = cols >= off + block
        within = (cols >= off) & (cols < off + block)
        pan = jnp.where(right, sol, 0.0)                       # [b, n]
        ukk_emb = lax.dynamic_update_slice(
            jnp.zeros_like(row), lkk.T, (0, off))
        # Row after its own panel step: zeros left, U_kk inside, U_k,rest
        # right — already the final upper-triangular layout.
        a3 = lax.dynamic_update_slice(
            a3, jnp.where(within, ukk_emb, pan)[None], (k, 0, 0))

        def update_row(j, a3):
            # Subtract pan_j^T @ pan from row block j. pan columns left of
            # the active panel are zero, so no column mask is needed.
            pj = lax.dynamic_slice(pan, (0, j * block), (block, block))
            rowj = lax.dynamic_slice(a3, (j, 0, 0), (1, block, n))[0]
            return lax.dynamic_update_slice(
                a3, (rowj - pj.T @ pan)[None], (j, 0, 0))

        return lax.fori_loop(k + 1, nb, update_row, a3)

    a = lax.fori_loop(0, nb, step, a3).reshape(n, n)
    return a[:n0, :n0] if pad else a


@partial(jax.jit, static_argnames=("trans", "block"))
def blocked_triangular_solve(u: jax.Array, b: jax.Array, *,
                             trans: bool = False,
                             block: Optional[int] = None) -> jax.Array:
    """Memory-lean triangular solve against an UPPER factor: O(n*block) temps.

    Solves ``U^T x = b`` (``trans=True``, forward substitution) or
    ``U x = b`` (``trans=False``, back substitution) where ``u`` is the
    upper Cholesky factor with a ZEROED strict lower triangle — exactly
    what ``inplace_blocked_cholesky`` returns. The zeroed lower triangle is
    load-bearing: each panel's update multiplies a full-height slice of
    ``u`` against the solution carry, and the triangle structure (not a
    mask) keeps not-yet-solved panels out of the product.

    Why not ``jax.scipy.linalg.solve_triangular``: XLA's expander for a
    monolithic triangular solve materializes a masked full-size copy of the
    factor plus a scan of staggered RHS temps, several times the factor's
    size. This panel loop's peak is
    the factor (argument, never copied) + one [n, block] slice + the
    [n, r] solution carry. Replaces the reference's predictive solve sites
    (spax/likelihoods.py:60, neural_tangents predict via spax/kernels.py:
    29-32) at scales where the monolithic op cannot run.

    ``b`` may be [n] or [n, r]. Like the factor kernel, non-block-multiple
    sizes prefer a block that divides n (see ``_dividing_block``); if none
    exists the factor is identity-padded (a full-size copy — avoid at the
    sizes this kernel exists for).
    """
    n0 = u.shape[-1]
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    if block is None:
        block = _dividing_block(n0) or min(1024, n0)
    block = min(block, n0)
    pad = (-n0) % block
    if pad:
        u = jnp.pad(u, ((0, pad), (0, pad)))
        u = u.at[jnp.arange(n0, n0 + pad), jnp.arange(n0, n0 + pad)].set(1.0)
        b = jnp.pad(b, ((0, pad), (0, 0)))
    n, r = u.shape[-1], b.shape[-1]
    nb = n // block

    def fwd_step(k, x):
        # Forward substitution in U^T x = b over row panels of x: the
        # cross-panel term is (U[:, panel])^T x, where rows of the column
        # slice at the diagonal block hit x entries still zero and rows
        # below it are structurally zero — no mask needed.
        off = k * block
        col = lax.dynamic_slice(u, (0, off), (n, block))       # [n, blk]
        ukk = lax.dynamic_slice(col, (off, 0), (block, block))
        rhs = lax.dynamic_slice(b, (off, 0), (block, r)) - col.T @ x
        xk = lax.linalg.triangular_solve(
            ukk, rhs, left_side=True, lower=False, transpose_a=True)
        return lax.dynamic_update_slice(x, xk, (off, 0))

    def bwd_step(i, x):
        # Back substitution in U x = b, bottom panel first: the row slice
        # is contiguous in the row-major factor layout, and its columns
        # left of the diagonal block are structurally zero.
        k = nb - 1 - i
        off = k * block
        row = lax.dynamic_slice(u, (off, 0), (block, n))       # [blk, n]
        ukk = lax.dynamic_slice(row, (0, off), (block, block))
        rhs = lax.dynamic_slice(b, (off, 0), (block, r)) - row @ x
        xk = lax.linalg.triangular_solve(
            ukk, rhs, left_side=True, lower=False)
        return lax.dynamic_update_slice(x, xk, (off, 0))

    x = lax.fori_loop(0, nb, fwd_step if trans else bwd_step,
                      jnp.zeros((n, r), u.dtype))
    if pad:
        x = x[:n0]
    return x[:, 0] if squeeze else x


def cyclic_cholesky(a: jax.Array, mesh: Mesh, block: int = 512,
                    axis_name: str = "data") -> jax.Array:
    """Block-cyclic column-panel Cholesky with explicit collectives
    (ScaLAPACK-style 1D right-looking factorization under ``shard_map``).

    Column blocks are dealt round-robin over the mesh (block-cyclic), so the
    trailing-update work stays balanced as the active submatrix shrinks —
    the failure mode of contiguous row sharding, where low-row devices go
    idle. Per panel step:

    - the owning device factors the diagonal block and solves its panel
      (``L21 L11^T = A21``, rows below the diagonal only),
    - one ``psum`` broadcasts the [N, b] panel over the mesh — XLA lowers
      this to an all-reduce, and it is the ONLY communication per step,
    - every device applies the rank-b update to its own local column blocks
      with global index > k, rows (k+1)b..N only (statically sliced; the
      strictly-upper part of each local block is never written and reads as
      garbage, exactly like ``jnp.linalg.cholesky``'s undefined upper half
      before the final ``tril``).

    The loop is software-pipelined with 1-step lookahead: after panel k's
    broadcast, column k+1 alone is updated and panel k+1 factored *before*
    the bulk trailing update, so the next psum has no data dependence on the
    bulk matmuls and the runtime can overlap collective and compute (the
    classic potrf lookahead; wall-clock benefit needs a real multi-chip
    slice to observe). Differentiable end-to-end (plain lax ops + psum)
    under an enclosing ``jit`` — which every snngp training step has; eager
    reverse-mode over shard_map trips a sharding-override assert in current
    JAX.
    """
    P = mesh.shape[axis_name]
    n0 = a.shape[-1]
    step = block * P
    pad = (-n0) % step
    if pad:
        a = jnp.pad(a, ((0, pad), (0, pad)))
        a = a.at[jnp.arange(n0, n0 + pad), jnp.arange(n0, n0 + pad)].set(1.0)
    n = a.shape[-1]
    nb = n // block
    lb = nb // P

    # Device-major block-cyclic layout: position d*lb + j holds global
    # column block d + j*P, so a contiguous shard_map split gives device d
    # exactly its cyclic deal.
    order = np.asarray([d + j * P for d in range(P) for j in range(lb)])
    a_perm = a.reshape(n, nb, block)[:, order, :].reshape(n, n)

    def local_fn(al):
        d = lax.axis_index(axis_name)
        out = jnp.zeros_like(al)
        eye = jnp.eye(block, dtype=al.dtype)

        def local_panel(al, k):
            """Pre-broadcast panel k: the owner factors its diagonal block
            and solves the rows below; everyone else factors an identity
            stand-in (keeps every lane finite so the select-mask stays
            NaN-free under reverse-mode AD) that the mask discards."""
            owner, li = k % P, k // P
            kb = k * block
            isown = d == owner
            cand = al[:, li * block:(li + 1) * block]
            diag = jnp.where(isown, cand[kb:kb + block], eye)
            rhs = jnp.where(isown, cand[kb + block:],
                            jnp.zeros_like(cand[kb + block:]))
            lkk = jnp.linalg.cholesky(diag)
            below = lax.linalg.triangular_solve(
                lkk, rhs, left_side=False, lower=True, transpose_a=True)
            panel = jnp.concatenate(
                [jnp.zeros((kb, block), al.dtype), lkk, below])
            return jnp.where(isown, panel, jnp.zeros_like(panel))

        # Software-pipelined with 1-step lookahead: panel k+1 is factored
        # right after the lookahead update of column k+1, BEFORE the bulk
        # trailing update of step k — so the next broadcast depends only on
        # ops preceding the bulk matmuls and the runtime is free to overlap
        # the collective with them.
        cand_panel = local_panel(al, 0)
        for k in range(nb):
            owner, li = k % P, k // P
            isown = d == owner
            panel = lax.psum(cand_panel, axis_name)     # owner -> everyone
            out = out.at[:, li * block:(li + 1) * block].set(
                jnp.where(isown, panel, out[:, li * block:(li + 1) * block]))
            if k + 1 == nb:
                break
            nk = k + 1
            nkb = nk * block
            nli = nk // P
            isnext = d == (nk % P)
            prows = panel[nkb:]                          # static row slice
            # Lookahead: apply panel k to column k+1 only (its owner), with
            # fully static slices since k+1 is a Python int.
            upd = prows @ panel[nkb:nkb + block].T
            seg = al[nkb:, nli * block:(nli + 1) * block]
            al = al.at[nkb:, nli * block:(nli + 1) * block].set(
                seg - jnp.where(isnext, 1.0, 0.0).astype(al.dtype) * upd)
            cand_panel = local_panel(al, nk)
            # Bulk trailing update: local columns with global index > k+1.
            for j in range(lb):
                g = d + j * P                            # traced global idx
                do = jnp.where(g > nk, 1.0, 0.0).astype(al.dtype)
                rowpart = lax.dynamic_slice(
                    panel, (g * block, 0), (block, block))
                upd = prows @ rowpart.T
                seg = al[nkb:, j * block:(j + 1) * block]
                al = al.at[nkb:,
                           j * block:(j + 1) * block].set(seg - do * upd)
        return out

    spec = Pspec(None, axis_name)
    fn = jax.shard_map(local_fn, mesh=mesh, in_specs=(spec,), out_specs=spec)
    out = fn(a_perm)
    inv = np.argsort(order)
    out = out.reshape(n, nb, block)[:, inv, :].reshape(n, n)
    return out[:n0, :n0]


def distributed_cholesky(a: jax.Array, mesh: Optional[Mesh] = None,
                         block: Optional[int] = None, axis_name: str = "data",
                         strategy: str = "pjit") -> jax.Array:
    """Distributed blocked Cholesky over a device mesh.

    ``strategy="pjit"``: GSPMD-partitioned full-width blocked kernel on
    row-sharded operands (collectives inserted by XLA).
    ``strategy="cyclic"``: explicit block-cyclic panel algorithm
    (:func:`cyclic_cholesky` — balanced trailing updates, one psum per
    panel). With ``mesh=None`` runs the single-device blocked kernel.
    """
    if mesh is None or mesh.size == 1:
        return blocked_cholesky(a, block=block)
    if strategy == "cyclic":
        return cyclic_cholesky(a, mesh, block=block or 512,
                               axis_name=axis_name)
    shard = row_sharding(mesh, ndim=2, axis_name=axis_name)
    fn = jax.jit(partial(blocked_cholesky, block=block),
                 in_shardings=shard, out_shardings=shard)
    return fn(jax.device_put(a, shard))
