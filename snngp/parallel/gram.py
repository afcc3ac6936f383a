"""Sharded N x N Gram construction (SURVEY.md D2).

The reference computes the full Gram monolithically via ``kernel_fn(x, x2)``
(``spax/kernels.py:23-27``), OOM-bound at large N. Here the row panels are
distributed over the mesh: each device evaluates the layer recursion for its
row block against the (replicated) full batch, so the O(N^2 depth) hot loop is
data-pair parallel with zero inter-device traffic until the solve stage.
"""

from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh, PartitionSpec as Pspec
from jax import shard_map

__all__ = ["sharded_gram"]


def sharded_gram(kernel_fn, x: jax.Array, mesh: Mesh, axis_name: str = "data",
                 x2: Optional[jax.Array] = None) -> jax.Array:
    """Mesh-sharded Gram: K[i, j] = kernel_fn(x_i, x2_j).

    1D mesh: row panels — each device evaluates its row block against the
    full (replicated) batch; output rows sharded over ``axis_name`` (feeds
    the distributed Cholesky without a relayout).

    2D mesh (``get_mesh(shape=(r, c))``): block layout — device (i, j)
    evaluates kernel_fn(x rows-block i, x2 cols-block j); the output is
    sharded over both mesh axes, each device holding one (N/r, N/c) tile and
    each input shard replicated along the orthogonal axis only (SURVEY.md
    D1-D2 block-2D layout; halves per-device input footprint vs row panels
    at equal device count).

    ``x``/``x2`` leading dims must be divisible by the respective mesh axis
    size (pad upstream).
    """
    if x2 is None:
        x2 = x

    def local_block(x_rows, x2_cols):
        return kernel_fn(x_rows, x2_cols, get="nngp")

    if len(mesh.axis_names) >= 2:
        rows_ax, cols_ax = mesh.axis_names[0], mesh.axis_names[1]
        fn = shard_map(
            local_block, mesh=mesh,
            in_specs=(Pspec(rows_ax), Pspec(cols_ax)),
            out_specs=Pspec(rows_ax, cols_ax),
        )
        return fn(x, x2)

    fn = shard_map(
        local_block, mesh=mesh,
        in_specs=(Pspec(axis_name), Pspec()),
        out_specs=Pspec(axis_name),
    )
    return fn(x, x2)
