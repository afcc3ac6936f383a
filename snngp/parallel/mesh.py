"""Mesh/runtime layer (SURVEY.md D1).

The reference's entire device story is env-var GPU selection
(``run.py:16-20``). Here the first-class runtime is a ``jax.sharding.Mesh``
over which Gram construction and dense factorizations shard; XLA inserts the
collectives.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["device_count", "init_distributed", "get_mesh", "row_sharding",
           "replicated"]

_DISTRIBUTED_INITIALIZED = False


def device_count() -> int:
    return jax.device_count()


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     **kwargs) -> bool:
    """Multi-host runtime hook (SURVEY.md D1): ``jax.distributed.initialize``.

    The reference's device story is env-var GPU selection (``run.py:16-20``);
    in a multi-process launch every process must join a coordination service
    before ``jax.devices()`` spans all hosts. Call this once per process
    before building meshes. A multi-process launch is signalled by explicit
    arguments or by ``JAX_COORDINATOR_ADDRESS``; without either this is a
    no-op (the single-host case). Returns True when a multi-process runtime
    is up.
    """
    global _DISTRIBUTED_INITIALIZED
    if _DISTRIBUTED_INITIALIZED:
        return True
    import os
    have_env = bool(os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if coordinator_address is None and num_processes is None and not have_env:
        return False  # single-process: nothing to join
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id, **kwargs)
        _DISTRIBUTED_INITIALIZED = True
        return True
    except RuntimeError as e:  # already initialized by the launcher
        if "already" in str(e).lower():
            _DISTRIBUTED_INITIALIZED = True
            return True
        raise


def get_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
             shape: Optional[Sequence[int]] = None,
             axis_names: Tuple[str, ...] = ("rows", "cols")) -> Mesh:
    """Device mesh: 1D ``(axis_name,)`` by default, or N-D via ``shape``.

    ``get_mesh(shape=(2, 4))`` builds a 2D ``("rows", "cols")`` mesh for
    block-2D Gram layouts (SURVEY.md D1-D2); the 1D form feeds the row-panel
    Gram + blocked Cholesky pipeline.
    """
    devs = jax.devices()
    if shape is not None:
        size = int(np.prod(shape))
        if size > len(devs):
            raise ValueError(f"mesh shape {tuple(shape)} needs {size} devices, "
                             f"have {len(devs)}")
        names = axis_names[:len(shape)]
        if len(names) != len(shape):
            raise ValueError("axis_names must cover every mesh dim")
        return Mesh(np.array(devs[:size]).reshape(shape), names)
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def row_sharding(mesh: Mesh, ndim: int = 2, axis_name: str = "data") -> NamedSharding:
    """Shard the leading (row) dimension over the mesh; replicate the rest."""
    spec = PartitionSpec(axis_name, *([None] * (ndim - 1)))
    return NamedSharding(mesh, spec)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
