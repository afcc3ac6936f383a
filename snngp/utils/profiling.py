"""Profiling counters + trace capture (SURVEY.md §5 — absent in the
reference; first-class here since the north-star metric is kernel+Cholesky
wall-clock).

``phase`` accumulates per-phase wall-clock with device synchronization (a
scalar fetch of the phase's output). ``trace`` wraps ``jax.profiler``
capture for perfetto/tensorboard inspection.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from collections import defaultdict
from typing import Dict

import jax
import jax.numpy as jnp

__all__ = ["Profiler", "trace", "gpu_name_and_power_limit"]


def _sync(value=None):
    if value is not None:
        leaves = [l for l in jax.tree_util.tree_leaves(value)
                  if hasattr(l, "dtype")]
        if leaves:
            # Index one element directly: an eager .ravel() is a full device
            # copy, which transiently doubles memory on a 10 GB Gram.
            lead = leaves[0]
            idx = (0,) * getattr(lead, "ndim", 0)
            float(jnp.sum(lead[idx] if idx else lead))
            return
    # No value to hang on: issue a trivial device computation and fetch it.
    float(jnp.zeros(()))


class Profiler:
    """Accumulating per-phase wall-clock counters.

    >>> prof = Profiler()
    >>> with prof.phase("gram"):
    ...     k = kernel_fn(x, x)          # sync'd on exit
    >>> prof.report()
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._last_value = None

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        _sync()  # drain prior async work so the phase owns its interval
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            _sync(sync_on if sync_on is not None else self._last_value)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1
            self._last_value = None

    def observe(self, value):
        """Register the phase's output so exit can synchronize on it."""
        self._last_value = value
        return value

    def report(self) -> str:
        lines = ["phase                 total_s     calls   mean_ms"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:<20} {t:9.4f} {c:9d} {1e3 * t / c:9.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace capture into ``logdir`` around a code block."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, one line each.

    A card set below its maximum power limit runs slower under load, so
    every timing is reported beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
