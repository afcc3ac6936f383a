"""snngp — Scale Mixtures of Neural Network Gaussian Processes in JAX.

A from-scratch JAX/XLA framework with the capabilities of the ICLR 2022
reference implementation (surveyed in SURVEY.md), run on NVIDIA GPUs:

- ``snngp.nn``       compositional NNGP/NTK kernel engine (replaces
                     ``neural_tangents.stax``; reference usage at
                     ``experiments/nt_kernels.py:21-103``), including the
                     full spatial-covariance tier for pooled (Myrtle) nets
                     and the resumable tiled Gram assembler.
- ``snngp.ops``      dense linear algebra (Cholesky solves, GP predictive,
                     fused log-marginal-likelihood), multivariate Student-t
                     primitives, softmax MC likelihood estimators.
- ``snngp.models``   probabilistic layer: bijector-constrained parameters,
                     priors (Gaussian / InverseGamma), likelihoods
                     (Gaussian / Student-t), exact SPR and sparse variational
                     SVSP models (reference ``spax/``).
- ``snngp.parallel`` device-mesh runtime: sharded Gram construction and
                     distributed blocked Cholesky.
- ``snngp.utils``    training utilities: optimizers, LR plateau scheduler,
                     data loader, checkpointing (reference
                     ``experiments/utils.py``), logging.
- ``snngp.data``     dataset layer: UCI/synthetic regression, image
                     classification with ood/imbalanced/noisy transforms.
- ``snngp.cli``      argparse command tree: {regression|classification|
                     ensemble} x {train|test|find} (reference ``run.py``).
"""

import os as _os

import jax as _jax

# GP Gram matrices are routinely near-singular. On NVIDIA GPUs XLA's default
# precision runs float32 matmuls as TF32 (10-bit mantissa, ~1e-3 relative
# error), enough to break Cholesky PSD-ness; "highest" keeps them in true
# fp32. Overridable via JAX_DEFAULT_MATMUL_PRECISION.
if "JAX_DEFAULT_MATMUL_PRECISION" not in _os.environ:
    _jax.config.update("jax_default_matmul_precision", "highest")


def compile_cache_dir():
    """Where compiled executables persist between processes.

    ``JAX_COMPILATION_CACHE_DIR`` wins when it is set (JAX reads it itself;
    set it empty to disable the cache). Otherwise one fixed directory in the
    checkout, ``.jax_cache`` beside the ``snngp`` package: the path is part
    of the cache's key, so it carries no hash, PID, time or temporary name.
    """
    if "JAX_COMPILATION_CACHE_DIR" in _os.environ:
        return _os.environ["JAX_COMPILATION_CACHE_DIR"] or None
    return _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), ".jax_cache")


if "JAX_COMPILATION_CACHE_DIR" not in _os.environ:
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())

from snngp import nn
from snngp import ops
from snngp import models
from snngp import parallel
from snngp import utils
from snngp import data

__version__ = "0.1.0"

__all__ = ["nn", "ops", "models", "parallel", "utils", "data", "__version__"]
