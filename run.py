"""CLI entry point (rebuilds the reference's run.py).

Device pre-flags: the reference's ``-g/--gpu`` (CUDA_VISIBLE_DEVICES, one
process per GPU) becomes ``--devices`` (number of devices in the mesh the
training loops shard over); ``-f/--fraction`` maps to
XLA_PYTHON_CLIENT_MEM_FRACTION unchanged. Both must be handled *before*
importing JAX (reference run.py:10-20). Select GPUs with
CUDA_VISIBLE_DEVICES as usual.
"""

import argparse
import os
import warnings

warnings.filterwarnings("ignore")
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

_pre = argparse.ArgumentParser(add_help=False)
# No short "-d": argparse's prefix matching would swallow the subcommands'
# "-dn"/"-dr" flags as "-d n"/"-d r".
_pre.add_argument("--devices", type=int, default=None)
_pre.add_argument("-f", "--fraction", type=float, default=None)
_pre_args, main_args = _pre.parse_known_args()

if _pre_args.fraction is not None:
    os.environ["XLA_PYTHON_CLIENT_MEM_FRACTION"] = str(_pre_args.fraction)

if _pre_args.devices is not None:
    # Consumed by drivers to build an N-device jax.sharding.Mesh (D1).
    os.environ["SNNGP_MESH_DEVICES"] = str(_pre_args.devices)

import snngp.cli  # noqa: E402  (imports JAX)


def main(raw_args):
    parser = argparse.ArgumentParser(description="Scale Mixtures of NNGP")
    subparsers = parser.add_subparsers(dest="command", metavar="command", required=True)
    snngp.cli.add_subparser(subparsers)

    args = parser.parse_args(raw_args)
    try:
        args.func(args)
    except KeyboardInterrupt:
        print("Stopped")


def cli():
    """Console-script entry point (``snngp`` after ``pip install -e .``)."""
    main(main_args)


if __name__ == "__main__":
    main(main_args)
