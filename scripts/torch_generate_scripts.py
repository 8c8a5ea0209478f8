"""Stamp launch scripts for the PyTorch port's trainer from
``experiment_config/*.json`` (the port's counterpart of
``script_generation_tools/generate_scripts.py``).

Usage (from the repo root):

    python scripts/torch_generate_scripts.py [--cluster] [--out DIR]

Writes ``DIR/<name>.sh`` (one device: ``bash DIR/<name>.sh``, ``DEVICE``
picks the device, the card by default) and, with ``--cluster``,
``DIR/<name>_cluster.sh`` (a ``torchrun`` launch of the JSON's
``mesh_shape``). ``DIR`` defaults to ``experiment_scripts_torch``;
``experiment_scripts/`` is the JAX generator's and is never written.
Prints each written path, relative to the repo root.
"""

from __future__ import annotations

import argparse
import os
import sys

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO_ROOT)

from howtotrainyourmamlpytorch_tpu_torch.utils.script_gen import (  # noqa: E402
    generate_launch_scripts)

DEFAULT_OUT = "experiment_scripts_torch"
JAX_SCRIPTS = "experiment_scripts"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cluster", action="store_true",
                    help="also generate the torchrun multi-node variants")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="scripts directory, relative to the repo root")
    args = ap.parse_args(argv)
    scripts_dir = os.path.join(_REPO_ROOT, args.out)
    if (os.path.realpath(scripts_dir)
            == os.path.realpath(os.path.join(_REPO_ROOT, JAX_SCRIPTS))):
        ap.error(f"{JAX_SCRIPTS}/ belongs to the JAX generator; pick "
                 f"another --out")
    config_dir = os.path.join(_REPO_ROOT, "experiment_config")
    written = generate_launch_scripts(config_dir, scripts_dir)
    if args.cluster:
        written += generate_launch_scripts(config_dir, scripts_dir,
                                           cluster=True)
    for path in written:
        print(os.path.relpath(path, _REPO_ROOT))
    return 0


if __name__ == "__main__":
    sys.exit(main())
