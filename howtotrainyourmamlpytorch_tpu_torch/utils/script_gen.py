"""Launch scripts for the port's trainer (the port's counterpart of the
JAX package's ``utils/script_gen.py``).

One ``<name>.sh`` per ``experiment_config/*.json`` runs the port's CLI on
one device, ``python -m howtotrainyourmamlpytorch_tpu_torch.
train_maml_system --device "${DEVICE:-cuda}"``; the cluster variant
``<name>_cluster.sh`` launches the JSON's ``mesh_shape`` (dcn, tasks) as
``torchrun --nnodes <dcn> --nproc_per_node <tasks>`` (one rank per
device, ``parallel/``), resuming from ``latest``. Run the cluster script
on every node with ``NODE_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``
set. Extra arguments pass through to the CLI as config overrides.

The scripts go to a directory of their own (``experiment_scripts_torch/``
by default): ``experiment_scripts/`` belongs to the JAX generator.
:func:`generate_config_variants` is the JAX package's, copied.
"""

from __future__ import annotations

import json
import os
import stat
from string import Template
from typing import Any, Dict, List, Sequence, Tuple

CLI_MODULE = "howtotrainyourmamlpytorch_tpu_torch.train_maml_system"

LOCAL_TEMPLATE = Template("""\
#!/usr/bin/env bash
# Auto-generated by scripts/torch_generate_scripts.py — do not edit by hand.
# Launches: ${experiment_name} (PyTorch/CUDA port, one device)
set -euo pipefail
cd "$$(dirname "$$0")/.."
exec python -m ${cli_module} --device "$${DEVICE:-cuda}" \\
    --name_of_args_json_file "${config_path}" "$$@"
""")

CLUSTER_TEMPLATE = Template("""\
#!/usr/bin/env bash
# Auto-generated by scripts/torch_generate_scripts.py — do not edit by hand.
# Multi-node launch for: ${experiment_name} (PyTorch/CUDA port)
# mesh_shape (${dcn}, ${tasks}): ${dcn} node(s) x ${tasks} rank(s), one
# device each. Run this same script on every node with NODE_RANK set
# (0 .. ${last_node}) and MASTER_ADDR / MASTER_PORT naming node 0.
set -euo pipefail
cd "$$(dirname "$$0")/.."
exec torchrun --nnodes ${dcn} --nproc_per_node ${tasks} \\
    --node_rank "$${NODE_RANK:-0}" \\
    --master_addr "$${MASTER_ADDR:-127.0.0.1}" \\
    --master_port "$${MASTER_PORT:-29500}" \\
    -m ${cli_module} \\
    --name_of_args_json_file "${config_path}" \\
    --continue_from_epoch latest "$$@"
""")


def _write_executable(path: str, content: str) -> None:
    with open(path, "w") as f:
        f.write(content)
    os.chmod(path, os.stat(path).st_mode
             | stat.S_IXUSR | stat.S_IXGRP | stat.S_IXOTH)


def mesh_layout(cfg: Dict[str, Any]) -> Tuple[int, int]:
    """``(nodes, ranks per node)`` of a config JSON's ``mesh_shape``
    (``(1, 1)`` when it has none)."""
    dcn, tasks = (int(v) for v in cfg.get("mesh_shape", (1, 1)))
    return dcn, tasks


def generate_launch_scripts(config_dir: str, scripts_dir: str,
                            cluster: bool = False) -> List[str]:
    """One ``<name>.sh`` (or ``<name>_cluster.sh``) per config JSON, with
    script paths relative to the repo root (the scripts ``cd`` to their
    directory's parent)."""
    os.makedirs(scripts_dir, exist_ok=True)
    template = CLUSTER_TEMPLATE if cluster else LOCAL_TEMPLATE
    written = []
    for fname in sorted(os.listdir(config_dir)):
        if not fname.endswith(".json"):
            continue
        name = fname[:-len(".json")]
        with open(os.path.join(config_dir, fname)) as f:
            cfg = json.load(f)
        dcn, tasks = mesh_layout(cfg)
        out = os.path.join(
            scripts_dir, name + ("_cluster.sh" if cluster else ".sh"))
        _write_executable(out, template.substitute(
            experiment_name=cfg.get("experiment_name", name),
            cli_module=CLI_MODULE, dcn=dcn, tasks=tasks,
            last_node=dcn - 1,
            config_path=os.path.join(os.path.basename(config_dir.rstrip("/")),
                                     fname)))
        written.append(out)
    return written


def generate_config_variants(base_config: Dict[str, Any],
                             grid: Dict[str, Sequence[Any]],
                             name_template: str,
                             config_dir: str) -> List[str]:
    """Stamp a config JSON per point of a hyperparameter grid;
    ``name_template`` is formatted with the grid point and becomes both
    the filename and the ``experiment_name``."""
    os.makedirs(config_dir, exist_ok=True)
    keys = sorted(grid)
    points: List[Dict[str, Any]] = [{}]
    for key in keys:
        points = [{**p, key: v} for p in points for v in grid[key]]
    written = []
    for point in points:
        cfg = {**base_config, **point}
        name = name_template.format(**cfg)
        cfg["experiment_name"] = name
        path = os.path.join(config_dir, name + ".json")
        with open(path, "w") as f:
            json.dump(cfg, f, indent=2, sort_keys=True)
        written.append(path)
    return written
