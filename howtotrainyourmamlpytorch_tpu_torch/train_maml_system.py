"""The port's trainer CLI — the reference's ``train_maml_system.py``
contract, on the card:

    python -m howtotrainyourmamlpytorch_tpu_torch.train_maml_system \\
        --name_of_args_json_file \\
        experiment_config/mini-imagenet_maml++_5-way_5-shot_DA_b12.json \\
        [--key value ...]

Any config field can be overridden after the JSON is applied (dataclass
defaults → JSON → CLI overrides), with the JAX package's parsing rules.
``--device cpu`` runs on the CPU (the card by default).
``main`` provisions the dataset from a local zip if one is there (else the
synthetic fallback applies), builds the experiment, runs it, and returns
75 when the run was preempted (SIGTERM/SIGINT: 'latest' is saved; resume
with ``--continue_from_epoch latest``).

Launched by torchrun, every rank joins the process group before the
builder (``parallel.multihost.initialize_distributed``) and trains its
shard of the (dcn, tasks) mesh:

    torchrun --nproc_per_node 2 -m \\
        howtotrainyourmamlpytorch_tpu_torch.train_maml_system \\
        --name_of_args_json_file <json> --mesh_shape 1 2

The pod fault domain (``cluster_collective_timeout_s`` > 0) and
``elastic_mode`` need a launcher that leaves the survivors running when a
rank dies: torchrun's agent sends SIGTERM to the other workers (which
then save and exit 75, racing the attributed exit 73), and a survivor
that ``exec``s itself confuses it. Start the ranks with the ``env://``
variables set yourself (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), as
``scripts/torch_chaos_pod.py`` does. With ``elastic_mode=1`` a process
launched with its original env while a degraded survivor group is live
is a backfill: it waits to rejoin through the roster file before it
joins any process group.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import List, Optional

import torch.distributed

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.device import DeviceLike
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentBuilder
from howtotrainyourmamlpytorch_tpu_torch.parallel import multihost
from howtotrainyourmamlpytorch_tpu_torch.resilience import (EXIT_PREEMPTED,
                                                            cluster, elastic)
from howtotrainyourmamlpytorch_tpu_torch.utils.dataset_tools import (
    maybe_unzip_dataset)


def _is_tuple(field) -> bool:
    return "Tuple" in str(field.type) or "tuple" in str(field.type)


def _coerce(parser, field, key: str, raw: str):
    """Parse a CLI override against its dataclass field type: JSON literals
    for every type; bools also take true/false/1/0/yes/no in any case;
    tuple fields also take bare comma-separated values; string fields
    take a bare string. Anything else is an error, never a smuggled
    string."""
    if field.type in ("bool", bool):
        low = raw.strip().lower()
        if low in ("true", "1", "yes"):
            return True
        if low in ("false", "0", "no"):
            return False
        parser.error(f"--{key} expects a boolean, got {raw!r}")
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        if _is_tuple(field):
            try:
                return json.loads(f"[{raw}]")
            except json.JSONDecodeError:
                pass
        if "str" in str(field.type):
            return raw  # bare string (e.g. --experiment_name foo)
        parser.error(f"--{key}: could not parse {raw!r} as {field.type}")


def get_args(argv: Optional[List[str]] = None) -> MAMLConfig:
    parser = argparse.ArgumentParser(
        description="MAML++ few-shot meta-learning (PyTorch/CUDA port)")
    parser.add_argument("--name_of_args_json_file", type=str, default=None,
                        help="experiment_config/*.json (reference schema)")
    known, overrides = parser.parse_known_args(argv)

    values = {}
    if known.name_of_args_json_file:
        with open(known.name_of_args_json_file) as f:
            values.update(json.load(f))

    fields = {f.name: f for f in dataclasses.fields(MAMLConfig)}
    i = 0
    while i < len(overrides):
        tok = overrides[i]
        if not tok.startswith("--"):
            parser.error(f"unexpected argument {tok!r}")
        key, eq, inline = tok[2:].partition("=")
        if key not in fields:
            parser.error(f"unknown config field --{key}")
        if eq:
            raw = inline
            i += 1
        else:
            # The run of non-flag tokens is the value, so tuple fields
            # work naturally ('--mesh_shape 2 4'); '-1' is a value.
            j = i + 1
            while j < len(overrides) and not overrides[j].startswith("--"):
                j += 1
            tokens = overrides[i + 1:j]
            if not tokens:
                parser.error(f"--{key} needs a value")
            if len(tokens) > 1 and not _is_tuple(fields[key]):
                parser.error(f"--{key} takes one value, got {len(tokens)}: "
                             f"{' '.join(tokens)!r}")
            raw = tokens[0] if len(tokens) == 1 else ",".join(tokens)
            i = j
        values[key] = _coerce(parser, fields[key], key, raw)
    return MAMLConfig.from_dict(values)


def _elastic_gate(cfg: MAMLConfig) -> None:
    """The elastic start-up gate, before the process group: a process
    launched with the ORIGINAL env (no ``MAML_ELASTIC_GENERATION``) while
    a degraded survivor group is LIVE is a backfill. It rejoins through
    the roster file (adopting the re-expanded generation's env in
    place) instead of standing up a rival full-geometry group. A
    whole-job restart over a stale roster retires it, so the lost-host
    budget restarts at zero. The original host index is ``RANK``."""
    lease_dir = os.path.join(cfg.experiment_root, cfg.experiment_name,
                             cluster.LEASE_DIR)
    if elastic.parse_roster_env() is not None:
        return  # already resharded: the roster env says who we are
    doc = elastic.read_roster(lease_dir)
    self_host = int(os.environ.get("RANK", "0"))
    stalled = cluster.stalled_after(cfg)
    n_ranks = len((doc or {}).get("roster", [])) or 1
    ages = cluster.read_lease_ages(lease_dir, expected_hosts=n_ranks)
    verdict = elastic.startup_disposition(self_host, doc, ages, stalled)
    if verdict == "backfill_wait":
        print(f"elastic: host {self_host} is a backfill for a live "
              f"degraded group (roster {(doc or {}).get('roster')}); "
              f"waiting to rejoin", flush=True)
        joined = elastic.backfill_wait(lease_dir, self_host, stalled)
        if joined is not None:
            # The process group is not up yet: adopt the re-expanded
            # generation's env in place, no exec needed.
            elastic.adopt_env(joined, self_host)
            print(f"elastic: rejoining at generation "
                  f"{joined['generation']}", flush=True)
        else:
            print("elastic: degraded group is gone; launching at the "
                  "original geometry", flush=True)
            elastic.archive_roster(lease_dir)
    elif doc is not None:
        elastic.archive_roster(lease_dir)


def main(argv: Optional[List[str]] = None, device: DeviceLike = None,
         builders: Optional[list] = None) -> int:
    """Run the CLI on ``device`` (the card by default). ``builders``, when
    given, receives the ``ExperimentBuilder`` that ran, for callers that
    inspect the run afterwards. ``--device <d>`` in ``argv`` picks the
    device when ``device`` is None. A process group this call joins is
    left again at its end."""
    pre = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    pre.add_argument("--device", default=None)
    known, argv = pre.parse_known_args(
        sys.argv[1:] if argv is None else argv)
    device = device if device is not None else known.device
    cfg = get_args(argv)
    if cfg.elastic_mode:
        _elastic_gate(cfg)
    # Before the builder: a torchrun rank joins the process group first.
    joins = not multihost.is_initialized()
    multihost.initialize_distributed(
        device, timeout_s=cluster.process_group_timeout(cfg))
    try:
        print(f"experiment: {cfg.experiment_name} | dataset: "
              f"{cfg.dataset_name} | {cfg.num_classes_per_set}-way "
              f"{cfg.num_samples_per_class}-shot | device "
              f"{device if device is not None else 'cuda'}", flush=True)
        maybe_unzip_dataset(cfg)  # synthetic fallback if absent
        builder = ExperimentBuilder(cfg, device=device)
        if builders is not None:
            builders.append(builder)
        result = builder.run_experiment()
    finally:
        if joins and multihost.is_initialized():
            torch.distributed.destroy_process_group()
    if isinstance(result, dict) and "preempted_at_iter" in result:
        return EXIT_PREEMPTED
    return 0


if __name__ == "__main__":
    sys.exit(main())
