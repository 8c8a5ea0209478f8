"""The port's trainer CLI — the reference's ``train_maml_system.py``
contract, on the card:

    python -m howtotrainyourmamlpytorch_tpu_torch.train_maml_system \\
        --name_of_args_json_file \\
        experiment_config/mini-imagenet_maml++_5-way_5-shot_DA_b12.json \\
        [--key value ...]

Any config field can be overridden after the JSON is applied (dataclass
defaults → JSON → CLI overrides), with the JAX package's parsing rules.
``main`` provisions the dataset from a local zip if one is there (else the
synthetic fallback applies), builds the experiment, runs it, and returns
75 when the run was preempted (SIGTERM/SIGINT: 'latest' is saved; resume
with ``--continue_from_epoch latest``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List, Optional

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.device import DeviceLike
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentBuilder
from howtotrainyourmamlpytorch_tpu_torch.resilience import EXIT_PREEMPTED
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


def main(argv: Optional[List[str]] = None, device: DeviceLike = None,
         builders: Optional[list] = None) -> int:
    """Run the CLI on ``device`` (the card by default). ``builders``, when
    given, receives the ``ExperimentBuilder`` that ran, for callers that
    inspect the run afterwards."""
    cfg = get_args(argv)
    print(f"experiment: {cfg.experiment_name} | dataset: "
          f"{cfg.dataset_name} | {cfg.num_classes_per_set}-way "
          f"{cfg.num_samples_per_class}-shot | device "
          f"{device if device is not None else 'cuda'}", flush=True)
    maybe_unzip_dataset(cfg)  # synthetic fallback if absent
    builder = ExperimentBuilder(cfg, device=device)
    if builders is not None:
        builders.append(builder)
    result = builder.run_experiment()
    if isinstance(result, dict) and "preempted_at_iter" in result:
        return EXIT_PREEMPTED
    return 0


if __name__ == "__main__":
    sys.exit(main())
