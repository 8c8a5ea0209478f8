"""One-command real-data accuracy gate of the PyTorch/CUDA port (the
port's counterpart of ``scripts/accuracy_gate.py``, with its flags,
tables, verdict line and exit codes).

    python scripts/torch_accuracy_gate.py \
        --config experiment_config/mini-imagenet_maml++_5-way_5-shot_DA.json \
        [--min-accuracy A] [--device cpu] [--key value ...]

Drives the port's trainer (the CLI's config parsing,
``train_maml_system.get_args``, then ``ExperimentBuilder``) through the
full training schedule and the evaluation protocol (the top-k ensemble
over the fixed test episodes), then prints ONE JSON verdict line
comparing the ensemble's test accuracy with the MAML++ paper table in
BASELINE.md. Exit code: 0 pass, 2 accuracy below the gate, 1 error (no
real dataset, training incomplete, a bad command line, ...).

It refuses to run without real data: a ``synthetic`` dataset name is
rejected, and a missing dataset directory fails with the provisioning
instructions (``utils/dataset_tools.py § maybe_unzip_dataset``,
``require=True``) instead of the synthetic fallback.

Trailing ``--key value`` pairs are config overrides with the trainer
CLI's coercion rules. ``--min-accuracy`` replaces the paper threshold
(required for configs with no paper row). ``--device cpu`` runs on the
CPU (the card by default).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

# MAML++ paper test-accuracy table (BASELINE.md; arXiv:1810.09502), keyed
# by (dataset family, way, shot) as (mean, published 95% CI half-width).
# The pass gate is >= mean - CI: a run at statistical parity lands on
# either side of the point estimate. The strict >= mean verdict is
# reported (``strict_pass``). Omniglot rows have no published CI: 0.
PAPER_GATES = {
    ("omniglot", 5, 1): (0.9947, 0.0),
    ("omniglot", 5, 5): (0.9993, 0.0),
    ("omniglot", 20, 1): (0.9765, 0.0),
    ("omniglot", 20, 5): (0.9933, 0.0),
    ("imagenet", 5, 1): (0.5215, 0.0026),
    ("imagenet", 5, 5): (0.6832, 0.0044),
}

# First-order rows (BASELINE.md § FOMAML; the MAML paper, arXiv:1703.03400
# Table 1), selected when the config trains meta_algorithm="fomaml".
# Mini-ImageNet rows are the paper's "first order approx." entries;
# Omniglot rows reuse its full-MAML numbers as proxies. anil and reptile
# have no row and need --min-accuracy.
FIRST_ORDER_GATES = {
    ("omniglot", 5, 1): (0.987, 0.004),
    ("omniglot", 5, 5): (0.999, 0.001),
    ("omniglot", 20, 1): (0.958, 0.003),
    ("omniglot", 20, 5): (0.989, 0.002),
    ("imagenet", 5, 1): (0.4807, 0.0175),
    ("imagenet", 5, 5): (0.6315, 0.0091),
}


def paper_gate(cfg) -> "tuple[float, float] | None":
    """(paper mean, published CI half-width) for the config's row, or
    None when the paper has none ("imagenet" is mini-ImageNet only:
    tiered-ImageNet has no row)."""
    name = cfg.dataset_name
    family = ("omniglot" if "omniglot" in name
              else "imagenet" if "mini" in name and "imagenet" in name
              else None)
    if family is None:
        return None
    table = (FIRST_ORDER_GATES if cfg.meta_algorithm == "fomaml"
             else PAPER_GATES if cfg.meta_algorithm == "maml++"
             else {})
    return table.get(
        (family, cfg.num_classes_per_set, cfg.num_samples_per_class))


def fail(reason: str, **extra) -> int:
    print(json.dumps({"gate": "accuracy", "pass": False,
                      "error": reason, **extra}), flush=True)
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="real-data accuracy gate vs the BASELINE.md table")
    ap.add_argument("--config", required=True,
                    help="experiment_config/*.json to gate")
    ap.add_argument("--min-accuracy", type=float, default=None,
                    help="replace the BASELINE.md threshold (required "
                         "for configs with no paper row)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU (default: the card)")
    # argparse exits 2 on a usage error, which is this tool's "ran but
    # below the gate": every parse failure maps to exit 1 + a verdict.
    try:
        args, overrides = ap.parse_known_args(argv)
    except SystemExit:
        return fail("invalid command line (usage printed on stderr)")

    from howtotrainyourmamlpytorch_tpu_torch.train_maml_system import (
        get_args)
    try:
        cfg = get_args(["--name_of_args_json_file", args.config]
                       + overrides)
    except (SystemExit, OSError, ValueError) as e:
        return fail(f"invalid config/override "
                    f"({e if not isinstance(e, SystemExit) else 'usage printed on stderr'})",
                    config=args.config)

    if "synthetic" in cfg.dataset_name:
        return fail(
            f"dataset_name {cfg.dataset_name!r} is synthetic: the "
            f"accuracy gate only means something on real data",
            config=args.config)

    paper_mean = paper_ci = None
    if args.min_accuracy is not None:
        threshold, margin = args.min_accuracy, 0.0
    else:
        row = paper_gate(cfg)
        if row is None:
            return fail(
                f"no BASELINE.md paper row for {cfg.dataset_name!r} "
                f"{cfg.num_classes_per_set}-way "
                f"{cfg.num_samples_per_class}-shot; pass --min-accuracy",
                config=args.config)
        paper_mean, paper_ci = row
        threshold, margin = paper_mean - paper_ci, paper_ci

    from howtotrainyourmamlpytorch_tpu_torch.utils.dataset_tools import (
        maybe_unzip_dataset)
    try:
        maybe_unzip_dataset(cfg, require=True)
    except (FileNotFoundError, NotImplementedError, RuntimeError,
            ValueError) as e:
        return fail(f"no real dataset at {cfg.dataset_dir!r}: {e}",
                    config=args.config)

    from howtotrainyourmamlpytorch_tpu_torch.experiment import (
        ExperimentBuilder)
    try:
        result = ExperimentBuilder(cfg, device=args.device).run_experiment()
    except RuntimeError as e:
        return fail(f"{type(e).__name__}: {e}", config=args.config)
    if "test_accuracy_mean" not in result:
        return fail(
            f"training did not reach the test protocol (result: "
            f"{result}); resume with --continue_from_epoch latest",
            config=args.config)

    acc = result["test_accuracy_mean"]
    verdict = {
        "gate": "accuracy",
        "config": args.config,
        "workload": cfg.experiment_name,
        "dataset": cfg.dataset_name,
        "dataset_path": cfg.dataset_dir,
        "way": cfg.num_classes_per_set,
        "shot": cfg.num_samples_per_class,
        "test_accuracy_mean": round(acc, 4),
        "test_accuracy_std": round(result["test_accuracy_std"], 4),
        "num_models": result["num_models"],
        "num_episodes": result["num_episodes"],
        "threshold": round(threshold, 6),
        "meta_algorithm": cfg.meta_algorithm,
        "threshold_source": (
            "--min-accuracy" if args.min_accuracy is not None
            else "BASELINE.md FOMAML (MAML paper) table, mean - CI"
            if cfg.meta_algorithm == "fomaml"
            else "BASELINE.md MAML++ paper table, mean - CI"),
        "paper_mean": paper_mean,
        "paper_ci": paper_ci,
        "margin": margin,
        "strict_pass": (bool(acc >= paper_mean)
                        if paper_mean is not None else None),
        "pass": bool(acc >= threshold),
    }
    print(json.dumps(verdict), flush=True)
    return 0 if verdict["pass"] else 2


if __name__ == "__main__":
    sys.exit(main())
