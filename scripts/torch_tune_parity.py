"""Autotune parity gate of the PyTorch/CUDA port: the tuned program
against the untuned one, one verdict (the port's counterpart of
``scripts/tune_parity.py``, with its flags and last-line contract).

    python scripts/torch_tune_parity.py --config TUNED.json-trial-config \
        --base-config BASE.json [--backend-option KEY=VAL ...] \
        [--steps K] [--tolerance T] [--full-shapes] [--device cpu]

Runs K train steps of the tuned candidate (a trial config, with its
backend options applied through the ``xla_compiler_options`` config
key, the plumbing a tuned training launch uses) and of the untuned
base program, from one seed on one synthetic batch
(``tune/trial.py § synthetic_batch``, at ``quick_shrink``'s shapes unless
``--full-shapes``), each under its own ``device.numerics_policy``, then
compares the train states (weights, LSLR, BN state, Adam's moments and
counts) and the losses:

* ``bitwise`` — every leaf identical;
* ``tolerance`` — max relative error <= ``--tolerance`` (default 5e-3;
  a magnitude floor of 1e-6 in the denominator);
* ``fail`` — beyond tolerance, incomparable states, or the tuned
  program refusing to run.

The LAST stdout line is ``{"metric": "tune_parity", "pass": ...,
"mode": ...}``. Exit 0 pass, 2 fail, 1 error. Invoked by
``scripts/torch_autotune.py`` (``tune/harness.py § run_parity``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def _leaves(state) -> dict:
    """``{path: array}`` of a train state, counters included."""
    import numpy as np

    out = {}

    def walk(prefix, tree):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(f"{prefix}/{k}", tree[k])
        else:
            out[prefix] = tree.detach().cpu().numpy()

    for name, tree in (("params", state.params), ("lslr", state.lslr),
                       ("bn_state", state.bn_state),
                       ("mu", state.opt_state.mu),
                       ("nu", state.opt_state.nu)):
        walk(name, tree)
    out["count"] = np.asarray(state.opt_state.count, np.int64)
    out["step"] = np.asarray(state.step, np.int64)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="bitwise-or-tolerance parity: tuned vs untuned "
                    "train program")
    ap.add_argument("--config", required=True,
                    help="the tuned candidate's config JSON (trial "
                         "structural overrides applied)")
    ap.add_argument("--base-config", required=True,
                    help="the untuned base config JSON")
    ap.add_argument("--backend-option", action="append", default=[],
                    metavar="KEY=VAL",
                    help="the candidate's backend options (repeatable), "
                         "applied via the xla_compiler_options key")
    ap.add_argument("--steps", type=int, default=2,
                    help="train steps to run on each side")
    ap.add_argument("--tolerance", type=float, default=5e-3,
                    help="max relative error accepted when not bitwise")
    ap.add_argument("--full-shapes", action="store_true",
                    help="skip the quick shrink (the real geometry)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU (default: the card)")
    args = ap.parse_args(argv)

    def emit(doc, rc):
        print(json.dumps({"metric": "tune_parity", **doc}), flush=True)
        return rc

    from howtotrainyourmamlpytorch_tpu_torch.tune.space import (
        parse_compiler_options)
    try:
        options = parse_compiler_options(args.backend_option)
    except ValueError as e:
        return emit({"pass": False, "mode": "fail", "error": str(e)}, 1)

    import numpy as np
    import torch

    from howtotrainyourmamlpytorch_tpu_torch.device import (
        numerics_policy, resolve_device)
    from howtotrainyourmamlpytorch_tpu_torch.meta.inner import Episode
    from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
        init_train_state, make_train_step)
    from howtotrainyourmamlpytorch_tpu_torch.models import make_model
    from howtotrainyourmamlpytorch_tpu_torch.tune.trial import (
        load_workload, quick_shrink, synthetic_batch)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        return emit({"pass": False, "mode": "fail", "error": str(e)}, 1)

    def run(path: str, backend_options: dict):
        cfg = load_workload(path)
        if not args.full_shapes:
            cfg = quick_shrink(cfg, 1)
        cfg = cfg.replace(xla_compiler_options=tuple(
            f"{k}={v}" for k, v in sorted(backend_options.items())))
        epoch = max(cfg.total_epochs - 1, 0)
        key = (cfg.use_second_order(epoch), cfg.use_msl(epoch))
        with numerics_policy(cfg.compute_dtype, deterministic=True,
                             options=cfg.xla_compiler_options_dict):
            init, apply = make_model(cfg)
            state = init_train_state(cfg, init, seed=0, device=device)
            batch = Episode(*(torch.from_numpy(a).to(device)
                              for a in synthetic_batch(cfg, 0)))
            step = make_train_step(cfg, apply)
            loss = None
            for _ in range(max(args.steps, 1)):
                state, m = step(state, batch, epoch, second_order=key[0],
                                use_msl=key[1])
                loss = float(m.loss)
        return key, _leaves(state), loss

    try:
        key_t, leaves_t, loss_t = run(args.config, options)
        key_b, leaves_b, loss_b = run(args.base_config, {})
    except Exception as e:  # noqa: BLE001 — a refused option or config
        # IS the verdict, not a tool crash.
        return emit({"pass": False, "mode": "fail",
                     "error": f"{type(e).__name__}: {e}"}, 2)
    if key_t != key_b:
        return emit({"pass": False, "mode": "fail",
                     "error": f"phase keys differ: {key_t} vs {key_b}"},
                    2)
    if sorted(leaves_t) != sorted(leaves_b):
        return emit({"pass": False, "mode": "fail",
                     "error": "state trees structurally incomparable"},
                    2)
    bitwise = True
    max_rel = 0.0
    for path in sorted(leaves_t):
        a, b = leaves_t[path], leaves_b[path]
        if a.shape != b.shape or a.dtype != b.dtype:
            return emit({"pass": False, "mode": "fail",
                         "error": f"leaf shape/dtype mismatch at "
                                  f"{path}"}, 2)
        if a.tobytes() != b.tobytes():
            bitwise = False
            af = a.astype(np.float64, copy=False)
            bf = b.astype(np.float64, copy=False)
            # Magnitude floor 1e-6: near-zero leaves (fresh Adam
            # moments) would otherwise turn a tiny absolute difference
            # into an unbounded relative one.
            denom = np.maximum(np.maximum(np.abs(af), np.abs(bf)), 1e-6)
            rel = np.max(np.abs(af - bf) / denom)
            if not np.isfinite(rel):
                return emit({"pass": False, "mode": "fail",
                             "error": "non-finite divergence"}, 2)
            max_rel = max(max_rel, float(rel))
    mode = ("bitwise" if bitwise
            else "tolerance" if max_rel <= args.tolerance else "fail")
    ok = mode != "fail"
    return emit({"pass": ok, "mode": mode, "bitwise": bitwise,
                 "max_rel_err": round(max_rel, 9),
                 "tolerance": args.tolerance,
                 "steps": args.steps,
                 "loss_tuned": loss_t, "loss_untuned": loss_b,
                 "compared_leaves": len(leaves_t),
                 "device": str(device)},
                0 if ok else 2)


if __name__ == "__main__":
    sys.exit(main())
