"""bf16-vs-f32 drift of the PyTorch/CUDA port's shipped train step at the
flagship geometry on the card (the port's counterpart of
``scripts/bf16_drift.py``).

The port's parity tests run on the CPU in f32, so what they cannot see
is what the shipped step (``compute_dtype=bfloat16`` + ``bn_fast_math``,
cuDNN's bf16 convolutions and the hand-written BN kernel) does to logits,
meta-gradients and a training trajectory at the real 84x84x3 /
48-filter / K=5 geometry. This script measures that against the f32
path (``compute_dtype=float32``, ``bn_fast_math=False``, TF32 off), with
the parameters in f32 in both variants, both from the same port init
(seed 0), at ``task_microbatches=1`` on one device.

    python scripts/torch_bf16_drift.py [--steps 50] [--batch 12] \\
        [--config <json>] [--quick --device cpu]

Four JSON lines, in the JAX script's order and with its keys, each also
carrying ``bn_launches`` (the BN kernel's launches for the probe) and
``device_kind``:

1. ``eval_logits``: adapted eval logits at the shared init: max / mean
   abs diff, the mean abs logit, argmax agreement over B*N*T
   predictions;
2. ``one_step``: one steady-state train step: both losses and the
   per-group relative L2 drift of the post-update parameters (groups
   ``params.<layer>.<leaf>`` and ``lslr.<layer>.<leaf>``);
3. ``trajectory`` on the unlearnable ``noise`` stream and on the
   learnable ``separable`` stream (``--steps`` steps each): loss gaps,
   final drift, end-state eval accuracy and argmax agreement on a
   held-out batch.

Dead parameter groups drift by construction and are reported, not
bounded by the callers: conv biases under batch-statistics BN (their
meta-gradient is zero in exact arithmetic) and the zero-init betas.
On the card both variants run the hand-written BN kernel; ``--device
cpu`` runs its plain version.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from howtotrainyourmamlpytorch_tpu_torch.device import resolve_device  # noqa: E402
from howtotrainyourmamlpytorch_tpu_torch.tune import points, trial  # noqa: E402


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    denom = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / (denom or 1.0))


def group_drift(tree_a, tree_b, prefix: str = "") -> dict:
    """``{"<key>.<key>...": rel_l2}`` over the leaves of two nested
    dicts (two levels give ``"<layer>.<leaf>"``, as the JAX script)."""
    out = {}
    for name in tree_a:
        key = f"{prefix}{name}"
        if isinstance(tree_a[name], dict):
            out.update(group_drift(tree_a[name], tree_b[name], f"{key}."))
        else:
            out[key] = rel_l2(_host(tree_a[name]), _host(tree_b[name]))
    return out


def _host(x):
    return x.detach().float().cpu().numpy() if hasattr(x, "detach") else x


def separable_batch(cfg, seed: int):
    """Learnable episodes (class i pixels ~ N(i/N, 0.3)): both variants
    can converge, so end-state prediction agreement measures accuracy
    parity rather than chaos on unlearnable noise."""
    from howtotrainyourmamlpytorch_tpu_torch.meta.inner import Episode
    rng = np.random.RandomState(seed)
    n, k, t, b = (cfg.num_classes_per_set, cfg.num_samples_per_class,
                  cfg.num_target_samples, cfg.batch_size)
    h, w, c = cfg.image_shape

    def gen(per):
        means = (np.arange(n) / n)[None, :, None, None, None, None]
        x = rng.randn(b, n, per, h, w, c) * 0.3 + means
        x = (np.clip(x, 0, 1) * 255).astype(np.uint8)
        y = np.tile(np.repeat(np.arange(n), per)[None], (b, 1))
        return x.reshape(b, n * per, h, w, c), y.astype(np.int32)

    sx, sy = gen(k)
    tx, ty = gen(t)
    return Episode(sx, sy, tx, ty)


def configs(config_path: str, batch: int = 0, quick: bool = False,
            device=None):
    """(shipped, f32) configs: one device, ``task_microbatches=1`` (a
    memory lever, not numerics), the f32 variant with
    ``bn_fast_math=False``."""
    cfg = trial.load_workload(config_path, 1)
    if batch:
        cfg = cfg.replace(batch_size=batch)
    cfg = cfg.replace(task_microbatches=1, mesh_shape=(1, 1))
    if device is not None:
        cfg = points.on_device(cfg, device, quick)
    cfg = cfg.replace(task_microbatches=1)
    return cfg, cfg.replace(compute_dtype="float32", bn_fast_math=False)


class Variant:
    """One dtype variant's state and steps on ``device``."""

    def __init__(self, cfg, device):
        from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
            make_eval_step, make_train_step)
        from howtotrainyourmamlpytorch_tpu_torch.models import make_model
        self.cfg, self.device = cfg, device
        self.init, apply = make_model(cfg)
        self.train = make_train_step(cfg, apply)
        self.eval = make_eval_step(cfg, apply)
        self.reset()

    def reset(self) -> None:
        from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
            init_train_state)
        self.state = init_train_state(self.cfg, self.init, seed=0,
                                      device=self.device)

    def step(self, ep, epoch: int, so: bool, msl: bool):
        self.state, m = self.train(self.state, self.batch(ep), epoch,
                                   second_order=so, use_msl=msl)
        return m

    def logits(self, ep) -> np.ndarray:
        return np.asarray(_host(self.eval(self.state, self.batch(ep))
                                .target_logits), np.float64)

    def batch(self, ep):
        import torch

        from howtotrainyourmamlpytorch_tpu_torch.meta.inner import Episode
        return Episode(*(torch.from_numpy(np.asarray(a)).to(self.device)
                         for a in ep))

    def groups(self) -> dict:
        return {"params": self.state.params, "lslr": self.state.lslr}


def probes(cfg_b, cfg_f, device, steps: int):
    """Yield the four probe rows (before their launch and device keys)."""
    steady = max(cfg_b.total_epochs - 1, 0)
    so, msl = cfg_b.use_second_order(steady), cfg_b.use_msl(steady)
    vb, vf = Variant(cfg_b, device), Variant(cfg_f, device)

    # 1. Eval-path adapted logits at the shared init.
    ep = trial.synthetic_batch(cfg_b, 123)
    lb, lf = vb.logits(ep), vf.logits(ep)
    yield {
        "probe": "eval_logits", "workload": cfg_b.experiment_name,
        "batch": cfg_b.batch_size,
        "max_abs_diff": round(float(np.abs(lb - lf).max()), 5),
        "mean_abs_diff": round(float(np.abs(lb - lf).mean()), 6),
        "logit_scale_mean_abs": round(float(np.abs(lf).mean()), 4),
        "argmax_agreement": float((lb.argmax(-1) == lf.argmax(-1)).mean()),
        "n_predictions": int(lb.shape[0] * lb.shape[1]),
    }

    # 2. One steady-state train step from the shared init.
    mb_, mf_ = vb.step(ep, steady, so, msl), vf.step(ep, steady, so, msl)
    drift = group_drift(vb.groups(), vf.groups())
    yield {
        "probe": "one_step", "second_order": so, "use_msl": msl,
        "loss_bf16": round(float(mb_.loss), 6),
        "loss_f32": round(float(mf_.loss), 6),
        "post_update_param_rel_l2_max": round(max(drift.values()), 6),
        "post_update_param_rel_l2": {k: round(v, 6)
                                     for k, v in sorted(drift.items())},
    }

    # 3. Trajectories from the shared init on the same stream: the noise
    # stream is the worst case (unlearnable, so trajectories amplify the
    # per-step drift chaotically, as between any two f32 backends), the
    # separable stream the accuracy question (do converged end states
    # agree where it matters?).
    for stream, make_batch in (("noise", trial.synthetic_batch),
                               ("separable", separable_batch)):
        losses_b, losses_f, acc_b, acc_f = [], [], [], []
        vb.reset()
        vf.reset()
        for t in range(steps):
            ep_t = make_batch(cfg_b, 1000 + t)
            m_b, m_f = (vb.step(ep_t, steady, so, msl),
                        vf.step(ep_t, steady, so, msl))
            losses_b.append(float(m_b.loss))
            losses_f.append(float(m_f.loss))
            acc_b.append(float(m_b.accuracy))
            acc_f.append(float(m_f.accuracy))
        gaps = np.abs(np.asarray(losses_b) - np.asarray(losses_f))
        drift_end = group_drift(vb.groups(), vf.groups())
        # End-state eval on a held-out batch of the same stream.
        ep_h = make_batch(cfg_b, 99)
        lb2, lf2 = vb.logits(ep_h), vf.logits(ep_h)
        labels = np.asarray(ep_h.target_y)
        yield {
            "probe": "trajectory", "stream": stream, "steps": steps,
            "loss_gap_max": round(float(gaps.max()), 5),
            "loss_gap_final": round(float(gaps[-1]), 5),
            "loss_final_bf16": round(losses_b[-1], 5),
            "loss_final_f32": round(losses_f[-1], 5),
            "train_acc_final_bf16": round(acc_b[-1], 4),
            "train_acc_final_f32": round(acc_f[-1], 4),
            "final_param_rel_l2_max": round(max(drift_end.values()), 5),
            "final_param_rel_l2_median": round(
                float(np.median(list(drift_end.values()))), 5),
            "final_param_rel_l2": {k: round(v, 5)
                                   for k, v in sorted(drift_end.items())},
            "end_state_argmax_agreement": round(
                float((lb2.argmax(-1) == lf2.argmax(-1)).mean()), 4),
            "end_state_eval_acc_bf16": round(
                float((lb2.argmax(-1) == labels).mean()), 4),
            "end_state_eval_acc_f32": round(
                float((lf2.argmax(-1) == labels).mean()), 4),
        }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=0,
                    help="tasks per step (default: the config's per-chip "
                         "batch)")
    ap.add_argument("--config", default=points.FLAGSHIP_JSON)
    ap.add_argument("--quick", action="store_true",
                    help="tiny shapes (trial.quick_shrink): CPU runs")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU (default: the card)")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be at least 1")
    device = resolve_device(args.device)
    from howtotrainyourmamlpytorch_tpu_torch.device import numerics_policy
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import profiler
    cfg_b, cfg_f = configs(args.config, args.batch, args.quick, device)
    kind = profiler.device_kind(device)
    # TF32 off: the f32 variant is the reference path.
    with numerics_policy("float32", deterministic=True):
        before = bn_act.launches
        for row in probes(cfg_b, cfg_f, device, args.steps):
            launches, before = bn_act.launches - before, bn_act.launches
            if (device.type == "cuda" and cfg_b.norm_layer == "batch_norm"
                    and launches == 0):
                raise RuntimeError(f"probe {row['probe']} launched the BN "
                                   f"kernel no time")
            print(json.dumps({**row, "bn_launches": launches,
                              "device_kind": kind}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
