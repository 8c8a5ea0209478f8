"""``scripts/torch_tune_parity.py`` against the JAX package's
``scripts/tune_parity.py``, on the CPU: on the same pairs of a tiny
first-order config the two give the same mode and exit code.

* A ``remat_policy`` pair is ``bitwise`` (exit 0): a checkpoint policy
  recomputes the same operations.
* A ``bn_fast_math`` pair is ``fail`` at the default tolerance (5e-3)
  and at tolerance 0 (exit 2) in both packages: the fold changes the
  BN statistics' rounding, and Adam's first step turns the conv biases'
  rounding-noise gradients (zero in exact arithmetic under batch
  statistics, ROADMAP.md § Known reference conditions) into updates of
  order the meta-LR, a relative error near 1-2 on those leaves.
* A ``task_microbatches`` pair under layer norm (whose conv biases are
  live) is ``tolerance`` at the default tolerance (exit 0) in both, each
  with a divergence in (0, 1e-3], a fifth of the gate: accumulating two
  chunks changes only the sums' rounding. The packages start from their
  own random weights, so their divergences are held to one bound, not
  to each other (the port's reads 1.4e-4 to 3.9e-4 across 8 to 1 CPU
  threads, the JAX package's 4.4e-7).
* A branch test, not a parity check: the ``bn_fast_math`` pair at
  tolerance 2 (the bound of the relative error, which divides by the
  larger magnitude, so any divergence passes) is ``tolerance`` (exit 0)
  in both.

The ten runs start together (each ~15 s of JAX compiles alone)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(experiment_name="parity", dataset_name="synthetic",
            image_height=8, image_width=8, image_channels=3,
            num_classes_per_set=2, num_samples_per_class=1,
            num_target_samples=1, cnn_num_filters=4, num_stages=2,
            number_of_training_steps_per_iter=1,
            number_of_evaluation_steps_per_iter=1, batch_size=2,
            task_microbatches=1, second_order=False,
            use_multi_step_loss_optimization=False, total_epochs=1,
            compute_dtype="float32", bn_fast_math=False)
# name -> (the base's changes, the tuned config's on top of them).
PAIRS = {"remat": ({}, {"remat_policy": "nothing"}),
         "fast_math": ({}, {"bn_fast_math": True}),
         "ln_microbatch": ({"norm_layer": "layer_norm"},
                           {"task_microbatches": 2}),
         "bn_microbatch": ({}, {"task_microbatches": 2})}
# (pair, tolerance) -> (mode, exit code), in both packages.
CASES = {("remat", 5e-3): ("bitwise", 0), ("fast_math", 5e-3): ("fail", 2),
         ("fast_math", 0.0): ("fail", 2),
         ("fast_math", 2.0): ("tolerance", 0),
         ("ln_microbatch", 5e-3): ("tolerance", 0),
         ("bn_microbatch", 5e-3): ("tolerance", 0)}
# The bound on a ``tolerance`` pair's divergence where the gate's
# tolerance is the default (the branch test at 2.0 is not held to it).
DIVERGENCE_BOUND = 1e-3


@pytest.fixture(scope="module")
def verdicts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parity")
    for name, (base, extra) in PAIRS.items():
        (tmp / f"{name}_base.json").write_text(json.dumps({**BASE,
                                                           **base}))
        (tmp / f"{name}.json").write_text(json.dumps({**BASE, **base,
                                                      **extra}))
    env = dict(os.environ, MAML_JAX_PLATFORM="cpu", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    procs = {}
    for (name, tol) in CASES:
        common = ["--config", str(tmp / f"{name}.json"), "--base-config",
                  str(tmp / f"{name}_base.json"), "--tolerance", str(tol),
                  "--full-shapes"]
        for side, script, extra in (
                ("port", "torch_tune_parity.py", ["--device", "cpu"]),
                ("jax", "tune_parity.py", [])):
            procs[(name, tol, side)] = subprocess.Popen(
                [sys.executable, os.path.join(REPO, "scripts", script),
                 *common, *extra], cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for key, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            out[key] = (proc.returncode,
                        json.loads(stdout.strip().splitlines()[-1]), stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


@pytest.mark.parametrize("case", list(CASES), ids=str)
def test_parity_mode_equals_jax(verdicts, case):
    name, tol = case
    want_mode, want_rc = CASES[case]
    for side in ("port", "jax"):
        rc, doc, err = verdicts[(name, tol, side)]
        assert doc["metric"] == "tune_parity", (side, err[-2000:])
        assert (doc["mode"], rc) == (want_mode, want_rc), (side, doc)
        assert doc["pass"] is (want_rc == 0)
        assert doc["tolerance"] == tol and doc["steps"] == 2
    port, jax_ = (verdicts[(name, tol, s)][1] for s in ("port", "jax"))
    assert port["bitwise"] == jax_["bitwise"]
    assert port["loss_tuned"] == pytest.approx(port["loss_untuned"],
                                               rel=1e-5)
    if want_mode == "tolerance" and tol < 1.0:
        for doc in (port, jax_):
            assert 0.0 < doc["max_rel_err"] <= DIVERGENCE_BOUND, doc
