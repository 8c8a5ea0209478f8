"""``scripts/torch_autotune.py`` end to end on the CPU at a tiny size: a
sweep of one spec (``remat_policy`` 'nothing' x ``cudnn_deterministic``
'true' / an unknown value: the baseline, one config trial and one
unknown backend option) ends with the unknown option counted
``invalid_flag``, a ``TUNED.json`` verdict with its reason, and a driver
that imported neither jax nor torch; a second invocation on the same
``--out`` repeats no trial; the sweep's ``events.jsonl`` summarizes to
the same tune section in the port's telemetry report as in the JAX
package's."""

import json
import os
import subprocess
import sys

from howtotrainyourmamlpytorch_tpu.telemetry import report as jreport
from howtotrainyourmamlpytorch_tpu.utils import tracing as jtracing
from howtotrainyourmamlpytorch_tpu_torch.telemetry import report
from howtotrainyourmamlpytorch_tpu_torch.tune import record
from howtotrainyourmamlpytorch_tpu_torch.utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "experiment_config",
                        "mini-imagenet_maml++_5-way_5-shot_DA_b12.json")
TINY = {"total_epochs": 3, "first_order_to_second_order_epoch": 1,
        "multi_step_loss_num_epochs": 1,
        "number_of_training_steps_per_iter": 1,
        "number_of_evaluation_steps_per_iter": 1,
        "compute_dtype": "float32", "bn_fast_math": False}
SPEC = {"axes": [{"name": "remat_policy", "values": ["nothing"]},
                 {"name": "cudnn_deterministic", "kind": "xla",
                  "values": ["true", "fastest"]}]}


def _sweep(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=REPO)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_sweep_counts_the_unknown_option_and_resumes(tmp_path):
    with open(FLAGSHIP) as f:
        base = {**json.load(f), **TINY}
    (tmp_path / "base.json").write_text(json.dumps(base))
    cmd = [sys.executable, os.path.join(REPO, "scripts", "torch_autotune.py"),
           "--config", str(tmp_path / "base.json"),
           "--out", str(tmp_path / "sweep"), "--platform", "cpu", "--quick",
           "--steps", "2", "--trial-timeout", "300",
           "--accuracy-gate", "skip", "--space", str(tmp_path / "s.json")]
    (tmp_path / "s.json").write_text(json.dumps(SPEC))
    art = _sweep(cmd)
    assert art["metric"] == "autotune" and art["ok"]
    assert art["jax_free"] is True and art["torch_free"] is True
    assert (art["trials_total"], art["trials_run"],
            art["trials_resumed"]) == (3, 3, 0)
    assert art["failed_by_outcome"] == {"invalid_flag": 1}
    assert art["invalid_flag_failures"] == 1
    assert art["baseline_objective"] > 0
    tuned = json.load(open(art["tuned_path"]))
    assert tuned["schema"] == record.TUNED_SCHEMA
    assert isinstance(tuned["adopted"], bool) and tuned["reason"]
    if tuned["adopted"]:
        assert tuned["config_overrides"] == {"remat_policy": "nothing"}
        assert tuned["bitwise_resume"] is True
        assert art["gates"]["parity"]["mode"] == "bitwise"
        assert "SKIPPED" in tuned["reason"]
    again = _sweep(cmd)
    assert (again["trials_run"], again["trials_resumed"]) == (0, 3)
    assert again["trials_failed"] == 1
    assert again["adopted"] == art["adopted"]
    ours = report.summarize_events(tracing.read_jsonl(art["events"]))
    ref = jreport.summarize_events(jtracing.read_jsonl(art["events"]))
    assert ours["tune"] == ref["tune"]
    assert ours["tune"]["trials_run"] == 3
    assert ours["tune"]["invalid_flag_failures"] == 1
