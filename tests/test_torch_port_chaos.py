"""The port's chaos harness on the CPU, read by the JAX package's report.

``scripts/torch_chaos_run.py --quick --device cpu`` (the tiny config, every
phase: baseline, faulted ``io_write@1;nan_loss@5;kill@6``, restart,
ckpt_kill, hang, and peer_kill through ``scripts/torch_chaos_pod.py``)
must end ``"status": "recovered"`` with ``warm_restart`` reported skipped
on the CPU with its reason (CUDA graphs need the card; ``chip_smoke.py``
phase 14 runs the leg on the card), the peer_kill leg's survivor exiting
73 naming host 1,
and its hang phase's
run — ended by the watchdog, then restarted — must read in the JAX
package's ``scripts/telemetry_report.py`` with a watchdog section of one
trip. The restarts are held bitwise to the baseline by the script itself
(its ``*_differing_leaves`` keys).
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def chaos(tmp_path_factory):
    out = tmp_path_factory.mktemp("chaos")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_chaos_run.py"),
         "--quick", "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env={k: v for k, v in os.environ.items() if k != "MAML_FAULTS"})
    lines = proc.stdout.strip().splitlines()
    return proc, json.loads(lines[-1]), lines, out


def test_quick_chaos_run_recovers(chaos):
    proc, art, lines, _ = chaos
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert art["metric"] == "chaos_recovery" and art["status"] == "recovered"
    assert art["preempted_at_iter"] == 6 and art["rewinds"] == 1
    assert art["io_retries"] == 1 and art["faults_injected"] == 3
    assert art["grad_norm_warn_before_rewind"]
    assert art["ckpt_kill_exit_code"] == 137
    assert art["ckpt_kill_committed_iter"] == art[
        "ckpt_kill_restart_iter"] == 4
    assert (art["ckpt_kill_pending_after_restart"],
            art["ckpt_kill_tmp_after_restart"],
            art["ckpt_kill_quarantined"]) == (0, 0, 0)
    assert art["hang_exit_code"] == 74 and art["hang_reason"] == "hung_feed"
    assert art["hang_watchdog_trips"] == 1
    assert art["ckpt_kill_restart_differing_leaves"] == []
    assert art["hang_restart_differing_leaves"] == []
    skipped = [json.loads(line) for line in lines
               if '"status": "skipped"' in line]
    assert {s["phase"] for s in skipped} == {"warm_restart"}
    assert art["peer_kill_skipped"] is None and art["peer_kill_recovered"]
    assert art["peer_kill_survivor_exit_code"] == 73
    assert art["peer_kill_suspect_hosts"] == [1]
    assert art["peer_kill_consensus_ok"]
    assert "CUDA graphs need the card" in art["warm_restart_skipped"]
    assert art["warm_restart_ok"] is None
    for key in ("warm_restart_compiles_before_first_step",
                "warm_restart_aot_hits", "warm_restart_aot_misses",
                "warm_restart_time_to_first_step_s"):
        assert key in art and art[key] is None


def test_jax_report_reads_the_watchdog_killed_run(chaos):
    _, _, _, out = chaos
    report = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "telemetry_report.py"),
         os.path.join(str(out), "chaos_hang"), "--json"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert report.returncode == 0, report.stderr
    summary = json.loads(report.stdout.strip().splitlines()[-1])
    assert summary["watchdog"]["trips"] == 1
    assert summary["watchdog"]["last_phase"] in ("feed", "step")
    assert summary["epochs"] >= 2
