"""The port's pod chaos harness (``scripts/torch_chaos_pod.py``) on the CPU.

Tier 1: the ``peer_kill`` phase alone — two gloo ranks of the trainer's
CLI at the tiny pod config, ``kill_peer`` on host 1 — must end with the
victim SIGKILLed, the survivor's exit 73 within the budget + slack, a
``peer_lost`` row and crash bundle naming host 1, and
``cluster/peer_losses`` 1 in ``metrics.prom``; the port's
``telemetry/report.py`` and the JAX package's
``scripts/telemetry_report.py`` must read the same cluster section from
that run. Each rank has a 120 s limit.

Slow: every phase with ``--quick --device cpu`` (peer_kill, restart with
the planted stale manifest, parity, elastic with its cold bitwise leg)
must read ``recovered``, as the JAX package's ``tests/test_pod_cluster.py``
reads ``scripts/chaos_pod.py``.
"""

import json
import os
import subprocess
import sys

import pytest

from helpers import gloo_multiprocess_quarantine

from howtotrainyourmamlpytorch_tpu_torch.telemetry.report import (
    summarize_events)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_chaos_pod.py")
RANK_TIMEOUT = "120"

pytestmark = gloo_multiprocess_quarantine


def _run(out, phases, timeout):
    env = {k: v for k, v in os.environ.items() if k != "MAML_FAULTS"}
    env.setdefault("OMP_NUM_THREADS", "1")
    proc = subprocess.run(
        [sys.executable, SCRIPT, "--quick", "--device", "cpu", "--out",
         str(out), "--phases", phases, "--timeout", RANK_TIMEOUT],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env)
    return proc, json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def peer_kill(tmp_path_factory):
    out = tmp_path_factory.mktemp("pod")
    proc, art = _run(out, "peer_kill", timeout=300)
    return proc, art, out


def test_survivor_exits_73_naming_the_killed_host(peer_kill):
    proc, art, _ = peer_kill
    assert proc.returncode == 0, (proc.stderr[-3000:],
                                  art.get("peer_kill_survivor_log_tail"))
    assert art["metric"] == "pod_chaos" and art["status"] == "recovered"
    assert art["peer_kill_victim_exit_code"] == -9
    assert art["peer_kill_survivor_exit_code"] == 73
    assert art["peer_kill_survivor_latency_s"] <= (
        art["cluster_collective_timeout_s"] + 60.0)
    assert art["peer_kill_suspect_hosts"] == [1]
    assert art["peer_kill_bundle_reason"] == "peer_lost"
    assert art["peer_kill_bundle_suspects"] == [1]
    assert {"crash.json", "flight.jsonl", "stacks.txt"} <= set(
        art["peer_kill_bundle_files"])
    assert art["peer_kill_prom_peer_losses"] == 1.0
    # Epoch 0 (iterations 1..4) committed; the kill at 6 is mid-epoch 1,
    # and the survivor stepped through it before its exit.
    assert (art["peer_kill_committed_epoch"],
            art["peer_kill_committed_iter"]) == (0, 4)
    assert art["peer_kill_kill_iter"] == 6
    assert art["peer_kill_survivor_steps"] == 6
    assert art["peer_kill_survivor_end"] == "exit 73"
    assert not art["peer_kill_victim_record"]


def test_both_reports_read_the_same_cluster_section(peer_kill):
    _, _, out = peer_kill
    run = os.path.join(str(out), "pod_chaos")
    report = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "telemetry_report.py"),
         run, "--json"], capture_output=True, text=True, timeout=120,
        cwd=REPO)
    assert report.returncode == 0, report.stderr
    ref = json.loads(report.stdout.strip().splitlines()[-1])
    with open(os.path.join(run, "logs", "events.jsonl")) as f:
        events = [json.loads(line) for line in f if line.strip()]
    ours = summarize_events(events)
    assert ours["cluster"] == ref["cluster"]
    assert ours["cluster"]["peer_losses"] == 1
    assert ours["cluster"]["last_suspect_host"] == 1
    lost = [e for e in events if e["event"] == "peer_lost"]
    assert len(lost) == 1 and lost[0]["suspect_hosts"] == [1]
    assert lost[0]["peer_verdicts"]["1"] in ("stalled", "dead")
    beats = [e for e in events if e["event"] == "heartbeat"]
    assert beats and all(set(b["peer_lease_age_seconds"]) == {"0", "1"}
                         for b in beats)


@pytest.mark.slow
def test_quick_pod_chaos_recovers(tmp_path):
    proc, art = _run(tmp_path, "peer_kill,restart,parity,elastic",
                     timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert art["status"] == "recovered"
    assert art["restart_resumed_lines"] == [
        ["resumed from checkpoint 'latest' at iter 4"]] * 2
    assert art["restart_committed_crc_unchanged"]
    assert art["restart_consensus_rows"] == [[0, 1]]
    assert art["restart_consensus_final_crc_equal"]
    assert art["parity_weights_equal"] and art["parity_weights_equal_elastic"]
    assert art["elastic_survivor_exit_codes"] == [0, 0]
    assert art["elastic_roster"] == [1, 2]
    assert art["elastic_report_elastic"]["reshards"] == 1
    assert art["elastic_bitwise_equal_cold"]


def _session_members(sid):
    """Live processes in the process group ``sid`` (read from /proc)."""
    found = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat[stat.rfind(")") + 2:].split()
        if fields[0] != "Z" and int(fields[2]) == sid:
            found.append(int(name))
    return found


def test_sigterm_to_the_harness_reaps_its_ranks(tmp_path):
    """A harness leg sent SIGTERM (a caller's time limit) ends its ranks
    before it exits: nothing of its process group is left alive."""
    import glob
    import signal
    import time
    env = {k: v for k, v in os.environ.items() if k != "MAML_FAULTS"}
    env.setdefault("OMP_NUM_THREADS", "1")
    out = tmp_path / "pod"
    proc = subprocess.Popen(
        [sys.executable, SCRIPT, "--quick", "--device", "cpu", "--out",
         str(out), "--phases", "peer_kill", "--timeout", RANK_TIMEOUT],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL, start_new_session=True)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and (
                len(glob.glob(str(out / "*.log"))) < 2
                or len(_session_members(proc.pid)) < 3):
            assert proc.poll() is None, "the harness ended before its ranks"
            time.sleep(0.1)
        ranks = [p for p in _session_members(proc.pid) if p != proc.pid]
        assert len(ranks) >= 2
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 128 + signal.SIGTERM
        assert _session_members(proc.pid) == []
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()


def test_reaper_terminates_and_waits_on_what_it_tracks():
    from howtotrainyourmamlpytorch_tpu_torch.utils import reaper
    child = reaper.track(subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(60)"]))
    done = reaper.track(subprocess.Popen([sys.executable, "-c", "pass"]))
    done.wait(timeout=30)
    assert reaper.reap(grace_s=5.0) == 1
    assert child.returncode is not None and child.returncode != 0
    assert reaper.reap() == 0


# A SIGTERM that lands between a child's fork and its tracking: the
# process it started must still be reaped (the harness's exit hook).
_SPAWN_UNDER_SIGTERM = r"""
import os, signal, subprocess, sys
from howtotrainyourmamlpytorch_tpu_torch.utils import reaper
reaper.install()
real = subprocess.Popen

class Popen(real):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        with open(sys.argv[1], "w") as f:
            f.write(str(self.pid))
        os.kill(os.getpid(), signal.SIGTERM)   # before spawn() tracks it

subprocess.Popen = Popen
reaper.spawn([sys.executable, "-c", "import time; time.sleep(60)"])
print("not reached")
"""


def test_sigterm_inside_spawn_is_held_until_the_child_is_tracked(tmp_path):
    import signal
    pid_file = tmp_path / "pid"
    res = subprocess.run(
        [sys.executable, "-c", _SPAWN_UNDER_SIGTERM, str(pid_file)],
        capture_output=True, text=True, timeout=60, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 128 + signal.SIGTERM, res.stderr
    assert "not reached" not in res.stdout
    pid = int(pid_file.read_text())
    assert not os.path.exists(f"/proc/{pid}") or open(
        f"/proc/{pid}/stat").read().split(") ")[1][0] == "Z"
