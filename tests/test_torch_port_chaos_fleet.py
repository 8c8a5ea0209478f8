"""``scripts/torch_chaos_fleet.py --quick --device cpu`` on the CPU: two
port replica processes per phase over localhost sockets, the port's
supervisor, router and alert rules.

One quick run is shared by the module. Asserted in tier-1 (what the run
does, not how fast this box does it): the kill phase's SIGKILL, restart,
zero lost requests and restoration; the crash loop's breaker trip, the
FAILED slot and zero lost requests at N-1; the burst's sheds at
admission; every phase's alerts fired and resolved; the console showing
none firing; each phase's replica lifecycle and BN-kernel accounting (0
launches against 0 on the CPU); the artifact's keys against the JAX
script's. The burst's zero deadline misses and the whole verdict depend
on how steadily this box serves under the burst, so the slow test
asserts them on a run of its own. Replicas run one intra-op thread each
(``OMP_NUM_THREADS=1``): several processes share this box's cores.
Every harness refuses ``--device cuda`` without a card.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

from helpers import _can_bind_localhost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
CHAOS = os.path.join(SCRIPTS, "torch_chaos_fleet.py")
# What the port's artifact adds to the JAX script's keys.
PORT_KEYS = {"backend", "device", "config"}

needs_sockets = pytest.mark.skipif(
    not _can_bind_localhost(),
    reason="chaos phases drive real replicas over localhost sockets")


def _run_chaos(out):
    proc = subprocess.run(
        [sys.executable, CHAOS, "--quick", "--device", "cpu", "--out",
         str(out)], cwd=REPO, capture_output=True, text=True, timeout=420,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert lines, f"no artifact line\n{proc.stderr[-3000:]}"
    return proc, json.loads(lines[-1])


@pytest.fixture(scope="module")
def chaos(tmp_path_factory):
    proc, art = _run_chaos(tmp_path_factory.mktemp("chaos") / "cf")
    assert art.get("status") != "skipped"
    assert "error" not in art, art.get("error")
    return art


def artifact_keys(path):
    """The keys ``main`` of a harness puts in its artifact on the
    success path: its ``artifact = {...}`` and ``artifact.update({...})``
    literals and ``artifact["key"] = ...`` stores, less the skip and
    error keys."""
    tree = ast.parse(open(path).read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = set()
    for node in ast.walk(main):
        dicts = []
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "artifact"
                        for t in node.targets)):
            dicts.append(node.value)
        elif (isinstance(node, ast.AnnAssign)
              and getattr(node.target, "id", None) == "artifact"):
            dicts.append(node.value)
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "update"
              and getattr(node.func.value, "id", None) == "artifact"):
            dicts += [a for a in node.args if isinstance(a, ast.Dict)]
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.ctx, ast.Store)
              and getattr(node.value, "id", None) == "artifact"
              and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
        for d in dicts:
            keys |= {k.value for k in d.keys if isinstance(k, ast.Constant)}
    return keys - {"skip_reason", "error"}


@needs_sockets
def test_kill_phase_restarts_with_zero_lost_requests(chaos):
    kill = chaos["phases"]["kill"]
    assert kill["ok"], kill
    assert kill["restarts"] >= 1 and kill["restored"]
    assert kill["stats"]["dropped"] == 0
    assert kill["stats"]["responses_ok"] == 48
    assert kill["restore_seconds"] is not None
    assert {"replica_restarts", "replica_lease_stale"} <= set(
        kill["alerts"]["fired_kinds"])
    assert kill["alerts"]["resolved_all"]
    # The victim's slot ran twice: SIGKILLed, then restarted and booted.
    runs = kill["lifecycle"][str(kill["victim_slot"])]
    assert runs[0]["pid"] == kill["victim_pid"] and runs[0]["exit_code"] == -9
    assert len(runs) == 2 and runs[1]["boot_seconds"] is not None
    # Both replicas asked at the end, the restarted one included.
    assert sorted(kill["kernels"]["replicas"]) == ["0", "1"]
    assert kill["kernels"]["ok"] and kill["kernels"]["total"] == 0


@needs_sockets
def test_crash_loop_trips_the_breaker_and_serves_at_n_minus_1(chaos):
    crash = chaos["phases"]["crash_loop"]
    assert crash["ok"], crash
    assert crash["crash_loops"] >= 1 and crash["slot_failed"]
    assert crash["served_at"] == 1
    assert crash["stats"]["dropped"] == 0
    assert "replica_crash_loop" in crash["alerts"]["fired_kinds"]
    assert crash["alerts"]["resolved_all"]
    # The poisoned slot never announced: every run exited on boot.
    poisoned = crash["lifecycle"][str(crash["poisoned_slot"])]
    assert len(poisoned) >= 2
    assert all(r["boot_seconds"] is None and r["exit_code"] == 1
               for r in poisoned)


@needs_sockets
def test_burst_sheds_at_admission(chaos):
    burst = chaos["phases"]["burst"]
    assert burst["shed"] > 0 and burst["replica_sheds"] >= burst["shed"]
    stats = burst["stats"]
    assert (stats["responses_ok"] + stats["shed"]
            + stats["status_counts"].get("failed", 0)
            == burst["burst_requests"] >= 240)
    assert burst["alerts"]["fired_kinds"] == ["admission_shedding"]
    assert burst["alerts"]["resolved_all"]
    assert burst["kernels"]["ok"]


@needs_sockets
def test_rollup_keys_and_console(chaos):
    for key in ("fleet_restarts", "fleet_crash_loops",
                "fleet_failover_count", "fleet_shed_count"):
        assert chaos[key] is not None, key
    assert chaos["alerts_resolved"] and chaos["alerts_active_final"] == 0
    assert {"replica_restarts", "replica_lease_stale", "replica_crash_loop",
            "admission_shedding"} <= set(chaos["alert_fired_kinds"])
    assert chaos["console"]["exit_code"] == 0
    assert chaos["console"]["alerts_firing"] == 0


@needs_sockets
def test_artifact_keys_are_the_jax_scripts(chaos):
    want = artifact_keys(os.path.join(SCRIPTS, "chaos_fleet.py"))
    assert {"fleet_restarts", "alert_fired_kinds", "console"} <= want
    assert set(chaos) == want | PORT_KEYS


@pytest.mark.slow
@needs_sockets
def test_quick_chaos_verdict(tmp_path):
    """The whole verdict of a quick run: three phases ok, the burst's
    admitted requests all inside their deadline."""
    proc, art = _run_chaos(tmp_path / "cf")
    assert art["status"] == "ok", art
    assert proc.returncode == 0
    assert art["value"] == 3 and art["recovered"]
    assert art["phases"]["burst"]["deadline_misses"] == 0


@pytest.mark.parametrize("script", ["torch_chaos_fleet.py",
                                    "torch_traffic_replay.py",
                                    "torch_serve_bench.py",
                                    "torch_fleet_bench.py"])
def test_harnesses_refuse_cuda_without_a_card(script, tmp_path):
    """No CPU fallback: ``--device cuda`` (the default) on a box without
    a card exits non-zero with a message and spawns nothing."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "out"
    args = [] if script == "torch_serve_bench.py" else ["--out", str(out)]
    proc = subprocess.run([sys.executable, os.path.join(SCRIPTS, script),
                           "--quick", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert not out.exists()
