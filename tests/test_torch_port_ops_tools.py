"""The port's operator tools against the JAX package's on one events
directory: ``scripts/torch_ops_console.py``, ``torch_slo_report.py`` and
``torch_trace_export.py`` give the artifacts of ``ops_console.py``,
``slo_report.py`` and ``trace_export.py`` (path fields and lease ages
aside), with the same exit codes on the usage and error paths, and run
with ``jax`` and the JAX package blocked.

The directory is written with the port's own telemetry at a tiny size:
registry flush rows (a counter that resets), alert transitions through
the port's ``AlertEvaluator`` (one resolved, one still firing) with its
``ALERTS.json`` snapshot, request traces through the port's reqtrace
ring, a membership lease, a rollout record, heartbeats, an epoch row
and a flight ring. The JAX scripts are jax-free at run time; both
render the same files.
"""

import json
import os
import subprocess
import sys

import pytest

from howtotrainyourmamlpytorch_tpu_torch.serve.fleet.router import (
    ReplicaLease)
from howtotrainyourmamlpytorch_tpu_torch.telemetry import alerts, reqtrace
from howtotrainyourmamlpytorch_tpu_torch.telemetry.registry import (
    MetricsRegistry)
from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import JsonlLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("ops_console", "slo_report", "trace_export")
# Where each tool's artifact names a path of the run (or a lease's age,
# which moves between two renders).
PATH_FIELDS = {"ops_console": ("fleet_dir",), "slo_report": (),
               "trace_export": ("out",)}
BLOCK = ("import runpy, sys\n"
         "for name in ('jax', 'jaxlib', 'howtotrainyourmamlpytorch_tpu'):\n"
         "    sys.modules[name] = None\n"
         "sys.argv = [sys.argv[1]] + sys.argv[2:]\n"
         "runpy.run_path(sys.argv[0], run_name='__main__')\n")


def _flight_rows(t0=1000.0):
    rows = [{"t": float(i), "ts": t0 + i, "kind": "phase", "phase": p,
             "detail": d}
            for i, (p, d) in enumerate([("feed", "train"), ("step", 0),
                                        ("serve_request", 3),
                                        ("step", 1)])]
    rows.append({"t": 4.0, "ts": t0 + 4, "kind": "fault",
                 "fault": "nan_loss", "step": 1})
    return rows


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("ops")
    logs = out / "logs"
    jl = JsonlLogger(str(logs / "events.jsonl"))
    jl.log("heartbeat", epoch=0, iter=4,
           host_mean_step_seconds=[0.1, 0.2], skew_frac=0.5, hosts=2)
    jl.log("train_epoch", epoch=0, epoch_seconds=2.5)
    jl.log("checkpoint", epoch=0, iter=4)
    # Registry rows: a counter that resets between flushes (a restarted
    # process) and the fleet gauges the console reads.
    for restarts, shed in ((2.0, 1.0), (1.0, 4.0)):
        reg = MetricsRegistry()
        reg.counter("fleet/restarts").inc(restarts)
        reg.counter("serve/shed_total").inc(shed)
        reg.gauge("fleet/canary_weight").set(0.25)
        reg.gauge("fleet/slo_burn_rate").set(0.5)
        reg.flush_jsonl(jl, replica="supervisor")
    # Alerts: one rule fires and resolves, one fires and stays.
    ev = alerts.AlertEvaluator(alerts.parse_rules({"rules": [
        {"name": "replica_restarts", "type": "rate",
         "metric": "fleet/restarts", "op": ">", "value": 0, "for_s": 0,
         "severity": "warn"},
        {"name": "shed_high", "type": "threshold",
         "metric": "serve/shed_total", "op": ">", "value": 2, "for_s": 0,
         "severity": "critical"}]}), source="supervisor",
        snapshot_path=str(out / "ALERTS_sup.json"))
    for t, restarts, shed in ((0.0, 0.0, 0.0), (1.0, 1.0, 3.0),
                              (2.0, 1.0, 3.0)):
        ev.evaluate(t, snapshot={"fleet/restarts": restarts,
                                 "serve/shed_total": shed}, jsonl=jl)
    with open(logs / "flight.jsonl", "w") as f:
        for row in _flight_rows():
            f.write(json.dumps(row) + "\n")
    # Request traces: a traced replica's spans and the frontend's roots.
    ring = reqtrace.SpanRing(capacity=256)
    prev = reqtrace.install(ring)
    try:
        for i in range(6):
            ctx = reqtrace.mint(f"tenant{i % 2}", i, 1.0)
            t0 = 100.0 + i
            reqtrace.record_span(ctx, reqtrace.SPAN_ROUTE, t0, 0.001)
            reqtrace.record_span(ctx, reqtrace.SPAN_BATCH_WAIT, t0 + 0.001,
                                 0.01 * (i + 1))
            reqtrace.record_span(ctx, reqtrace.SPAN_ADAPT, t0 + 0.05,
                                 0.02 * (i + 1), batched=2)
            reqtrace.record_span(ctx, reqtrace.SPAN_PREDICT, t0 + 0.2,
                                 0.005)
            reqtrace.record_root(ctx, t0, 0.05 * (i + 1) + 0.3,
                                 replica=i % 2)
        ring.flush(JsonlLogger(str(out / "events_replica_0.jsonl")),
                   phase="fleet_replica", replica=0)
    finally:
        reqtrace.install(prev)
    fleet = out / "fleet"
    fleet.mkdir()
    assert ReplicaLease(str(fleet), 0, 0.0).touch(payload={
        "port": 7001, "pid": 1234, "version": 2,
        "stats": {"queue_depth": 1, "p95_ms": 12.5},
        "alerts_firing": {"count": 1, "max_severity": "critical"}},
        force=True)
    (fleet / "ROLLOUT.json").write_text(json.dumps(
        {"state": "rolling", "stage": 1, "version": 2}))
    return out


def _run(tool, args, port):
    script = os.path.join(REPO, "scripts",
                          f"torch_{tool}.py" if port else f"{tool}.py")
    proc = subprocess.run([sys.executable, "-c", BLOCK, script, *args],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    lines = [ln for ln in proc.stdout.strip().splitlines() if ln]
    try:
        art = json.loads(lines[-1]) if lines else {}
    except ValueError:
        art = {}
    return proc, art


def _comparable(tool, art):
    art = {k: v for k, v in art.items() if k not in PATH_FIELDS[tool]}
    for rep in art.get("replicas") or []:
        rep.pop("age_s", None)
    return art


# The console's lease verdict follows the lease's age; these bounds keep
# it "live" however long the module takes, so two renders agree.
LEASE_AGES = ["--stalled-s", "1e9", "--dead-s", "1e9"]


def _args(tool, run_dir, tmp_path, port):
    if tool == "trace_export":
        return [str(run_dir / "logs"), "--out",
                str(tmp_path / ("port" if port else "jax") / "trace.json")]
    if tool == "ops_console":
        return [str(run_dir)] + LEASE_AGES
    return [str(run_dir)]


@pytest.mark.parametrize("tool", TOOLS)
def test_port_tool_gives_the_jax_artifact(tool, run_dir, tmp_path):
    """The port's tool, with jax and the JAX package blocked, gives the
    JAX script's artifact on the same files."""
    arts = {}
    for port in (False, True):
        proc, art = _run(tool, _args(tool, run_dir, tmp_path, port), port)
        assert proc.returncode == 0, (port, proc.stderr[-2000:])
        arts[port] = art
    assert arts[True]["metric"] == tool
    assert _comparable(tool, arts[True]) == _comparable(tool, arts[False])


def test_what_the_renders_hold(run_dir, tmp_path):
    """The events directory exercises each tool's content: the console's
    lease, rollout, reset-aware totals and the still-firing alert; the
    report's six traces of two tenants; the export's spans and hosts."""
    _, con = _run("ops_console", [str(run_dir), "--json"] + LEASE_AGES,
                  True)
    assert con["replicas_live"] == 1 and con["rollout_state"] == "rolling"
    assert con["counters"]["fleet/restarts"] == 3.0
    assert con["alerts_firing"] == 1
    assert con["alerts"][0]["rule"] == "shed_high"
    _, slo = _run("slo_report", [str(run_dir), "--json"], True)
    assert slo["traces"] == 6 and slo["linked"] == 6
    assert set(slo["tenants"]) == {"tenant0", "tenant1"}
    _, tr = _run("trace_export", [str(run_dir / "logs"), "--out",
                                  str(tmp_path / "t.json")], True)
    assert tr["hosts"] == 2 and tr["flight_rows"] == 5
    assert json.load(open(tr["out"]))["traceEvents"]


@pytest.mark.parametrize("tool,args,code", [
    ("ops_console", ["{empty}", "--json"], 1),
    ("ops_console", ["{empty}", "--watch", "-1"], 2),
    ("slo_report", ["{empty}"], 1),
    ("slo_report", ["{untraced}"], 1),
    ("slo_report", ["{untraced}", "--slo-target-frac", "1.0"], 2),
    ("trace_export", ["{empty}/nothing"], 1),
])
def test_usage_and_error_paths_match(tool, args, code, tmp_path):
    """Bad knobs and empty input: the JAX script's exit code and an
    ``error`` line, from both."""
    empty = tmp_path / "empty"
    empty.mkdir()
    untraced = tmp_path / "untraced"
    untraced.mkdir()
    (untraced / "events.jsonl").write_text(
        json.dumps({"event": "epoch", "ts": 1.0}) + "\n")
    args = [a.format(empty=empty, untraced=untraced) for a in args]
    for port in (False, True):
        proc, art = _run(tool, args, port)
        assert proc.returncode == code, (port, proc.stderr[-1000:])
        assert "error" in art, port
