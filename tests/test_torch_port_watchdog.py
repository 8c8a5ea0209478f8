"""The port's watchdog, flight recorder and fault plan against the JAX
package's, on the same inputs, on the CPU.

* ``FaultPlan.parse(spec).maybe_fire`` over a fixed call order (step-keyed
  and call-counted kinds, ``:count`` windows, repeats): the same answers
  and the same ``fired`` record; the config's spec validation rejects
  what the JAX package's rejects.
* ``Watchdog.check`` on synthetic instants for every phase (disabled and
  bookkeeping phases included), and the auto poll interval: equal.
* The flight ring's order and bound, the crash bundle's file names and
  ``crash.json`` keys, and the bundle's ``trace.json`` (byte-equal to
  the JAX package's for the same ring): equal.
* A real-thread trip with ``on_trip``; ``hang_collective`` and
  ``kill_peer`` raise ``NotImplementedError`` naming the parallel/mesh
  slice; the kernel's first-use ``nvcc`` build runs under ``compile``,
  so a build longer than a tight step deadline does not trip.

Exact equality throughout: these are integer and string decisions.
"""

import json
import os
import subprocess
import time

import pytest

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.resilience import faults as jfaults
from howtotrainyourmamlpytorch_tpu.resilience import flightrec as jflightrec
from howtotrainyourmamlpytorch_tpu.resilience import watchdog as jwatchdog
from howtotrainyourmamlpytorch_tpu.telemetry import trace as jtrace
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentBuilder
from howtotrainyourmamlpytorch_tpu_torch.ops import build
from howtotrainyourmamlpytorch_tpu_torch.resilience import (EXIT_HUNG,
                                                            faults,
                                                            flightrec,
                                                            watchdog)
from howtotrainyourmamlpytorch_tpu_torch.telemetry import (MetricsRegistry,
                                                           trace)
from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import (JsonlLogger,
                                                               read_jsonl)

SPECS = ["io_write@1", "io_write@2:3", "nan_loss@5;kill@6",
         "episode_corrupt@3:2,hang_feed@4", "io_read@1;io_read@3",
         "ckpt_corrupt@1:2;kill_in_ckpt_write@2", "hang_step@0:4",
         " nan_loss@5 ; ; kill@6 "]
# One call order over every ported kind: call-counted (step None) and
# step-keyed calls, repeats of a step (a fault fires once per step).
CALLS = ([("io_write", None)] * 5 + [("io_read", None)] * 4
         + [("ckpt_corrupt", None)] * 3 + [("kill_in_ckpt_write", None)] * 3
         + [(k, s) for s in (0, 3, 4, 5, 5, 6, 6, 7)
            for k in ("nan_loss", "kill", "episode_corrupt", "hang_feed",
                      "hang_step")])


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_fires_like_jax(spec):
    ours, ref = faults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    assert ([(s.kind, s.at, s.count) for s in ours.specs]
            == [(s.kind, s.at, s.count) for s in ref.specs])
    got = [ours.maybe_fire(k, s) for k, s in CALLS]
    want = [ref.maybe_fire(k, s) for k, s in CALLS]
    assert got == want and any(want)
    assert ours.fired == ref.fired


@pytest.mark.parametrize("spec", ["bogus@1", "io_write", "io_write@x",
                                  "io_write@1:0", "io_write@-1",
                                  "nan_loss@1:y"])
def test_bad_specs_are_rejected_like_jax(spec):
    """By the plan and by the config, as the JAX package rejects them
    (an unknown kind passed the port's config before this slice)."""
    with pytest.raises(ValueError):
        jfaults.FaultPlan.parse(spec)
    with pytest.raises(ValueError):
        faults.FaultPlan.parse(spec)
    with pytest.raises(ValueError):
        JaxConfig(fault_spec=spec)
    with pytest.raises(ValueError):
        MAMLConfig(fault_spec=spec)


@pytest.mark.parametrize("kind", ["hang_collective", "kill_peer"])
def test_unported_kinds_raise_naming_the_mesh_slice(kind, tmp_path):
    """A plan naming a kind with no site on one card raises instead of
    parsing and never firing; the config still validates it, as the JAX
    package's does, and the builder refuses it."""
    spec = f"io_write@1;{kind}@3"
    assert MAMLConfig(fault_spec=spec).fault_spec == spec
    with pytest.raises(NotImplementedError, match="parallel/mesh slice"):
        faults.FaultPlan.parse(spec)
    with pytest.raises(NotImplementedError, match="parallel/mesh slice"):
        faults.configure(spec)
    assert faults.get_plan() is None
    with pytest.raises(NotImplementedError, match="parallel/mesh slice"):
        ExperimentBuilder(MAMLConfig(experiment_root=str(tmp_path),
                                     fault_spec=spec), device="cpu")


def test_maybe_fire_counts_and_records(monkeypatch):
    """A firing counts ``resilience/faults_injected`` and rings a
    ``fault`` event; with no plan installed every site answers False."""
    from howtotrainyourmamlpytorch_tpu_torch import resilience
    reg, rec = MetricsRegistry(), flightrec.FlightRecorder()
    prev_reg = resilience.set_registry(reg)
    prev_rec = flightrec.install(rec)
    try:
        faults.configure("nan_loss@2")
        assert not faults.maybe_fire("nan_loss", step=1)
        assert faults.maybe_fire("nan_loss", step=2)
        faults.configure("")
        assert not faults.active() and not faults.maybe_fire("nan_loss", 2)
    finally:
        resilience.set_registry(prev_reg)
        flightrec.install(prev_rec)
    assert reg.snapshot()["resilience/faults_injected"] == 1.0
    assert [(e["kind"], e["fault"], e["step"]) for e in rec.events()] == [
        ("fault", "nan_loss", 2)]


def test_hang_sleeps_for_the_env_override(monkeypatch):
    monkeypatch.setenv(faults.HANG_SECONDS_ENV, "0.3")
    t0 = time.monotonic()
    faults.hang()
    assert 0.3 <= time.monotonic() - t0 < 2.0
    assert faults.DEFAULT_HANG_SECONDS == jfaults.DEFAULT_HANG_SECONDS
    assert faults.HANG_SECONDS_ENV == jfaults.HANG_SECONDS_ENV
    assert faults.ENV_VAR == jfaults.ENV_VAR and faults.KINDS == jfaults.KINDS


DEADLINES = [
    {"step": 10.0, "feed": 5.0, "collective": 0.0, "compile": 100.0,
     "serve_request": 2.0, "ckpt": 0.0},
    {"step": 0.0, "feed": 0.0, "collective": 0.0, "compile": 0.0,
     "serve_request": 0.0, "ckpt": 0.0},
    {"step": 1800.0, "feed": 900.0, "collective": 1800.0, "compile": 7200.0,
     "serve_request": 600.0, "ckpt": 1800.0},
    {"step": 0.1, "feed": 0.0, "collective": 0.0, "compile": 0.0,
     "serve_request": 0.0, "ckpt": 0.0},
]
PHASES = ["step", "feed", "collective", "compile", "serve_request", "ckpt",
          "idle", "init"]


@pytest.mark.parametrize("deadlines", DEADLINES)
def test_watchdog_check_and_poll_match_jax(deadlines, tmp_path,
                                           monkeypatch):
    ours = watchdog.Watchdog(watchdog.ProgressBeacon(), deadlines,
                             bundle_dir=str(tmp_path))
    ref = jwatchdog.Watchdog(jwatchdog.ProgressBeacon(), deadlines,
                             bundle_dir=str(tmp_path))
    assert ours.enabled == ref.enabled
    assert ours.poll_interval_s == ref.poll_interval_s
    for poll in (0.3, 2.0):
        assert (watchdog.Watchdog(ours.beacon, deadlines, bundle_dir="x",
                                  poll_interval_s=poll).poll_interval_s
                == jwatchdog.Watchdog(ref.beacon, deadlines, bundle_dir="x",
                                      poll_interval_s=poll).poll_interval_s)
    for phase in PHASES:
        # Both beacons stamp the same instant, so ``now - stamp`` rounds
        # alike in both packages at every age.
        with monkeypatch.context() as m:
            m.setattr(time, "monotonic", lambda: 5000.0 + len(phase))
            ours.beacon.stamp(phase, detail=3)
            ref.beacon.stamp(phase, detail=3)
        assert ours.deadline_for(phase) == ref.deadline_for(phase)
        for age in (0.0, 0.05, 1.0, 2.0, 2.5, 5.0, 5.5, 10.0, 11.0, 1e4):
            got = ours.check(now=ours.beacon.current()[1] + age)
            want = ref.check(now=ref.beacon.current()[1] + age)
            assert got == want, (phase, age)


def test_deadlines_from_config_match_jax():
    for kw in ({}, {"watchdog_step_timeout_s": 2.0,
                    "watchdog_feed_timeout_s": 0.0}):
        ours, ref = MAMLConfig(**kw), JaxConfig(**kw)
        assert (watchdog.deadlines_from_config(ours)
                == jwatchdog.deadlines_from_config(ref))
        assert (watchdog.watchdog_enabled(ours)
                == jwatchdog.watchdog_enabled(ref))
    assert watchdog.PHASE_TIMEOUT_FIELDS == jwatchdog.PHASE_TIMEOUT_FIELDS
    assert (watchdog.TRIPS_COUNTER, watchdog.PROGRESS_AGE_GAUGE,
            watchdog.TRIP_EVENT) == (jwatchdog.TRIPS_COUNTER,
                                     jwatchdog.PROGRESS_AGE_GAUGE,
                                     jwatchdog.TRIP_EVENT)


def _ring_rows(rec):
    return [{k: v for k, v in e.items() if k not in ("t", "ts")}
            for e in rec.events()]


def test_flight_ring_order_and_bound_match_jax():
    ours, ref = flightrec.FlightRecorder(3), jflightrec.FlightRecorder(3)
    for i in range(7):
        for rec in (ours, ref):
            rec.record("phase", phase="step", detail=i)
    assert len(ours) == len(ref) == 3
    assert _ring_rows(ours) == _ring_rows(ref) == [
        {"kind": "phase", "phase": "step", "detail": d} for d in (4, 5, 6)]
    with pytest.raises(ValueError):
        flightrec.FlightRecorder(0)
    assert flightrec.DEFAULT_CAPACITY == jflightrec.DEFAULT_CAPACITY


def _fixed_ring(module):
    """A recorder of ``module`` holding the same rows, timestamps fixed."""
    rec = module.FlightRecorder(16)
    rows = [("phase", {"phase": "feed", "detail": "train"}),
            ("phase", {"phase": "step", "detail": 3}),
            ("fault", {"fault": "hang_step", "step": 4}),
            ("phase", {"phase": "compile", "detail": "nvcc:bn_act"}),
            ("watchdog_trip", {"phase": "step", "age_seconds": 2.5})]
    for i, (kind, fields) in enumerate(rows):
        rec.record(kind, **fields)
    with rec._lock:
        for i, event in enumerate(rec._ring):
            event["t"], event["ts"] = 10.0 + i, 1.7e9 + 0.25 * i
    return rec


def test_crash_bundle_layout_and_trace_match_jax(tmp_path):
    """Same ring, same registry: the same files, the same ``crash.json``
    keys, the same ``flight.jsonl`` rows, a byte-equal ``trace.json``."""
    reg = MetricsRegistry()
    reg.counter("watchdog/trips").inc()
    reg.gauge("memory/live_bytes_total").set(123.0)
    profile = tmp_path / "PROFILE.json"
    profile.write_text(json.dumps({"cards": {}}))
    info = {"phase": "step", "detail": 3, "age_seconds": 2.5,
            "deadline_seconds": 2.0, "process_index": 0}
    dirs = {}
    for name, mod in (("ours", flightrec), ("ref", jflightrec)):
        prev = mod.register_profile(str(profile))
        try:
            dirs[name] = mod.write_crash_bundle(
                str(tmp_path / name), reason="hung_step", info=info,
                recorder=_fixed_ring(mod), registry=reg)
        finally:
            mod.register_profile(prev)
    ours, ref = dirs["ours"], dirs["ref"]
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref)) == sorted(
        ["stacks.txt", "flight.jsonl", "trace.json", "crash.json",
         "PROFILE.json"])
    crash = {n: json.load(open(os.path.join(d, "crash.json")))
             for n, d in dirs.items()}
    assert set(crash["ours"]) == set(crash["ref"])
    assert crash["ours"]["metrics"] == crash["ref"]["metrics"]
    assert crash["ours"]["reason"] == "hung_step"
    for name in ("flight.jsonl", "trace.json"):
        with open(os.path.join(ours, name), "rb") as a, \
                open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(ours, "trace.json")) as f:
        doc = json.load(f)
    jtrace.validate_trace(doc)
    assert {e["name"] for e in doc["traceEvents"]} >= {
        "feed", "step", "compile", "fault", "watchdog_trip"}


def test_trace_flight_layer_is_byte_equal_to_jax(tmp_path):
    """The per-epoch ``trace.json`` from a ring and an events tail."""
    flight = _fixed_ring(flightrec).events()
    events = [{"ts": 1.7e9 + 2, "event": "checkpoint", "epoch": 0,
               "iter": 4}]
    for kw in (dict(flight=flight), dict(flight=flight, events=events)):
        a = trace.write_trace(str(tmp_path / "ours.json"), **kw)
        b = jtrace.write_trace(str(tmp_path / "ref.json"), **kw)
        assert {**a, "path": None} == {**b, "path": None}
        assert ((tmp_path / "ours.json").read_bytes()
                == (tmp_path / "ref.json").read_bytes())


def test_real_thread_trip_with_on_trip(tmp_path):
    """A watchdog thread trips a stalled ``step`` within its deadline plus
    a poll: the trip is counted, the bundle written (reason
    ``hung_step``), a ``watchdog_trip`` row and a metrics row logged,
    ``metrics.prom`` written, and ``on_trip`` called instead of the
    exit."""
    reg, rec = MetricsRegistry(), flightrec.FlightRecorder()
    jsonl = JsonlLogger(str(tmp_path / "events.jsonl"))
    beacon = watchdog.ProgressBeacon()
    trips = []
    prev = flightrec.install(rec)
    prev_beacon = watchdog.install_beacon(None)
    dog = watchdog.Watchdog(
        beacon, {"step": 0.3, "compile": 60.0}, bundle_dir=str(
            tmp_path / "bundle"), registry=reg, jsonl=jsonl,
        prom_path=str(tmp_path / "metrics.prom"), poll_interval_s=0.05,
        on_trip=trips.append)
    try:
        with watchdog.phase("compile"):
            pass  # no beacon installed: a no-op scope
        beacon.stamp("idle")
        dog.start()
        time.sleep(0.5)
        assert not trips  # an idle phase has no deadline
        t0 = time.monotonic()
        beacon.stamp("step", detail=7)
        deadline = time.monotonic() + 10
        while not trips and time.monotonic() < deadline:
            time.sleep(0.02)
        took = time.monotonic() - t0
    finally:
        dog.stop()
        flightrec.install(prev)
        watchdog.install_beacon(prev_beacon)
    assert len(trips) == 1 and dog.tripped == trips[0]
    assert trips[0]["phase"] == "step" and trips[0]["detail"] == 7
    assert 0.3 < took < 0.3 + 2 * 0.05 + 1.0
    assert reg.snapshot()[watchdog.TRIPS_COUNTER] == 1.0
    crash = json.load(open(tmp_path / "bundle" / "crash.json"))
    assert crash["reason"] == "hung_step" and crash["metrics"][
        "watchdog/trips"] == 1.0
    rows = read_jsonl(str(tmp_path / "events.jsonl"))
    assert [r["event"] for r in rows] == ["watchdog_trip", "metrics"]
    assert "watchdog_trips 1.0" in (tmp_path / "metrics.prom").read_text()
    assert [e["kind"] for e in rec.events()][-1] == "watchdog_trip"
    assert EXIT_HUNG == 74


def test_scoped_phase_restores_the_previous_phase():
    beacon = watchdog.ProgressBeacon()
    prev = watchdog.install_beacon(beacon)
    try:
        watchdog.stamp("step", detail=1)
        with watchdog.phase("ckpt", detail="latest"):
            assert beacon.current()[0] == "ckpt"
        phase, _, detail = beacon.current()
        assert (phase, detail) == ("step", 1)
    finally:
        watchdog.install_beacon(prev)
    assert beacon.age() >= 0.0


def test_nvcc_build_runs_under_compile(tmp_path, monkeypatch):
    """The first-use build of a kernel runs under the ``compile`` phase:
    an ``nvcc`` that takes longer than a tight step deadline does not
    trip the watchdog, while the same wait under ``step`` does; a cached
    load stamps nothing."""
    nvcc_seconds, step_deadline = 0.8, 0.3

    def slow_nvcc(cmd, **kw):
        time.sleep(nvcc_seconds)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"\x7fELF")
        return subprocess.CompletedProcess(cmd, 0, "ptxas info", "")

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_built", {})
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", slow_nvcc)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())
    rec, beacon, trips = flightrec.FlightRecorder(), watchdog.ProgressBeacon(
        ), []
    prev_rec, prev_beacon = flightrec.install(rec), watchdog.install_beacon(
        beacon)
    dog = watchdog.Watchdog(beacon, {"step": step_deadline,
                                     "compile": 60.0},
                            bundle_dir=str(tmp_path / "bundle"),
                            poll_interval_s=0.05, on_trip=trips.append)
    try:
        beacon.stamp("step", detail=0)
        dog.start()
        built = build.load("bn_act")
        assert built.seconds >= nvcc_seconds and not trips
        assert beacon.current()[0] == "step"
        monkeypatch.setattr(build, "_built", {})
        n = len(rec)
        assert build.load("bn_act").seconds == 0.0   # cached on disk
        assert len(rec) == n
        time.sleep(nvcc_seconds)                     # the control
        deadline = time.monotonic() + 5
        while not trips and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        dog.stop()
        flightrec.install(prev_rec)
        watchdog.install_beacon(prev_beacon)
    phases = [(e["phase"], e["detail"]) for e in rec.events()
              if e["kind"] == "phase"]
    assert ("compile", "nvcc:bn_act") in phases
    assert [t["phase"] for t in trips] == ["step"]
