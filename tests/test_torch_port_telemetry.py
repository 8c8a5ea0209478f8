"""The port's telemetry modules against the JAX package's, on the CPU:
``registry`` (byte-equal ``metrics.prom`` text and JSONL snapshots for the
same calls), ``instruments.FeedStallMeter``, ``aggregate`` (heartbeats and
the offline fleet collectors), ``alerts`` (the same transitions, rows,
firing summaries and ``ALERTS.json`` for a table of rules and snapshot
sequences) and ``trace`` (the same ``build_trace`` JSON and the same
validity verdicts). Also the pure parts of the port's perf sampler:
the peak table, cost cards and ``PROFILE.json`` as the JAX package reads
them, and the attribution of synthetic device records.

Pure Python: every comparison is exact (``==`` on the parsed rows, byte
equality on the written files), with ``time.time`` pinned.
"""

import json
import math
import os

import pytest

from howtotrainyourmamlpytorch_tpu.telemetry import aggregate as jagg
from howtotrainyourmamlpytorch_tpu.telemetry import alerts as jalerts
from howtotrainyourmamlpytorch_tpu.telemetry import instruments as jinst
from howtotrainyourmamlpytorch_tpu.telemetry import profiler as jprof
from howtotrainyourmamlpytorch_tpu.telemetry import registry as jreg
from howtotrainyourmamlpytorch_tpu.telemetry import trace as jtrace
from howtotrainyourmamlpytorch_tpu.utils import tracing as jtracing
from howtotrainyourmamlpytorch_tpu_torch.telemetry import aggregate as agg
from howtotrainyourmamlpytorch_tpu_torch.telemetry import alerts
from howtotrainyourmamlpytorch_tpu_torch.telemetry import instruments as inst
from howtotrainyourmamlpytorch_tpu_torch.telemetry import profiler as prof
from howtotrainyourmamlpytorch_tpu_torch.telemetry import registry as reg
from howtotrainyourmamlpytorch_tpu_torch.telemetry import trace
from howtotrainyourmamlpytorch_tpu_torch.utils import tracing

NOW = 1_790_000_000.25


@pytest.fixture
def frozen_time(monkeypatch):
    """``time.time`` pinned (both packages read the one ``time`` module)."""
    monkeypatch.setattr(reg.time, "time", lambda: NOW)


def _script_counters(r):
    r.counter("ckpt/saves").inc()
    r.counter("ckpt/saves").inc(2)
    r.counter("ckpt/save_seconds").inc(0.125)
    r.counter("resilience/io_retries")


def _script_gauges(r):
    r.gauge("train/loss").set(1.5)
    r.gauge("feed/stall_frac").set(0.03125)
    r.gauge("never/set")
    r.gauge("9starts-with.digit").set(-2)


def _script_histograms(r):
    h = r.histogram("step_seconds")
    for v in (0.0001, 0.003, 0.25, 1.5, 1.5, 2e4, float("nan"), 0.0):
        h.observe(v)
    c = r.histogram("custom", buckets=(3.0, 1.0, 2.0))
    for v in (0.5, 1.0, 2.5, 9.0):
        c.observe(v)
    r.histogram("empty")


def _script_mixed(r):
    _script_counters(r)
    _script_gauges(r)
    _script_histograms(r)


@pytest.mark.parametrize("script", [_script_counters, _script_gauges,
                                    _script_histograms, _script_mixed])
def test_registry_files_are_byte_equal_to_jax(script, tmp_path,
                                              frozen_time):
    ours, ref = reg.MetricsRegistry(), jreg.MetricsRegistry()
    script(ours)
    script(ref)
    assert ours.snapshot() == ref.snapshot()
    ours.write_prometheus(str(tmp_path / "ours.prom"))
    ref.write_prometheus(str(tmp_path / "ref.prom"))
    assert (tmp_path / "ours.prom").read_bytes() == (
        tmp_path / "ref.prom").read_bytes()
    ours.flush_jsonl(tracing.JsonlLogger(str(tmp_path / "ours.jsonl")),
                     epoch=3)
    ref.flush_jsonl(jtracing.JsonlLogger(str(tmp_path / "ref.jsonl")),
                    epoch=3)
    assert (tmp_path / "ours.jsonl").read_bytes() == (
        tmp_path / "ref.jsonl").read_bytes()


def test_registry_buckets_quantiles_and_type_errors_match_jax():
    assert reg.exponential_buckets() == jreg.exponential_buckets()
    assert reg.exponential_buckets(0.5, 3.0, 7) == jreg.exponential_buckets(
        0.5, 3.0, 7)
    for bad in ((0, 2, 3), (1, 1, 3), (1, 2, 0)):
        with pytest.raises(ValueError):
            reg.exponential_buckets(*bad)
        with pytest.raises(ValueError):
            jreg.exponential_buckets(*bad)
    ours, ref = reg.MetricsRegistry(), jreg.MetricsRegistry()
    for r in (ours, ref):
        h = r.histogram("h")
        for v in range(1, 40):
            h.observe(v * 0.01)
        r.counter("c")
    for q in (0.01, 0.5, 0.95, 1.0):
        assert ours.histogram("h").quantile(q) == ref.histogram(
            "h").quantile(q)
    for r in (ours, ref):
        with pytest.raises(TypeError):
            r.gauge("c")
        with pytest.raises(ValueError):
            r.counter("c").inc(-1)


def test_feed_stall_meter_matches_jax():
    ours, ref = inst.FeedStallMeter(), jinst.FeedStallMeter()
    before = None
    for wait, dispatch in ((0.5, 1.5), (0.0, 2.0), (0.25, 0.0)):
        for m in (ours, ref):
            m.record_wait(wait)
            m.record_dispatch(dispatch)
        assert ours.snapshot() == ref.snapshot()
        assert (inst.FeedStallMeter.delta(ours.snapshot(), before)
                == jinst.FeedStallMeter.delta(ref.snapshot(), before))
        before = ours.snapshot()
    empty = {"feed_wait_seconds": 0.0, "feed_dispatch_seconds": 0.0,
             "feed_batches": 0.0}
    assert inst.FeedStallMeter.delta(empty, None) == \
        jinst.FeedStallMeter.delta(empty, None)


def test_device_memory_stats_is_none_on_the_cpu():
    assert inst.device_memory_stats("cpu") is None


@pytest.mark.parametrize("extra", [{}, {"alerts_firing": {
    "count": 1, "max_severity": "warn"}}, {"progress_age_seconds": 2.5}])
def test_heartbeat_rows_match_jax(extra, tmp_path, frozen_time):
    ours = agg.emit_heartbeat(
        tracing.JsonlLogger(str(tmp_path / "ours.jsonl")), epoch=2,
        iteration=40, local_mean_step_seconds=0.75, **extra)
    ref = jagg.emit_heartbeat(
        jtracing.JsonlLogger(str(tmp_path / "ref.jsonl")), epoch=2,
        iteration=40, local_mean_step_seconds=0.75, process_index=0,
        **extra)
    assert ours == ref
    assert (tmp_path / "ours.jsonl").read_bytes() == (
        tmp_path / "ref.jsonl").read_bytes()
    assert agg.heartbeat_rows([ours, {"event": "x"}]) == [ours]
    assert agg.host_step_skew(0.0) == jagg.host_step_skew(0.0)


def _write_fleet(root):
    """Two sources (one restarted, one rotated) and a supervisor row."""
    rows_a = [{"ts": 3.0, "event": "metrics",
               "metrics": {"serve/requests": 5.0, "fleet/x": 1.0}},
              {"ts": 1.0, "event": "metrics",
               "metrics": {"serve/requests": 9.0}},
              {"ts": 5.0, "event": "metrics",
               "metrics": {"serve/requests": 2.0, "other/y": 4.0}},
              {"event": "no_ts"}]
    rows_b = [{"ts": 2.0, "event": "metrics", "replica": "supervisor",
               "metrics": {"fleet/x": 7.0, "fleet/canary_weight": 0.5}}]
    os.makedirs(root / "logs")
    with open(root / "events_replica_0.jsonl", "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows_a[2:])
    with open(root / "events_replica_0.jsonl.1", "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows_a[:2])
    with open(root / "logs" / "events.jsonl", "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows_b)


def test_fleet_collectors_match_jax(tmp_path):
    _write_fleet(tmp_path)
    paths = [str(tmp_path), str(tmp_path / "missing.jsonl")]
    assert agg.resolve_fleet_files(paths) == jagg.resolve_fleet_files(
        paths)
    ours, ref = agg.collect_fleet_events(paths), jagg.collect_fleet_events(
        paths)
    assert ours == ref and len(ours) == 5
    assert agg.fleet_counter_totals(ours) == jagg.fleet_counter_totals(ref)
    names = ["fleet/canary_weight", "fleet/x", "absent"]
    assert agg.latest_gauges(ours, names) == jagg.latest_gauges(ref, names)


# Rules and snapshot sequences: (rules, [(now, snapshot, ages,
# burn_rates), ...]).
ALERT_CASES = {
    "threshold_fires_and_resolves": (
        [{"name": "loss_high", "type": "threshold", "metric": "train/loss",
          "op": ">", "value": 2.0, "severity": "critical"}],
        [(0.0, {"train/loss": 1.0}, {}, {}),
         (1.0, {"train/loss": 3.0}, {}, {}),
         (2.0, {"train/loss": 4.0}, {}, {}),
         (3.0, {"train/loss": 1.5}, {}, {})]),
    "hysteresis": (
        [{"name": "slow", "type": "threshold", "metric": "step", "op": ">=",
          "value": 1.0, "for_s": 10.0}],
        [(0.0, {"step": 2.0}, {}, {}), (5.0, {"step": 2.0}, {}, {}),
         (6.0, {"step": 0.5}, {}, {}), (7.0, {"step": 2.0}, {}, {}),
         (20.0, {"step": 2.0}, {}, {}), (21.0, {"step": float("nan")},
                                          {}, {})]),
    "rate_reset_aware": (
        [{"name": "retries", "type": "rate",
          "metric": "resilience/io_retries", "op": ">", "value": 0.5,
          "severity": "info"}],
        [(0.0, {"resilience/io_retries": 0.0}, {}, {}),
         (10.0, {"resilience/io_retries": 20.0}, {}, {}),
         (20.0, {"resilience/io_retries": 3.0}, {}, {}),
         (30.0, {"resilience/io_retries": 3.0}, {}, {})]),
    "absence_and_burn": (
        [{"name": "stale", "type": "absence", "signal_prefix": "lease/",
          "max_age_s": 5.0},
         {"name": "hb", "type": "absence", "signal": "heartbeat",
          "max_age_s": 60.0, "severity": "critical"},
         {"name": "burn", "type": "burn_rate", "max_burn": 2.0}],
        [(0.0, {}, {"lease/0": 1.0, "lease/1": 9.0, "heartbeat": 5.0},
          {"a": 3.0, "b": 1.0}),
         (1.0, {}, {"lease/0": 7.0, "lease/1": float("inf"),
                    "heartbeat": 61.0}, {"a": 1.0, "b": "x"}),
         (2.0, {}, {}, {})]),
}


@pytest.mark.parametrize("case", sorted(ALERT_CASES))
def test_alert_transitions_match_jax(case, tmp_path, frozen_time):
    rules, steps = ALERT_CASES[case]
    doc = {"rules": rules}
    ours = alerts.AlertEvaluator(alerts.parse_rules(doc), source="train",
                                 snapshot_path=str(tmp_path / "ours.json"))
    ref = jalerts.AlertEvaluator(jalerts.parse_rules(doc), source="train",
                                 snapshot_path=str(tmp_path / "ref.json"))
    logs = (tracing.JsonlLogger(str(tmp_path / "ours.jsonl")),
            jtracing.JsonlLogger(str(tmp_path / "ref.jsonl")))
    regs = (reg.MetricsRegistry(), jreg.MetricsRegistry())
    for now, snapshot, ages, burn in steps:
        got = [ev.evaluate(now, snapshot=snapshot, ages=ages,
                           burn_rates=burn, jsonl=log, registry=r)
               for ev, log, r in zip((ours, ref), logs, regs)]
        assert json.dumps(got[0]) == json.dumps(got[1])
        assert ours.firing_summary() == ref.firing_summary()
        assert ours.active() == ref.active()
        assert regs[0].snapshot() == regs[1].snapshot()
        assert (tmp_path / "ours.json").read_bytes() == (
            tmp_path / "ref.json").read_bytes()
    assert (tmp_path / "ours.jsonl").read_bytes() == (
        tmp_path / "ref.jsonl").read_bytes()
    assert (ours.fired_total, ours.resolved_total) == (ref.fired_total,
                                                        ref.resolved_total)


@pytest.mark.parametrize("bad", [
    [], {"rules": [{"type": "threshold"}]},
    {"rules": [{"name": "a", "type": "treshold"}]},
    {"rules": [{"name": "a", "type": "threshold", "metric": "m",
                "op": "=>", "value": 1}]},
    {"rules": [{"name": "a", "type": "absence", "max_age_s": 1}]},
    {"rules": [{"name": "a", "type": "burn_rate", "max_burn": 1,
                "sevrity": "info"}]}])
def test_alert_rule_rejections_match_jax(bad):
    with pytest.raises(ValueError) as ours:
        alerts.parse_rules(bad)
    with pytest.raises(ValueError) as ref:
        jalerts.parse_rules(bad)
    assert str(ours.value) == str(ref.value)


def _run_events():
    return [
        {"ts": 100.0, "event": "train_epoch", "epoch": 0,
         "epoch_seconds": 12.5, "train_loss": 1.25},
        {"ts": 100.5, "event": "heartbeat", "epoch": 0, "iter": 3,
         "host_mean_step_seconds": [1.5],
         "host_progress_age_seconds": [0.25], "progress_phase": "step"},
        {"ts": 101.0, "event": "perf_profile", "iter": 4,
         "wall_seconds": 2.5, "device_compute_frac": 0.2,
         "per_family_seconds": {"conv": 0.1}, "roofline": {}},
        {"ts": 101.0, "event": "checkpoint", "epoch": 0, "bytes": 10},
        {"ts": 99.0, "event": "health_grad_norm_warn", "iter": 2},
        {"ts": 102.0, "event": "request_trace", "name": "wire_send",
         "trace_id": "t1", "ts_start": 101.5, "dur_s": 0.01, "pid": 7},
        {"ts": 102.0, "event": "request_trace", "name": "socket_queue",
         "trace_id": "t1", "ts_start": 101.52, "dur_s": 0.02, "pid": 9},
        {"ts": 103.0, "event": "validation", "epoch": 0},
        {"event": "rewind"}]


def test_build_trace_matches_jax(tmp_path):
    events = _run_events()
    flight = [{"ts": 99.5, "kind": "phase", "phase": "step", "detail": 3},
              {"ts": 99.7, "kind": "fault", "t": 1.0},
              {"ts": 99.9, "kind": "phase", "phase": "mystery"}]
    for kw in (dict(events=events), dict(events=events, flight=flight),
               dict(flight=flight, process_index=2), {}):
        ours, ref = trace.build_trace(**kw), jtrace.build_trace(**kw)
        assert json.dumps(ours) == json.dumps(ref)
        trace.validate_trace(ours)
        assert trace.trace_stats(ours) == jtrace.trace_stats(ref)
    ours = trace.write_trace(str(tmp_path / "ours.json"), events=events)
    ref = jtrace.write_trace(str(tmp_path / "ref.json"), events=events)
    assert {k: v for k, v in ours.items() if k != "path"} == {
        k: v for k, v in ref.items() if k != "path"}
    assert (tmp_path / "ours.json").read_bytes() == (
        tmp_path / "ref.json").read_bytes()


@pytest.mark.parametrize("bad", [
    {}, {"traceEvents": [{"ph": "Q", "ts": 1, "pid": 0, "tid": 0,
                          "name": "a"}]},
    {"traceEvents": [{"ph": "X", "ts": 1, "pid": 0, "tid": 0, "name": "a",
                      "dur": 0}]},
    {"traceEvents": [{"ph": "i", "ts": 1.5, "pid": 0, "tid": 0,
                      "name": "a"}]},
    {"traceEvents": [{"ph": "s", "ts": 1, "pid": 0, "tid": 0, "name": "a"}]},
    {"traceEvents": [{"ph": "i", "ts": 5, "pid": 0, "tid": 0, "name": "a"},
                     {"ph": "i", "ts": 4, "pid": 0, "tid": 0,
                      "name": "b"}]}])
def test_validate_trace_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError) as ours:
        trace.validate_trace(bad)
    with pytest.raises(ValueError) as ref:
        jtrace.validate_trace(bad)
    assert str(ours.value) == str(ref.value)


# ---------------------------------------------------------------------------
# the perf sampler's pure parts

@pytest.mark.parametrize("kind, env, want", [
    ("NVIDIA H100 80GB HBM3", {}, (989e12, 3.35e12, "table")),
    ("NVIDIA H100 PCIe", {}, (756e12, 2.0e12, "table")),
    ("NVIDIA H100 80GB HBM3", {"MAML_PEAK_FLOPS": "5e14"},
     (5e14, 3.35e12, "override")),
    ("NVIDIA H100 80GB HBM3", {"MAML_HBM_GBPS": "1000"},
     (989e12, 1e12, "override")),
    ("Some Other Card", {}, (0.0, 0.0, "unknown"))])
def test_resolve_peaks(kind, env, want):
    got = prof.resolve_peaks(kind, env=env)
    assert (got["peak_flops"], got["hbm_bytes_per_s"], got["source"]) == want


@pytest.mark.parametrize("flops, nbytes", [(1e12, 1e9), (1e12, 1e12),
                                           (0.0, 1e9), (1e12, 0.0)])
def test_roofline_verdict_matches_jax(flops, nbytes):
    assert prof.roofline_verdict(flops, nbytes, 989e12, 3.35e12) == \
        jprof.roofline_verdict(flops, nbytes, 989e12, 3.35e12)


def test_profile_json_reads_in_the_jax_package(tmp_path):
    """A port PROFILE.json of cost cards loads in the JAX package's
    reader, the cards in the JAX card keys, and the JAX merge keeps
    them."""
    peaks = prof.resolve_peaks("NVIDIA H100 80GB HBM3")
    cards = [prof.build_cost_card(prof.phase_card_name(so, msl),
                                  flops=1e12 * (1 + so), kind="H100",
                                  peaks=peaks)
             for so, msl in ((False, True), (True, False))]
    path = str(tmp_path / "PROFILE.json")
    prof.merge_profile(path, cards, device_kind="H100", peaks=peaks)
    doc = jprof.load_profile(path)
    assert set(doc["cards"]) == {"train_so0_msl1", "train_so1_msl0"}
    jax_card = jprof.build_cost_card(
        "x", flops_info={"flops": 1.0}, bytes_accessed=0.0, memory=None,
        fingerprint=None, device_kind="H100", peaks=peaks)
    assert set(doc["cards"]["train_so1_msl0"]) >= set(jax_card) - {
        "flops_parse_error", "trip_counts"}
    assert doc["peak_flops"] == 989e12 and doc["peak_flops_source"] == (
        "table")
    jprof.merge_profile(path, [], device_kind="H100")
    assert prof.load_profile(path)["cards"] == doc["cards"]


MS = 1_000_000  # ns


def test_summarize_records_attribution():
    """Clipping to the window, the three fractions, families, and the
    innermost label at each record's launch (other outside every label,
    unattributed without a launch)."""
    records = [
        ("bn_act_persistent_kernel<bf16>", 1 * MS, 3 * MS, int(1.5 * MS)),
        ("sm90_xmma_fprop_implicit_gemm", 2 * MS, 6 * MS, 2 * MS),
        ("max_pool_forward_nhwc", 8 * MS, 9 * MS, int(4.5 * MS)),
        ("elementwise_kernel", 9 * MS, 10 * MS, int(7.5 * MS)),
        ("Memcpy HtoD", 10 * MS, 12 * MS, None),
        ("before_window", -3 * MS, -1 * MS, -2 * MS)]
    labels = [("task_adapt", 0, 5 * MS),
              ("inner_support_forward", 1 * MS, 3 * MS),
              ("inner_support_grad", 4 * MS, 5 * MS)]
    row = prof.summarize_records(records, labels, (0, 20 * MS), 99.0)
    assert row["wall_seconds"] == 0.02
    assert row["device_compute_seconds"] == pytest.approx(0.009)
    assert row["device_idle_seconds"] == pytest.approx(0.002)
    assert row["host_gap_seconds"] == pytest.approx(0.009)
    total = (row["device_compute_frac"] + row["device_idle_frac"]
             + row["dispatch_gap_frac"])
    assert total == pytest.approx(1.0, abs=1e-12)
    assert row["per_family_kernels"] == {
        "conv": 1, "bn_act": 1, "elementwise/other": 2, "pool": 1}
    assert row["per_region_seconds"] == pytest.approx({
        "inner_support_forward": 0.006, "unattributed": 0.002,
        "inner_support_grad": 0.001, "other": 0.001})
    assert row["device_spans"] == 5
    prof.attach_card(row, "train_so1_msl0", {"flops": 1e9, "bound":
                                             "unknown"},
                     {"peak_flops": 1e12, "source": "table"})
    assert row["top_executable"] == "train_so1_msl0"
    assert row["mfu"] == pytest.approx(1e9 / 0.02 / 1e12)
    assert row["roofline"]["train_so1_msl0"]["achieved_flops_per_s"] == (
        pytest.approx(1e9 / 0.009))
    assert math.isclose(row["per_executable_seconds"]["train_so1_msl0"],
                        0.01)


def test_summarize_records_without_a_window_or_records():
    row = prof.summarize_records([], [], None, 0.5)
    assert (row["wall_seconds"], row["device_compute_seconds"],
            row["dispatch_gap_frac"]) == (0.5, 0.0, 1.0)
    prof.attach_card(row, "train_so0_msl1", None,
                     {"peak_flops": 0.0, "source": "unknown"})
    assert row["mfu"] is None and row["top_executable"] is None
    assert row["per_executable_seconds"] == {}


@pytest.mark.parametrize("name, family", [
    ("bn_act_persistent<__nv_bfloat16>", "bn_act"),
    ("max_pool_forward_nhwc", "pool"),
    ("sm90_xmma_wgrad_implicit_gemm", "conv"),
    ("cutlass_80_tensorop_gemm", "gemm"),
    ("reduce_kernel<512>", "reduce"),
    ("vectorized_elementwise_kernel", "elementwise/other")])
def test_kernel_families(name, family):
    assert prof.kernel_family(name) == family


class _Record:
    """A stand-in for one raw profiler record (``_KinetoEvent``)."""

    def __init__(self, name, device, start, end, corr, linked=0,
                 annotation=False, thread=1):
        self._f = (name, device, start, end, corr, linked, annotation,
                   thread)

    def name(self):
        return self._f[0]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._f[1] == "cuda" else DeviceType.CPU

    def start_ns(self):
        return self._f[2]

    def end_ns(self):
        return self._f[3]

    def correlation_id(self):
        return self._f[4]

    def linked_correlation_id(self):
        return self._f[5]

    def is_user_annotation(self):
        return self._f[6]

    def is_hidden_event(self):
        return False

    def start_thread_id(self):
        return self._f[7]


def test_window_records_pair_each_kernel_with_its_launch():
    """A kernel's launch is the runtime call with its correlation id AND
    its linked op: an op (or an unlinked runtime call) whose own id
    happens to equal the kernel's, from the other counter, is not it.
    Device-side label spans are not activity; a launch in the window with
    no device record is counted as lost."""
    events = [
        _Record(prof.WINDOW_MARKER, "cpu", 0, 100 * MS, 1, annotation=True),
        _Record("episode_normalize", "cpu", 1 * MS, 10 * MS, 2,
                annotation=True),
        _Record("aten::copy_", "cpu", 2 * MS, 3 * MS, 6),
        _Record("cudaLaunchKernel", "cpu", 2 * MS + 5, 3 * MS, 14, 6),
        # An unlinked runtime call whose id collides with the op's.
        _Record("cudaStreamSynchronize", "cpu", 90 * MS, 99 * MS, 6),
        _Record("task_adapt", "cpu", 20 * MS, 40 * MS, 7, annotation=True),
        _Record("aten::mul", "cpu", 30 * MS, 31 * MS, 14),
        _Record("cudaLaunchKernel", "cpu", 30 * MS + 5, 31 * MS, 20, 14),
        _Record("copy_kernel", "cuda", 4 * MS, 5 * MS, 14, 6),
        _Record("mul_kernel", "cuda", 32 * MS, 33 * MS, 20, 14),
        _Record("episode_normalize", "cuda", 4 * MS, 5 * MS, 2,
                annotation=True),
        _Record("Memcpy HtoD", "cuda", 50 * MS, 51 * MS, 99, 98),
        _Record("cudaStreamIsCapturing", "cpu", 60 * MS, 61 * MS, 30, 14),
        _Record("cudaLaunchKernel", "cpu", 62 * MS, 63 * MS, 31, 14),
        _Record("cudaLaunchKernel", "cpu", 120 * MS, 121 * MS, 32, 14)]
    records, labels, window, lane, lost = prof.window_records(events)
    assert lane == "cuda" and window == (0, 100 * MS) and lost == 1
    assert [r[0] for r in records] == ["copy_kernel", "mul_kernel",
                                       "Memcpy HtoD"]
    assert [r[3] for r in records] == [2 * MS + 5, 30 * MS + 5, None]
    row = prof.summarize_records(records, labels, window, 0.0)
    assert row["per_region_seconds"] == pytest.approx({
        "episode_normalize": 0.001, "task_adapt": 0.001,
        "unattributed": 0.001})


def _tail_window(tail_recorded):
    """A window whose step ends in ``meta_update`` and then the sampler's
    tail sentinel; with ``tail_recorded`` False the tracer dropped the
    tail: the ``meta_update`` kernels AND their launch records, and the
    sentinel's, while the host kept its operators and labels."""
    events = [
        _Record(prof.WINDOW_MARKER, "cpu", 0, 100 * MS, 1, annotation=True),
        _Record("task_adapt", "cpu", 1 * MS, 40 * MS, 2, annotation=True),
        _Record("aten::mul", "cpu", 10 * MS, 11 * MS, 5),
        _Record("cudaLaunchKernel", "cpu", 10 * MS + 5, 11 * MS, 20, 5),
        _Record("mul_kernel", "cuda", 12 * MS, 13 * MS, 20, 5),
        _Record("meta_update", "cpu", 50 * MS, 80 * MS, 3, annotation=True),
        _Record("aten::add_", "cpu", 55 * MS, 56 * MS, 6),
        _Record("aten::add_", "cpu", 60 * MS, 61 * MS, 7),
        _Record(prof.WINDOW_TAIL, "cpu", 90 * MS, 92 * MS, 4,
                annotation=True),
        _Record("aten::add_", "cpu", 90 * MS + 10, 91 * MS, 8),
        _Record("cudaDeviceSynchronize", "cpu", 93 * MS, 99 * MS, 30)]
    if tail_recorded:
        events += [
            _Record("cudaLaunchKernel", "cpu", 55 * MS + 5, 56 * MS, 21, 6),
            _Record("cudaLaunchKernel", "cpu", 60 * MS + 5, 61 * MS, 22, 7),
            _Record("cudaLaunchKernel", "cpu", 90 * MS + 20, 91 * MS, 23,
                    8),
            _Record("add_kernel", "cuda", 57 * MS, 58 * MS, 21, 6),
            _Record("add_kernel", "cuda", 62 * MS, 63 * MS, 22, 7),
            _Record("add_kernel", "cuda", 92 * MS, 93 * MS, 23, 8)]
    return events


@pytest.mark.parametrize("tail_recorded", [True, False])
def test_window_records_count_a_dropped_tail(tail_recorded):
    """A complete window holds the tail sentinel's kernel (left out of the
    records) and lost nothing. When the tracer dropped the step's tail,
    launches included, the missing sentinel shows it, and ``lost``
    counts the host operators after the last recorded launch (the two
    ``meta_update`` adds and the sentinel's own; the closing sync is a
    runtime call, not one of them): the every-label check
    then sees a window that lost records, not a step without
    ``meta_update``."""
    win = prof.window_records(_tail_window(tail_recorded))
    names = [r[0] for r in win.records]
    if tail_recorded:
        assert win.lost == 0
        assert names == ["mul_kernel", "add_kernel", "add_kernel"]
        row = prof.summarize_records(win.records, win.labels, win.span, 0.1)
        assert set(row["per_region_seconds"]) == {"task_adapt",
                                                  "meta_update"}
    else:
        assert win.lost == 3
        assert names == ["mul_kernel"]
