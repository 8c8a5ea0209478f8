"""The port's pod fault domain (``resilience/cluster.py``) against the JAX
package's, on the same inputs, on the CPU.

* The pure functions: ``stalled_after``, ``dead_after``,
  ``arm_deadlines``, ``ClusterMonitor.check``/``suspects`` at the
  boundaries of ``tests/test_cluster.py``, ``latest_committed_epoch`` on
  one ``MANIFEST.json`` (stale, whole, damaged) and ``consensus_epoch``:
  equal answers. Leases written by one package read by the other.
* Each trip path with an injected ``_exit`` / ``on_trip``, run through
  both packages: watchdog delegation, a generic deadline below the
  budget staying a hang (74), the second-trip escalation, the backstop,
  a collective error with and without attribution. The ``peer_lost``
  row's keys, the suspects, the exit code and the counters must be the
  JAX package's.
* The process group's timeout outlasts the budget and its backstop when
  the domain is armed, and is the backend's default when it is not.
* A run with the knobs at 0 installs nothing; an armed one-process run
  writes its lease and heartbeat rows carrying ``peer_lease_age_seconds``
  that the port's and the JAX package's reports read alike.

Exact equality throughout: these are integer, string and set decisions.
"""

import json
import math
import os
import time

import pytest

from howtotrainyourmamlpytorch_tpu import resilience as jres
from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.ckpt import manifest as jmanifest
from howtotrainyourmamlpytorch_tpu.parallel import multihost as jmultihost
from howtotrainyourmamlpytorch_tpu.resilience import cluster as jcluster
from howtotrainyourmamlpytorch_tpu.resilience import flightrec as jflightrec
from howtotrainyourmamlpytorch_tpu.resilience import watchdog as jwatchdog
from howtotrainyourmamlpytorch_tpu.telemetry import (
    MetricsRegistry as JaxRegistry)
from howtotrainyourmamlpytorch_tpu.telemetry.report import (
    summarize_events as jax_summarize)
from howtotrainyourmamlpytorch_tpu.utils.tracing import (
    JsonlLogger as JaxJsonl)
from howtotrainyourmamlpytorch_tpu_torch import resilience as tres
from howtotrainyourmamlpytorch_tpu_torch.ckpt import manifest as tmanifest
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentBuilder
from howtotrainyourmamlpytorch_tpu_torch.parallel import multihost
from howtotrainyourmamlpytorch_tpu_torch.resilience import (cluster,
                                                            flightrec,
                                                            watchdog)
from howtotrainyourmamlpytorch_tpu_torch.telemetry import MetricsRegistry
from howtotrainyourmamlpytorch_tpu_torch.telemetry.report import (
    summarize_events)
from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import (JsonlLogger,
                                                               read_jsonl)

# (resilience, cluster, watchdog, flightrec, multihost, manifest,
#  registry, jsonl) of each package.
JAX = (jres, jcluster, jwatchdog, jflightrec, jmultihost, jmanifest,
       JaxRegistry, JaxJsonl)
PORT = (tres, cluster, watchdog, flightrec, multihost, tmanifest,
        MetricsRegistry, JsonlLogger)
BOTH = pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])


@pytest.fixture(autouse=True)
def _clean_process_state():
    """No domain, beacon, recorder or registry left installed by a test,
    in either package."""
    prev = [(m.install(None), m) for m in (cluster, jcluster)]
    yield
    for p, m in prev:
        m.install(p)


def test_exit_code_and_exports_are_the_jax_packages():
    assert tres.EXIT_PEER_LOST == jres.EXIT_PEER_LOST == 73
    assert set(jres.__all__) <= set(tres.__all__)
    for name in ("PEER_LOST_EVENT", "CONSENSUS_EVENT", "PEER_LOSSES_COUNTER",
                 "ESCALATIONS_COUNTER", "LAST_SUSPECT_GAUGE",
                 "CONSENSUS_EPOCH_GAUGE", "LEASE_DIR", "LEASE_PREFIX",
                 "LEASE_SUFFIX", "LIVE", "STALLED", "DEAD"):
        assert getattr(cluster, name) == getattr(jcluster, name)


@pytest.mark.parametrize("kw", [
    {}, dict(cluster_collective_timeout_s=30.0),
    dict(cluster_collective_timeout_s=2.0),
    dict(cluster_collective_timeout_s=600.0, cluster_lease_interval_s=10.0),
    dict(cluster_collective_timeout_s=20.0, cluster_lease_interval_s=1.0,
         cluster_peer_stalled_s=4.0, cluster_peer_dead_s=9.0)],
    ids=["off", "30s", "tight", "pod_json", "explicit"])
def test_thresholds_and_armed_deadlines_equal_jax(kw):
    ours, ref = MAMLConfig(**kw), JaxConfig(**kw)
    assert cluster.cluster_enabled(ours) == jcluster.cluster_enabled(ref)
    if cluster.cluster_enabled(ours):
        assert cluster.stalled_after(ours) == jcluster.stalled_after(ref)
        assert cluster.dead_after(ours) == jcluster.dead_after(ref)
    for base in ({"collective": 1800.0, "step": 300.0}, {"collective": 0.0},
                 {"collective": 5.0}, {}):
        assert (cluster.arm_deadlines(ours, base)
                == jcluster.arm_deadlines(ref, base))


@pytest.mark.parametrize("ages", [
    {0: 0.0, 1: 2.0, 2: 2.01, 3: 10.0, 4: 10.01, 5: math.inf, 6: -5.0},
    {0: 5.0, 1: 12.0, 2: 4.0, 3: 30.0},
    {0: 5.0, 1: 4.0, 2: 0.1},
    {0: 50.0, 1: 0.1, 2: 0.2},
    {0: 0.0, 1: math.inf}])
@pytest.mark.parametrize("self_index", [0, 1])
def test_monitor_check_and_suspects_equal_jax(ages, self_index):
    ours = cluster.ClusterMonitor(2.0, 10.0, self_index=self_index)
    ref = jcluster.ClusterMonitor(2.0, 10.0, self_index=self_index)
    assert ours.check(ages) == ref.check(ages)
    assert ours.suspects(ages) == ref.suspects(ages)


@pytest.mark.parametrize("bad", [(0.0, 10.0), (10.0, 2.0)])
def test_monitor_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError):
        jcluster.ClusterMonitor(*bad)
    with pytest.raises(ValueError):
        cluster.ClusterMonitor(*bad)


@pytest.mark.parametrize("writer,reader", [(cluster, jcluster),
                                           (jcluster, cluster)],
                         ids=["port_writes", "jax_writes"])
def test_leases_cross_read(tmp_path, writer, reader):
    """A lease written by one package reads in the other: ages, an aged
    peer, an expected host with no file (inf), an orphan beyond the pod
    size dropped, and the same ages through both readers."""
    lease_dir = str(tmp_path / "cluster")
    lease = writer.HeartbeatLease(lease_dir, process_index=0, interval_s=60)
    assert lease.touch(detail="epoch_0") is True
    assert lease.touch() is False and lease.touch(force=True) is True
    assert json.load(open(lease.path))["host"] == 0
    past = time.time() - 120.0
    for host in (1, 7):
        path = writer.lease_path(lease_dir, host)
        with open(path, "w") as f:
            f.write("{}")
        os.utime(path, (past, past))
    now = time.time()
    for expected in (0, 2, 3):
        got = reader.read_lease_ages(lease_dir, expected, now=now)
        assert got == writer.read_lease_ages(lease_dir, expected, now=now)
    ages = reader.read_lease_ages(lease_dir, expected_hosts=3, now=now)
    assert ages[0] < 30.0 and 100.0 < ages[1] < 200.0
    assert ages[2] == math.inf and 7 not in ages
    assert reader.lease_path(lease_dir, 1) == writer.lease_path(lease_dir, 1)


def _manifests(tmp_path, mod):
    """Fresh (0, 1 committed; 2 pending; latest), stale (0 only) and
    damaged (none) manifests, as tests/test_cluster.py plants them."""
    fresh = mod.Manifest(str(tmp_path / "fresh"))
    for epoch in (0, 1):
        fresh.begin(str(epoch), epoch=epoch, iteration=4 * (epoch + 1))
        fresh.commit(str(epoch), nbytes=10, crc=1)
    fresh.begin("latest", iteration=8)
    fresh.commit("latest", nbytes=10, crc=1)
    fresh.begin("2", epoch=2, iteration=12)
    stale = mod.Manifest(str(tmp_path / "stale"))
    stale.begin("0", epoch=0, iteration=4)
    stale.commit("0", nbytes=10, crc=1)
    return fresh, stale, mod.Manifest(str(tmp_path / "empty"))


def test_latest_committed_epoch_and_consensus_equal_jax(tmp_path):
    """Each package's manifests through both packages'
    ``latest_committed_epoch``, a stale manifest's file read by the
    other package's ``Manifest``, then ``consensus_epoch`` over views."""
    for i, mod in enumerate((tmanifest, jmanifest)):
        views = []
        for m in _manifests(tmp_path / str(i), mod):
            view = cluster.latest_committed_epoch(m)
            assert view == jcluster.latest_committed_epoch(m)
            views.append(view)
        assert views == [1, 0, -1]
        assert (cluster.consensus_epoch(views)
                == jcluster.consensus_epoch(views) == 0)
        other = (jmanifest if mod is tmanifest else tmanifest).Manifest(
            str(tmp_path / str(i) / "fresh"))
        assert cluster.latest_committed_epoch(other) == 1
        assert [r["tag"] for r in other.committed()] == [
            r["tag"] for r in _manifests(tmp_path / f"again{i}", mod)[0]
            .committed()]
    for views in ([5, 3, 4], [5, -1, 3], [-1, -1], [], [0]):
        assert cluster.consensus_epoch(views) == \
            jcluster.consensus_epoch(views)


def _domain(pkg, tmp_path, **kw):
    res, clu, _, _, _, _, Reg, Jsonl = pkg
    reg = Reg()
    jsonl = Jsonl(str(tmp_path / "events.jsonl"))
    base = dict(
        lease_dir=str(tmp_path / "cluster"), process_index=0,
        num_processes=2, collective_timeout_s=10.0,
        stalled_after_s=2.0, dead_after_s=10.0, lease_interval_s=0.1,
        registry=reg, jsonl=jsonl,
        bundle_dir=str(tmp_path / "crash_bundle"),
        prom_path=str(tmp_path / "metrics.prom"))
    base.update(kw)
    return clu.ClusterFaultDomain(**base), reg


def _dead_peer(clu, domain, age=120.0):
    domain.heartbeat(force=True)
    peer = clu.lease_path(domain.lease.lease_dir, 1)
    with open(peer, "w") as f:
        f.write("{}")
    past = time.time() - age
    os.utime(peer, (past, past))


def _rows(path):
    return read_jsonl(str(path)) if os.path.exists(str(path)) else []


def _watchdog_delegation(pkg, tmp_path):
    res, clu, wdm, fr, _, _, _, _ = pkg
    trips = []
    domain, reg = _domain(pkg, tmp_path, on_trip=trips.append)
    fr.install(fr.FlightRecorder(32))
    try:
        _dead_peer(clu, domain)
        beacon = wdm.ProgressBeacon()
        beacon.stamp("collective", detail="any_process_true_each")
        wd = wdm.Watchdog(beacon, {"collective": 10.0},
                          bundle_dir=str(tmp_path / "wd_bundle"),
                          registry=reg, jsonl=domain.jsonl, cluster=domain)
        info = wd.check(now=beacon.current()[1] + 12.0)
        assert domain.owns_trip(info)
        wd.trip(info)
        events = _rows(tmp_path / "events.jsonl")
        lost = [e for e in events if e["event"] == "peer_lost"]
        crash = json.load(open(tmp_path / "crash_bundle" / "crash.json"))
        return {
            "trips": len(trips), "suspects": trips[0]["suspect_hosts"],
            "verdicts": trips[0]["peer_verdicts"],
            "row_keys": sorted(set(lost[0]) - {"ts"}),
            "events": [e["event"] for e in events],
            "peer_losses": reg.counter(clu.PEER_LOSSES_COUNTER).value,
            "last_suspect": reg.gauge(clu.LAST_SUSPECT_GAUGE).value,
            "crash_reason": crash["reason"],
            "crash_suspects": crash["suspect_hosts"],
            "flight_kinds": [e["kind"] for e in fr.get().events()],
            "prom": "cluster_peer_losses 1" in open(
                tmp_path / "metrics.prom").read(),
        }
    finally:
        fr.install(None)
        domain.close()


def _below_budget(pkg, tmp_path):
    res, clu, wdm, _, _, _, _, _ = pkg
    domain, reg = _domain(pkg, tmp_path, collective_timeout_s=100.0)
    beacon = wdm.ProgressBeacon()
    beacon.stamp("collective", detail="barrier:x")
    wd_trips = []
    wd = wdm.Watchdog(beacon, {"collective": 5.0},
                      bundle_dir=str(tmp_path / "wd_bundle"), registry=reg,
                      jsonl=domain.jsonl, cluster=domain,
                      on_trip=wd_trips.append)
    info = wd.check(now=beacon.current()[1] + 6.0)
    late = dict(info, age_seconds=domain.collective_timeout_s + 5.0)
    owned = [domain.owns_trip(info), domain.owns_trip(late),
             domain.owns_trip(dict(late, deadline_seconds=100.0))]
    wd.trip(info)
    return {"owned": owned, "generic": wd_trips == [info],
            "events": [e["event"] for e in _rows(tmp_path / "events.jsonl")
                       if e["event"] in ("watchdog_trip", "peer_lost")],
            "hung_code": res.EXIT_HUNG}


def _second_trip(pkg, tmp_path):
    res, clu, _, _, _, _, _, _ = pkg
    exits = []
    domain, reg = _domain(pkg, tmp_path)
    domain._exit = exits.append
    info = {"phase": "collective", "detail": "gather_host_floats",
            "age_seconds": 12.0, "deadline_seconds": 10.0,
            "process_index": 0}
    domain.trip_peer_lost(info)
    first = list(exits)
    domain.trip_peer_lost(info)
    events = _rows(tmp_path / "events.jsonl")
    domain.close()
    return {"first": first, "second": exits,
            "rows": sum(e["event"] == "peer_lost" for e in events),
            "escalations": reg.counter(clu.ESCALATIONS_COUNTER).value}


def _backstop(pkg, tmp_path):
    exits = []
    domain, _ = _domain(pkg, tmp_path, collective_timeout_s=0.2, jsonl=None,
                        bundle_dir=None, prom_path=None)
    domain._exit = exits.append
    domain.trip_peer_lost({"phase": "collective", "age_seconds": 1.0})
    armed = domain._backstop is not None
    deadline = time.monotonic() + 5.0
    while len(exits) < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    domain.close()
    return {"armed": armed, "exits": exits[:2]}


def _collective_error(pkg, tmp_path):
    res, clu, _, _, mh, _, _, _ = pkg
    trips = []
    domain, _ = _domain(pkg, tmp_path, on_trip=trips.append)
    _dead_peer(clu, domain)
    clu.install(domain)
    with pytest.raises(RuntimeError, match="connection reset"):
        with mh._collective("gather_host_floats"):
            raise RuntimeError("connection reset by peer")
    solo, _ = _domain(pkg, tmp_path / "solo", num_processes=1,
                      on_trip=trips.append)
    clu.install(solo)
    with pytest.raises(ValueError):
        with mh._collective("x"):
            raise ValueError("not a transport error")
    clu.install(None)
    with pytest.raises(ValueError):
        with mh._collective("x"):
            raise ValueError("boom")
    domain.close()
    return {"trips": len(trips), "detail": trips[0]["detail"],
            "suspects": trips[0]["suspect_hosts"],
            "keys": sorted(trips[0]),
            "error": trips[0]["error"],
            "rows": sum(e["event"] == "peer_lost"
                        for e in _rows(tmp_path / "events.jsonl"))}


def _unattributed(pkg, tmp_path):
    res, clu, _, _, mh, _, _, _ = pkg
    trips = []
    domain, reg = _domain(pkg, tmp_path, on_trip=trips.append,
                          collective_timeout_s=1.0)
    domain.heartbeat(force=True)
    with open(clu.lease_path(domain.lease.lease_dir, 1), "w") as f:
        f.write("{}")
    clu.install(domain)
    with pytest.raises(RuntimeError, match="app bug"):
        with mh._collective("agree_int_from_main"):
            raise RuntimeError("app bug, not a dead peer")
    clu.install(None)
    return {"trips": trips, "tripped": domain.tripped,
            "events": os.path.exists(tmp_path / "events.jsonl"),
            "unattributed": reg.counter(
                "cluster/unattributed_collective_errors").value}


@pytest.mark.parametrize("case", [_watchdog_delegation, _below_budget,
                                  _second_trip, _backstop,
                                  _collective_error, _unattributed],
                         ids=lambda f: f.__name__.strip("_"))
def test_trip_paths_equal_jax(case, tmp_path):
    """Each trip path through both packages: the same rows, suspects,
    counters and exit codes (the injected ``_exit`` records 73)."""
    ref = case(JAX, tmp_path / "jax")
    ours = case(PORT, tmp_path / "port")
    assert ours == ref
    if case is _second_trip:
        assert ours["second"] == [73, 73] and ours["escalations"] == 1
    if case is _backstop:
        assert ours == {"armed": True, "exits": [73, 73]}
    if case is _watchdog_delegation:
        assert ours["suspects"] == [1] and "watchdog_trip" not in \
            ours["events"]


@pytest.mark.parametrize("budget", [0.0, 0.5, 20.0, 600.0])
def test_process_group_timeout_outlasts_budget_and_backstop(budget,
                                                            monkeypatch):
    """Armed, ``init_process_group`` gets a timeout above the budget plus
    the trip's backstop (one more budget, at least 1 s): NCCL's 10 min
    default equals the pod JSON's 600 s budget and would abort first.
    Off, the backend's default stands (no timeout passed)."""
    cfg = MAMLConfig(cluster_collective_timeout_s=budget)
    got = cluster.process_group_timeout(cfg)
    if budget == 0:
        assert got is None
    else:
        assert got > budget + max(budget, 1.0)
    seen = {}
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda *a, **k: seen.update(k))
    monkeypatch.setattr(multihost, "is_initialized", lambda: False)
    for key, value in (("RANK", "0"), ("WORLD_SIZE", "1"),
                       ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(key, value)
    multihost.initialize_distributed("cpu", timeout_s=got)
    if got is None:
        assert "timeout" not in seen
    else:
        assert seen["timeout"].total_seconds() == got


def test_run_installs_the_domain_iff_armed_and_reports_like_jax(tmp_path):
    """Knobs at 0: no domain, no lease. Armed (one process): the lease
    exists, the watchdog carries the domain, the collective deadline is
    the budget, heartbeat rows carry ``peer_lease_age_seconds``, the
    counter reads 0, and both packages' reports read the cluster section
    alike; after the run nothing is left installed."""
    kw = dict(experiment_root=str(tmp_path), dataset_name="synthetic_pod",
              image_height=10, image_width=10, image_channels=1,
              num_classes_per_set=3, num_samples_per_class=1,
              num_target_samples=2, batch_size=2, cnn_num_filters=4,
              num_stages=2, number_of_training_steps_per_iter=1,
              number_of_evaluation_steps_per_iter=1, second_order=False,
              use_multi_step_loss_optimization=False, total_epochs=2,
              total_iter_per_epoch=2, num_evaluation_tasks=2,
              max_models_to_save=1, compute_dtype="float32")
    seen = {}
    real = watchdog.Watchdog.start

    def start(self):
        seen["cluster"], seen["deadlines"] = self.cluster, self.deadlines
        seen["installed"] = cluster.get()
        return real(self)
    watchdog.Watchdog.start = start
    try:
        off = ExperimentBuilder(MAMLConfig(experiment_name="off", **kw),
                                device="cpu")
        off.run_experiment()
        assert seen["cluster"] is None and seen["installed"] is None
        assert not os.path.exists(tmp_path / "off" / "cluster")
        on = ExperimentBuilder(MAMLConfig(
            experiment_name="on", cluster_collective_timeout_s=30.0,
            cluster_lease_interval_s=0.1, **kw), device="cpu")
        on.run_experiment()
    finally:
        watchdog.Watchdog.start = real
    assert seen["cluster"] is not None and seen["installed"] is not None
    assert seen["deadlines"]["collective"] == 30.0
    assert cluster.get() is None and on._cluster is None
    assert os.path.exists(tmp_path / "on" / "cluster" / "host_0.lease")
    events = read_jsonl(str(tmp_path / "on" / "logs" / "events.jsonl"))
    beats = [e for e in events if e["event"] == "heartbeat"]
    assert len(beats) == 2 and all(
        set(b["peer_lease_age_seconds"]) == {"0"} for b in beats)
    metrics = [e for e in events if e["event"] == "metrics"]
    assert metrics[-1]["metrics"][cluster.PEER_LOSSES_COUNTER] == 0
    ours, ref = summarize_events(events), jax_summarize(events)
    assert ours["cluster"] == ref["cluster"]
    assert ours["cluster"]["peer_losses"] == 0
    off_events = read_jsonl(str(tmp_path / "off" / "logs" / "events.jsonl"))
    assert not any("peer_lease_age_seconds" in e for e in off_events)
    assert summarize_events(off_events)["cluster"] == jax_summarize(
        off_events)["cluster"]
