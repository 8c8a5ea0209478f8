"""The port's elastic pod (``resilience/elastic.py``) against the JAX
package's, on the same inputs, on the CPU.

* ``roster_consensus``, ``rerank``, ``parse_roster_env``,
  ``startup_disposition``, ``should_reshard`` and ``apply_roster``: equal
  answers.
* ``exec_env``/``adopt_env``: the same roster trio; where the JAX package
  writes ``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/
  ``JAX_PROCESS_ID`` the port writes ``MASTER_ADDR`` + ``MASTER_PORT``/
  ``WORLD_SIZE``/``RANK`` (and ``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` for
  ranks sharing a node); a lone survivor drops them all.
* The attributed trip -> roster consensus -> exec pipeline with an
  injected ``_exec``, through both packages: the same proposal, roster
  and reshard row; refusals (over budget, a newer roster) exit 73 alike.
  When the run's writer is among the dead, the next rank 0 records the
  reshard.
* The re-exec of a ``python -m`` launch runs the module again (the
  command line is ``sys.orig_argv``), with a real ``os.execve``.
* ``_maybe_re_expand`` and the CLI's backfill gate.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.resilience import cluster as jcluster
from howtotrainyourmamlpytorch_tpu.resilience import elastic as jelastic
from howtotrainyourmamlpytorch_tpu.telemetry import (
    MetricsRegistry as JaxRegistry)
from howtotrainyourmamlpytorch_tpu.utils.tracing import (
    JsonlLogger as JaxJsonl)
from howtotrainyourmamlpytorch_tpu_torch import train_maml_system as cli
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentBuilder
from howtotrainyourmamlpytorch_tpu_torch.resilience import cluster, elastic
from howtotrainyourmamlpytorch_tpu_torch.telemetry import MetricsRegistry
from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import (JsonlLogger,
                                                               read_jsonl)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = (jcluster, jelastic, JaxRegistry, JaxJsonl)
PORT = (cluster, elastic, MetricsRegistry, JsonlLogger)
# JAX's process-group trio -> the port's env:// variables.
PG = {"JAX_COORDINATOR_ADDRESS": ("MASTER_ADDR", "MASTER_PORT"),
      "JAX_NUM_PROCESSES": ("WORLD_SIZE",), "JAX_PROCESS_ID": ("RANK",)}


@pytest.fixture(autouse=True)
def _clean_process_state():
    prev = [(m.install(None), m) for m in (cluster, jcluster)]
    yield
    for p, m in prev:
        m.install(p)


def test_names_are_the_jax_packages():
    for name in ("GEN_ENV", "ROSTER_ENV", "ORIG_ENV", "ADVERTISE_ENV",
                 "ROSTER_FILE", "PROPOSAL_PREFIX", "REJOIN_PREFIX",
                 "RESHARD_EVENT", "RE_EXPAND_EVENT", "RESHARDS_COUNTER",
                 "DEGRADED_EPOCHS_COUNTER", "RE_EXPANSIONS_COUNTER",
                 "REFUSALS_COUNTER", "GENERATION_GAUGE", "LOST_HOSTS_GAUGE"):
        assert getattr(elastic, name) == getattr(jelastic, name)
    assert (elastic.proposal_path("d", 3, 2)
            == jelastic.proposal_path("d", 3, 2))
    assert elastic.rejoin_path("d", 1) == jelastic.rejoin_path("d", 1)


@pytest.mark.parametrize("proposals,members", [
    ({0: [1]}, [0, 1]), ({0: [3]}, [0, 1, 2, 3]),
    ({0: [3], 1: [3], 2: [3]}, [0, 1, 2, 3]),
    ({0: [3], 1: [3]}, [0, 1, 2, 3]), ({0: [2, 3], 1: [3]}, [0, 1, 2, 3]),
    ({0: [1], 1: [0]}, [0, 1]), ({1: [0], 2: [0]}, [0, 1, 2]), ({}, [0])])
def test_roster_consensus_and_rerank_equal_jax(proposals, members):
    got = elastic.roster_consensus(proposals, members)
    assert got == jelastic.roster_consensus(proposals, members)
    for h in got[0]:
        assert elastic.rerank(got[0], h) == jelastic.rerank(got[0], h)


@pytest.mark.parametrize("args", [
    (1, {"generation": 1, "roster": [0], "orig_processes": 2}, {0: 0.2},
     1.5),
    (0, {"generation": 1, "roster": [0], "orig_processes": 2}, {0: 0.2},
     1.5),
    (1, {"generation": 1, "roster": [0], "orig_processes": 2}, {0: 99.0},
     1.5),
    (1, None, {}, 1.5),
    (1, {"generation": 2, "roster": [0, 1], "orig_processes": 2}, {0: .2},
     1.5),
    (0, {"generation": 1, "roster": [1, 2], "orig_processes": 3},
     {0: 0.1, 1: 50.0}, 3.0)])
def test_startup_disposition_equal_jax(args):
    assert (elastic.startup_disposition(*args)
            == jelastic.startup_disposition(*args))


@pytest.mark.parametrize("roster,orig,lost,dcn", [
    ([0, 1, 2, 3], 4, 2, 4), ([0, 1, 2], 4, 2, 3), ([0, 1], 2, 1, 1),
    ([0, 1, 2], 3, 1, 3), ([1, 2], 3, 1, 2)])
def test_should_reshard_equal_jax(roster, orig, lost, dcn):
    kw = dict(lease_dir="/nonexistent", process_index=0, roster=roster,
              generation=orig - len(roster), orig_processes=orig,
              max_lost_hosts=lost, timeout_s=1.0, mesh_dcn=dcn)
    ours, ref = elastic.ElasticPolicy(**kw), jelastic.ElasticPolicy(**kw)
    for suspects in ([], [0], [1], [1, 2], [1, 2, 3], [1, 1]):
        assert ours.should_reshard(suspects) == ref.should_reshard(suspects)
    assert ours.degraded == ref.degraded
    assert ours.missing_hosts() == ref.missing_hosts()
    assert ours.full_roster_doc("c")["roster"] == ref.full_roster_doc(
        "c")["roster"]


@pytest.mark.parametrize("env", [
    {}, {elastic.GEN_ENV: "0"},
    {elastic.GEN_ENV: "1", elastic.ROSTER_ENV: "0", elastic.ORIG_ENV: "2"},
    {elastic.GEN_ENV: "1", elastic.ROSTER_ENV: "1", elastic.ORIG_ENV: "3"},
    {elastic.GEN_ENV: "1", elastic.ROSTER_ENV: "2,1", elastic.ORIG_ENV: "3"},
    {elastic.GEN_ENV: "2", elastic.ROSTER_ENV: "0,1,2",
     elastic.ORIG_ENV: "3"}])
def test_parse_and_apply_roster_equal_jax(env):
    assert elastic.parse_roster_env(env) == tuple(
        jelastic.parse_roster_env(env) or ()) or (
        elastic.parse_roster_env(env) is None
        and jelastic.parse_roster_env(env) is None)
    kw = dict(batch_size=12, mesh_shape=(3, 1), task_microbatches=12,
              continue_from_epoch="from_scratch", elastic_mode=1,
              cluster_collective_timeout_s=12.0, num_evaluation_tasks=48)
    if env.get(elastic.ORIG_ENV, "3") != "3":
        # A roster of another pod size than the mesh's dcn axis: refused
        # alike.
        with pytest.raises(ValueError, match="dcn extent"):
            jelastic.apply_roster(JaxConfig(**kw), environ=env)
        with pytest.raises(ValueError, match="dcn extent"):
            elastic.apply_roster(MAMLConfig(**kw), environ=env)
        return
    ours, ours_state = elastic.apply_roster(MAMLConfig(**kw), environ=env)
    ref, ref_state = jelastic.apply_roster(JaxConfig(**kw), environ=env)
    assert (ours_state is None) == (ref_state is None)
    if ours_state is not None:
        assert tuple(ours_state) == tuple(ref_state)
        assert ours_state.degraded == ref_state.degraded
    for field in ("mesh_shape", "elastic_pad_tasks", "eval_batch_size",
                  "task_microbatches", "continue_from_epoch", "batch_size"):
        assert getattr(ours, field) == getattr(ref, field), field


def _translated(jax_env):
    """The JAX exec env with its process-group trio renamed to the
    port's variables (the coordinator split into address and port)."""
    out = {k: v for k, v in jax_env.items() if k not in PG}
    if "JAX_COORDINATOR_ADDRESS" in jax_env:
        addr, _, port = jax_env["JAX_COORDINATOR_ADDRESS"].rpartition(":")
        out.update(MASTER_ADDR=addr, MASTER_PORT=port,
                   WORLD_SIZE=jax_env["JAX_NUM_PROCESSES"],
                   RANK=jax_env["JAX_PROCESS_ID"])
    return out


@pytest.mark.parametrize("doc,host,one_node", [
    ({"generation": 2, "roster": [0, 2, 3], "orig_processes": 4,
      "coordinator": "10.0.0.1:7777"}, 3, False),
    ({"generation": 1, "roster": [1, 2], "orig_processes": 3,
      "coordinator": "127.0.0.1:4242"}, 1, True),
    ({"generation": 1, "roster": [1, 2], "orig_processes": 3,
      "coordinator": "127.0.0.1:4242"}, 2, True),
    ({"generation": 1, "roster": [1], "orig_processes": 2,
      "coordinator": "x:1"}, 1, True)])
def test_exec_env_is_the_jax_trio_in_the_ports_names(doc, host, one_node):
    jax_in = {"MAML_FAULTS": "kill_peer@3", "OTHER": "kept",
              "JAX_COORDINATOR_ADDRESS": "old:1", "JAX_NUM_PROCESSES": "4",
              "JAX_PROCESS_ID": "3"}
    world = str(doc["orig_processes"])
    port_in = {"MAML_FAULTS": "kill_peer@3", "OTHER": "kept",
               "MASTER_ADDR": "old", "MASTER_PORT": "1", "WORLD_SIZE": world,
               "RANK": "1", "LOCAL_RANK": "0" if not one_node else "1",
               "LOCAL_WORLD_SIZE": world if one_node else "1"}
    ref = _translated(jelastic.exec_env(doc, host, environ=jax_in))
    ours = elastic.exec_env(doc, host, environ=port_in)
    local = {k: ours.pop(k) for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE")
             if k in ours}
    assert ours == ref
    assert "MAML_FAULTS" not in ours and ours["OTHER"] == "kept"
    if len(doc["roster"]) <= 1:
        assert not (set(elastic.PG_ENV_KEYS) & set(ours)) and not local
    elif one_node:
        assert local == {"LOCAL_RANK": ours["RANK"],
                         "LOCAL_WORLD_SIZE": str(len(doc["roster"]))}
    else:
        assert local == {"LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}
    assert tuple(elastic.parse_roster_env(ours)) == tuple(
        jelastic.parse_roster_env(ref))
    # adopt_env in place: the same result, removed keys dropped.
    adopted = dict(port_in)
    elastic.adopt_env(doc, host, environ=adopted)
    assert {k: v for k, v in adopted.items()
            if k not in ("LOCAL_RANK", "LOCAL_WORLD_SIZE")} == ours


def _stale_peer(clu, lease_dir, host, age_s=120.0):
    os.makedirs(lease_dir, exist_ok=True)
    path = clu.lease_path(lease_dir, host)
    with open(path, "w") as f:
        f.write("{}")
    past = time.time() - age_s
    os.utime(path, (past, past))


def _reshard(pkg, tmp_path, roster, self_rank, dead, proposed=(),
             max_lost=1, newer_roster=False, jsonl_on=True):
    """One attributed trip on a policy of ``pkg`` with an injected exec;
    ``proposed`` are peers' proposals written beforehand."""
    clu, el, Reg, Jsonl = pkg
    reg = Reg()
    jsonl = Jsonl(str(tmp_path / "events.jsonl"), enabled=jsonl_on)
    trips, execs = [], []
    domain = clu.ClusterFaultDomain(
        lease_dir=str(tmp_path / "cluster"), process_index=self_rank,
        num_processes=len(roster), collective_timeout_s=2.0,
        stalled_after_s=1.0, dead_after_s=2.0, lease_interval_s=0.1,
        registry=reg, jsonl=jsonl, on_trip=trips.append)
    policy = el.ElasticPolicy(
        lease_dir=domain.lease.lease_dir, process_index=self_rank,
        roster=roster, generation=0, orig_processes=len(roster),
        max_lost_hosts=max_lost, timeout_s=1.0, mesh_dcn=len(roster),
        lease=domain.lease, registry=reg, jsonl=jsonl,
        # JAX re-execs [sys.executable] + argv; the port the whole
        # command line (sys.orig_argv by default).
        argv=(["-m", "trainer", "--x", "1"] if el is jelastic
              else ["python", "-m", "trainer", "--x", "1"]))
    policy._exec = lambda exe, argv, env: execs.append((argv, env))
    domain.elastic = policy
    domain.heartbeat(force=True)
    for h in roster:
        if h != roster[self_rank]:
            _stale_peer(clu, domain.lease.lease_dir, h,
                        120.0 if h in dead else 0.0)
    for h, d in proposed:
        el.write_proposal(domain.lease.lease_dir, 1, h,
                          {"host": h, "dead": d, "coordinator": f"c{h}:9"})
    if newer_roster:
        el.write_roster(domain.lease.lease_dir,
                        {"generation": 1, "roster": [1],
                         "orig_processes": 2, "coordinator": "c"})
    domain.trip_peer_lost({"phase": "collective", "detail": "gather",
                           "age_seconds": 2.5, "deadline_seconds": 2.0})
    domain.close()
    doc = el.read_roster(domain.lease.lease_dir) or {}
    props = el.read_proposals(domain.lease.lease_dir, 1)
    events = (read_jsonl(str(tmp_path / "events.jsonl"))
              if os.path.exists(tmp_path / "events.jsonl") else [])
    rows = [e for e in events if e["event"] == el.RESHARD_EVENT]
    return {
        "execs": len(execs), "argv": execs[0][0][1:] if execs else None,
        "env": ({k: v for k, v in execs[0][1].items()
                 if k.startswith("MAML_ELASTIC")} if execs else None),
        "exec_env": execs[0][1] if execs else None,
        "trips": [t["suspect_hosts"] for t in trips],
        "roster": {k: doc.get(k) for k in ("generation", "roster", "dead",
                                           "orig_processes")},
        "coordinator": doc.get("coordinator"),
        "my_dead": props.get(roster[self_rank], {}).get("dead"),
        "rows": [{k: r[k] for k in ("generation", "roster", "dead",
                                    "suspects", "orig_processes")}
                 for r in rows],
        "reshards": reg.counter(el.RESHARDS_COUNTER).value,
        "refusals": reg.counter(el.REFUSALS_COUNTER).value,
        "peer_losses": reg.counter(clu.PEER_LOSSES_COUNTER).value,
    }


@pytest.mark.parametrize("case", [
    dict(roster=[0, 1], self_rank=0, dead=[1]),
    dict(roster=[0, 1, 2], self_rank=1, dead=[0], proposed=[(2, [0])]),
    dict(roster=[0, 1, 2], self_rank=2, dead=[0], proposed=[(1, [0])]),
    dict(roster=[0, 1, 2], self_rank=0, dead=[1, 2]),
    dict(roster=[0, 1], self_rank=0, dead=[1], newer_roster=True),
    dict(roster=[0, 1, 2], self_rank=0, dead=[1], proposed=[(2, [0])])],
    ids=["lone_survivor", "host0_lost_rank1", "host0_lost_rank2",
         "over_budget", "newer_roster", "mutual_accusation"])
def test_trip_to_reshard_equals_jax(case, tmp_path):
    """The same trip through both packages: proposals, the agreed roster,
    the reshard row and counters, the exec (argv as given; the roster
    trio) or the fall-back to the attributed exit (``on_trip``)."""
    ref = _reshard(JAX, tmp_path / "jax", **case)
    ours = _reshard(PORT, tmp_path / "port", **case)
    ref_env, our_env = ref.pop("exec_env"), ours.pop("exec_env")
    ref_coord, our_coord = ref.pop("coordinator"), ours.pop("coordinator")
    assert ours == ref
    if ours["execs"]:
        assert ours["argv"] == ["-m", "trainer", "--x", "1"]
        assert _translated(ref_env).keys() - {"MASTER_ADDR", "MASTER_PORT"}\
            <= our_env.keys()
        if len(ours["roster"]["roster"]) > 1:
            # The coordinator is the new rank 0's candidate.
            assert our_coord == f"{our_env['MASTER_ADDR']}:" \
                                f"{our_env['MASTER_PORT']}"
            assert our_env["RANK"] == _translated(ref_env)["RANK"]
        else:
            assert not set(elastic.PG_ENV_KEYS) & set(our_env)
    else:
        assert ours["trips"] and (ours["refusals"] >= 1
                                  or ours["roster"]["generation"] is None
                                  or case.get("newer_roster"))
    if case["dead"] == [0] and case["self_rank"] == 1:
        assert ours["roster"]["roster"] == [1, 2] and ours["rows"]


def test_the_next_rank_0_records_a_reshard_its_writer_missed(tmp_path):
    """Host 0 (the run's only writer of events.jsonl) dies: the survivor
    that becomes rank 0 of generation 1 logs the reshard row and flushes
    the registry, so the run's log holds the reshard; the other survivor
    still writes nothing."""
    rank1 = _reshard(PORT, tmp_path / "r1", [0, 1, 2], 1, [0],
                     proposed=[(2, [0])], jsonl_on=False)
    assert len(rank1["rows"]) == 1 and rank1["rows"][0]["roster"] == [1, 2]
    events = read_jsonl(str(tmp_path / "r1" / "events.jsonl"))
    assert [e["metrics"][elastic.RESHARDS_COUNTER] for e in events
            if e["event"] == "metrics"] == [1]
    rank2 = _reshard(PORT, tmp_path / "r2", [0, 1, 2], 2, [0],
                     proposed=[(1, [0])], jsonl_on=False)
    assert rank2["execs"] == 1 and rank2["rows"] == []
    assert not os.path.exists(tmp_path / "r2" / "events.jsonl")


REEXEC_MODULE = '''
import json, os, sys
sys.path.insert(0, os.environ["REPO"])
from howtotrainyourmamlpytorch_tpu_torch.resilience import elastic
if elastic.parse_roster_env() is None:
    policy = elastic.ElasticPolicy(
        lease_dir=os.environ["LEASE"], process_index=0, roster=[0, 1],
        generation=0, orig_processes=2, max_lost_hosts=1, timeout_s=1.0,
        mesh_dcn=2)
    policy.exec_into({"generation": 1, "roster": [0],
                      "orig_processes": 2, "coordinator": "x:1"})
print(json.dumps({"name": __name__, "spec": __spec__.name,
                  "argv": sys.argv[1:],
                  "roster": list(elastic.parse_roster_env())}))
'''


def test_a_dash_m_launch_is_reexecd_as_the_module(tmp_path):
    """``python -m <module> args``: the restart in place (a real
    ``os.execve``) runs the module again as a module, with its args and
    the new roster env (``sys.argv`` would name the module's file, and
    re-running that path would run it as a script)."""
    (tmp_path / "reexec_probe.py").write_text(textwrap.dedent(
        REEXEC_MODULE))
    env = dict(os.environ, REPO=REPO, LEASE=str(tmp_path / "cluster"),
               PYTHONPATH=str(tmp_path))
    for key in (elastic.GEN_ENV, elastic.ROSTER_ENV, elastic.ORIG_ENV):
        env.pop(key, None)
    proc = subprocess.run([sys.executable, "-m", "reexec_probe", "--a", "1"],
                          capture_output=True, text=True, timeout=120,
                          env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"name": "__main__", "spec": "reexec_probe",
                   "argv": ["--a", "1"], "roster": [1, [0], 2]}
    assert "elastic: re-expanding to generation 1" in proc.stdout


def _tiny(tmp_path, **kw):
    base = dict(experiment_root=str(tmp_path), dataset_name="synthetic_pod",
                image_height=10, image_width=10, image_channels=1,
                num_classes_per_set=3, num_samples_per_class=1,
                num_target_samples=2, batch_size=2, cnn_num_filters=4,
                num_stages=2, number_of_training_steps_per_iter=1,
                number_of_evaluation_steps_per_iter=1, second_order=False,
                use_multi_step_loss_optimization=False, total_epochs=2,
                total_iter_per_epoch=2, num_evaluation_tasks=2,
                max_models_to_save=1, compute_dtype="float32",
                cluster_collective_timeout_s=300.0, elastic_mode=1)
    base.update(kw)
    return MAMLConfig(**base)


def test_maybe_re_expand_writes_full_roster_and_execs(tmp_path):
    """With every missing host's rejoin file present the survivor writes
    the next generation's FULL roster and restarts in place (the exec
    env of the port's names); without one it keeps training."""
    builder = ExperimentBuilder(_tiny(tmp_path), device="cpu")
    execs = []
    policy = elastic.ElasticPolicy(
        lease_dir=os.path.join(builder.paths["base"], cluster.LEASE_DIR),
        process_index=0, roster=[0], generation=1, orig_processes=2,
        max_lost_hosts=1, timeout_s=1.0, mesh_dcn=1,
        registry=builder.registry, jsonl=builder.jsonl)
    policy._exec = lambda exe, argv, env: execs.append(env)
    builder._elastic = policy
    builder._maybe_re_expand()
    assert not execs
    elastic.write_rejoin(policy.lease_dir, 1)
    builder._maybe_re_expand()
    assert len(execs) == 1
    env = execs[0]
    assert (env[elastic.GEN_ENV], env[elastic.ROSTER_ENV]) == ("2", "0,1")
    assert (env["WORLD_SIZE"], env["RANK"]) == ("2", "0")
    doc = elastic.read_roster(policy.lease_dir)
    assert doc["generation"] == 2 and doc["roster"] == [0, 1]
    assert env["MASTER_PORT"] == doc["coordinator"].rpartition(":")[2]
    rows = [e for e in read_jsonl(os.path.join(builder.paths["logs"],
                                               "events.jsonl"))
            if e["event"] == elastic.RE_EXPAND_EVENT]
    assert len(rows) == 1 and rows[0]["generation"] == 2
    assert builder.registry.counter(
        elastic.RE_EXPANSIONS_COUNTER).value == 1
    builder._re_expand_sock.close()


def test_run_installs_elastic_iff_enabled(tmp_path, monkeypatch):
    seen = {}

    def probe(builder):
        def stub():
            seen.update(cluster=builder._cluster, elastic=builder._elastic,
                        attached=getattr(builder._cluster, "elastic", None))
            return {"paused_at_iter": builder.current_iter}
        return stub
    off = ExperimentBuilder(_tiny(tmp_path / "off", elastic_mode=0),
                            device="cpu")
    monkeypatch.setattr(off, "_run_experiment", probe(off))
    off.run_experiment()
    assert seen["cluster"] is not None and seen["elastic"] is None
    on = ExperimentBuilder(_tiny(tmp_path / "on"), device="cpu")
    monkeypatch.setattr(on, "_run_experiment", probe(on))
    on.run_experiment()
    assert isinstance(seen["elastic"], elastic.ElasticPolicy)
    assert seen["attached"] is seen["elastic"]
    assert (seen["elastic"].roster, seen["elastic"].generation) == ((0,), 0)
    assert on._elastic is None and cluster.get() is None


def test_cli_gate_backfills_into_the_next_generation(tmp_path, monkeypatch):
    """The CLI's start-up gate with ``RANK=1``: a live degraded group
    whose roster excludes this host makes it wait; the re-expanded roster
    that includes it is adopted in place (the port's variables, no stale
    fault plan); a stale roster of a dead group is archived."""
    cfg = _tiny(tmp_path, experiment_name="pod")
    lease_dir = os.path.join(str(tmp_path), "pod", cluster.LEASE_DIR)
    elastic.write_roster(lease_dir, {"generation": 1, "roster": [0],
                                     "orig_processes": 2,
                                     "coordinator": "127.0.0.1:1"})
    lease = cluster.HeartbeatLease(lease_dir, 0, 0.05)
    lease.touch(force=True)
    for key, value in (("RANK", "1"), ("WORLD_SIZE", "2"),
                       ("MASTER_ADDR", "a"), ("MASTER_PORT", "1"),
                       ("MAML_FAULTS", "kill_peer@3")):
        monkeypatch.setenv(key, value)
    # Unset, and recorded so that teardown also removes what the gate
    # writes into os.environ (a delenv of an absent key records nothing).
    for key in (elastic.GEN_ENV, elastic.ROSTER_ENV, elastic.ORIG_ENV):
        monkeypatch.setenv(key, "0")
        monkeypatch.delenv(key)
    real_wait = elastic.backfill_wait
    monkeypatch.setattr(elastic, "backfill_wait",
                        lambda d, h, s: real_wait(d, h, s, poll_s=0.1,
                                                  timeout_s=20.0))

    def promote():
        time.sleep(0.5)
        lease.touch(force=True)
        elastic.write_roster(lease_dir, {
            "generation": 2, "roster": [0, 1], "orig_processes": 2,
            "coordinator": "127.0.0.1:4343"})
    t = threading.Thread(target=promote)
    t.start()
    cli._elastic_gate(cfg)
    t.join()
    assert os.environ[elastic.GEN_ENV] == "2"
    assert (os.environ["MASTER_PORT"], os.environ["RANK"],
            os.environ["WORLD_SIZE"]) == ("4343", "1", "2")
    assert "MAML_FAULTS" not in os.environ
    assert elastic.read_rejoins(lease_dir) == []
    # A stale roster of a dead group: launched full, the roster retired.
    for key in (elastic.GEN_ENV, elastic.ROSTER_ENV, elastic.ORIG_ENV):
        monkeypatch.delenv(key, raising=False)
    past = time.time() - 600.0
    os.utime(lease.path, (past, past))
    cli._elastic_gate(cfg)
    assert elastic.read_roster(lease_dir) is None
    assert any(n.startswith(elastic.ROSTER_FILE + ".gen2")
               for n in os.listdir(lease_dir))
