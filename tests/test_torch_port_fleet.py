"""The port's fleet (``serve/fleet/``: router, controller, supervisor,
replica; ``serve/loadlab/``) against the JAX package's copies, on the
same scripted inputs: ring placement, routing keys, bounded-load spill,
the rolling-swap state machine tick by tick, the crash-loop breaker and
the supervisor's slots, ``advise``, the traffic generators and trace
files. Then the sibling modules the port's supervisor and loaders
resolve (never the JAX package's, even when that was imported first),
the replica's start-up guard and device rule, and
``scripts/torch_fleet_bench.py --quick --device cpu`` with 2 replica
processes.
"""

import importlib
import itertools
import json
import os
import random
import subprocess
import sys
import time

import numpy as np
import pytest

from helpers import _can_bind_localhost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "howtotrainyourmamlpytorch_tpu_torch")
PKGS = {"jax": "howtotrainyourmamlpytorch_tpu",
        "port": "howtotrainyourmamlpytorch_tpu_torch"}

needs_sockets = pytest.mark.skipif(
    not _can_bind_localhost(),
    reason="fleet replicas serve over localhost sockets, which this "
           "sandbox cannot bind")


def _mod(pkg, name):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


class _Counter:
    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        self.value += n


class _Gauge:
    def __init__(self):
        self.value = None

    def set(self, v):
        self.value = v


class _Reg:
    def __init__(self):
        self.counters, self.gauges = {}, {}

    def counter(self, name):
        return self.counters.setdefault(name, _Counter())

    def gauge(self, name):
        return self.gauges.setdefault(name, _Gauge())

    def values(self):
        return ({k: c.value for k, c in self.counters.items()},
                {k: g.value for k, g in self.gauges.items()})


def _arrays(n):
    rng = np.random.RandomState(0)
    return [(rng.randint(0, 256, (3, 4, 4, 1)).astype(np.uint8),
             (np.arange(3) % 3).astype(np.int32)) for _ in range(n)]


def test_routing_key_and_ring_placement_match_jax():
    arrays = _arrays(1000)
    routers = [_mod(p, "serve.fleet.router") for p in ("jax", "port")]
    keys = [[r.routing_key(sx, sy) for sx, sy in arrays] for r in routers]
    assert keys[0] == keys[1]
    for members, vnodes in (([0, 1, 2], 64), ([0, 2, 5, 7], 128)):
        rings = [r.HashRing(members, vnodes=vnodes) for r in routers]
        placed = [[ring.primary(k) for k in keys[0]] for ring in rings]
        assert placed[0] == placed[1]
        assert set(placed[1]) == set(members)
        cands = [[ring.candidates(k) for k in keys[0][:50]]
                 for ring in rings]
        assert cands[0] == cands[1]
    fractions = [[r.canary_fraction(f"t{i}", i) for i in range(50)]
                 for r in routers]
    assert fractions[0] == fractions[1]


def _announce(router_mod, fleet_dir, rid):
    lease = router_mod.ReplicaLease(str(fleet_dir), rid, interval_s=0.0)
    assert lease.touch({"port": 9000 + rid}, force=True)
    return lease


def test_bounded_load_spill_matches_jax(tmp_path):
    """The same hot and cold keys routed through both routers, with and
    without completions: the same replica picks and spill counts."""
    keys = [routing_key for routing_key in
            (_mod("port", "serve.fleet.router").routing_key(sx, sy)
             for sx, sy in _arrays(6))]
    picks, spills = [], []
    for pkg in ("jax", "port"):
        rmod = _mod(pkg, "serve.fleet.router")
        fleet_dir = tmp_path / pkg
        leases = [_announce(rmod, fleet_dir, rid) for rid in (0, 1, 2)]
        reg = _Reg()
        router = rmod.FleetRouter(str(fleet_dir), load_factor=1.25,
                                  stalled_after_s=60.0, dead_after_s=120.0,
                                  registry=reg)
        router.refresh()
        seq = [router.route(keys[0]) for _ in range(12)]
        for r in seq[:6]:
            router.complete(r)
        seq += [router.route(k) for k in keys[1:]]
        picks.append(seq)
        spills.append(reg.counters[rmod.SPILLS_COUNTER].value)
        assert leases
    assert picks[0] == picks[1] and spills[0] == spills[1] > 0


class _FakeFleet:
    def __init__(self, rids):
        self.members = {r: {"state": "live", "age": 0.0, "draining": False,
                            "payload": {"version": 1, "stats": {}}}
                        for r in rids}

    def __call__(self):
        return {r: dict(rec) for r, rec in self.members.items()}


_VOLATILE = {"updated_ts", "started_ts", "ts", "halt_ts"}


def _doc(doc):
    return {k: v for k, v in doc.items() if k not in _VOLATILE}


def _rollout_script(fc, root):
    """A scripted rolling swap: a happy rollout, a canary-fail halt with
    its fleet-wide pin, a retry refused, a newer version, a death
    mid-swap. Returns every tick's record and the counters."""
    reg = _Reg()
    fleet = _FakeFleet([0, 1, 2])
    ctl = fc.FleetController(str(root), fleet, registry=reg)
    docs = [_doc(ctl.start_rollout(2)), _doc(ctl.tick())]
    for rid in (0, 1, 2):
        fleet.members[rid]["payload"] = {"version": 2}
        docs.append(_doc(ctl.tick()))
        docs.append({"drains": sorted(
            r for r in (0, 1, 2) if os.path.exists(ctl._drain_path(r)))})
    docs.append(_doc(ctl.tick()))
    docs.append(_doc(ctl.start_rollout(3)))
    fleet.members[0]["payload"] = {"version": 2, "swap_failed": 3}
    docs.append(_doc(ctl.tick()))
    docs.append(_doc(ctl.start_rollout(3)))
    docs.append(_doc(ctl.start_rollout(4)))
    fleet.members[0]["state"] = "dead"
    docs.append(_doc(ctl.tick()))
    return docs, reg.values()


def test_rolling_swap_state_machine_matches_jax(tmp_path):
    outs = [_rollout_script(_mod(p, "serve.fleet.controller"),
                            tmp_path / p) for p in ("jax", "port")]
    assert outs[0] == outs[1]
    fc = _mod("port", "serve.fleet.controller")
    docs, (counters, _) = outs[1]
    assert [d.get("state") for d in docs if "state" in d][-1] == fc.HALTED
    assert fc.DONE in [d.get("state") for d in docs]
    assert counters[fc.SWAPS_COUNTER] == 1
    assert counters[fc.HALTS_COUNTER] == 2


def test_advise_and_signals_match_jax(tmp_path):
    results = []
    for pkg in ("jax", "port"):
        fc = _mod(pkg, "serve.fleet.controller")
        fleet = _FakeFleet([0, 1])
        fleet.members[0]["payload"] = {"stats": {
            "queue_depth": 70, "p95_ms": 250.0, "cache_hit_frac": 0.9,
            "l2_hits": 5, "l2_misses": 2, "l2_errors": 0, "responses": 10}}
        fleet.members[1]["payload"] = {"stats": {
            "queue_depth": 10, "p95_ms": 900.0, "cache_hit_frac": 0.4,
            "l2_hits": 1, "l2_misses": 1, "l2_errors": 1, "responses": 4}}
        reg = _Reg()
        ctl = fc.FleetController(str(tmp_path / pkg), fleet, registry=reg)
        sig = ctl.publish_signals()
        advice = [fc.advise(sig, live=2),
                  fc.advise({"queue_depth_total": 0, "p95_ms_max": 50.0},
                            live=2),
                  fc.advise({"queue_depth_total": 0, "p95_ms_max": 50.0},
                            live=1),
                  fc.advise({"queue_depth_total": 5, "p95_ms_max": 50.0,
                             "slo_burn_rate": 3.0}, live=2)]
        results.append((sig, advice, reg.values()))
    assert results[0] == results[1]
    assert results[1][1][:3] == ["scale_up", "scale_down", "hold"]


class _FakeProc:
    _pids = itertools.count(4000)

    def __init__(self):
        self.pid = next(_FakeProc._pids)
        self.exit_code = None

    def poll(self):
        return self.exit_code

    def terminate(self):
        self.exit_code = 0

    def kill(self):
        self.exit_code = -9


def _supervisor_script(fsup, root):
    """A slot that crash-loops and trips the breaker while the spare
    backfills, then an operator reset; every tick's slot states."""
    spawned = {}

    def spawn(slot):
        proc = _FakeProc()
        spawned.setdefault(slot, []).append(proc)
        return proc
    reg = _Reg()
    sup = fsup.ReplicaSupervisor(
        str(root), spawn, registry=reg, desired=1, scale_max=2,
        max_restarts=2, restart_window_s=60.0, backoff_base_s=0.01,
        backoff_cap_s=0.02, rng=random.Random(0))
    t0 = 1000.0
    states = [dict(sup.tick(t0))]
    spawned[0][0].exit_code = 1
    states.append(dict(sup.tick(t0 + 1.0)))
    states.append(dict(sup.tick(t0 + 2.0)))
    spawned[0][1].exit_code = 1
    states.append(dict(sup.tick(t0 + 3.0)))
    states.append(dict(sup.tick(t0 + 4.0)))
    sup.reset_slot(0)
    states.append({s: r["state"] for s, r in sup.slots.items()})
    breaker = fsup.CrashLoopBreaker(max_restarts=3, window_s=10.0)
    trips = [breaker.record_restart(0, t) for t in (0.0, 1.0, 2.0, 20.0,
                                                    21.0, 22.0)]
    return states, reg.values(), {s: len(p) for s, p in spawned.items()}, \
        trips


def test_supervisor_and_crash_loop_breaker_match_jax(tmp_path):
    outs = [_supervisor_script(_mod(p, "serve.fleet.supervisor"),
                               tmp_path / p) for p in ("jax", "port")]
    assert outs[0] == outs[1]
    fsup = _mod("port", "serve.fleet.supervisor")
    states, (counters, _), _, trips = outs[1]
    assert states[3][0] == fsup.FAILED
    assert counters[fsup.CRASH_LOOPS_COUNTER] == 1
    assert trips == [False, False, True, False, False, True]


def test_supervisor_siblings_are_the_ports_after_the_jax_ones():
    """A process that imported the JAX supervisor first (and made it
    resolve its router and retry modules) still gets the port's router
    and backoff from the port's supervisor, under the port's own
    aliases."""
    code = (
        "import sys, os\n"
        "sys.path.insert(0, '.')\n"
        "from howtotrainyourmamlpytorch_tpu.serve.fleet import (\n"
        "    supervisor as jsup)\n"
        "jsup.router_mod(); jsup.backoff_delay(1, base=0.05, cap=2.0)\n"
        "from howtotrainyourmamlpytorch_tpu_torch.serve.fleet import (\n"
        "    supervisor as psup)\n"
        "port = os.path.abspath('howtotrainyourmamlpytorch_tpu_torch')\n"
        "r = psup.router_mod()\n"
        "assert r.__file__.startswith(port), r.__file__\n"
        "assert psup.backoff_delay(0, base=0.05, cap=2.0) == 0.05\n"
        "b = sys.modules[psup._backoff_cached.__module__]\n"
        "assert b.__file__.startswith(port), b.__file__\n"
        "assert r is not jsup.router_mod()\n"
        "print('PORT_SIBLINGS_OK')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "PORT_SIBLINGS_OK" in out.stdout


def test_file_path_loads_resolve_the_ports_modules(tmp_path):
    """Loaded by file path (no package import), the port's supervisor,
    router and workloads resolve the port's router, request-trace and
    trace modules, by file, under aliases the JAX package never uses."""
    code = (
        "import importlib.util, os, sys\n"
        "port = os.path.abspath('howtotrainyourmamlpytorch_tpu_torch')\n"
        "def load(name, rel):\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name, os.path.join(port, rel))\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    return mod\n"
        "sup = load('s', 'serve/fleet/supervisor.py')\n"
        "rt = load('r', 'serve/fleet/router.py')\n"
        "wl = load('w', 'serve/loadlab/workloads.py')\n"
        "for m in (sup.router_mod(), rt.reqtrace_mod(), wl.trace_mod()):\n"
        "    assert m.__file__.startswith(port), m.__file__\n"
        "    assert not m.__name__.startswith('_maml_fleet'), m.__name__\n"
        "assert 'torch' not in sys.modules and 'jax' not in sys.modules\n"
        "print('FILE_PATH_OK')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "FILE_PATH_OK" in out.stdout


def test_loadlab_generators_and_trace_files_match_jax(tmp_path):
    outs = []
    for pkg in ("jax", "port"):
        wl = _mod(pkg, "serve.loadlab.workloads")
        tr = _mod(pkg, "serve.loadlab.trace")
        rp = _mod(pkg, "serve.loadlab.replay")
        rng = np.random.RandomState(3)
        pool = wl.tenant_pool((8, 8, 1), 3, True, rng, [(3, 4)], 5)
        arrays = wl.synthetic_arrays((8, 8, 1), 3, True, rng, (3, 4))
        recs = wl.gen_diurnal_trace(duration_s=20.0, base_rate=5.0,
                                    peak_rate=15.0, period_s=10.0,
                                    num_tenants=12, active_tenants=4,
                                    churn_every_s=5.0, buckets=[(3, 4)],
                                    seed=7)
        recs = wl.overlay_burst(recs, at_s=5.0, duration_s=2.0, rate=20.0,
                                num_tenants=3, buckets=[(3, 4)], seed=8)
        path = str(tmp_path / f"{pkg}{tr.TRACE_SUFFIX}")
        tr.write_trace(path, recs, meta={"seed": 7})
        phases = [{"name": "a", "until_s": 10.0},
                  {"name": "b", "until_s": 20.0}]
        stats = rp.phase_stats(recs, phases,
                               {i: float(i % 7) for i in range(len(recs))},
                               lambda v, q: sorted(v)[int(q * (len(v) - 1))])
        outs.append(([(sx.tobytes(), sy.tobytes(), q) for sx, sy, q in pool],
                     [a.tobytes() for a in arrays], recs,
                     open(path, "rb").read(), stats))
    assert outs[0] == outs[1]
    assert len(outs[1][2]) > 0


def test_avoid_fleet_rejected_rolls_back_at_startup(tmp_path):
    """The port replica's start-up guard, as the JAX one: pin the
    fleet-rejected versions, and roll a replica that booted on one back
    to the newest live version that is not."""
    from howtotrainyourmamlpytorch_tpu_torch.ckpt.registry import (
        ModelRegistry)
    from howtotrainyourmamlpytorch_tpu_torch.serve.fleet.replica import (
        avoid_fleet_rejected)
    reg_dir = str(tmp_path / "ckpt")
    registry = ModelRegistry(reg_dir)
    registry.publish(tag="0", epoch=0, val_acc=0.5, fingerprint=111)
    registry.publish(tag="1", epoch=1, val_acc=0.6, fingerprint=222)
    fleet_dir = tmp_path / "fleet"
    fleet_dir.mkdir()
    (fleet_dir / "ROLLOUT.json").write_text(json.dumps(
        {"state": "halted", "version": 2, "rejected": [2]}))

    class _StubEngine:
        def __init__(self, version):
            self._model_version = version
            self._registry_dir = reg_dir
            self.pinned, self.adopted = set(), None

        def pin_rejected(self, v):
            self.pinned.add(v)

        def load_registry_version(self, rec):
            return {"loaded": rec["tag"]}

        def adopt_version(self, rec, state):
            self.adopted = (rec["version"], state)
            self._model_version = rec["version"]

    eng = _StubEngine(2)
    assert avoid_fleet_rejected(eng, str(fleet_dir)) == 1
    assert eng.pinned == {2} and eng.adopted == (1, {"loaded": "0"})
    good = _StubEngine(1)
    assert avoid_fleet_rejected(good, str(fleet_dir)) is None
    assert good.adopted is None and good.pinned == {2}


def test_replica_needs_a_card_unless_cpu_is_asked_for(tmp_path):
    """``replica.main`` without ``--device cpu`` on a box with no card
    raises instead of serving on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from howtotrainyourmamlpytorch_tpu_torch.serve.fleet import replica
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"dataset_name": "synthetic_serve"}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        replica.main(["--config", str(cfg), "--replica-id", "0",
                      "--fleet-dir", str(tmp_path / "fleet"),
                      "--checkpoint", str(tmp_path / "ckpt")])


@needs_sockets
def test_torch_fleet_bench_quick_two_replicas(tmp_path):
    """2 real replica processes on the CPU behind the port's router:
    every request answered, none dropped, and the migrated tenant
    served from L2 with no adapt on its new replica."""
    out = tmp_path / "fb"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "torch_fleet_bench.py"),
         "--quick", "--device", "cpu", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    art = json.loads(proc.stdout.strip().splitlines()[-1])
    assert proc.returncode == 0 and art["status"] == "ok", art
    assert art["backend"] == "torch" and art["replicas"] == 2
    assert art["zero_dropped"] is True
    assert art["fleet"]["responses_ok"] == art["requests"]
    mig = art["migration"]
    assert mig["second_tier"] == "l2" and mig["target_adapt_delta"] == 0
    assert art["bn_act_launches"]["fleet"]["ok"]
    for key in ("fleet_qps", "fleet_l2_hit_frac", "fleet_rolling_swaps",
                "fleet_rolling_swap_halts", "fleet_router_spills"):
        assert key in art, key
