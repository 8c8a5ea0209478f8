"""Pod chaos harness of the PyTorch/CUDA port: SIGKILL a rank, prove the
attributed exit, the consensus resume and the elastic reshard, with real
OS processes.

The port's counterpart of ``scripts/chaos_pod.py``, with its phases, its
last-line artifact and its exit codes, and no JAX:

1. **peer_kill** — start N gloo ranks of the trainer's CLI with the pod
   fault domain armed (``cluster_collective_timeout_s``). Host 1 carries
   ``kill_peer@I`` (mid-epoch 1, after epoch 0's checkpoint): at
   iteration I it SIGKILLs itself before the stop-decision collective.
   The survivor must exit ``EXIT_PEER_LOST`` (73) within the budget +
   slack of the death, with a ``peer_lost`` row and a crash bundle naming
   host 1 and ``cluster/peer_losses`` 1 in ``metrics.prom``.
2. **restart** — all N start again with no fault: every rank resumes at
   the committed epoch's iteration (its file's CRC pinned before and
   after) and the run ends through the test protocol. Then a planted
   disagreement: rank 1 reads the run through a view whose
   ``MANIFEST.json`` lacks the newest epoch (a stale cache of shared
   storage; every other file is the shared one). Every rank must log
   ``consensus_resume``, resume from the older epoch, and retrain to the
   same final checkpoint bytes.
3. **parity** — zero cost when armed: one-process runs with the domain
   off, on, and on with ``elastic_mode=1`` end with bitwise equal
   weights.
4. **elastic** — 3 ranks with ``elastic_mode=1``; host 0 (the checkpoint
   writer and the host of the process group's store) SIGKILLs itself at
   iteration I. Hosts 1 and 2 agree on generation 1 through the lease
   directory and restart in place as ranks 0 and 1 of 2 (the new rank 0
   hosts the store and writes the checkpoints); the run ends with exit 0
   and one reshard. Then a cold 2-rank run launched directly at the
   survivor geometry (``MAML_ELASTIC_*`` set) from a snapshot of the
   same committed state must end with the same final checkpoint bytes.
   On the card the leg arms the warm-start store as the JAX harness
   does: ``scripts/torch_aot_prewarm.py --degraded 1 --degraded-only``
   runs as a child first (it fills the survivor roster's fingerprint
   directory, and builds the kernel if no process has), the ranks run
   with ``aot_store_dir`` (their steps as CUDA graphs around each rank's
   collective), and each survivor must reach
   its first step with ``compiles_before_first_step == 0``, no miss, no
   ``nvcc`` run and no executable demoted to the eager step; the cold
   run is eager, so the survivors' graphs are held bitwise to it. On the
   CPU (no graphs) the leg runs without a store.

The ranks are started here with the ``env://`` variables set (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``), not by torchrun: torchrun's agent sends SIGTERM to the
other workers when one dies (their save-on-signal exit 75 would race the
attributed 73) and an ``exec``'d survivor confuses it. Each rank runs the
trainer's CLI (``train_maml_system.main``) under :func:`rank_main`, which
records per process its host, generation, step times and the BN
kernel's launches (written at its exit, its exit 73 and its exec; a
SIGKILLed rank writes nothing).

Geometry: by default (and with ``--quick``) the JAX harness's tiny pod
config on ``mesh_shape (N, 1)``; ``--config <json>`` takes another
config (e.g. the flagship with its length cuts), on which the pod knobs
are set. ``--device cuda`` (the default) runs every rank on the card
(ranks share it over gloo); ``--device cpu`` on the CPU.

Last stdout line: ``{"metric": "pod_chaos", "status": "recovered" |
"failed" | "skipped", ...}``; exit 0 iff recovered (or skipped: a box
that cannot bind localhost sockets says so instead of failing).

Usage:
    python scripts/torch_chaos_pod.py --quick --device cpu
    python scripts/torch_chaos_pod.py --phases peer_kill,restart
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import zlib

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SCRIPTS = os.path.dirname(os.path.abspath(__file__))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from howtotrainyourmamlpytorch_tpu_torch.utils import reaper  # noqa: E402

NUM_PROCESSES = 2
ELASTIC_PROCESSES = 3
ELASTIC_KILL_HOST = 0
COLLECTIVE_TIMEOUT_S = 12.0
LEASE_INTERVAL_S = 0.5
# Trip-latency slack on top of the collective budget: watchdog poll
# overshoot, the attribution's grace re-read, the bundle and flush drain,
# and scheduling jitter on a shared host.
TRIP_SLACK_S = 60.0
# Each leg's limit for its ranks (--timeout): a rank still running at
# it is killed and the leg fails.
RUN_TIMEOUT_S = 1500.0
NAME = "pod_chaos"
# The process group's env:// variables and the elastic trio: a launch
# sets its own, never the caller's.
_LAUNCH_KEYS = ("MAML_FAULTS", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "MAML_ELASTIC_GENERATION", "MAML_ELASTIC_ROSTER",
                "MAML_ELASTIC_ORIG_PROCESSES")
# One rank: the trainer's CLI under rank_main (re-exec'd as launched by
# an elastic reshard: sys.orig_argv).
RANK_CHILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
              "import torch_chaos_pod as h; sys.exit(h.rank_main(sys.argv[2:]))")


def tiny_cfg_dict() -> dict:
    """scripts/chaos_pod.py § pod_cfg_dict's workload: 3-way 1-shot at
    10x10x1, 2 stages of 4 filters, 2 epochs x 4 iterations."""
    return dict(
        dataset_name="synthetic_pod",
        image_height=10, image_width=10, image_channels=1,
        num_classes_per_set=3, num_samples_per_class=1,
        num_target_samples=2, batch_size=8,
        cnn_num_filters=4, num_stages=2,
        number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=2,
        second_order=False, use_multi_step_loss_optimization=False,
        total_epochs=2, total_iter_per_epoch=4,
        num_evaluation_tasks=4, max_models_to_save=2,
        compute_dtype="float32", meta_learning_rate=0.005)


def pod_cfg_dict(base: dict, out_dir: str, n: int, budget: float,
                 lease: float, **kw) -> dict:
    """``base`` with the pod knobs: every sync point one iteration apart
    (the kill lands deterministically), the domain armed at ``budget``,
    generous generic deadlines (only the cluster budget may trip), and
    ``mesh_shape (n, 1)`` (one process per dcn host) required."""
    cfg = dict(base)
    cfg.update(
        experiment_name=NAME, experiment_root=out_dir,
        dispatch_sync_every=1, live_progress=False,
        mesh_shape=[n, 1], require_mesh=1,
        continue_from_epoch="latest",
        cluster_collective_timeout_s=budget,
        cluster_lease_interval_s=lease,
        watchdog_step_timeout_s=600.0, watchdog_feed_timeout_s=600.0,
        watchdog_collective_timeout_s=600.0,
        watchdog_compile_timeout_s=1200.0,
        watchdog_poll_interval_s=0.25)
    cfg.update(kw)
    return cfg


def kill_iter(cfg: dict) -> int:
    """Mid-epoch 1: the second iteration after epoch 0's checkpoint."""
    return int(cfg["total_iter_per_epoch"]) + 2


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------

def rank_main(argv) -> int:
    """One rank: ``<record dir> <device> <config json> [--key value ...]``.
    Runs ``train_maml_system.main`` and writes this process's record
    (``rank_h<host>_g<generation>.json``) at its end, at an ``os._exit``
    (the attributed trip) and before an ``os.execve`` (a reshard)."""
    record_dir, device, cfg_path = argv[:3]
    from howtotrainyourmamlpytorch_tpu_torch import train_maml_system
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.resilience import elastic
    roster = elastic.parse_roster_env()
    rank = int(os.environ.get("RANK", "0"))
    from howtotrainyourmamlpytorch_tpu_torch.ops import build
    rec = {"host": roster.roster[rank] if roster else rank,
           "generation": roster.generation if roster else 0,
           "rank": rank, "world": int(os.environ.get("WORLD_SIZE", "1")),
           "pid": os.getpid(), "t_start": time.time(), "t_first_step": None,
           "start_iter": None, "step_ms": [], "launches": 0, "end": None,
           "warm_start": None, "aot": {}, "nvcc_runs": 0}
    path = os.path.join(record_dir,
                        f"rank_h{rec['host']}_g{rec['generation']}.json")
    builders = []

    def dump(end: str) -> None:
        rec.update(end=end, launches=bn_act.launches, t_end=time.time(),
                   nvcc_runs=build.nvcc_runs)
        if builders:
            # This rank's warm start: its row and its own aot/* counters.
            rec["warm_start"] = builders[-1].warm_start_row
            rec["aot"] = {k: v for k, v in
                          builders[-1].registry.snapshot().items()
                          if k.startswith("aot/")}
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, path)

    real_exit, real_execve = os._exit, os.execve

    def _exit(code):
        dump(f"exit {code}")
        real_exit(code)

    def execve(exe, args, env):
        dump("exec")
        real_execve(exe, args, env)

    os._exit, os.execve = _exit, execve

    class Builders(list):
        """Times each train step of the builder the CLI makes (its loss
        fetch included: the loop fetches it at every sync point)."""

        def append(self, builder):
            super().append(builder)
            builders.append(builder)
            rec["start_iter"] = builder.current_iter
            step = builder.train_step

            def timed(*a, **k):
                if rec["t_first_step"] is None:
                    rec["t_first_step"] = time.time()
                t0 = time.perf_counter()
                out = step(*a, **k)
                float(out[1].loss)
                rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
                return out
            builder.train_step = timed

    rc = train_maml_system.main(["--name_of_args_json_file", cfg_path]
                                + list(argv[3:]), device=device,
                                builders=Builders())
    dump(f"exit {rc}")
    return rc


# ---------------------------------------------------------------------------
# launching and reading
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def base_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCH_KEYS}
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def launch_pod(out: str, cfg: dict, n: int, device: str, records: str,
               fault_host=None, fault_spec: str = "", extra=None,
               env_extra=None, tag: str = "worker"):
    """Start ``n`` ranks joined over ``env://`` at a fresh localhost port;
    returns the processes. Each writes straight to ``<out>/<tag><r>.log``
    (an undrained pipe on one rank would stall every rank)."""
    os.makedirs(out, exist_ok=True)
    os.makedirs(records, exist_ok=True)
    cfg_path = os.path.join(out, f"{tag}_cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    port = free_port()
    procs = []
    for r in range(n):
        env = base_env()
        env.update({"RANK": str(r), "WORLD_SIZE": str(n),
                    "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(n),
                    "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
        env.update(env_extra or {})
        if device == "cpu":
            env.setdefault("OMP_NUM_THREADS", "1")
        if fault_host is not None and r == fault_host:
            env["MAML_FAULTS"] = fault_spec
        log = open(os.path.join(out, f"{tag}{r}.log"), "w")
        procs.append(reaper.spawn(
            [sys.executable, "-c", RANK_CHILD, _SCRIPTS, records, device,
             cfg_path] + list((extra or {}).get(r, [])),
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=_REPO))
        log.close()
    return procs


def watch(procs, timeout_s: float) -> list:
    """Wait for every process; returns ``(exit code, exit wall time)``
    per process (code None: still running at the limit, then killed)."""
    ends = [None] * len(procs)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and any(e is None for e in ends):
        for i, p in enumerate(procs):
            if ends[i] is None and p.poll() is not None:
                ends[i] = (p.returncode, time.time())
        time.sleep(0.05)
    for i, p in enumerate(procs):
        if ends[i] is None:
            p.kill()
            p.wait()
            ends[i] = (None, time.time())
    return ends


def read_events(root: str) -> list:
    path = os.path.join(root, NAME, "logs", "events.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def read_records(records: str) -> dict:
    """``{(host, generation): record}``."""
    out = {}
    if os.path.isdir(records):
        for name in sorted(os.listdir(records)):
            if name.startswith("rank_") and name.endswith(".json"):
                with open(os.path.join(records, name)) as f:
                    rec = json.load(f)
                out[(rec["host"], rec["generation"])] = rec
    return out


def file_crc(path: str):
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return zlib.crc32(f.read())


def committed_view(root: str):
    """(newest committed epoch, its iteration, its file's CRC32) from the
    shared manifest: the consensus resume's target."""
    saved = os.path.join(root, NAME, "saved_models")
    epoch = it = None
    path = os.path.join(saved, "MANIFEST.json")
    if os.path.exists(path):
        with open(path) as f:
            records = json.load(f).get("records", {})
        epochs = [(int(t), r) for t, r in records.items()
                  if t.isdigit() and r.get("status") == "committed"]
        if epochs:
            epoch, rec = max(epochs)
            it = rec.get("iter")
    crc = (file_crc(os.path.join(saved, f"train_model_{epoch}.ckpt"))
           if epoch is not None else None)
    return epoch, it, crc


def log_text(path: str) -> str:
    if not os.path.exists(path):
        return ""
    with open(path, errors="replace") as f:
        return f.read()


def resumed_lines(text: str) -> list:
    return [ln.strip() for ln in text.splitlines()
            if ln.startswith("resumed from checkpoint")]


def prom_value(path: str, name: str):
    """A sample of ``metrics.prom`` by registry name (``/`` -> ``_``)."""
    want = name.replace("/", "_")
    for line in log_text(path).splitlines():
        parts = line.split()
        if len(parts) == 2 and parts[0] == want:
            return float(parts[1])
    return None


def final_crc(root: str):
    """CRC of the run's last epoch checkpoint."""
    saved = os.path.join(root, NAME, "saved_models")
    tags = [int(n[len("train_model_"):-len(".ckpt")])
            for n in (os.listdir(saved) if os.path.isdir(saved) else [])
            if n.startswith("train_model_") and n.endswith(".ckpt")
            and n[len("train_model_"):-len(".ckpt")].isdigit()]
    return (file_crc(os.path.join(saved, f"train_model_{max(tags)}.ckpt"))
            if tags else None)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

class Pod:
    """The harness's settings shared by every phase."""

    def __init__(self, out: str, base: dict, device: str, budget: float,
                 lease: float, timeout: float = RUN_TIMEOUT_S):
        self.out, self.base, self.device = out, base, device
        self.budget, self.lease, self.timeout = budget, lease, timeout

    def cfg(self, root: str, n: int, **kw) -> dict:
        return pod_cfg_dict(self.base, root, n, self.budget, self.lease,
                            **kw)


def run_peer_kill(pod: Pod) -> dict:
    """Phase 1: the attributed abort."""
    from howtotrainyourmamlpytorch_tpu_torch.resilience import (
        EXIT_PEER_LOST)
    out = pod.out
    cfg = pod.cfg(out, NUM_PROCESSES)
    at = kill_iter(cfg)
    records = os.path.join(out, "records_peer_kill")
    procs = launch_pod(out, cfg, NUM_PROCESSES, pod.device, records,
                       fault_host=1, fault_spec=f"kill_peer@{at}")
    ends = watch(procs, pod.timeout)
    (survivor, t_survivor), (victim, t_victim) = ends[0], ends[1]
    latency = (t_survivor - t_victim
               if survivor is not None and victim is not None else None)
    events = read_events(out)
    lost = [e for e in events if e.get("event") == "peer_lost"]
    bundle = os.path.join(out, NAME, "logs", "crash_bundle_p0")
    crash = {}
    if os.path.exists(os.path.join(bundle, "crash.json")):
        with open(os.path.join(bundle, "crash.json")) as f:
            crash = json.load(f)
    epoch, it, crc = committed_view(out)
    rec = read_records(records).get((0, 0), {})
    facts = {
        "kill_iter": at,
        "victim_exit_code": victim,
        "survivor_exit_code": survivor,
        "survivor_latency_s": (round(latency, 3) if latency is not None
                               else None),
        "latency_bound_s": pod.budget + TRIP_SLACK_S,
        "peer_lost_rows": len(lost),
        "suspect_hosts": lost[-1].get("suspect_hosts") if lost else None,
        "bundle_reason": crash.get("reason"),
        "bundle_suspects": crash.get("suspect_hosts"),
        "bundle_files": (sorted(os.listdir(bundle))
                         if os.path.isdir(bundle) else []),
        "prom_peer_losses": prom_value(
            os.path.join(out, NAME, "logs", "metrics.prom"),
            "cluster/peer_losses"),
        "committed_epoch": epoch,
        "committed_iter": it,
        "committed_crc": crc,
        "survivor_end": rec.get("end"),
        "survivor_launches": rec.get("launches"),
        "survivor_steps": len(rec.get("step_ms") or []),
        "survivor_step_ms": rec.get("step_ms"),
        "victim_record": bool(read_records(records).get((1, 0))),
    }
    facts["ok"] = bool(
        victim == -9 and survivor == EXIT_PEER_LOST
        and latency is not None and latency <= pod.budget + TRIP_SLACK_S
        and facts["peer_lost_rows"] >= 1 and facts["suspect_hosts"] == [1]
        and facts["bundle_reason"] == "peer_lost"
        and facts["bundle_suspects"] == [1]
        and facts["prom_peer_losses"] == 1.0
        and epoch == 0 and it == cfg["total_iter_per_epoch"]
        and facts["survivor_end"] == f"exit {EXIT_PEER_LOST}")
    if not facts["ok"]:
        facts["survivor_log_tail"] = log_text(
            os.path.join(out, "worker0.log"))[-2000:]
    return facts


def _stale_view(out: str, view: str) -> int:
    """Rank 1's view of the run: every file of ``saved_models`` the shared
    one (symlinks) except ``MANIFEST.json``, a copy without the newest
    committed epoch; ``logs`` and ``cluster`` the shared directories.
    Returns the epoch dropped."""
    shutil.rmtree(view, ignore_errors=True)
    src = os.path.join(out, NAME)
    dst = os.path.join(view, NAME)
    os.makedirs(os.path.join(dst, "saved_models"))
    for sub in ("logs", "cluster"):
        os.symlink(os.path.join(src, sub), os.path.join(dst, sub))
    saved = os.path.join(src, "saved_models")
    for name in os.listdir(saved):
        if name != "MANIFEST.json":
            os.symlink(os.path.join(saved, name),
                       os.path.join(dst, "saved_models", name))
    with open(os.path.join(saved, "MANIFEST.json")) as f:
        doc = json.load(f)
    newest = max(int(t) for t, r in doc["records"].items()
                 if t.isdigit() and r.get("status") == "committed")
    del doc["records"][str(newest)]
    with open(os.path.join(dst, "saved_models", "MANIFEST.json"), "w") as f:
        json.dump(doc, f)
    return newest


def run_restart(pod: Pod, committed_epoch, committed_crc) -> dict:
    """Phase 2: consensus resume. All ranks relaunch, resume bitwise from
    the committed epoch's bytes and finish; then again with rank 1's
    manifest one epoch stale."""
    out = pod.out
    cfg = pod.cfg(out, NUM_PROCESSES)
    iters = cfg["total_iter_per_epoch"]
    records = os.path.join(out, "records_restart")
    ends = watch(launch_pod(out, cfg, NUM_PROCESSES, pod.device, records,
                            tag="restart"), pod.timeout)
    logs = [log_text(os.path.join(out, f"restart{r}.log"))
            for r in range(NUM_PROCESSES)]
    resumed = [resumed_lines(t) for t in logs]
    crc_after = (file_crc(os.path.join(
        out, NAME, "saved_models", f"train_model_{committed_epoch}.ckpt"))
        if committed_epoch is not None else None)
    final = final_crc(out)
    recs = read_records(records)
    facts = {
        "exit_codes": [c for c, _ in ends],
        "resumed_lines": resumed,
        "committed_crc_unchanged": bool(committed_crc is not None
                                        and crc_after == committed_crc),
        "test_protocol_ran": "test:" in logs[0],
        "final_crc": final,
        "launches": [recs.get((r, 0), {}).get("launches")
                     for r in range(NUM_PROCESSES)],
        "start_iters": [recs.get((r, 0), {}).get("start_iter")
                        for r in range(NUM_PROCESSES)],
        "step_ms": [recs.get((r, 0), {}).get("step_ms")
                    for r in range(NUM_PROCESSES)],
    }
    want = f"at iter {(committed_epoch or 0) * iters + iters}"
    facts["ok"] = bool(
        all(c == 0 for c, _ in ends)
        and all(r and want in r[-1] for r in resumed)
        and facts["committed_crc_unchanged"] and facts["test_protocol_ran"])
    if not facts["ok"]:
        facts["worker0_log_tail"] = logs[0][-2000:]
        return facts

    # The planted disagreement: rank 1's manifest lacks the newest epoch.
    view = os.path.join(out, "stale_view")
    dropped = _stale_view(out, view)
    older = dropped - 1
    older_crc = file_crc(os.path.join(out, NAME, "saved_models",
                                      f"train_model_{older}.ckpt"))
    records = os.path.join(out, "records_consensus")
    t0 = time.time()
    ends = watch(launch_pod(out, cfg, NUM_PROCESSES, pod.device, records,
                            tag="consensus",
                            extra={1: ["--experiment_root", view]}),
                 pod.timeout)
    logs = [log_text(os.path.join(out, f"consensus{r}.log"))
            for r in range(NUM_PROCESSES)]
    consensus_rows = [e for e in read_events(out)
                      if e.get("event") == "consensus_resume"]
    recs = read_records(records)
    want = f"resumed from checkpoint {older} at iter {(older + 1) * iters}"
    facts.update({
        "consensus_dropped_epoch": dropped,
        "consensus_exit_codes": [c for c, _ in ends],
        "consensus_lines": [[ln.strip() for ln in t.splitlines()
                             if ln.startswith("cluster consensus:")]
                            for t in logs],
        "consensus_resumed_lines": [resumed_lines(t) for t in logs],
        "consensus_rows": [(e.get("consensus_epoch"), e.get("local_view"))
                           for e in consensus_rows],
        "consensus_older_crc_unchanged": older_crc == file_crc(os.path.join(
            out, NAME, "saved_models", f"train_model_{older}.ckpt")),
        "consensus_final_crc": final_crc(out),
        "consensus_final_crc_equal": final_crc(out) == final,
        "consensus_launches": [recs.get((r, 0), {}).get("launches")
                               for r in range(NUM_PROCESSES)],
        "consensus_start_iters": [recs.get((r, 0), {}).get("start_iter")
                                  for r in range(NUM_PROCESSES)],
        "consensus_resume_wall_s": [
            round(recs[(r, 0)]["t_first_step"] - t0, 3)
            if recs.get((r, 0), {}).get("t_first_step") else None
            for r in range(NUM_PROCESSES)],
    })
    facts["consensus_ok"] = bool(
        all(c == 0 for c, _ in ends)
        and all(len(lines) == 1 for lines in facts["consensus_lines"])
        and all(r and want in r[-1]
                for r in facts["consensus_resumed_lines"])
        and facts["consensus_rows"] == [(older, dropped)]
        and facts["consensus_older_crc_unchanged"]
        and facts["consensus_final_crc_equal"])
    facts["ok"] = facts["consensus_ok"]
    if not facts["ok"]:
        facts["consensus_log_tails"] = [t[-1500:] for t in logs]
    shutil.rmtree(view, ignore_errors=True)
    return facts


def run_parity(pod: Pod) -> dict:
    """Phase 3: the domain off, on, and on with ``elastic_mode=1`` in one
    process: bitwise equal final weights (the watchdog's standard)."""
    import torch
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    from howtotrainyourmamlpytorch_tpu_torch.experiment import (
        ExperimentBuilder)

    def single(name, **kw):
        cfg = pod.cfg(pod.out, 1, experiment_name=name, mesh_shape=[1, 1],
                      batch_size=2, require_mesh=0,
                      continue_from_epoch="from_scratch", **kw)
        builder = ExperimentBuilder(MAMLConfig.from_dict(cfg),
                                    device=pod.device)
        builder.run_experiment()
        return builder

    def leaves(b):
        out = []

        def walk(tree):
            for _, v in sorted(tree.items()):
                walk(v) if isinstance(v, dict) else out.append(v)
        walk(b.state.params)
        return out

    b_on = single("parity_on", cluster_collective_timeout_s=300.0,
                  cluster_lease_interval_s=0.1)
    b_off = single("parity_off", cluster_collective_timeout_s=0.0)
    b_el = single("parity_elastic", cluster_collective_timeout_s=300.0,
                  cluster_lease_interval_s=0.1, elastic_mode=1)
    on, off, el = leaves(b_on), leaves(b_off), leaves(b_el)
    facts = {
        "weights_equal": all(torch.equal(a, b) for a, b in zip(on, off)),
        "weights_equal_elastic": all(torch.equal(a, b)
                                     for a, b in zip(el, off)),
        "leaves": len(off),
        "lease_written": os.path.exists(os.path.join(
            pod.out, "parity_on", "cluster", "host_0.lease")),
    }
    facts["ok"] = bool(facts["weights_equal"]
                       and facts["weights_equal_elastic"]
                       and facts["lease_written"] and len(on) == len(off))
    return facts


def elastic_cfg(pod: Pod, eout: str, store_root=None,
                n: int = ELASTIC_PROCESSES) -> dict:
    """The elastic leg's config: ``n`` ranks with ``elastic_mode=1``, 4
    tasks per rank (4n / (n - 1) per survivor), on the warm-start store
    at ``store_root`` when given."""
    warm = {"aot_store_dir": store_root} if store_root else {}
    return pod.cfg(eout, n, batch_size=4 * n, elastic_mode=1,
                   elastic_max_lost_hosts=1, **warm)


def run_elastic(pod: Pod, n: int = ELASTIC_PROCESSES,
                kill_host: int = ELASTIC_KILL_HOST,
                prewarmed: str = "") -> dict:
    """Phase 4: kill host ``kill_host`` of ``n`` with ``elastic_mode=1``;
    the survivors reshard to generation 1 and finish; a cold run at the
    survivor geometry from a snapshot of the committed state must end
    with the same final checkpoint bytes. ``prewarmed``: the artifact
    file of a ``--degraded 1 --degraded-only`` prewarm a caller already
    ran on :func:`elastic_cfg`, whose store the ranks then use (without
    it, on the card, the leg runs that prewarm first)."""
    from howtotrainyourmamlpytorch_tpu_torch.resilience import elastic as el
    eout = os.path.join(pod.out, "elastic")
    # On the card the store is armed: the survivor roster prewarmed
    # first (its child builds the kernel if no process has), every
    # rank's steps run as graphs (gloo staged collectives between them).
    store = pod.device != "cpu"
    prewarm = None
    if prewarmed:
        with open(prewarmed) as f:
            prewarm = json.load(f)
    root = (os.path.dirname(prewarm["store_dir"]) if prewarm
            and prewarm.get("store_dir") else os.path.join(eout,
                                                           "aot_store"))
    cfg = elastic_cfg(pod, eout, root if store else None, n)
    at = kill_iter(cfg)
    if store and prewarm is None:
        prewarm = run_prewarm(eout, cfg, pod.timeout)
    if prewarm is not None and not prewarm.get("ok"):
        return {"kill_ok": False, "ok": False, "store": True,
                "prewarm": prewarm}
    records = os.path.join(eout, "records")
    procs = launch_pod(eout, cfg, n, pod.device, records,
                       fault_host=kill_host, fault_spec=f"kill_peer@{at}")
    victim = procs[kill_host]
    try:
        victim.wait(timeout=pod.timeout)
    except subprocess.TimeoutExpired:
        pass
    t_victim = time.time()
    # Snapshot the committed state for the cold leg at once: the
    # survivors write nothing before generation 1's first epoch ends.
    cold_root = os.path.join(pod.out, "elastic_cold")
    for _ in range(40):
        epoch, _, _ = committed_view(eout)
        if epoch == 0:
            break
        time.sleep(0.25)
    shutil.rmtree(cold_root, ignore_errors=True)
    shutil.copytree(os.path.join(eout, NAME), os.path.join(cold_root, NAME),
                    ignore=shutil.ignore_patterns("*.lease", "ROSTER.json*",
                                                  "reshard_g*"))
    ends = watch(procs, pod.timeout)
    survivors = [h for h in range(n) if h != kill_host]
    roster_path = os.path.join(eout, NAME, "cluster", el.ROSTER_FILE)
    roster_doc = json.loads(log_text(roster_path) or "{}")
    proposals = el.read_proposals(os.path.join(eout, NAME, "cluster"), 1)
    t_trip = min((p.get("ts") for p in proposals.values()), default=None)
    events = read_events(eout)
    reshards = [e for e in events if e.get("event") == el.RESHARD_EVENT]
    recs = read_records(records)
    gen1 = [recs.get((h, 1), {}) for h in survivors]
    first_steps = [r.get("t_first_step") for r in gen1]
    logs = [log_text(os.path.join(eout, f"worker{h}.log"))
            for h in range(n)]
    report = _report_elastic(events)
    elastic_crc = final_crc(eout)
    facts = {
        "kill_iter": at,
        "kill_host": kill_host,
        "victim_exit_code": ends[kill_host][0],
        "survivor_exit_codes": [ends[h][0] for h in survivors],
        "trip_after_death_s": (round(t_trip - t_victim, 3)
                               if t_trip else None),
        "reshard_wall_s": (round(max(first_steps) - t_trip, 3)
                           if t_trip and all(first_steps) else None),
        "death_to_generation1_step_s": (
            round(max(first_steps) - t_victim, 3)
            if all(first_steps) else None),
        "reshard_rows": len(reshards),
        "reshard_suspects": reshards[-1].get("suspects") if reshards
        else None,
        "roster_generation": roster_doc.get("generation"),
        "roster": roster_doc.get("roster"),
        "report_elastic": report,
        "generation1_ranks": [(r.get("host"), r.get("rank"), r.get("world"))
                              for r in gen1],
        "generation0_launches": {h: recs.get((h, 0), {}).get("launches")
                                 for h in survivors},
        "generation0_ends": {h: recs.get((h, 0), {}).get("end")
                             for h in survivors},
        "generation1_launches": {h: recs.get((h, 1), {}).get("launches")
                                 for h in survivors},
        "generation1_start_iters": [r.get("start_iter") for r in gen1],
        "generation1_step_ms": [r.get("step_ms") for r in gen1],
        "generation1_writer": (resumed_lines(logs[survivors[0]]) or [None])
        [-1],
        "test_protocol_ran": "test:" in logs[survivors[0]],
        "final_crc": elastic_crc,
        "store": store,
        "prewarm": prewarm,
        "generation1_warm_start": [r.get("warm_start") for r in gen1],
        "generation1_aot": [r.get("aot") for r in gen1],
        "generation1_nvcc_runs": [r.get("nvcc_runs") for r in gen1],
    }
    # Each survivor's first step after the reshard: every graph captured
    # from a prewarmed record, no kernel build, none demoted.
    facts["warm_ok"] = (not store) or all(
        (r.get("warm_start") or {}).get("compiles_before_first_step") == 0
        and (r.get("warm_start") or {}).get("aot_misses") == 0
        and (r.get("warm_start") or {}).get("aot_hits", 0) >= 1
        and r.get("nvcc_runs") == 0
        and (r.get("aot") or {}).get("aot/exec_fallbacks", 1) == 0
        for r in gen1)
    iters = cfg["total_iter_per_epoch"]
    facts["kill_ok"] = bool(
        facts["warm_ok"] and
        ends[kill_host][0] == -9
        and all(c == 0 for c in facts["survivor_exit_codes"])
        and facts["reshard_rows"] >= 1
        and facts["reshard_suspects"] == [kill_host]
        and facts["roster_generation"] == 1
        and facts["roster"] == survivors
        and isinstance(report, dict) and report.get("reshards") == 1
        and facts["generation1_ranks"] == [
            (h, i, len(survivors)) for i, h in enumerate(survivors)]
        and all(e == "exec" for e in facts["generation0_ends"].values())
        and all(s == iters for s in facts["generation1_start_iters"])
        and facts["test_protocol_ran"] and elastic_crc is not None)
    if not facts["kill_ok"]:
        facts["survivor_log_tails"] = [logs[h][-1500:] for h in survivors]
        return facts

    # The cold leg: the survivor geometry launched directly.
    roster = ",".join(str(h) for h in survivors)
    cold_records = os.path.join(cold_root, "records")
    ends = watch(launch_pod(
        cold_root, elastic_cfg(pod, cold_root, n=n),
        len(survivors), pod.device, cold_records, tag="cold",
        env_extra={el.GEN_ENV: "1", el.ROSTER_ENV: roster,
                   el.ORIG_ENV: str(n)}), pod.timeout)
    cold = read_records(cold_records)
    cold_crc = final_crc(cold_root)
    facts.update({
        "cold_exit_codes": [c for c, _ in ends],
        "cold_final_crc": cold_crc,
        "cold_launches": {h: cold.get((h, 1), {}).get("launches")
                          for h in survivors},
        "cold_step_ms": [cold.get((h, 1), {}).get("step_ms")
                         for h in survivors],
        "bitwise_equal_cold": bool(cold_crc is not None
                                   and cold_crc == elastic_crc),
    })
    facts["ok"] = bool(facts["kill_ok"]
                       and all(c == 0 for c in facts["cold_exit_codes"])
                       and facts["bitwise_equal_cold"])
    if not facts["ok"]:
        facts["cold_log_tail"] = log_text(
            os.path.join(cold_root, "cold0.log"))[-1500:]
    return facts


def run_prewarm(out: str, cfg: dict, timeout: float) -> dict:
    """``scripts/torch_aot_prewarm.py --degraded 1 --degraded-only`` on
    ``cfg`` as a child (tracked, so reaped with the harness): the
    survivor roster's executables and the kernel build; its artifact
    with its exit code."""
    path = os.path.join(out, "prewarm_cfg.json")
    os.makedirs(out, exist_ok=True)
    with open(path, "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(out, "prewarm.log"), "w") as log:
        proc = reaper.spawn(
            [sys.executable, os.path.join(_SCRIPTS, "torch_aot_prewarm.py"),
             "--config", path, "--degraded", "1", "--degraded-only"],
            env=base_env(), stdout=subprocess.PIPE, stderr=log, text=True,
            cwd=_REPO)
    try:
        stdout, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        return {"ok": False, "exit_code": None, "error": "timed out"}
    lines = stdout.strip().splitlines()
    try:
        doc = json.loads(lines[-1]) if lines else {}
    except ValueError:
        doc = {"error": lines[-1][-500:]}
    doc["exit_code"] = proc.returncode
    doc["ok"] = bool(doc.get("ok")) and proc.returncode == 0
    return doc


def _report_elastic(events: list):
    """The run's elastic section, as the port's report reads it."""
    from howtotrainyourmamlpytorch_tpu_torch.telemetry.report import (
        summarize_events)
    try:
        return summarize_events(events).get("elastic")
    except Exception as e:  # noqa: BLE001 — reported, and the phase fails
        return f"unreadable: {type(e).__name__}: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Pod fault-domain chaos of the PyTorch/CUDA port: "
                    "SIGKILL a rank, prove the attributed exit 73, the "
                    "consensus resume and the elastic reshard.")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="experiment root (default: a fresh temp dir, "
                         "removed on success)")
    ap.add_argument("--phases", default="peer_kill,restart,parity,elastic",
                    help="comma list of peer_kill,restart,parity,elastic")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card; ranks share it) or 'cpu'")
    ap.add_argument("--config", default=None,
                    help="config JSON (default: the tiny pod config)")
    ap.add_argument("--quick", action="store_true",
                    help="the tiny pod config (the default without "
                         "--config)")
    ap.add_argument("--budget", type=float, default=COLLECTIVE_TIMEOUT_S,
                    help="cluster_collective_timeout_s")
    ap.add_argument("--lease-interval", type=float,
                    default=LEASE_INTERVAL_S,
                    help="cluster_lease_interval_s")
    ap.add_argument("--timeout", type=float, default=RUN_TIMEOUT_S,
                    help="each leg's limit in seconds for its ranks")
    ap.add_argument("--elastic-prewarm", default="", metavar="FILE",
                    help="the elastic leg's survivor roster is already "
                         "prewarmed: the artifact of that prewarm "
                         "(run on elastic_cfg's config), whose store the "
                         "ranks use")
    args = ap.parse_args(argv)
    # Every rank this harness starts ends with it, on SIGTERM too.
    reaper.install()
    if args.device != "cpu":
        import torch
        if not torch.cuda.is_available():
            print("torch_chaos_pod: no CUDA device is available; pass "
                  "--device cpu for the CPU", file=sys.stderr)
            return 1
    base = tiny_cfg_dict()
    if args.config and not args.quick:
        with open(args.config) as f:
            base = json.load(f)
    phases = [p.strip() for p in args.phases.split(",") if p.strip()]
    out = args.out or tempfile.mkdtemp(prefix="torch_chaos_pod_")
    cleanup = args.out is None
    artifact = {"metric": "pod_chaos", "phases": phases,
                "device": args.device,
                "geometry": "quick" if base == tiny_cfg_dict() else "config",
                "cluster_collective_timeout_s": args.budget,
                "cluster_lease_interval_s": args.lease_interval}
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
    except OSError:
        artifact.update({"value": None, "status": "skipped",
                         "skip_reason": "cannot bind localhost sockets"})
        print(json.dumps(artifact), flush=True)
        return 0
    pod = Pod(out, base, args.device, args.budget, args.lease_interval,
              args.timeout)
    results, ok = {}, True
    committed_epoch = committed_crc = None
    for phase in phases:
        print(json.dumps({"phase": phase, "status": "running"}), flush=True)
        t0 = time.perf_counter()
        if phase == "peer_kill":
            facts = run_peer_kill(pod)
            committed_epoch = facts["committed_epoch"]
            committed_crc = facts["committed_crc"]
        elif phase == "restart":
            if committed_epoch is None:
                committed_epoch, _, committed_crc = committed_view(out)
            facts = run_restart(pod, committed_epoch, committed_crc)
        elif phase == "parity":
            facts = run_parity(pod)
        elif phase == "elastic":
            facts = run_elastic(pod, prewarmed=args.elastic_prewarm)
        else:
            raise SystemExit(f"unknown phase {phase!r}")
        facts["seconds"] = round(time.perf_counter() - t0, 1)
        results.update({f"{phase}_{k}": v for k, v in facts.items()})
        ok = ok and bool(facts["ok"] if "ok" in facts
                         else facts.get("kill_ok"))
    artifact.update(results)
    artifact.update({"value": 1.0 if ok else 0.0, "unit": "recovered",
                     "status": "recovered" if ok else "failed",
                     "out_dir": None if cleanup else out})
    if cleanup and ok:
        shutil.rmtree(out, ignore_errors=True)
    print(json.dumps(artifact), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
