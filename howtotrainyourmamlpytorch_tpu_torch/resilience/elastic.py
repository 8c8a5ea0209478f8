"""Elastic pod: survivors reshard and keep training through peer loss
(the port's copy of the JAX package's ``resilience/elastic.py``, with its
names, files, rows and counters).

The pod fault domain (``resilience/cluster.py``) ends every attributed
peer loss in ``EXIT_PEER_LOST`` (73), a whole-job restart. With
``elastic_mode=1`` an attributed loss within ``elastic_max_lost_hosts``
routes to a coordinated reconfiguration instead:

1. **Roster consensus through the lease directory.** The survivors'
   collectives are dead (that is why the trip fired), so agreement runs
   over shared storage: every survivor writes a proposal file naming the
   hosts its leases convict plus a coordinator candidate, then polls
   until every host outside the UNION of proposed dead sets has proposed
   (:func:`roster_consensus`, a pure fixpoint). Mutually accusing hosts
   land in the dead set together and each refuses its own reshard:
   there is exactly one union, so no two survivor groups can form.
2. **Restart in place.** Each agreed survivor ``exec``s its own command
   line (``sys.orig_argv``, so a ``-m`` or ``-c`` launch re-runs as
   launched) with the survivor env: the process group's ``env://``
   variables for the new generation (``MASTER_ADDR``/``MASTER_PORT`` at
   the new rank 0's coordinator candidate, ``WORLD_SIZE``, ``RANK``,
   ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) and the ``MAML_ELASTIC_*``
   roster trio. The fresh image derives the degraded geometry
   (``parallel/mesh.py § derive_degraded_config``) and resumes from the
   committed epoch. A host the roster excludes exits 73 as before.
3. **Re-expansion.** A backfilled replacement host finds the roster
   excludes it, writes a rejoin file and waits (:func:`backfill_wait`).
   At the next epoch boundary the survivors see every missing host's
   rejoin file, agree (one collective), write the next generation's FULL
   roster, and everyone re-forms the original mesh from the committed
   checkpoint.

Unattributed or over-budget losses still exit 73, and ``elastic_mode=0``
(the default) installs nothing.

The launcher must leave the survivors running: torchrun's agent tears
the group down when one worker dies (SIGTERM to the others), and an
``exec``'d worker confuses it. ``scripts/torch_chaos_pod.py`` starts the
ranks itself.

Addressing: real pods set ``MAML_ELASTIC_ADVERTISE`` per host (the
address peers can reach this host's coordinator candidate on); without
it the candidate advertises ``127.0.0.1``, which is right only for
single-machine pods (the chaos harness).
"""

from __future__ import annotations

import json
import os
import socket
import sys
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

from howtotrainyourmamlpytorch_tpu_torch.resilience import flightrec

GEN_ENV = "MAML_ELASTIC_GENERATION"
ROSTER_ENV = "MAML_ELASTIC_ROSTER"
ORIG_ENV = "MAML_ELASTIC_ORIG_PROCESSES"
ADVERTISE_ENV = "MAML_ELASTIC_ADVERTISE"

ROSTER_FILE = "ROSTER.json"
PROPOSAL_PREFIX = "reshard_g"
REJOIN_PREFIX = "rejoin_h"

RESHARD_EVENT = "elastic_reshard"
RE_EXPAND_EVENT = "elastic_re_expand"
RESHARDS_COUNTER = "elastic/reshards"
DEGRADED_EPOCHS_COUNTER = "elastic/degraded_epochs"
RE_EXPANSIONS_COUNTER = "elastic/re_expansions"
REFUSALS_COUNTER = "elastic/reshard_refusals"
GENERATION_GAUGE = "elastic/generation"
LOST_HOSTS_GAUGE = "elastic/lost_hosts"

_POLL_S = 0.25


def elastic_enabled(cfg: Any) -> bool:
    """One switch: ``elastic_mode=1``. Config validation already pins
    that it implies the pod fault domain (the trip source)."""
    return int(getattr(cfg, "elastic_mode", 0)) == 1


def reshard_timeout(cfg: Any) -> float:
    """Roster-consensus deadline: explicit knob, else one collective
    budget — the peers' own trips arrive within a poll overshoot of
    ours, so one budget bounds the straggliest proposal."""
    v = float(getattr(cfg, "elastic_reshard_timeout_s", 0.0))
    return v if v > 0 else float(cfg.cluster_collective_timeout_s)


# ---------------------------------------------------------------------------
# pure roster math
# ---------------------------------------------------------------------------

def roster_consensus(proposals: Dict[int, Sequence[int]],
                     members: Sequence[int]
                     ) -> Tuple[List[int], List[int], bool]:
    """``(roster, dead, complete)`` from the proposals seen so far.

    ``proposals`` maps original host id -> the dead set that host
    proposes; ``members`` is the current generation's roster (original
    ids). The agreed dead set is the UNION over received proposals
    (any survivor's conviction removes a host — a wrongly-accused but
    live host finds itself excluded and takes the exit-73 path, which
    a scheduler heals; the union can never disagree between observers,
    so no two survivor groups can form). ``complete`` iff every member
    OUTSIDE the union has proposed — the fixpoint is immediate because
    the union only grows as proposals arrive.
    """
    dead: set = set()
    for view in proposals.values():
        dead.update(int(d) for d in view)
    roster = [int(m) for m in sorted(int(x) for x in members)
              if int(m) not in dead]
    complete = bool(roster) and all(m in proposals for m in roster)
    return roster, sorted(dead), complete


def rerank(roster: Sequence[int], host: int) -> int:
    """The generation-local process index of original host ``host``."""
    return sorted(int(h) for h in roster).index(int(host))


class RosterState(NamedTuple):
    """The elastic identity a (possibly resharded) process runs under."""
    generation: int
    roster: Tuple[int, ...]      # original host ids, rank-ordered
    orig_processes: int

    @property
    def degraded(self) -> bool:
        return len(self.roster) < self.orig_processes


def parse_roster_env(environ: Optional[Dict[str, str]] = None
                     ) -> Optional[RosterState]:
    """The ``MAML_ELASTIC_*`` trio, or None for a generation-0 launch."""
    env = os.environ if environ is None else environ
    gen = int(env.get(GEN_ENV, "0") or 0)
    if gen <= 0:
        return None
    roster = tuple(sorted(int(x) for x in env[ROSTER_ENV].split(",")
                          if x.strip() != ""))
    orig = int(env.get(ORIG_ENV, str(len(roster))))
    return RosterState(gen, roster, orig)


def apply_roster(cfg: Any, environ: Optional[Dict[str, str]] = None
                 ) -> Tuple[Any, Optional[RosterState]]:
    """Degrade ``cfg`` to the roster the environment says this process
    runs under (generation > 0), else return it untouched. A resharded
    segment is by definition a resume, so ``continue_from_epoch`` is
    forced to 'latest' — a from_scratch config must not silently
    restart the workload at the degraded geometry."""
    state = parse_roster_env(environ)
    if state is None:
        return cfg, None
    from howtotrainyourmamlpytorch_tpu_torch.parallel.mesh import (
        derive_degraded_config)
    cfg = derive_degraded_config(cfg, len(state.roster),
                                 state.orig_processes)
    if cfg.continue_from_epoch != "latest":
        cfg = cfg.replace(continue_from_epoch="latest")
    return cfg, state


# ---------------------------------------------------------------------------
# shared-storage roster files (atomic tmp+rename, fail-soft reads)
# ---------------------------------------------------------------------------

def _write_atomic(path: str, doc: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(json.dumps(doc, sort_keys=True))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_json(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def roster_path(lease_dir: str) -> str:
    return os.path.join(lease_dir, ROSTER_FILE)


def read_roster(lease_dir: str) -> Optional[Dict[str, Any]]:
    doc = _read_json(roster_path(lease_dir))
    if not isinstance(doc, dict) or "roster" not in doc:
        return None
    return doc


def write_roster(lease_dir: str, doc: Dict[str, Any]) -> None:
    """Idempotent by content: every agreeing survivor computes the SAME
    doc, so concurrent writers replace the file with identical bytes."""
    _write_atomic(roster_path(lease_dir), doc)


def archive_roster(lease_dir: str) -> None:
    """A fresh full-geometry launch retires a stale roster (and any
    rejoin wreckage) so the lost-host budget restarts at zero."""
    doc = read_roster(lease_dir)
    if doc is not None:
        try:
            os.replace(roster_path(lease_dir),
                       roster_path(lease_dir)
                       + f".gen{int(doc.get('generation', 0))}.stale")
        except OSError:
            pass
    for name in _listdir(lease_dir):
        if name.startswith(REJOIN_PREFIX):
            try:
                os.unlink(os.path.join(lease_dir, name))
            except OSError:
                pass


def _listdir(path: str) -> List[str]:
    try:
        return os.listdir(path)
    except OSError:
        return []


def proposal_path(lease_dir: str, generation: int, host: int) -> str:
    return os.path.join(lease_dir,
                        f"{PROPOSAL_PREFIX}{int(generation)}"
                        f"_h{int(host)}.json")


def write_proposal(lease_dir: str, generation: int, host: int,
                   doc: Dict[str, Any]) -> None:
    _write_atomic(proposal_path(lease_dir, generation, host), doc)


def read_proposals(lease_dir: str,
                   generation: int) -> Dict[int, Dict[str, Any]]:
    out: Dict[int, Dict[str, Any]] = {}
    prefix = f"{PROPOSAL_PREFIX}{int(generation)}_h"
    for name in _listdir(lease_dir):
        if not (name.startswith(prefix) and name.endswith(".json")):
            continue
        raw = name[len(prefix):-len(".json")]
        if not raw.isdigit():
            continue
        doc = _read_json(os.path.join(lease_dir, name))
        if doc is not None:
            out[int(raw)] = doc
    return out


def rejoin_path(lease_dir: str, host: int) -> str:
    return os.path.join(lease_dir, f"{REJOIN_PREFIX}{int(host)}.json")


def write_rejoin(lease_dir: str, host: int) -> None:
    _write_atomic(rejoin_path(lease_dir, host),
                  {"host": int(host), "pid": os.getpid(),
                   "ts": time.time()})


def read_rejoins(lease_dir: str) -> List[int]:
    out = []
    for name in _listdir(lease_dir):
        if (name.startswith(REJOIN_PREFIX) and name.endswith(".json")
                and name[len(REJOIN_PREFIX):-len(".json")].isdigit()):
            out.append(int(name[len(REJOIN_PREFIX):-len(".json")]))
    return sorted(out)


# ---------------------------------------------------------------------------
# coordinator candidates + exec env
# ---------------------------------------------------------------------------

def bind_coordinator_candidate() -> Tuple[Optional[socket.socket], str]:
    """Reserve an ephemeral port for the next generation's coordination
    service. The socket is held open until ``exec`` (Python sockets are
    close-on-exec, so the port frees exactly when the new image needs
    it; the tiny re-bind race degrades to a failed distributed init,
    which the scheduler's whole-job restart heals)."""
    host = os.environ.get(ADVERTISE_ENV, "127.0.0.1")
    try:
        sock = socket.socket()
        sock.bind(("0.0.0.0", 0))
        return sock, f"{host}:{sock.getsockname()[1]}"
    except OSError:
        return None, f"{host}:0"


# The process group's ``env://`` variables (parallel/multihost.py reads
# them): what a roster generation rewrites, and what a lone survivor drops.
PG_ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
               "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def exec_env(doc: Dict[str, Any], host: int,
             environ: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The environment a roster member restarts in place under.

    ``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` follow the launch's layout: when
    the replaced env ran every rank on one node (``LOCAL_WORLD_SIZE ==
    WORLD_SIZE``, the ranks sharing a machine), the new generation does
    too and they become the new rank and world; otherwise (one process
    per host, the dcn axis) they are left as launched."""
    env = dict(os.environ if environ is None else environ)
    roster = [int(h) for h in doc["roster"]]
    env[GEN_ENV] = str(int(doc["generation"]))
    env[ROSTER_ENV] = ",".join(str(h) for h in roster)
    env[ORIG_ENV] = str(int(doc["orig_processes"]))
    # Deterministic fault plans are per-launch: a resharded segment must
    # not replay the injection that killed the peer.
    env.pop("MAML_FAULTS", None)
    one_node = env.get("LOCAL_WORLD_SIZE", env.get("WORLD_SIZE")) == \
        env.get("WORLD_SIZE")
    if len(roster) <= 1:
        # A lone survivor runs plain single-process: no process group to
        # stand up (and bitwise a cold one-process run at the degraded
        # geometry).
        for key in PG_ENV_KEYS:
            env.pop(key, None)
    else:
        addr, _, port = str(doc["coordinator"]).rpartition(":")
        rank = rerank(roster, host)
        env["MASTER_ADDR"], env["MASTER_PORT"] = addr, port
        env["WORLD_SIZE"], env["RANK"] = str(len(roster)), str(rank)
        if one_node:
            env["LOCAL_RANK"] = str(rank)
            env["LOCAL_WORLD_SIZE"] = str(len(roster))
    return env


def adopt_env(doc: Dict[str, Any], host: int,
              environ: Optional[Dict[str, str]] = None) -> None:
    """Adopt a roster's env IN PLACE (the backfill gate: the process
    group is not initialized yet, so no exec is needed).
    :func:`exec_env` REMOVES keys too — ``MAML_FAULTS`` (fault plans are
    per-launch; the rejoined host must not re-arm the plan that killed
    its predecessor) and the process group's variables for a lone
    roster — and ``dict.update`` cannot delete, so removed keys are
    dropped explicitly."""
    env = os.environ if environ is None else environ
    adopted = exec_env(doc, host, environ=dict(env))
    for key in ("MAML_FAULTS",) + PG_ENV_KEYS:
        if key not in adopted:
            env.pop(key, None)
    env.update(adopted)


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------

class ElasticPolicy:
    """Decides — and executes — reshard-instead-of-exit-73.

    Installed on the :class:`~..resilience.cluster.ClusterFaultDomain`
    (``domain.elastic``) for the run's duration when ``elastic_mode=1``;
    ``trip_peer_lost`` consults :meth:`should_reshard` after attribution
    and calls :meth:`initiate`, which either ``exec``s into the next
    generation (never returns) or returns False (consensus timed out,
    the roster excluded us, or the derivation is infeasible) so the
    caller falls through to the ordinary exit 73. ``elastic_mode=0``
    installs nothing — every hook is one attribute check.
    """

    def __init__(self, *, lease_dir: str, process_index: int,
                 roster: Sequence[int], generation: int,
                 orig_processes: int, max_lost_hosts: int,
                 timeout_s: float, mesh_dcn: int,
                 lease: Optional[Any] = None,
                 registry: Optional[Any] = None,
                 jsonl: Optional[Any] = None,
                 prom_path: Optional[str] = None,
                 argv: Optional[List[str]] = None):
        self.lease_dir = lease_dir
        self.process_index = int(process_index)
        self.roster = tuple(sorted(int(h) for h in roster))
        self.generation = int(generation)
        self.orig_processes = int(orig_processes)
        self.max_lost_hosts = int(max_lost_hosts)
        self.timeout_s = float(timeout_s)
        self.mesh_dcn = int(mesh_dcn)
        self.lease = lease
        self.registry = registry
        self.jsonl = jsonl
        self.prom_path = prom_path
        # The whole command line, interpreter and its flags included:
        # under ``python -m <module>`` sys.argv[0] is the module's file,
        # and re-running that path would run it as a script.
        self.argv = list(sys.orig_argv if argv is None else argv)
        self.host_id = self.roster[self.process_index]
        # Injectable seams (tests observe a reshard without exec'ing the
        # test process away).
        self._exec = os.execve
        self._sleep = time.sleep

    # -- identity ---------------------------------------------------------
    @property
    def degraded(self) -> bool:
        return len(self.roster) < self.orig_processes

    def missing_hosts(self) -> List[int]:
        return [h for h in range(self.orig_processes)
                if h not in self.roster]

    # -- routing ----------------------------------------------------------
    def should_reshard(self, suspects: Sequence[int]) -> bool:
        """Reshard iff the loss is ATTRIBUTED (non-empty suspect set),
        the CUMULATIVE lost-host count stays within budget, at least
        one survivor remains, and the mesh's dcn axis tracks processes
        (the only geometry the degraded derivation knows how to
        shrink). Everything else keeps the exit-73 contract."""
        if not suspects:
            return False
        if self.mesh_dcn != len(self.roster):
            return False
        n_suspects = len({int(s) for s in suspects})
        lost_total = (self.orig_processes - len(self.roster)) + n_suspects
        survivors = len(self.roster) - n_suspects
        return survivors >= 1 and lost_total <= self.max_lost_hosts

    def _count_refusal(self, reason: str) -> None:
        if self.registry is not None:
            try:
                self.registry.counter(REFUSALS_COUNTER).inc()
            except Exception:
                pass
        print(f"elastic: falling back to exit 73 ({reason})", flush=True)

    # -- the reshard ------------------------------------------------------
    def initiate(self, info: Dict[str, Any], ages: Dict[int, float],
                 suspects: Sequence[int]) -> bool:
        """Roster consensus, then restart-in-place. Returns True only
        with an injected ``_exec`` (tests); False means the caller must
        exit 73."""
        # A newer roster already on disk means peers resharded past us
        # while we were wedged: if it includes us we could in principle
        # join it, but our process state predates the agreement — the
        # safe move either way is the whole-host restart path (a roster
        # that includes us will take us back through the backfill
        # gate).
        existing = read_roster(self.lease_dir)
        if existing is not None and int(existing.get("generation", 0)) \
                > self.generation:
            self._count_refusal("a newer roster generation exists")
            return False
        gen = self.generation + 1
        my_dead = sorted({self.roster[int(s)] for s in suspects
                          if 0 <= int(s) < len(self.roster)})
        sock, coord = bind_coordinator_candidate()
        write_proposal(self.lease_dir, gen, self.host_id, {
            "host": self.host_id, "dead": my_dead, "coordinator": coord,
            "ts": time.time()})
        deadline = time.monotonic() + max(self.timeout_s, 1.0)
        roster = dead = None
        complete = False
        while time.monotonic() < deadline:
            if self.lease is not None:
                # The watchdog poll thread (the usual lease toucher) is
                # busy running THIS trip: keep our lease fresh by hand
                # so peers' monitors don't convict us mid-consensus.
                self.lease.touch(detail="elastic_consensus", force=True)
            proposals = read_proposals(self.lease_dir, gen)
            roster, dead, complete = roster_consensus(
                {h: p.get("dead", ()) for h, p in proposals.items()},
                self.roster)
            if complete:
                break
            self._sleep(_POLL_S)
        if not complete:
            self._count_refusal(
                f"roster consensus incomplete after {self.timeout_s:.1f}s "
                f"(a second loss during the reshard, or stalled storage)")
            return False
        if self.host_id not in roster:
            self._count_refusal(
                "the agreed roster excludes this host (peers convicted "
                "us while we convicted them)")
            return False
        lost_total = self.orig_processes - len(roster)
        if lost_total > self.max_lost_hosts:
            self._count_refusal(
                f"agreed roster loses {lost_total} hosts > "
                f"elastic_max_lost_hosts {self.max_lost_hosts}")
            return False
        proposals = read_proposals(self.lease_dir, gen)
        doc = {
            "generation": gen,
            "roster": roster,
            "dead": sorted(set(dead)
                           | set(range(self.orig_processes))
                           - set(roster)),
            "orig_processes": self.orig_processes,
            "coordinator": proposals[roster[0]].get("coordinator", ""),
            "ts": time.time(),
        }
        write_roster(self.lease_dir, doc)
        if (self.jsonl is not None and not self.jsonl.enabled
                and self.roster[0] in doc["dead"]
                and self.host_id == roster[0]):
            # The run's writer (this generation's rank 0) is among the
            # dead: the next generation's rank 0 records the reshard, or
            # no row of it would reach events.jsonl.
            self.jsonl.enabled = True
        self.publish(RESHARD_EVENT, doc, suspects=list(suspects),
                     info=info)
        env = exec_env(doc, self.host_id)
        if sock is not None and self.host_id != roster[0]:
            # Only the new rank 0's candidate port is adopted; release
            # ours now (rank 0's socket frees at exec, close-on-exec).
            try:
                sock.close()
            except OSError:
                pass
        print(f"elastic: resharding to generation {gen} roster {roster} "
              f"(lost {doc['dead']}); restarting in place as rank "
              f"{rerank(roster, self.host_id)} of {len(roster)}",
              flush=True)
        self._exec(sys.executable, self.argv, env)
        return True  # reached only with an injected _exec

    # -- telemetry --------------------------------------------------------
    def publish(self, event: str, doc: Dict[str, Any], **extra) -> None:
        """Counter + flight row + events row + registry flush — the
        forensic trail must be on disk before exec replaces the
        image. Best-effort throughout."""
        row = {"generation": doc["generation"], "roster": doc["roster"],
               "dead": doc.get("dead", []),
               "orig_processes": doc["orig_processes"],
               "coordinator": doc.get("coordinator"), **extra}
        try:
            flightrec.record(event, **row)
        except Exception:
            pass
        if self.registry is not None:
            try:
                counter = (RESHARDS_COUNTER if event == RESHARD_EVENT
                           else RE_EXPANSIONS_COUNTER)
                self.registry.counter(counter).inc()
                self.registry.gauge(GENERATION_GAUGE).set(
                    float(doc["generation"]))
                self.registry.gauge(LOST_HOSTS_GAUGE).set(
                    float(doc["orig_processes"] - len(doc["roster"])))
            except Exception:
                pass
        if self.jsonl is not None:
            try:
                self.jsonl.log(event, **row)
                if self.registry is not None:
                    self.registry.flush_jsonl(self.jsonl, phase=event)
            except Exception:
                pass
        if self.prom_path and self.registry is not None:
            try:
                self.registry.write_prometheus(self.prom_path)
            except Exception:
                pass

    def full_roster_doc(self, coordinator: str) -> Dict[str, Any]:
        """The re-expansion target: next generation, every original
        host back in the roster."""
        return {
            "generation": self.generation + 1,
            "roster": list(range(self.orig_processes)),
            "dead": [],
            "orig_processes": self.orig_processes,
            "coordinator": coordinator,
            "ts": time.time(),
        }

    def exec_into(self, doc: Dict[str, Any]) -> None:
        """Restart-in-place into ``doc``'s generation (re-expansion)."""
        self.publish(RE_EXPAND_EVENT, doc)
        print(f"elastic: re-expanding to generation {doc['generation']} "
              f"roster {doc['roster']}; restarting in place", flush=True)
        self._exec(sys.executable, self.argv, exec_env(doc, self.host_id))


# ---------------------------------------------------------------------------
# startup gate (backfilled hosts)
# ---------------------------------------------------------------------------

def startup_disposition(self_host: int, roster_doc: Optional[Dict[str, Any]],
                        lease_ages: Dict[int, float],
                        stalled_after_s: float) -> str:
    """Pure decision for a process launched with the ORIGINAL env (no
    ``MAML_ELASTIC_GENERATION``): ``"full"`` — proceed at the original
    geometry (fresh run, or whole-job restart of a dead group) — or
    ``"backfill_wait"`` — a degraded survivor group is LIVE and this
    host is not in its roster, so it must rejoin via the roster file
    rather than stand up a rival full-geometry ring.

    Liveness is read from the CURRENT generation's rank leases: any
    fresh lease among ranks [0, len(roster)) means the group is live.
    """
    if roster_doc is None:
        return "full"
    roster = [int(h) for h in roster_doc.get("roster", [])]
    orig = int(roster_doc.get("orig_processes", len(roster)))
    if not roster or len(roster) >= orig or self_host in roster:
        return "full"
    live = any(age <= stalled_after_s
               for rank, age in lease_ages.items()
               if 0 <= int(rank) < len(roster))
    return "backfill_wait" if live else "full"


def backfill_wait(lease_dir: str, self_host: int, stalled_after_s: float,
                  poll_s: float = 1.0,
                  timeout_s: Optional[float] = None
                  ) -> Optional[Dict[str, Any]]:
    """Rejoin protocol for a backfilled host: announce via a rejoin
    file, then wait for either (a) a roster generation that includes us
    — returned so the caller can adopt its env — or (b) the survivor
    group's leases going stale (it died or restarted full), returning
    None so the caller proceeds at the original geometry. ``timeout_s``
    bounds the wait for tests; production backfills wait as long as
    the survivors keep training."""
    from howtotrainyourmamlpytorch_tpu_torch.resilience.cluster import (
        read_lease_ages)
    entry = read_roster(lease_dir)
    entry_gen = int(entry.get("generation", 0)) if entry else 0
    write_rejoin(lease_dir, self_host)
    deadline = (time.monotonic() + timeout_s
                if timeout_s is not None else None)
    try:
        while deadline is None or time.monotonic() < deadline:
            doc = read_roster(lease_dir)
            if (doc is not None
                    and int(doc.get("generation", 0)) > entry_gen
                    and self_host in [int(h) for h in
                                      doc.get("roster", [])]):
                return doc
            current = doc if doc is not None else entry
            n_ranks = len((current or {}).get("roster", [])) or 1
            ages = read_lease_ages(lease_dir, expected_hosts=n_ranks)
            if ages and all(a > stalled_after_s for a in ages.values()):
                return None  # the degraded group is gone: launch full
            time.sleep(poll_s)
    finally:
        try:
            os.unlink(rejoin_path(lease_dir, self_host))
        except OSError:
            pass
    return None
