"""Experiment orchestration: train loop, validation sweeps, checkpointing,
and the top-k ensemble test protocol (the port's counterpart of the JAX
package's ``experiment.py § ExperimentBuilder``).

Reference (``experiment_builder.py § ExperimentBuilder``): per epoch,
``total_iter_per_epoch`` train iterations → a full validation sweep → a
CSV stats row → an epoch checkpoint + ``latest`` (keeping the top
``max_models_to_save`` by val accuracy); after training, each kept
checkpoint runs over the fixed test episodes and their per-sample softmax
probabilities are summed into the ensemble's prediction
(``test_summary.csv``).

On the card:

* The phase flags (derivative-order annealing, MSL window) are read per
  epoch; ``precompile_phases`` is a documented no-op (the warm-start
  store below is what captures the phase executables).
* Per-step metrics stay on the device and are fetched once at the
  epoch's end; the loss is fetched every ``dispatch_sync_every`` steps,
  for the divergence guard, the live progress line and preemption.
* The fixed val/test batches are cached on the device
  (``cache_eval_episodes``).
* SIGTERM/SIGINT snapshot ``latest`` at the current iteration and return
  ``{"preempted_at_iter": ...}`` (the CLI exits 75); a second signal while
  the first drains exits 75 at once.

* ``run_experiment`` runs under the entry point's numerics policy
  (``device.numerics_policy``): f32 configs with TF32 off, cuDNN
  deterministic, the previous flags restored afterwards.

Telemetry (``telemetry/``), the JAX package's rows at the same loop
points: a metrics registry (also the resilience counters' registry)
flushed to ``events.jsonl`` and ``logs/metrics.prom`` per epoch, at a
preemption and after the test protocol; per epoch one ``telemetry`` row
(step-time quantiles, feed stall, device memory) and one ``heartbeat``
row, and ``logs/trace.json``; alert rules (``alert_rules_path``);
training-health rows (``health_metrics_every_n_steps``, at dispatch-sync
points); the perf sampler (``profile_every_n_steps``: ``perf_profile``
rows, ``logs/PROFILE.json``); a device trace of epoch ``profile_epoch``
(``profile_dir``); TensorBoard scalars (``use_tensorboard``). Off, each
costs one ``None`` check where it would act. ``logs/PROFILE.json`` holds
the run's cost cards (the warm-start store's, one per captured
executable, and the sampler's) whenever the sampler or the store is on;
it is written after the store's adoption and again at the run's end.

Resilience (``resilience/``), at the JAX package's loop points:

* The watchdog and flight recorder are installed for ``run_experiment``
  iff any ``watchdog_*_timeout_s`` > 0 (the defaults are on). The loop
  stamps ``step`` per iteration and per eval batch, and a step variant's
  (or the eval step's) first call runs under ``compile``: it pays for
  CUDA's lazy init, cuDNN/cuBLAS handles and the first-use ``nvcc``
  build. The host runs ahead of the card, so a wedged kernel is seen at
  the loss fetch every ``dispatch_sync_every`` steps, with ``step``
  stamped, or at a save's encode, under ``ckpt``. A trip writes
  ``logs/crash_bundle`` and exits 74 (``EXIT_HUNG``).
* Crash bundles also on a preemption, on an unhandled exception and on
  a second signal (before ``os._exit(75)``); ``logs/flight.jsonl`` and
  the flight layer of ``logs/trace.json`` every epoch.
* Fault injection (``fault_spec`` / ``MAML_FAULTS``; the env wins):
  ``nan_loss``, ``hang_step`` and ``kill`` at the dispatch-sync point,
  the storage, checkpoint and loader hooks in their modules.
* ``ckpt_async=1`` moves the epoch checkpoint's file writes to a
  background thread (``ckpt/writer.py``), drained before a rewind, the
  preemption snapshot, the test protocol and the run's end.

Checkpoints, ``state.json``, ``MANIFEST.json``, ``REGISTRY.json`` and the
CSVs are the JAX package's formats: either package resumes, evaluates or
serves the other's run.

Several processes (torchrun; ``parallel/``): the builder runs on the
(dcn, tasks) mesh of the process group, one rank per device. Its
geometry: a mesh that the world does not realize raises with
``require_mesh=1`` and otherwise warns and falls back to (1, 1) (with
several processes it must match the world exactly). Process 0 alone
writes ``config.json``, checkpoints, ``state.json``, the CSVs,
``events.jsonl`` and the timeline; every rank keeps the checkpoint
bookkeeping. Filesystem-dependent decisions are agreed across ranks:
fresh run or resume, which checkpoint, its iteration and its content
fingerprint, a rewind's target, each ensemble member's fingerprint, and
the stop decisions (divergence rewind, preemption) at every sync point
and epoch boundary. Barriers order process 0's writes before the
others' reads (``builder_init``, ``checkpoints_written``). Crash bundles
go to ``crash_bundle_p<rank>``.

The pod fault domain (``cluster_collective_timeout_s`` > 0,
``resilience/cluster.py``), at the JAX package's points: the run installs
the domain (its lease under ``<experiment>/cluster/``, touched at every
sync point, every heartbeat row and every watchdog poll), arms the
watchdog's ``collective`` deadline at the cluster budget, and a lost
peer ends a rank with a ``peer_lost`` row naming the suspect hosts, a
crash bundle and exit 73 (``EXIT_PEER_LOST``); ``kill_peer`` SIGKILLs a
rank at the sync point, before the stop-decision collective. After such
a restart ``_resume`` agrees every rank on the newest epoch all of them
see committed. With ``elastic_mode=1`` (``resilience/elastic.py``) the
survivors agree on a roster and restart in place at the degraded
geometry (``apply_roster``, before anything reads the config); a
degraded run counts its epochs and re-expands when every missing host
has asked to rejoin.

Warm start (``parallel/aot.py``, the JAX package's ``_adopt_aot_plan``
and ``warm_start`` row): ``compilation_cache_dir`` is the kernel build
cache for the run (``ops/build.py § set_cache_dir``). With
``aot_store_dir`` (on the card: a ``ValueError`` on the CPU), the train
step of each phase key of the remaining schedule and the eval step run
as CUDA graphs: a rank's train step as two graphs, the rank-local
accumulation and the update, around its one all-reduce, which runs
eagerly between them; the eval step as one graph before its eager
all-gather. One process captures its first phase key's and the eval
step's before the first step (hits from the store's records, misses
captured and recorded), a later key's at its phase boundary on the
stepping thread, before its epoch's batches are asked for (the JAX
trainer compiles those on a background thread). Under several processes
every rank captures every key before the first step, none deferred;
process 0 alone writes records, and the store's fingerprint holds the
world size, so a survivor roster finds its own directory
(``scripts/torch_aot_prewarm.py --degraded``). Steps with training
health, and a phase's first step under the perf sampler (which counts
its FLOPs), run eagerly. Each session logs one ``warm_start`` row after
its first train step (time to it, kernel builds and graph misses
captured before it, hits, misses, and whether the config's backend
options keep the bitwise resume contract), every rank of several also
into ``logs/warm_start_p<rank>.jsonl``, and sets the ``warm_start/*``
gauges.
"""

from __future__ import annotations

import logging
import os
import signal
import sys
import time
import warnings
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from howtotrainyourmamlpytorch_tpu_torch import resilience
from howtotrainyourmamlpytorch_tpu_torch.ckpt import writer as ckpt_writer
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.data.loader import (
    MetaLearningDataLoader)
from howtotrainyourmamlpytorch_tpu_torch.device import (DeviceLike,
                                                        numerics_policy,
                                                        resume_is_bitwise,
                                                        synchronize)
from howtotrainyourmamlpytorch_tpu_torch.meta.inner import (
    adapted_param_counts)
from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
    MetaTrainState, init_train_state, migrate_lslr_rows, reconcile_loaded_shapes, state_leaf_shapes)
from howtotrainyourmamlpytorch_tpu_torch.models import make_model
from howtotrainyourmamlpytorch_tpu_torch.ops import build
from howtotrainyourmamlpytorch_tpu_torch.parallel import aot, multihost
from howtotrainyourmamlpytorch_tpu_torch.parallel.mesh import (
    make_mesh, make_sharded_steps)
from howtotrainyourmamlpytorch_tpu_torch.parallel.multihost import (
    abort_all_if_any, agree_int_from_main, any_process_true,
    any_process_true_each, barrier, gather_host_ints)
from howtotrainyourmamlpytorch_tpu_torch.resilience import (EXIT_PREEMPTED,
                                                            DivergenceGuard,
                                                            cluster,
                                                            elastic,
                                                            faults,
                                                            flightrec,
                                                            watchdog)
from howtotrainyourmamlpytorch_tpu_torch.telemetry import (
    FeedStallMeter, MetricsRegistry, device_memory_stats, emit_heartbeat)
from howtotrainyourmamlpytorch_tpu_torch.telemetry import alerts as alerts_mod
from howtotrainyourmamlpytorch_tpu_torch.telemetry import health as health_mod
from howtotrainyourmamlpytorch_tpu_torch.telemetry import (
    profiler as profiler_mod)
from howtotrainyourmamlpytorch_tpu_torch.telemetry import trace as trace_mod
from howtotrainyourmamlpytorch_tpu_torch.utils.checkpoint import (
    LATEST, CheckpointManager)
from howtotrainyourmamlpytorch_tpu_torch.utils.storage import (
    build_experiment_folder, save_statistics, save_to_json)
from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import (
    JsonlLogger, StepTimer, profile_trace, read_jsonl)

def _mesh_geometry(cfg: MAMLConfig, world: int) -> MAMLConfig:
    """The config whose ``mesh_shape`` this world realizes: with several
    processes it must cover them exactly; one process with a bigger mesh
    raises under ``require_mesh=1`` and otherwise warns and falls back to
    (1, 1)."""
    n_mesh = int(np.prod(cfg.mesh_shape))
    if world > 1 and n_mesh != world:
        raise ValueError(
            f"mesh_shape {cfg.mesh_shape} covers {n_mesh} devices but "
            f"the pod exposes {world}; multi-host runs need mesh size == "
            f"global device count")
    if n_mesh <= world:
        return cfg
    if cfg.require_mesh:
        raise ValueError(
            f"mesh_shape {cfg.mesh_shape} needs {n_mesh} devices but "
            f"only {world} are visible and require_mesh=1; fix the "
            f"mesh/pod geometry or unset require_mesh to accept the "
            f"single-device fallback")
    warnings.warn(
        f"mesh_shape {cfg.mesh_shape} needs {n_mesh} devices but {world} "
        f"are visible; falling back to a single-device mesh")
    return cfg.replace(mesh_shape=(1, 1))


class ExperimentBuilder:
    """Builds and runs one experiment described by a :class:`MAMLConfig`,
    on ``device`` (the card by default; ``device="cpu"`` must be asked
    for), over the mesh of the process group when there is one."""

    def __init__(self, cfg: MAMLConfig, device: DeviceLike = None):
        self.device = multihost.rank_device(device)
        aot.require_card(cfg, self.device)
        # Every rank computes; process 0 alone writes the shared files.
        self.is_main_process = multihost.process_index() == 0
        self._multihost = multihost.process_count() > 1
        # Telemetry registry first: storage retries and checkpoint saves
        # below count into it (the last constructed builder's registry
        # is the process's).
        self.registry = MetricsRegistry()
        resilience.set_registry(self.registry)
        # Fault injection: the env wins over the config; the empty default
        # clears a previous builder's plan.
        faults.configure(os.environ.get(faults.ENV_VAR, "")
                         or cfg.fault_spec)
        # Elastic pod: a process restarted in place over a survivor
        # roster carries the MAML_ELASTIC_* trio; the config is degraded
        # to that roster's geometry HERE, before the mesh, plan or loader
        # reads it (generation 0, the ordinary case, leaves it as is).
        cfg, self._roster = elastic.apply_roster(cfg)
        if self._roster is not None:
            print(f"elastic: generation {self._roster.generation} roster "
                  f"{list(self._roster.roster)} of "
                  f"{self._roster.orig_processes} original hosts; mesh "
                  f"{cfg.mesh_shape}, {cfg.elastic_pad_tasks} pad "
                  f"task(s)", flush=True)
        self.paths = build_experiment_folder(cfg.experiment_root,
                                             cfg.experiment_name)
        cfg = _mesh_geometry(cfg, multihost.process_count())
        eff_mb = cfg.effective_task_microbatches(
            int(np.prod(cfg.mesh_shape)))
        if eff_mb != cfg.task_microbatches:
            msg = (f"task_microbatches {cfg.task_microbatches} clamped to "
                   f"{eff_mb} for this batch/mesh geometry (see "
                   f"MAMLConfig.effective_task_microbatches); the recorded "
                   f"config reflects what actually runs")
            warnings.warn(msg)
            logging.getLogger(__name__).warning(msg)
            cfg = cfg.replace(task_microbatches=eff_mb)
        self.cfg = cfg
        # The recorded config reflects what actually runs.
        if self.is_main_process:
            save_to_json(f"{self.paths['base']}/config.json", cfg.to_dict())

        self.model_init, self.model_apply = make_model(cfg)
        self.mesh = make_mesh(cfg)
        print(self.mesh.describe(self.device), flush=True)
        # Without a process group the mesh reduces nothing, and the
        # steps are the plain ones.
        self._plan = make_sharded_steps(cfg, self.model_apply, self.mesh)
        # The loop calls train_step: the phase key's executable once the
        # warm start adopted one (_dispatch_step), else the plan's step.
        self.train_step = self._dispatch_step
        self.eval_step = self._plan.eval_step
        self.data = MetaLearningDataLoader(cfg, device=self.device,
                                           registry=self.registry,
                                           mesh=self.mesh)
        # Process 0's earlier writes (a previous run's saves, a
        # preemption snapshot) land before any rank reads state.json.
        barrier("builder_init")
        self.ckpt = CheckpointManager(self.paths["saved_models"],
                                      max_to_keep=cfg.max_models_to_save,
                                      quarantine=self.is_main_process)
        # The async worker thread starts at the first async save, so a
        # builder that is never run leaks nothing.
        self.ckpt_writer = ckpt_writer.CheckpointWriter(
            self.ckpt, async_saves=bool(cfg.ckpt_async),
            queue_policy=cfg.ckpt_queue_policy,
            publish=cfg.ckpt_publish and self.is_main_process)
        # Size-capped at 64 MiB: one rotation into events.jsonl.1.
        self.jsonl = JsonlLogger(f"{self.paths['logs']}/events.jsonl",
                                 max_bytes=64 * 1024 * 1024,
                                 enabled=self.is_main_process)
        # Alert rules (telemetry/alerts.py), evaluated at the registry
        # flush points only; None when alert_rules_path is unset.
        self._alerts: Optional[alerts_mod.AlertEvaluator] = None
        self._last_heartbeat_ts: Optional[float] = None
        if cfg.alert_rules_path:
            self._alerts = alerts_mod.AlertEvaluator(
                alerts_mod.load_rules(cfg.alert_rules_path), source="train",
                snapshot_path=(f"{self.paths['logs']}/ALERTS.json"
                               if self.is_main_process else None))
            # A scrape before the first evaluation reads 0 firing.
            self.registry.gauge(alerts_mod.FIRING_GAUGE).set(0.0)
        self._feed_prev: Optional[Dict[str, float]] = None
        self._tb = None             # lazy SummaryWriter (_finish_epoch)
        self._tb_disabled = False   # set if the writer cannot be made
        # Training health (telemetry/health.py): the step computes the
        # diagnostics only on the dispatch-sync iterations this cadence
        # publishes. The grad-norm early warning has its own guard, so
        # it warns with rewinds off too.
        self._health_every = cfg.health_metrics_every_n_steps
        self._last_health_iter: Optional[int] = None
        self._norm_guard = (DivergenceGuard(
            patience=1, grad_norm_factor=cfg.health_grad_norm_warn_factor)
            if self._health_every > 0 else None)
        # Perf sampler (telemetry/profiler.py): made in run_experiment
        # iff profile_every_n_steps > 0. Phase keys whose first step
        # this session has run: that step counts the phase's FLOPs.
        self._perf: Optional[profiler_mod.PerfSampler] = None
        self._phases_run: set = set()
        # Watchdog and flight recorder: installed for run_experiment only,
        # iff any watchdog_*_timeout_s > 0. The eval step's first call
        # runs under 'compile' as a train phase's does.
        self._watchdog: Optional[watchdog.Watchdog] = None
        self._beacon: Optional[watchdog.ProgressBeacon] = None
        self._flightrec: Optional[flightrec.FlightRecorder] = None
        self._eval_compile_stamped = False
        # Warm start (parallel/aot.py): the store, its adoption stats, the
        # phase keys whose executables are adopted (graph or eager
        # fallback) and those probed at adoption for their boundary.
        self._aot_store: Optional[aot.AOTStore] = None
        self._aot_stats: Optional[Dict[str, Any]] = None
        self._phase_fns: Dict[Any, Any] = {}
        self._deferred: set = set()
        self._run_started_at: Optional[float] = None
        self._nvcc_at_start = 0
        self._captures_before_first_step: Optional[int] = None
        self._first_dispatch_noted = False
        # This session's warm_start row, once its first step returned.
        self.warm_start_row: Optional[Dict[str, Any]] = None
        # Pod fault domain and elastic policy: installed for
        # run_experiment only, iff cluster_collective_timeout_s > 0 (and
        # elastic_mode=1 for the policy).
        self._cluster: Optional[cluster.ClusterFaultDomain] = None
        self._elastic: Optional[elastic.ElasticPolicy] = None
        self.state = init_train_state(cfg, self.model_init, seed=cfg.seed,
                                      device=self.device)
        self.current_iter = 0
        # Set by the signal handler, checked once per train iteration.
        self._preempted = False
        # Divergence guard: observes the outer loss at dispatch-sync
        # points; a trigger rewinds to the last-good epoch checkpoint.
        self._guard = (DivergenceGuard(cfg.divergence_patience,
                                       cfg.divergence_spike_factor)
                       if cfg.divergence_patience > 0 else None)
        self._rewind_requested = False
        # Device-resident cache of the fixed val/test batches.
        self._eval_cache: Dict[str, List[Any]] = {}
        # The test protocol's ensemble argmax per (episode, query row);
        # the mean prediction for regression.
        self.ensemble_predictions: Optional[np.ndarray] = None
        if cfg.continue_from_epoch != "from_scratch":
            self._resume(cfg.continue_from_epoch)
        # Post-rewind train streams are salted by the persisted rewind
        # count, so a rewound-then-preempted run resumes the same stream.
        self.data.set_train_salt(int(self.ckpt.meta.get("rewinds", 0)))

    # ------------------------------------------------------------------
    def _load_member(self, tag) -> MetaTrainState:
        """Checkpoint ``tag`` as a state shaped like the live one (the
        pre-(K+1) LSLR migration and the shape reconciliation applied)."""
        template_shapes = state_leaf_shapes(self.state)
        state, _ = self.ckpt.load(self.state, tag)
        state = migrate_lslr_rows(self.cfg, state)
        return reconcile_loaded_shapes(self.cfg, state, template_shapes)

    def _resume(self, tag) -> None:
        """Fresh run or resume, which checkpoint and which iteration are
        filesystem-dependent decisions that every process must make alike
        (ranks entering the loop at different iterations deadlock in
        their first mismatched collective): process 0's resolution is
        adopted everywhere, and a process that cannot comply aborts
        every process. ``tag`` itself is config, identical on all ranks,
        so every rank runs the same collectives."""
        is_latest = -1
        from_latest = tag == LATEST
        # OR-reduce: if ANY rank sees checkpoint files or bookkeeping,
        # this is not a fresh run.
        if from_latest and not any_process_true(
                self.ckpt.has_any_checkpoint() or self.ckpt.meta_from_disk):
            return  # fresh run with continue_from_epoch='latest'
        if (from_latest and self._multihost
                and cluster.cluster_enabled(self.cfg)):
            # Consensus resume: after a peer-loss restart every rank
            # gathers its view of the newest committed epoch; when any
            # view disagrees (a stale cache or damaged MANIFEST.json on
            # SOME host), ALL ranks adopt the newest epoch every one of
            # them sees committed, instead of process 0's 'latest'.
            # Unanimous views keep the ordinary 'latest' path.
            local_view = cluster.latest_committed_epoch(self.ckpt.manifest)
            agreed = cluster.consensus_epoch(gather_host_ints(local_view))
            if agreed >= 0 and any_process_true(agreed != local_view):
                from_latest = False
                tag = agreed
                self.registry.gauge(cluster.CONSENSUS_EPOCH_GAUGE).set(
                    agreed)
                self.jsonl.log(cluster.CONSENSUS_EVENT,
                               consensus_epoch=agreed, local_view=local_view)
                print(f"cluster consensus: hosts disagree on the newest "
                      f"committed checkpoint (local view {local_view}); "
                      f"resuming every host from epoch {agreed}",
                      flush=True)
        template_shapes = state_leaf_shapes(self.state)
        err: Optional[BaseException] = None
        state, meta = self.state, {}
        try:
            if from_latest:
                # Falls back to the newest readable epoch checkpoint if
                # the latest file is missing or damaged.
                state, meta, tag = self.ckpt.load_latest_or_fallback(
                    self.state)
            else:
                state, meta = self.ckpt.load(self.state, tag)
        except Exception as e:  # noqa: BLE001 — re-raised on every rank
            err = e
        abort_all_if_any(err, "a peer process has no readable checkpoint")
        if from_latest:
            # The fallback resolution is per-process; adopt process 0's.
            local = is_latest if tag == LATEST else int(tag)
            agreed = agree_int_from_main(local)
            if agreed != local:
                tag = LATEST if agreed == is_latest else int(agreed)
                try:
                    state, meta = self.ckpt.load(self.state, tag)
                except Exception as e:  # noqa: BLE001 — as above
                    err = e
            abort_all_if_any(err, f"a peer process could not load the "
                                  f"agreed checkpoint {tag!r}")
        # The same tag can still mean other bytes (a stale filesystem
        # cache): the iteration must agree too, then the fingerprint.
        local_iter = int(meta["current_iter"])
        agreed_iter = agree_int_from_main(local_iter)
        if any_process_true(agreed_iter != local_iter):
            detail = (
                f"THIS process diverges: local iter {local_iter} vs "
                f"process 0's {agreed_iter} — stale filesystem cache?"
                if agreed_iter != local_iter else
                f"a peer process's iteration differs from process 0's "
                f"{agreed_iter} (this process agrees)")
            raise RuntimeError(
                "processes disagree on the resume iteration; aborting all "
                "processes instead of deadlocking in the first mismatched "
                "collective. " + detail)
        self.current_iter = local_iter
        self._agree_checkpoint_fingerprint(tag, "resume")
        if tag != LATEST:
            # Epochs after the resume point are abandoned; their
            # checkpoints must not feed the top-k ensemble.
            self.ckpt.rewind_to(int(tag), write=self.is_main_process)
        state = migrate_lslr_rows(self.cfg, state)
        self.state = reconcile_loaded_shapes(self.cfg, state,
                                             template_shapes)
        print(f"resumed from checkpoint {tag!r} at iter {self.current_iter}")

    def _agree_checkpoint_fingerprint(self, tag, context: str) -> None:
        """With several processes: checkpoint ``tag``'s bytes must match
        process 0's (a cheap content fingerprint and one collective).
        State is never broadcast, so this is what catches a stale cache
        serving one rank old bytes under the agreed tag."""
        if not self._multihost:
            return
        local_fp = self.ckpt.fingerprint(tag)
        if any_process_true(agree_int_from_main(local_fp) != local_fp):
            raise RuntimeError(
                f"processes disagree on the {context} checkpoint {tag!r}'s "
                f"content fingerprint (same tag, different bytes — stale "
                f"filesystem cache?); aborting all processes")

    # ------------------------------------------------------------------
    @property
    def epoch(self) -> int:
        return self.current_iter // self.cfg.total_iter_per_epoch

    def _train_epoch(self):
        """Train to the next epoch boundary (a resumed run mid-epoch does
        only the remainder). Returns the epoch's stats dict; None if
        preempted before the boundary (state snapshotted to 'latest');
        ``"rewind"`` if the divergence guard fired (nothing saved)."""
        cfg = self.cfg
        epoch = self.epoch
        iters_left = (cfg.total_iter_per_epoch
                      - self.current_iter % cfg.total_iter_per_epoch)
        second_order, use_msl = cfg.use_second_order(epoch), cfg.use_msl(epoch)
        phase_key = (second_order, use_msl)
        card_name = profiler_mod.phase_card_name(*phase_key)
        live = (cfg.live_progress and cfg.dispatch_sync_every > 0
                and self.is_main_process)
        live_tty = live and getattr(sys.stdout, "isatty", lambda: False)()
        live_samples: List[tuple] = []
        metrics_acc = []   # per step: (loss, accuracy, support loss) tensors
        meta_lr = None
        timer = StepTimer()
        t0 = time.time()
        timer.start()
        # The device trace covers the epoch's first profile_num_steps real
        # steps (no extra step; training is bitwise the same).
        prof = None
        if cfg.profile_dir and epoch == cfg.profile_epoch:
            prof = profile_trace(cfg.profile_dir, f"epoch{epoch}")
            prof.__enter__()
        # A deferred phase key's executable is captured here, on the
        # stepping thread, before this epoch's batches are asked for.
        self._adopt_deferred(phase_key, epoch)
        batches = self.data.get_train_batches(self.current_iter, iters_left)
        try:
            for i, batch in enumerate(batches):
                if prof is not None and i == cfg.profile_num_steps:
                    prof.__exit__(None, None, None)
                    prof = None
                sync_point = bool(cfg.dispatch_sync_every and (
                    (i + 1) % cfg.dispatch_sync_every == 0))
                # Health is computed only on the iterations it is
                # published on: dispatch-sync points on its cadence.
                want_health = bool(
                    self._health_every and sync_point
                    and (self._last_health_iter is None
                         or self.current_iter + 1 - self._last_health_iter
                         >= self._health_every))
                # Progress beacon: "dispatching train step <iter>". A
                # variant's first call pays for CUDA's lazy init, the
                # library handles and the kernel's first-use build, so it
                # runs under the compile budget instead.
                watchdog.stamp("step", detail=self.current_iter)
                first_call = phase_key not in self._phases_run
                # Perf sampler: one step under the profiler on its
                # cadence, never a phase's first step (that one counts
                # the phase's FLOPs) nor while the device trace records.
                sampling = (self._perf is not None and not first_call
                            and prof is None
                            and self._perf.due(self.current_iter)
                            and self._perf.start_window(self.current_iter))
                step = lambda: self.train_step(
                    self.state, batch, epoch, second_order=second_order,
                    use_msl=use_msl, health=want_health)
                try:
                    if first_call:
                        with watchdog.phase("compile",
                                            detail=str(phase_key)):
                            self.state, metrics = self._first_step(
                                step, card_name, batch)
                    else:
                        self.state, metrics = step()
                except BaseException:
                    # The process-wide profiler must not stay on.
                    if sampling:
                        self._perf.abort_window()
                    raise
                self._phases_run.add(phase_key)
                if not self._first_dispatch_noted:
                    self._note_first_dispatch()
                if sampling:
                    self._perf.end_window(self.current_iter, epoch=epoch,
                                          executable=card_name)
                # Stays on the device until the epoch's end.
                metrics_acc.append((metrics.loss.detach(),
                                    metrics.accuracy.detach(),
                                    metrics.support_loss.detach()))
                meta_lr = metrics.learning_rate
                self.current_iter += 1
                timer.tick()
                if sync_point:
                    # The one fetch between epoch ends: it bounds how far
                    # the host runs ahead, so a signal takes effect within
                    # dispatch_sync_every iterations.
                    loss_now = float(metrics.loss)
                    # Fault hooks and the guard act here, on a scalar
                    # fetched anyway.
                    nan_fault = faults.maybe_fire("nan_loss",
                                                  step=self.current_iter)
                    if nan_fault:
                        loss_now = float("nan")
                    if faults.maybe_fire("hang_step",
                                         step=self.current_iter):
                        # A wedged step ('step' is stamped): the watchdog
                        # must end the process.
                        faults.hang()
                    if self._cluster is not None:
                        # Heartbeat lease: a rate-limited touch on a
                        # fetch that already synced.
                        self._cluster.heartbeat(detail=self.current_iter)
                    if faults.maybe_fire("kill_peer",
                                         step=self.current_iter):
                        # A lost host as its peers see it: no handler, no
                        # save, no cleanup, BEFORE the stop-decision
                        # collective below, so the peers strand in it
                        # and must name this rank and exit 73.
                        os.kill(os.getpid(), signal.SIGKILL)
                    # Health before the guard: a divergence post-mortem
                    # reads warn -> rewind in log order.
                    if metrics.health is not None:
                        self._observe_health(metrics.health, epoch,
                                             nan_fault)
                    if live:
                        live_samples.append((loss_now,
                                             float(metrics.accuracy)))
                        means = np.mean(live_samples, axis=0)
                        done = ((self.current_iter - 1)
                                % cfg.total_iter_per_epoch + 1)
                        line = (f"epoch {epoch}: iter {done}"
                                f"/{cfg.total_iter_per_epoch} "
                                f"loss {means[0]:.4f} acc {means[1]:.4f}")
                        print(f"\r{line}" if live_tty else line,
                              end="" if live_tty else "\n", flush=True)
                    rewind = (self._guard is not None
                              and self._guard.observe(loss_now,
                                                      self.current_iter))
                    if faults.maybe_fire("kill", step=self.current_iter):
                        # The real preemption path: handler -> flag ->
                        # snapshot.
                        signal.raise_signal(signal.SIGTERM)
                    if self._multihost:
                        # One OR-reduce for both stop decisions: a lone
                        # rank's signal must stop every rank at the SAME
                        # iteration.
                        rewind, self._preempted = any_process_true_each(
                            (rewind, self._preempted))
                    if rewind:
                        self._rewind_requested = True
                        break
                    if self._preempted:
                        break
                elif self._preempted and not self._multihost:
                    break
        finally:
            # Stops the loader's prefetch thread on a break or an error.
            batches.close()
            if prof is not None:
                prof.__exit__(None, None, None)
        # The epoch-end wait is for the steps still queued on the card:
        # the step deadline, not the feed's (the loader stamped 'feed'
        # before it found the end of the epoch).
        watchdog.stamp("step", detail=self.current_iter)
        synchronize(self.device)
        if live_tty and live_samples:
            print("\r\x1b[K", end="")  # clear the in-place progress line
        if self._rewind_requested:
            return "rewind"  # the poisoned state is never checkpointed
        if self._preempted:
            # Mid-epoch snapshot to 'latest' only; resume continues at
            # exactly this iteration with the same batch stream.
            self.ckpt_writer.save_latest(self.state, self.current_iter,
                                         write=self.is_main_process)
            self.jsonl.log("preempt_checkpoint", iter=self.current_iter)
            # Final registry snapshot: counters since the last epoch
            # flush must not die with the process.
            self._flush_registry(phase="preempt")
            print(f"preempted: saved latest checkpoint at iter "
                  f"{self.current_iter}")
            return None
        dt = time.time() - t0
        loss, acc, s_loss = (torch.stack(col).float().cpu().numpy()
                             for col in zip(*metrics_acc))
        tasks = len(metrics_acc) * cfg.batch_size
        stats = {
            "train_loss": float(np.mean(loss)),
            "train_accuracy": float(np.mean(acc)),
            "train_support_loss": float(np.mean(s_loss)),
            "meta_lr": float(meta_lr),
            "epoch_seconds": dt,
            "meta_tasks_per_sec": tasks / dt,
            "meta_tasks_per_sec_per_chip": tasks / dt / self.mesh.size,
        }
        # Host dispatch intervals; the epoch-end sync folds the device's
        # tail into the last one.
        tsum = timer.summary(cfg.batch_size, self.mesh.size)
        self.jsonl.log("train_epoch", epoch=epoch, iter=self.current_iter,
                       second_order=second_order, use_msl=use_msl, **stats,
                       **{f"dispatch_{k}": v for k, v in tsum.items()})
        self._emit_epoch_telemetry(epoch, timer, tsum, stats)
        return stats

    def _dispatch_step(self, state, batch, epoch, *, second_order: bool,
                       use_msl: bool, plain: bool = False,
                       health: bool = False):
        """The train step the loop calls: the phase key's executable
        (parallel/aot.py) when the warm start adopted one, except for a
        phase's first step under the perf sampler (it counts the phase's
        FLOPs); otherwise the plan's eager step."""
        key = (second_order, use_msl)
        fn = self._phase_fns.get(key)
        if fn is None or (self._perf is not None
                          and key not in self._phases_run):
            fn = self._plan.train_step
        return fn(state, batch, epoch, second_order=second_order,
                  use_msl=use_msl, plain=plain, health=health)

    def _first_step(self, step, card_name: str, batch):
        """A step variant's first call. With the perf sampler on and no
        card of the variant registered (the store's, when it captured
        one), it counts the variant's FLOPs, bytes accessed and memory
        into its cost card: arguments (state and batch) and outputs by
        their tensors; on the card the temporaries too, the step's peak
        allocation above what was allocated before it
        (``max_memory_allocated`` after ``reset_peak_memory_stats``) less
        its outputs. On the CPU the temporaries are not measured: the
        card's memory holds the argument and output sizes only."""
        perf = self._perf
        if perf is None or card_name in perf.cards:
            return step()
        on_card = self.device.type == "cuda"
        if on_card:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            before = torch.cuda.memory_allocated(self.device)
        result, costs = profiler_mod.counted(step)
        out = profiler_mod.tree_bytes(result)
        temp = None
        if on_card:
            torch.cuda.synchronize(self.device)
            temp = max(torch.cuda.max_memory_allocated(self.device)
                       - before - out, 0)
        card = profiler_mod.card_from_costs(
            card_name, costs, kind=perf.kind, peaks=perf.peaks,
            memory=profiler_mod.memory_stats(
                profiler_mod.tree_bytes((self.state, batch)), out, temp))
        if "count_error" in card:
            perf._count_error(RuntimeError(card["count_error"]))
        perf.register_card(card_name, card)
        return result

    def _observe_health(self, health: Dict[str, torch.Tensor], epoch: int,
                        nan_fault: bool = False) -> None:
        """Fetch one health snapshot and publish it (``health/*`` gauges,
        one ``health`` row), then feed the outer-grad norm to the early
        warning. ``nan_fault``: the ``nan_loss`` fault poisons the
        observed grad norm too, as a real non-finite outer loss would, so
        the warning lands before the rewind."""
        self._last_health_iter = self.current_iter
        fetched = health_mod.fetch_health(health)
        if nan_fault:
            fetched["grad_norm"] = float("nan")
        health_mod.publish_health(self.registry, self.jsonl, fetched,
                                  iteration=self.current_iter, epoch=epoch)
        grad_norm = float(fetched["grad_norm"])
        if (self._norm_guard is not None
                and self._norm_guard.observe_grad_norm(grad_norm)):
            self.jsonl.log(health_mod.GRAD_NORM_WARN_EVENT,
                           iter=self.current_iter, epoch=epoch,
                           grad_norm=grad_norm)
            print(f"health: outer-grad norm warning at iter "
                  f"{self.current_iter} (norm {grad_norm:g})", flush=True)

    def _emit_epoch_telemetry(self, epoch: int, timer: StepTimer,
                              tsum: Dict[str, float],
                              stats: Dict[str, float]) -> None:
        """Per-epoch rollup: registry update, one ``telemetry`` row and one
        ``heartbeat`` row. Device memory is None on the CPU and eager
        PyTorch compiles nothing, so those read "unavailable" in the
        report, never a fake zero."""
        reg = self.registry
        for key, value in stats.items():
            reg.gauge(f"train/{key}").set(value)
        hist = reg.histogram("step_seconds")
        for dt in timer.durations:
            hist.observe(dt)
        # Per-epoch delta of the loader's cumulative feed meter.
        feed_now = self.data.feed.snapshot()
        feed = FeedStallMeter.delta(feed_now, self._feed_prev)
        self._feed_prev = feed_now
        reg.gauge("feed/stall_frac").set(feed["feed_stall_frac"])
        mem = device_memory_stats(self.device)
        if mem is not None:
            reg.gauge("memory/live_bytes_total").set(
                mem["live_bytes_total"])
            reg.gauge("memory/peak_bytes_max_device").set(
                mem["peak_bytes_max_device"])
        # The beacon's age: a stalling run shows on the dashboard before
        # its watchdog trips.
        beacon = self._beacon
        progress_age = beacon.age() if beacon is not None else None
        if progress_age is not None:
            reg.gauge(watchdog.PROGRESS_AGE_GAUGE).set(progress_age)
        # Pod fault domain: refresh this rank's lease and put every
        # rank's lease age on the row, so a stalling peer shows in
        # events.jsonl before any deadline trips.
        lease_ages = None
        if self._cluster is not None:
            self._cluster.heartbeat(detail=f"epoch_{epoch}", force=True)
            lease_ages = {str(h): (round(a, 3) if np.isfinite(a) else None)
                          for h, a in sorted(
                              self._cluster.peer_lease_ages().items())}
        self.jsonl.log(
            "telemetry", epoch=epoch, iter=self.current_iter,
            step_seconds_p50=tsum.get("p50_step_seconds"),
            step_seconds_p95=tsum.get("p95_step_seconds"),
            step_seconds_mean=tsum.get("mean_step_seconds"),
            meta_tasks_per_sec_per_chip=stats.get(
                "meta_tasks_per_sec_per_chip"),
            compile_count_total=None, compile_seconds_total=None,
            feed_wait_seconds=feed["feed_wait_seconds"],
            feed_dispatch_seconds=feed["feed_dispatch_seconds"],
            feed_stall_frac=feed["feed_stall_frac"],
            memory=mem)
        emit_heartbeat(self.jsonl, epoch=epoch, iteration=self.current_iter,
                       local_mean_step_seconds=tsum.get(
                           "mean_step_seconds", 0.0),
                       process_index=self.mesh.rank,
                       progress_age_seconds=progress_age,
                       progress_phase=(beacon.current()[0]
                                       if beacon is not None else None),
                       **({"peer_lease_age_seconds": lease_ages}
                          if lease_ages is not None else {}),
                       **({"alerts_firing": self._alerts.firing_summary()}
                          if self._alerts is not None else {}))
        self._last_heartbeat_ts = time.time()

    def _evaluate_alerts(self) -> None:
        """One alert-rule pass over the registry snapshot (no-op without
        rules), at the registry flush points only. The ``heartbeat``
        absence signal is the age of this run's last heartbeat row."""
        if self._alerts is None:
            return
        now = time.time()
        ages: Dict[str, float] = {}
        if self._last_heartbeat_ts is not None:
            ages["heartbeat"] = now - self._last_heartbeat_ts
        self._alerts.evaluate(now=now, snapshot=self.registry.snapshot(),
                              ages=ages, jsonl=self.jsonl,
                              registry=self.registry)

    def _flush_registry(self, **extra) -> None:
        """Alert pass, then the registry as one ``metrics`` row and
        ``logs/metrics.prom`` (process 0)."""
        self._evaluate_alerts()
        self.registry.flush_jsonl(self.jsonl, **extra)
        if self.is_main_process:
            self.registry.write_prometheus(
                f"{self.paths['logs']}/metrics.prom")

    def _eval_batches(self, split: str) -> Iterable:
        """The split's fixed evaluation batches, device-cached after the
        first sweep (they are a pure function of the fixed eval seeds)."""
        src = (self.data.get_val_batches if split == "val"
               else self.data.get_test_batches)
        if not self.cfg.cache_eval_episodes:
            return src()
        if split not in self._eval_cache:
            self._eval_cache[split] = list(src())
        return self._eval_cache[split]

    def _evaluate(self, batches: Iterable, state: MetaTrainState,
                  collect_logits: bool = False) -> Dict[str, Any]:
        """Run eval batches, truncated to exactly num_evaluation_tasks
        episodes (the loader pads the final batch); one fetch at the
        end."""
        n_left = self.cfg.num_evaluation_tasks
        losses, accs, logits = [], [], []
        for batch in batches:
            # Eval stamps 'step' too: a validation sweep or the test
            # protocol can hang like training; its first call pays its
            # own first-use costs.
            watchdog.stamp("step", detail="eval")
            if not self._eval_compile_stamped:
                self._eval_compile_stamped = True
                with watchdog.phase("compile", detail="eval"):
                    res = self.eval_step(state, batch)
            else:
                res = self.eval_step(state, batch)
            take = min(n_left, res.loss.shape[0])
            losses.append(res.loss[:take])
            accs.append(res.accuracy[:take])
            if collect_logits:
                logits.append(res.target_logits[:take])
            n_left -= take
        acc = torch.cat(accs).float().cpu().numpy()
        out: Dict[str, Any] = {
            "loss": float(np.mean(torch.cat(losses).float().cpu().numpy())),
            "accuracy": float(np.mean(acc)),
            "per_task_accuracy": acc,
        }
        if collect_logits:
            out["logits"] = torch.cat(logits).float().cpu().numpy()
        return out

    # ------------------------------------------------------------------
    def _bundle_dir(self) -> str:
        """Where this run's crash bundles go: one per process with
        several, so ranks do not overwrite each other's forensics."""
        suffix = f"_p{self.mesh.rank}" if self._multihost else ""
        return os.path.join(self.paths["logs"], f"crash_bundle{suffix}")

    def run_experiment(self) -> Dict[str, Any]:
        """Train, validate and test under the entry point's numerics
        policy (TF32 off for f32 configs, cuDNN deterministic; restored
        on return), with the watchdog and flight recorder installed for
        the run when any watchdog deadline is on, and the pod fault
        domain (and elastic policy) when the cluster budget is."""
        cfg = self.cfg
        # The cluster budget tightens the watchdog's collective deadline
        # (and turns the watchdog on: the watchdog thread enforces it).
        deadlines = cluster.arm_deadlines(
            cfg, watchdog.deadlines_from_config(cfg))
        wd_enabled = any(v > 0 for v in deadlines.values())
        prev_recorder = prev_beacon = prev_profile = prev_cluster = None
        if cluster.cluster_enabled(cfg):
            prev_cluster = self._install_cluster()
        if wd_enabled:
            self._flightrec = flightrec.FlightRecorder(
                cfg.flight_recorder_events)
            prev_recorder = flightrec.install(self._flightrec)
            self._beacon = watchdog.ProgressBeacon()
            prev_beacon = watchdog.install_beacon(self._beacon)
            self._beacon.stamp("step", detail=self.current_iter)
            self._watchdog = watchdog.Watchdog(
                self._beacon, deadlines, bundle_dir=self._bundle_dir(),
                registry=self.registry, jsonl=self.jsonl,
                prom_path=f"{self.paths['logs']}/metrics.prom",
                poll_interval_s=cfg.watchdog_poll_interval_s,
                process_index=self.mesh.rank, cluster=self._cluster).start()
            # Every metrics row shows "0 trips", not a missing counter.
            self.registry.counter(watchdog.TRIPS_COUNTER)
        if cfg.profile_every_n_steps > 0:
            self._perf = profiler_mod.PerfSampler(
                cfg.profile_every_n_steps, registry=self.registry,
                jsonl=self.jsonl, device=self.device)
            # A crash bundle carries the cost cards once they are on disk.
            prev_profile = flightrec.register_profile(os.path.join(
                self.paths["logs"], profiler_mod.PROFILE_FILE))
        # The kernel build cache for the run (restored on return).
        prev_cache = (build.set_cache_dir(cfg.compilation_cache_dir)
                      if cfg.compilation_cache_dir else None)
        self._run_started_at = time.time()
        self._nvcc_at_start = build.nvcc_runs
        self._first_dispatch_noted = False
        try:
            with numerics_policy(cfg.compute_dtype, deterministic=True,
                                 options=cfg.xla_compiler_options_dict):
                # Captures run under the policy the steps run under.
                self._adopt_aot_plan()
                if self._perf is not None or self._aot_store is not None:
                    self._write_profile_json()
                result = self._run_experiment()
            if (self._flightrec is not None
                    and "preempted_at_iter" in result):
                # A preemption post-mortem gets the same last-seconds
                # context a crash gets.
                flightrec.write_crash_bundle(
                    self._bundle_dir(), reason="preempted",
                    info={"iter": self.current_iter},
                    registry=self.registry, process_index=self.mesh.rank)
            return result
        except BaseException as e:
            # Not for SystemExit: an orderly exit carries no mystery.
            if (self._flightrec is not None
                    and not isinstance(e, SystemExit)):
                flightrec.write_crash_bundle(
                    self._bundle_dir(),
                    reason=f"exception:{type(e).__name__}",
                    info={"error": str(e)[:500], "iter": self.current_iter},
                    registry=self.registry, process_index=self.mesh.rank)
            raise
        finally:
            # Drain and stop the async writer: an orderly exit leaves
            # every enqueued save on disk.
            try:
                self.ckpt_writer.close()
            except Exception as e:  # noqa: BLE001 — the run's result
                # survives a failed final flush; the write-error counter
                # and warning already reported it.
                logging.getLogger(__name__).warning(
                    "checkpoint writer close failed (%s: %s)",
                    type(e).__name__, e)
            if self._watchdog is not None:
                self._watchdog.stop()
                self._watchdog = None
            if self._cluster is not None:
                self._cluster.close()
                cluster.install(prev_cluster)
                self._cluster = None
                self._elastic = None
            # Refresh logs/PROFILE.json with the cards of phase keys
            # captured or counted since the start.
            if self._perf is not None or self._aot_store is not None:
                self._write_profile_json()
            if self._perf is not None:
                flightrec.register_profile(prev_profile)
            if wd_enabled:
                watchdog.install_beacon(prev_beacon)
                flightrec.install(prev_recorder)
                self._beacon = None
                self._flightrec = None
            if self._tb is not None:
                # Release the writer's thread and file handle.
                self._tb.close()
                self._tb = None
            if cfg.compilation_cache_dir:
                build.set_cache_dir(prev_cache)

    def _phase_order(self) -> List[Any]:
        """The phase keys ``(second_order, use_msl)`` the remaining
        schedule visits, in order."""
        cfg = self.cfg
        keys: List[Any] = []
        for e in range(self.epoch, cfg.total_epochs):
            key = (cfg.use_second_order(e), cfg.use_msl(e))
            if key not in keys:
                keys.append(key)
        return keys

    def _train_capture(self, key, epoch: int):
        """A capture function of phase ``key``'s train step, on the
        current state and a zero batch of this rank's shard (what a
        replay reads is the caller's), and the signature it is recorded
        under."""
        batch = aot.zero_episode(
            self.cfg, self.cfg.padded_batch_size // self.mesh.world,
            self.device)
        return (lambda: aot.TrainGraph(self.cfg, self._plan.train_step, key,
                                       self.state, batch, epoch),
                aot.signature_of(self.state, batch))

    def _adopt_aot_plan(self) -> None:
        """Warm-start adoption (parallel/aot.py): every phase key of the
        remaining schedule and the eval step are probed in the store
        (hits and misses counted); the first key's train step and the
        eval step are captured now, under the compile deadline (a miss
        is recorded for the next process), the later keys at their
        phase boundary (:meth:`_adopt_deferred`). Under several
        processes every key is captured now, none deferred (the JAX
        trainer's uniform dispatch across processes): each rank captures
        its own graphs before the ranks' first collective, and process 0
        alone writes records. Fail-soft: a failed capture leaves the
        eager step, counted."""
        cfg = self.cfg
        if not aot.enabled(cfg) or self._aot_store is not None:
            return
        for name in aot.COUNTERS:
            self.registry.counter(name)
        keys = [] if cfg.evaluate_on_test_set_only else self._phase_order()
        stats: Dict[str, Any] = {"hits": 0, "misses": 0}
        captures = 0
        with watchdog.phase("compile", detail="aot_adopt"):
            store = aot.AOTStore.from_config(
                cfg, self.device, registry=self.registry,
                writer=self.is_main_process)
            self._aot_store = store
            for i, key in enumerate(keys):
                capture, sig = self._train_capture(key, self.epoch)
                name = aot.train_exec_name(key)
                if i == 0 or self._multihost:
                    fn, hit = aot.load_or_compile(
                        store, name, capture, sig, registry=self.registry,
                        fallback=self._plan.train_step)
                    self._phase_fns[key] = fn
                    captures += int(not hit)
                else:
                    hit = aot.probe(store, name, sig)
                    self._deferred.add(key)
                stats["hits" if hit else "misses"] += 1
            batch = aot.zero_episode(
                cfg, cfg.effective_eval_batch_size // self.mesh.world,
                self.device)
            eager_eval = self.eval_step
            self.eval_step, hit = aot.load_or_compile(
                store, "eval",
                lambda: aot.EvalGraph(self._plan.eval_step, self.state,
                                      batch),
                aot.EvalGraph.signature(self.state, batch),
                registry=self.registry, fallback=eager_eval)
            stats["hits" if hit else "misses"] += 1
            captures += int(not hit)
        stats.update(fingerprint=store.fingerprint, store_dir=store.dir)
        self._aot_stats = stats
        self._captures_before_first_step = captures
        if self.is_main_process:
            print(f"warm start: {stats['hits']} executable(s) captured "
                  f"from store records, {captures} captured and recorded"
                  + (f", {len(self._deferred)} at their phase boundary"
                     if self._deferred else "")
                  + f" (store {store.dir})", flush=True)

    def _adopt_deferred(self, key, epoch: int) -> None:
        """Capture phase ``key``'s train step at its boundary (probed and
        counted at adoption), on this thread with the loader idle."""
        if key not in self._deferred:
            return
        self._deferred.discard(key)
        capture, sig = self._train_capture(key, epoch)
        with watchdog.phase("compile", detail=f"aot_phase{key}"):
            self._phase_fns[key], _ = aot.load_or_compile(
                self._aot_store, aot.train_exec_name(key), capture, sig,
                registry=self.registry, fallback=self._plan.train_step,
                count_load=False)
        if self._perf is not None:
            self._write_profile_json()   # the sampler gets its card

    def _note_first_dispatch(self) -> None:
        """One ``warm_start`` row per session, after its first train step
        returns: seconds from the run's start, and what was compiled
        before it (kernel builds by nvcc, and graphs captured on store
        misses), with the store's hits and misses when it is on."""
        self._first_dispatch_noted = True
        compiles = (build.nvcc_runs - self._nvcc_at_start
                    + (self._captures_before_first_step or 0))
        ttfs = (round(time.time() - self._run_started_at, 3)
                if self._run_started_at is not None else None)
        if ttfs is not None:
            self.registry.gauge(
                "warm_start/time_to_first_step_seconds").set(ttfs)
        self.registry.gauge(
            "warm_start/compiles_before_first_step").set(compiles)
        row: Dict[str, Any] = {
            "iter": self.current_iter,
            "time_to_first_step_seconds": ttfs,
            "compiles_before_first_step": compiles,
            "nvcc_runs_before_first_step": (build.nvcc_runs
                                            - self._nvcc_at_start),
            # False under backend options that give up the bitwise
            # resume contract (a tuned config's cuDNN switches).
            "bitwise_resume": resume_is_bitwise(
                self.cfg.xla_compiler_options_dict),
        }
        if self._aot_stats is not None:
            row.update(aot_hits=self._aot_stats["hits"],
                       aot_misses=self._aot_stats["misses"],
                       aot_fingerprint=self._aot_stats["fingerprint"][:16])
        self.warm_start_row = row
        self.jsonl.log("warm_start", **row)
        if self._multihost:
            # Every rank's own row (events.jsonl is process 0's): each
            # rank captures its own graphs and pays its own first step.
            JsonlLogger(os.path.join(
                self.paths["logs"],
                f"warm_start_p{self.mesh.rank}.jsonl")).log(
                "warm_start", rank=self.mesh.rank, **row)

    def _install_cluster(self) -> Optional[cluster.ClusterFaultDomain]:
        """Install the pod fault domain (and, with ``elastic_mode=1``,
        the elastic policy on it) for the run; returns the previous
        domain. Its counters and gauges are registered at once, so an
        armed run reports "0 peer losses", "0 reshards"."""
        cfg = self.cfg
        logs = self.paths["logs"]
        self._cluster = cluster.ClusterFaultDomain(
            lease_dir=os.path.join(self.paths["base"], cluster.LEASE_DIR),
            process_index=self.mesh.rank, num_processes=self.mesh.world,
            collective_timeout_s=cfg.cluster_collective_timeout_s,
            stalled_after_s=cluster.stalled_after(cfg),
            dead_after_s=cluster.dead_after(cfg),
            lease_interval_s=cfg.cluster_lease_interval_s,
            registry=self.registry, jsonl=self.jsonl,
            bundle_dir=self._bundle_dir(), prom_path=f"{logs}/metrics.prom")
        prev = cluster.install(self._cluster)
        self._cluster.heartbeat(force=True)  # the lease exists from t0
        self.registry.counter(cluster.PEER_LOSSES_COUNTER)
        if elastic.elastic_enabled(cfg):
            ros, n = self._roster, self.mesh.world
            self._elastic = elastic.ElasticPolicy(
                lease_dir=self._cluster.lease.lease_dir,
                process_index=self.mesh.rank,
                roster=ros.roster if ros is not None else range(n),
                generation=ros.generation if ros is not None else 0,
                orig_processes=ros.orig_processes if ros is not None else n,
                max_lost_hosts=cfg.elastic_max_lost_hosts,
                timeout_s=elastic.reshard_timeout(cfg),
                mesh_dcn=int(cfg.mesh_shape[0]), lease=self._cluster.lease,
                registry=self.registry, jsonl=self.jsonl,
                prom_path=f"{logs}/metrics.prom")
            self._cluster.elastic = self._elastic
            for name in (elastic.RESHARDS_COUNTER,
                         elastic.DEGRADED_EPOCHS_COUNTER,
                         elastic.RE_EXPANSIONS_COUNTER):
                self.registry.counter(name)
            self.registry.gauge(elastic.GENERATION_GAUGE).set(
                float(self._elastic.generation))
            self.registry.gauge(elastic.LOST_HOSTS_GAUGE).set(
                float(len(self._elastic.missing_hosts())))
        return prev

    def _write_profile_json(self) -> None:
        """The run's cost cards as ``logs/PROFILE.json`` (the JAX
        package's schema): the sampler's cards, and the warm-start
        store's (its PROFILE.json: one card per captured executable),
        which win by name and are registered with the sampler. The main
        process writes. Best-effort: observability only."""
        try:
            cards: Dict[str, Any] = {}
            kind = profiler_mod.device_kind(self.device)
            peaks = None
            fingerprint = None
            if self._perf is not None:
                cards.update(self._perf.cards)
                kind, peaks = self._perf.kind, self._perf.peaks
            if self._aot_store is not None:
                doc = profiler_mod.load_profile(
                    self._aot_store.profile_path())
                if doc:
                    cards.update(doc["cards"])
                    if self._perf is not None:
                        for name, card in doc["cards"].items():
                            self._perf.register_card(name, card)
                fingerprint = self._aot_store.fingerprint
            if self.is_main_process:
                profiler_mod.merge_profile(
                    os.path.join(self.paths["logs"],
                                 profiler_mod.PROFILE_FILE),
                    list(cards.values()), device_kind=kind, peaks=peaks,
                    fingerprint=fingerprint)
        except Exception as e:  # noqa: BLE001 — observability only
            logging.getLogger(__name__).warning(
                "PROFILE.json write failed (%s: %s)", type(e).__name__, e)

    def _run_experiment(self) -> Dict[str, Any]:
        cfg = self.cfg
        # Which algorithm this run trains and how many parameters its
        # inner loop adapts (the report's "algo" section).
        adapted, total = adapted_param_counts(cfg, self.state.params)
        self.registry.gauge("algo/adapted_params").set(adapted)
        self.registry.gauge("algo/total_params").set(total)
        self.jsonl.log("algo", meta_algorithm=cfg.meta_algorithm,
                       task_type=cfg.task_type, adapted_params=adapted,
                       total_params=total)
        if cfg.evaluate_on_test_set_only:
            return self.run_test_protocol()
        total_iters = cfg.total_epochs * cfg.total_iter_per_epoch
        epochs_this_session = 0
        # Eager registration: every metrics row carries these counters,
        # so a report shows "0 rewinds", not a missing section.
        for name in ("resilience/rewinds", "resilience/io_retries",
                     "resilience/faults_injected", ckpt_writer.SAVES,
                     ckpt_writer.SAVE_SECONDS, ckpt_writer.BLOCKED_SECONDS,
                     ckpt_writer.SKIPPED_SAVES, "ckpt/gc_deletes"):
            self.registry.counter(name)
        if self._health_every:
            self.registry.counter(health_mod.GRAD_NORM_WARN_COUNTER)
        # Save-on-signal around the training loop (main thread only).
        prev_handlers = []
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers.append((sig, signal.signal(
                    sig, self._handle_signal)))
            except ValueError:  # not the main thread: no handler
                pass
        try:
            while (self.current_iter < total_iters
                   and epochs_this_session < cfg.total_epochs_before_pause
                   and not self._preempted):
                epoch = self.epoch
                train_stats = self._train_epoch()
                if train_stats == "rewind":  # diverged: rewind, retrain
                    self._perform_rewind()
                    continue
                if train_stats is None:  # preempted mid-epoch, state saved
                    return {"preempted_at_iter": self.current_iter}
                t0 = time.perf_counter()
                val_stats = self._evaluate(self._eval_batches("val"),
                                           self.state)
                val_stats["seconds"] = time.perf_counter() - t0
                epochs_this_session += 1
                self._finish_epoch(epoch, train_stats, val_stats)
                if self._multihost:
                    # The epoch-boundary stop decision is agreed too: a
                    # rank leaving while others start the next epoch
                    # would hang their first all-reduce.
                    self._preempted = any_process_true(self._preempted)
                if (not self._preempted and self._elastic is not None
                        and self._elastic.degraded):
                    # A degraded elastic segment: count the epoch and
                    # look for every missing host's rejoin file.
                    self.registry.counter(
                        elastic.DEGRADED_EPOCHS_COUNTER).inc()
                    self._maybe_re_expand()
        finally:
            for sig, prev in prev_handlers:
                signal.signal(sig, prev)
        if self.current_iter >= total_iters:
            return self.run_test_protocol()
        if self._preempted:
            # A signal at an epoch boundary: the epoch checkpoint is
            # saved, and it is still a preemption (exit 75).
            return {"preempted_at_iter": self.current_iter}
        return {"paused_at_iter": self.current_iter}

    def _maybe_re_expand(self) -> None:
        """Epoch-boundary re-expansion: when every host missing from the
        degraded roster has a rejoin file (a backfilled replacement
        waiting in ``elastic.backfill_wait``), the survivors agree (one
        AND-reduce, so a straggling filesystem view delays rather than
        splits the decision), process 0 writes the next generation's
        FULL roster, checkpoints drain, and every rank restarts in place
        at the original geometry from the committed epoch. Not ready:
        keep training degraded (one directory listing per epoch)."""
        pol = self._elastic
        rejoins = elastic.read_rejoins(pol.lease_dir)
        ready = all(h in rejoins for h in pol.missing_hosts())
        if self._multihost:
            ready = not any_process_true(not ready)  # AND over ranks
        if not ready:
            return
        # Everything queued is committed before the image is replaced:
        # the full-roster run resumes from the manifest this completes.
        self.ckpt_writer.drain()
        if self.is_main_process:
            # A previous attempt's candidate socket must not leak; the
            # new one stays bound until exec (close-on-exec frees the
            # port exactly when the new rank 0's store needs it).
            prev_sock = getattr(self, "_re_expand_sock", None)
            if prev_sock is not None:
                try:
                    prev_sock.close()
                except OSError:
                    pass
            self._re_expand_sock, coord = \
                elastic.bind_coordinator_candidate()
            try:
                elastic.write_roster(pol.lease_dir,
                                     pol.full_roster_doc(coord))
            except OSError as e:
                # One storage hiccup keeps training degraded and retries
                # at the next boundary; the read-back below returns.
                logging.getLogger(__name__).warning(
                    "elastic re-expansion roster write failed (%s: %s); "
                    "retrying at the next epoch boundary",
                    type(e).__name__, e)
        if self._multihost:
            barrier("elastic_re_expand")
        doc = elastic.read_roster(pol.lease_dir)
        if doc is None or int(doc.get("generation", 0)) <= pol.generation:
            return  # the write failed or a stale read: retry later
        try:
            self.ckpt_writer.close()
        except Exception:  # noqa: BLE001 — the exec goes ahead
            pass
        pol.exec_into(doc)  # no return (tests inject pol._exec)

    def _handle_signal(self, signum=None, frame=None) -> None:
        """First SIGTERM/SIGINT: drain (finish the in-flight step,
        snapshot 'latest', return). Second while draining: the drain
        itself is stuck, so write the crash bundle and exit 75 now."""
        if self._preempted:
            print(f"second signal {signum} while draining: exiting "
                  f"{EXIT_PREEMPTED} without the snapshot", file=sys.stderr,
                  flush=True)
            try:
                # Runs on the main thread, possibly inside a stamp or a
                # registry flush: the recorder's and registry's locks are
                # reentrant, and any failure here must still reach the
                # exit.
                flightrec.record("signal_escalation", signum=signum,
                                 iter=self.current_iter)
                flightrec.write_crash_bundle(
                    self._bundle_dir(), reason="signal_escalation",
                    info={"signum": signum, "iter": self.current_iter},
                    registry=self.registry)
            except Exception:
                pass
            os._exit(EXIT_PREEMPTED)
        self._preempted = True

    def _perform_rewind(self) -> None:
        """Recover from a diverged outer loss: reload the newest readable
        epoch checkpoint, drop the abandoned window's bookkeeping, rewrite
        'latest' to the rewound state and re-seed the train stream past
        the window that produced the divergence. The rewind count is
        persisted in state.json."""
        self._rewind_requested = False
        cfg = self.cfg
        # An in-flight async epoch save must be on disk (and a candidate)
        # before a rewind target is picked.
        self.ckpt_writer.drain()
        rewinds = int(self.ckpt.meta.get("rewinds", 0)) + 1
        err: Optional[BaseException] = None
        tag = -1
        try:
            if rewinds > cfg.divergence_max_rewinds:
                raise RuntimeError(
                    f"outer loss diverged again after {rewinds - 1} "
                    f"rewind(s) (divergence_max_rewinds="
                    f"{cfg.divergence_max_rewinds}); a loss that keeps "
                    f"diverging from a good checkpoint is a bug, not a "
                    f"transient — failing loudly")
            candidates = sorted(
                (int(e) for e in self.ckpt.meta["iter_at_epoch"]
                 if self.ckpt.has_checkpoint(int(e))),
                key=lambda e: self.ckpt.meta["iter_at_epoch"][str(e)],
                reverse=True)
            if not candidates:
                raise RuntimeError(
                    "outer loss diverged before any epoch checkpoint "
                    "exists; nothing to rewind to — fix the config "
                    "(lr/clip) or seed")
            tag = candidates[0]
        except RuntimeError as e:
            err = e
        # Every rank raises, or every rank rewinds to process 0's pick.
        abort_all_if_any(err, "a peer process could not pick a rewind "
                              "checkpoint")
        tag = agree_int_from_main(tag)
        state = None
        try:
            state = self._load_member(tag)
        except Exception as e:  # noqa: BLE001 — re-raised on every rank
            err = e
        abort_all_if_any(err, f"a peer process could not load the rewind "
                              f"checkpoint {tag}")
        self._agree_checkpoint_fingerprint(tag, "rewind")
        self.state = state
        self.ckpt.meta["rewinds"] = rewinds
        # Persists the rewind count too (process 0).
        self.ckpt.rewind_to(tag, write=self.is_main_process)
        self.current_iter = int(self.ckpt.meta["current_iter"])
        # 'latest' still holds the abandoned window's weights.
        self.ckpt_writer.save_latest(self.state, self.current_iter,
                                     write=self.is_main_process)
        self.data.set_train_salt(rewinds)
        # Post-rewind iterations restart below the poisoned window: the
        # health cadence and the warn guard's norm history restart too.
        self._last_health_iter = None
        if self._norm_guard is not None:
            self._norm_guard.reset()
        self.registry.counter("resilience/rewinds").inc()
        self.jsonl.log("rewind", epoch=tag, iter=self.current_iter,
                       rewinds=rewinds)
        print(f"divergence guard: rewound to epoch {tag} checkpoint (iter "
              f"{self.current_iter}); train stream re-seeded (salt "
              f"{rewinds})", flush=True)

    def _finish_epoch(self, epoch: int, train_stats: Dict[str, float],
                      val_stats: Dict[str, Any]) -> None:
        row = {"epoch": epoch, **train_stats,
               "val_loss": val_stats["loss"],
               "val_accuracy": val_stats["accuracy"]}
        if self.is_main_process:
            save_statistics(self.paths["logs"], row)
        self.jsonl.log("validation", epoch=epoch,
                       val_loss=val_stats["loss"],
                       val_accuracy=val_stats["accuracy"],
                       seconds=val_stats["seconds"])
        self.registry.gauge("val/loss").set(val_stats["loss"])
        self.registry.gauge("val/accuracy").set(val_stats["accuracy"])
        self.registry.gauge("progress/epoch").set(epoch)
        # Alert transitions land just before the metrics row that
        # triggered them.
        self._flush_registry(epoch=epoch)
        self._flush_timeline()
        if (self.cfg.use_tensorboard and not self._tb_disabled
                and self.is_main_process):
            self._tensorboard_scalars(row, epoch)
        # Every rank keeps the bookkeeping (the ensemble reads it);
        # process 0 writes the files.
        self.ckpt_writer.save(self.state, epoch, self.current_iter,
                              val_stats["accuracy"],
                              write=self.is_main_process)
        self.jsonl.log("checkpoint", epoch=epoch, iter=self.current_iter,
                       bytes=self.ckpt_writer.last_save_bytes,
                       seconds=self.ckpt_writer.last_save_seconds)
        print(f"epoch {epoch}: "
              f"train loss {train_stats['train_loss']:.4f} "
              f"acc {train_stats['train_accuracy']:.4f} | "
              f"val loss {val_stats['loss']:.4f} "
              f"acc {val_stats['accuracy']:.4f} | "
              f"{train_stats['meta_tasks_per_sec']:.1f} tasks/s | "
              f"lr {train_stats['meta_lr']:.2e}", flush=True)

    def _flush_timeline(self) -> None:
        """``logs/flight.jsonl`` (the flight ring, when the recorder is
        installed) and ``logs/trace.json``, a Chrome trace of the ring and
        the tail of the run's events; both bounded windows, so the cost
        per epoch stays flat. Best-effort: a timeline never stops
        training. Process 0 only."""
        if not self.is_main_process:
            return
        try:
            logs = self.paths["logs"]
            flight = None
            if self._flightrec is not None:
                self._flightrec.dump_jsonl(os.path.join(logs,
                                                        "flight.jsonl"))
                flight = self._flightrec.events()
            events = (read_jsonl(self.jsonl.path, tail=4096)
                      if os.path.exists(self.jsonl.path) else None)
            trace_mod.write_trace(os.path.join(logs, "trace.json"),
                                  events=events, flight=flight,
                                  process_index=self.mesh.rank)
        except (OSError, ValueError) as e:
            logging.getLogger(__name__).warning(
                "timeline flush failed (%s: %s)", type(e).__name__, e)

    def _tensorboard_scalars(self, row: Dict[str, Any], epoch: int) -> None:
        """The epoch's CSV row as TensorBoard scalars under
        ``logs/tensorboard``; the writer is made at the first write, and
        if it cannot be (tensorboardX missing), the run warns once and
        goes on with CSV/JSONL only, as the JAX package does."""
        if self._tb is None:
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(f"{self.paths['logs']}/tensorboard")
            except Exception as e:  # noqa: BLE001 — optional feature
                warnings.warn(
                    f"use_tensorboard=True but the SummaryWriter could not "
                    f"be created ({type(e).__name__}: {e}); falling back to "
                    f"CSV/JSONL only", stacklevel=2)
                self._tb_disabled = True
                return
        for key, value in row.items():
            if key != "epoch":
                self._tb.add_scalar(key, float(value), epoch)
        self._tb.flush()

    # ------------------------------------------------------------------
    def run_test_protocol(self) -> Dict[str, Any]:
        """Reference test protocol: ensemble the top-k checkpoints by val
        accuracy over the fixed test episodes; vote by summed per-sample
        softmax probabilities (regression: the mean prediction, scored by
        per-episode −MSE, with ``test_mse_mean``); report mean ± std of
        per-episode accuracy; write ``test_summary.csv``."""
        cfg = self.cfg
        t0 = time.perf_counter()
        # Every queued save is on disk, then process 0's writes are
        # ordered before every rank's reads.
        self.ckpt_writer.drain()
        barrier("checkpoints_written")
        # Filter by presence: bookkeeping can outlive a file (a 'skip'
        # policy save, an external deletion).
        top = [e for e in self.ckpt.top_epochs(cfg.max_models_to_save)
               if self.ckpt.has_checkpoint(e)]
        per_model_logits, per_model_acc = [], {}
        if not top:
            warnings.warn("no checkpoints recorded; testing current state")
            res = self._evaluate(self._eval_batches("test"), self.state,
                                 collect_logits=True)
            per_model_logits.append(res["logits"])
            per_model_acc["current"] = res["accuracy"]
        for epoch in top:
            member = self._load_member(epoch)
            # Each member's bytes agree across ranks before it runs.
            self._agree_checkpoint_fingerprint(epoch, "ensemble")
            res = self._evaluate(self._eval_batches("test"), member,
                                 collect_logits=True)
            per_model_logits.append(res["logits"])
            per_model_acc[f"epoch_{epoch}"] = res["accuracy"]
        if cfg.task_type == "regression":
            # A regression head has one output unit, so a softmax vote
            # would report accuracy 1.0 unconditionally. The ensemble is
            # the mean of per-model predictions, scored as per-episode MSE
            # against the episodes' float targets; "accuracy" stays −MSE,
            # the epoch loop's convention.
            preds = np.mean([lg[..., 0] for lg in per_model_logits],
                            axis=0)  # (E, N*T)
            targets, n_left = [], cfg.num_evaluation_tasks
            for batch in self._eval_batches("test"):
                # A rank holds its shard of each batch: gather them.
                (y,) = self.mesh.all_gather([batch.target_y])
                y = y.cpu().numpy()
                take = min(n_left, y.shape[0])
                targets.append(y[:take])
                n_left -= take
            labels = np.concatenate(targets)  # (E, N*T) float
            per_episode_acc = -((preds - labels) ** 2).mean(axis=1)
        else:
            # Ensemble: sum of softmax probabilities over models, argmax.
            probs = sum(torch.softmax(torch.from_numpy(lg), dim=-1)
                        for lg in per_model_logits)
            preds = probs.argmax(-1).numpy()  # (E, N*T)
            n, t = cfg.num_classes_per_set, cfg.num_target_samples
            labels = np.tile(np.repeat(np.arange(n), t)[None],
                             (preds.shape[0], 1))
            per_episode_acc = (preds == labels).mean(axis=1)
        self.ensemble_predictions = preds
        result = {
            "test_accuracy_mean": float(per_episode_acc.mean()),
            "test_accuracy_std": float(per_episode_acc.std()),
            "num_models": len(per_model_logits),
            "num_episodes": int(per_episode_acc.shape[0]),
            "per_model_accuracy": per_model_acc,
        }
        if cfg.task_type == "regression":
            result["test_mse_mean"] = -result["test_accuracy_mean"]
        # One packed column keeps the CSV schema stable as the member set
        # changes between re-runs.
        if self.is_main_process:
            save_statistics(
                self.paths["logs"],
                {**{k: v for k, v in result.items()
                    if k != "per_model_accuracy"},
                 "per_model_accuracy": "|".join(
                     f"{k}:{v:.6f}" for k, v in per_model_acc.items())},
                filename="test_summary.csv")
        self.jsonl.log("test_protocol", **{
            k: v for k, v in result.items() if k != "per_model_accuracy"},
            per_model_accuracy=per_model_acc,
            seconds=time.perf_counter() - t0)
        # The final snapshot lands in metrics.prom and events.jsonl.
        self.registry.gauge("test/accuracy_mean").set(
            result["test_accuracy_mean"])
        self.registry.gauge("test/accuracy_std").set(
            result["test_accuracy_std"])
        self._flush_registry(phase="test_protocol")
        score = (f"mse {result['test_mse_mean']:.4f}"
                 if cfg.task_type == "regression"
                 else f"{result['test_accuracy_mean']:.4f}")
        print(f"test: {score} ± {result['test_accuracy_std']:.4f} "
              f"({result['num_models']}-model ensemble, "
              f"{result['num_episodes']} episodes)", flush=True)
        return result
