"""Experiment orchestration: train loop, validation sweeps, checkpointing,
and the top-k ensemble test protocol (the port's counterpart of the JAX
package's ``experiment.py § ExperimentBuilder``, on one device).

Reference (``experiment_builder.py § ExperimentBuilder``): per epoch,
``total_iter_per_epoch`` train iterations → a full validation sweep → a
CSV stats row → an epoch checkpoint + ``latest`` (keeping the top
``max_models_to_save`` by val accuracy); after training, each kept
checkpoint runs over the fixed test episodes and their per-sample softmax
probabilities are summed into the ensemble's prediction
(``test_summary.csv``).

On the card:

* The phase flags (derivative-order annealing, MSL window) are read per
  epoch; eager PyTorch has no executables to swap, so
  ``precompile_phases`` is a documented no-op.
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
costs one ``None`` check where it would act.

Checkpoints, ``state.json``, ``MANIFEST.json``, ``REGISTRY.json`` and the
CSVs are the JAX package's formats: either package resumes, evaluates or
serves the other's run. Not ported yet (each raises when set away from its
default, naming its ROADMAP.md Queue 1 item): the mesh, the AOT store and
compile cache, the pod fault domain and elastic mode, fault injection and
the async checkpoint writer. The watchdog and flight recorder (on by
default in the JAX package) are not ported either: the builder says so
once at start.
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
                                                        resolve_device,
                                                        synchronize)
from howtotrainyourmamlpytorch_tpu_torch.meta.inner import (
    adapted_param_counts)
from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
    MetaTrainState, init_train_state, make_eval_step, make_train_step,
    migrate_lslr_rows, reconcile_loaded_shapes, state_leaf_shapes)
from howtotrainyourmamlpytorch_tpu_torch.models import make_model
from howtotrainyourmamlpytorch_tpu_torch.resilience import (EXIT_PREEMPTED,
                                                            DivergenceGuard)
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

FAULTS_ENV = "MAML_FAULTS"
WATCHDOG_FIELDS = ("watchdog_step_timeout_s", "watchdog_feed_timeout_s",
                   "watchdog_collective_timeout_s",
                   "watchdog_compile_timeout_s", "watchdog_serve_timeout_s",
                   "watchdog_ckpt_timeout_s")


def refuse_unported_knobs(cfg: MAMLConfig) -> None:
    """Raise ``NotImplementedError`` for a knob whose subsystem the port
    does not have yet, set away from its default: a run must not quietly
    do less than its config says."""
    checks = (
        (tuple(cfg.mesh_shape) != (1, 1),
         f"mesh_shape {tuple(cfg.mesh_shape)} (a device mesh)",
         "parallel/mesh slice"),
        (bool(cfg.aot_store_dir), "aot_store_dir (the AOT executable store)",
         "AOT/compile-cache slice"),
        (bool(cfg.compilation_cache_dir),
         "compilation_cache_dir (the persistent compile cache)",
         "AOT/compile-cache slice"),
        (cfg.cluster_collective_timeout_s > 0,
         "cluster_collective_timeout_s > 0 (the pod fault domain)",
         "parallel/mesh slice"),
        (bool(cfg.elastic_mode), "elastic_mode (elastic resharding)",
         "parallel/mesh slice"),
        (bool(cfg.fault_spec or os.environ.get(FAULTS_ENV)),
         f"fault_spec / {FAULTS_ENV} (fault injection)",
         "resilience/ckpt slice"),
    )
    for unported, what, item in checks:
        if unported:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP.md, Queue 1: {item})")


class ExperimentBuilder:
    """Builds and runs one experiment described by a :class:`MAMLConfig`,
    on ``device`` (the card by default; ``device="cpu"`` must be asked
    for)."""

    def __init__(self, cfg: MAMLConfig, device: DeviceLike = None):
        refuse_unported_knobs(cfg)
        self.device = resolve_device(device)
        # Telemetry registry first: storage retries and checkpoint saves
        # below count into it (the last constructed builder's registry
        # is the process's).
        self.registry = MetricsRegistry()
        resilience.set_registry(self.registry)
        self.paths = build_experiment_folder(cfg.experiment_root,
                                             cfg.experiment_name)
        eff_mb = cfg.effective_task_microbatches()
        if eff_mb != cfg.task_microbatches:
            msg = (f"task_microbatches {cfg.task_microbatches} clamped to "
                   f"{eff_mb} for this batch geometry (see "
                   f"MAMLConfig.effective_task_microbatches); the recorded "
                   f"config reflects what actually runs")
            warnings.warn(msg)
            logging.getLogger(__name__).warning(msg)
            cfg = cfg.replace(task_microbatches=eff_mb)
        self.cfg = cfg
        # The recorded config reflects what actually runs.
        save_to_json(f"{self.paths['base']}/config.json", cfg.to_dict())

        self.model_init, self.model_apply = make_model(cfg)
        self.train_step = make_train_step(cfg, self.model_apply)
        self.eval_step = make_eval_step(cfg, self.model_apply)
        self.data = MetaLearningDataLoader(cfg, device=self.device,
                                           registry=self.registry)
        self.ckpt = CheckpointManager(self.paths["saved_models"],
                                      max_to_keep=cfg.max_models_to_save)
        self.ckpt_writer = ckpt_writer.CheckpointWriter(
            self.ckpt, async_saves=bool(cfg.ckpt_async),
            publish=cfg.ckpt_publish)
        # Size-capped at 64 MiB: one rotation into events.jsonl.1.
        self.jsonl = JsonlLogger(f"{self.paths['logs']}/events.jsonl",
                                 max_bytes=64 * 1024 * 1024)
        # Alert rules (telemetry/alerts.py), evaluated at the registry
        # flush points only; None when alert_rules_path is unset.
        self._alerts: Optional[alerts_mod.AlertEvaluator] = None
        self._last_heartbeat_ts: Optional[float] = None
        if cfg.alert_rules_path:
            self._alerts = alerts_mod.AlertEvaluator(
                alerts_mod.load_rules(cfg.alert_rules_path), source="train",
                snapshot_path=f"{self.paths['logs']}/ALERTS.json")
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
        from_latest = tag == LATEST
        if from_latest and not (self.ckpt.has_any_checkpoint()
                                or self.ckpt.meta_from_disk):
            return  # fresh run with continue_from_epoch='latest'
        template_shapes = state_leaf_shapes(self.state)
        if from_latest:
            # Falls back to the newest readable epoch checkpoint if the
            # latest file is missing or damaged.
            state, meta, tag = self.ckpt.load_latest_or_fallback(self.state)
        else:
            state, meta = self.ckpt.load(self.state, tag)
        self.current_iter = int(meta["current_iter"])
        if tag != LATEST:
            # Epochs after the resume point are abandoned; their
            # checkpoints must not feed the top-k ensemble.
            self.ckpt.rewind_to(int(tag))
        state = migrate_lslr_rows(self.cfg, state)
        self.state = reconcile_loaded_shapes(self.cfg, state,
                                             template_shapes)
        print(f"resumed from checkpoint {tag!r} at iter {self.current_iter}")

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
        live = cfg.live_progress and cfg.dispatch_sync_every > 0
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
                    if first_call and self._perf is not None:
                        (self.state, metrics), flops = (
                            profiler_mod.count_flops(step))
                        self._perf.register_card(
                            card_name, profiler_mod.build_cost_card(
                                card_name, flops=flops,
                                kind=self._perf.kind,
                                peaks=self._perf.peaks))
                    else:
                        self.state, metrics = step()
                except BaseException:
                    # The process-wide profiler must not stay on.
                    if sampling:
                        self._perf.abort_window()
                    raise
                self._phases_run.add(phase_key)
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
                    if metrics.health is not None:
                        self._observe_health(metrics.health, epoch)
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
                    if (self._guard is not None
                            and self._guard.observe(loss_now,
                                                    self.current_iter)):
                        self._rewind_requested = True
                        break
                    if self._preempted:
                        break
                elif self._preempted:
                    break
        finally:
            # Stops the loader's prefetch thread on a break or an error.
            batches.close()
            if prof is not None:
                prof.__exit__(None, None, None)
        synchronize(self.device)
        if live_tty and live_samples:
            print("\r\x1b[K", end="")  # clear the in-place progress line
        if self._rewind_requested:
            return "rewind"  # the poisoned state is never checkpointed
        if self._preempted:
            # Mid-epoch snapshot to 'latest' only; resume continues at
            # exactly this iteration with the same batch stream.
            self.ckpt_writer.save_latest(self.state, self.current_iter)
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
            "meta_tasks_per_sec_per_chip": tasks / dt,
        }
        # Host dispatch intervals; the epoch-end sync folds the device's
        # tail into the last one.
        tsum = timer.summary(cfg.batch_size)
        self.jsonl.log("train_epoch", epoch=epoch, iter=self.current_iter,
                       second_order=second_order, use_msl=use_msl, **stats,
                       **{f"dispatch_{k}": v for k, v in tsum.items()})
        self._emit_epoch_telemetry(epoch, timer, tsum, stats)
        return stats

    def _observe_health(self, health: Dict[str, torch.Tensor],
                        epoch: int) -> None:
        """Fetch one health snapshot and publish it (``health/*`` gauges,
        one ``health`` row), then feed the outer-grad norm to the early
        warning."""
        self._last_health_iter = self.current_iter
        fetched = health_mod.fetch_health(health)
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
        ``logs/metrics.prom``."""
        self._evaluate_alerts()
        self.registry.flush_jsonl(self.jsonl, **extra)
        self.registry.write_prometheus(f"{self.paths['logs']}/metrics.prom")

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
    def run_experiment(self) -> Dict[str, Any]:
        """Train, validate and test under the entry point's numerics
        policy (TF32 off for f32 configs, cuDNN deterministic; restored
        on return)."""
        cfg = self.cfg
        if any(getattr(cfg, f) > 0 for f in WATCHDOG_FIELDS):
            print("watchdog: not ported yet (ROADMAP.md, Queue 1: "
                  "resilience/ckpt slice); this run has no hang detection "
                  "and writes no flight recorder", flush=True)
        if cfg.profile_every_n_steps > 0:
            self._perf = profiler_mod.PerfSampler(
                cfg.profile_every_n_steps, registry=self.registry,
                jsonl=self.jsonl, device=self.device)
        try:
            with numerics_policy(cfg.compute_dtype, deterministic=True):
                return self._run_experiment()
        finally:
            if self._perf is not None:
                self._write_profile_json()
            if self._tb is not None:
                # Release the writer's thread and file handle.
                self._tb.close()
                self._tb = None

    def _write_profile_json(self) -> None:
        """Persist the phase cost cards as ``logs/PROFILE.json`` (the JAX
        package's schema). Best-effort: observability only."""
        try:
            profiler_mod.merge_profile(
                os.path.join(self.paths["logs"], profiler_mod.PROFILE_FILE),
                list(self._perf.cards.values()),
                device_kind=self._perf.kind, peaks=self._perf.peaks)
        except OSError as e:
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

    def _handle_signal(self, signum=None, frame=None) -> None:
        """First SIGTERM/SIGINT: drain (finish the in-flight step,
        snapshot 'latest', return). Second while draining: exit 75 now."""
        if self._preempted:
            print(f"second signal {signum} while draining: exiting "
                  f"{EXIT_PREEMPTED} without the snapshot", file=sys.stderr,
                  flush=True)
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
        rewinds = int(self.ckpt.meta.get("rewinds", 0)) + 1
        if rewinds > cfg.divergence_max_rewinds:
            raise RuntimeError(
                f"outer loss diverged again after {rewinds - 1} rewind(s) "
                f"(divergence_max_rewinds={cfg.divergence_max_rewinds}); a "
                f"loss that keeps diverging from a good checkpoint is a "
                f"bug, not a transient — failing loudly")
        candidates = sorted(
            (int(e) for e in self.ckpt.meta["iter_at_epoch"]
             if self.ckpt.has_checkpoint(int(e))),
            key=lambda e: self.ckpt.meta["iter_at_epoch"][str(e)],
            reverse=True)
        if not candidates:
            raise RuntimeError(
                "outer loss diverged before any epoch checkpoint exists; "
                "nothing to rewind to — fix the config (lr/clip) or seed")
        tag = candidates[0]
        self.state = self._load_member(tag)
        self.ckpt.meta["rewinds"] = rewinds
        self.ckpt.rewind_to(tag)   # persists the rewind count too
        self.current_iter = int(self.ckpt.meta["current_iter"])
        # 'latest' still holds the abandoned window's weights.
        self.ckpt_writer.save_latest(self.state, self.current_iter)
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
        if self.cfg.use_tensorboard and not self._tb_disabled:
            self._tensorboard_scalars(row, epoch)
        self.ckpt_writer.save(self.state, epoch, self.current_iter,
                              val_stats["accuracy"])
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
        """``logs/trace.json``: a Chrome trace of the tail of the run's
        events (the flight-ring layer stays empty until the resilience
        slice). Best-effort: a timeline never stops training."""
        try:
            logs = self.paths["logs"]
            events = (read_jsonl(self.jsonl.path, tail=4096)
                      if os.path.exists(self.jsonl.path) else None)
            trace_mod.write_trace(os.path.join(logs, "trace.json"),
                                  events=events)
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
        # Filter by presence: bookkeeping can outlive a file.
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
            res = self._evaluate(self._eval_batches("test"),
                                 self._load_member(epoch),
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
                y = batch.target_y.cpu().numpy()
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
