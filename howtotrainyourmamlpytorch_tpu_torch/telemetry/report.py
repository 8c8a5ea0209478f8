"""Run-summary computation over an ``events.jsonl`` stream (the port's
copy of the JAX package's ``telemetry/report.py``: the same summary of
the same rows, whichever package wrote them).

The analysis half of the telemetry subsystem: pure functions from a list
of parsed JSONL rows (``utils.tracing.read_jsonl``) to a run summary —
used by ``scripts/telemetry_report.py`` (human table + CI JSON) and unit
tests. Every fail-soft metric that never reported (CPU memory stats, a
jax without compile events, a log predating this subsystem) summarizes
to the explicit string ``"unavailable"`` — a report must distinguish
"measured zero" from "not measured" or it will hide the exact failure
modes it exists to surface.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Union

# v2: + "serving"; v3: + "resilience"; v4: + "data" (datastore
# subsystem); v5: + "watchdog" (hang detection / flight recorder);
# v6: + "health" (optimization-health introspection, telemetry/health.py);
# v7: + "checkpoint" (ckpt/ lifecycle subsystem: async saves, GC,
# serving hot-swap); v8: + "cluster" (pod fault domain,
# resilience/cluster.py: peer losses, suspect attribution, consensus
# resume, lease ages); v9: + "warm_start" (AOT executable store,
# parallel/aot.py: hits/misses/load seconds + per-start
# time-to-first-step and the compiles-before-first-dispatch count);
# v10: + "elastic" (elastic pod, resilience/elastic.py: reshard events,
# current/lost roster, degraded-epoch count, re-expansions — counters
# reset-aware across the restart-in-place segments the subsystem
# creates by design); v11: + "fleet" (serving fleet, serve/fleet/:
# replicas live/draining, shared-L2 hits/misses/errors, rolling swaps
# and halts, router spills — counters reset-aware across replica
# restarts, gauges last-wins); v12: + "perf" (perf lab,
# telemetry/profiler.py: sampled device-time attribution — sample
# counters reset-aware across process lifetimes, window-split fractions
# and the top device-time executable last-signal in log order);
# v13: + "tune" (autotune subsystem, tune/ + scripts/autotune.py:
# trial counts/failures from tune/* counters reset-aware across
# sweep-runner segments (a killed-and-resumed sweep spans processes by
# design) cross-checked against the explicit tune_trial rows; best
# objective the max over ok rows; adopted-vs-rejected verdict and the
# tuned fingerprint last-signal from the tune_adopt row);
# v14: + "requests" (request tracing + SLO ledger,
# telemetry/reqtrace.py + serve/fleet/controller.py: span/drop
# counters reset-aware per `replica` source like the fleet section —
# one log interleaves several replicas' flushes plus the router process's —
# cross-checked against the explicit request_trace rows, which are
# assembled into traces for the linked fraction, dominant latency
# tier and tenant count; SLO good/bad totals reset-aware, burn-rate
# gauge last-wins);
# v15: + "algo" (meta-algorithm registry, meta/algos/: which algorithm
# the run trains/serves and how many parameters its inner loop adapts
# — identity/counts last-signal from the explicit "algo" rows and the
# algo/* gauges; serve adapt-seconds p50 last-signal PER VARIANT from
# the meta_algorithm-stamped serving metrics rows, whose adapt-batch
# counters accumulate reset-aware per (replica source, variant) like
# the fleet section);
# v16: + "fleet_health" (self-healing fleet, serve/fleet/supervisor.py
# + router breaker + shed-at-admission: restart/crash-loop/scale
# counters from the supervisor's flushes, failover/breaker-trip
# counters from the router's process, shed counts from replica flushes
# — all reset-aware per (source, metric) like the fleet section;
# replicas_desired gauge last-wins; supervisor lifecycle events
# tallied by kind);
# v17: + "traffic" (traffic lab, serve/loadlab/ + continuous batching
# + weighted canary rollouts: cb group/fill/linger dispatch counters
# from replica flushes, canary-request / cohort-fallback /
# stage-promotion counters from the router+controller process — all
# reset-aware per (source, metric) like the fleet-health section; the
# canary weight gauge — the rollout ladder's current stage — takes
# the last signal);
# v18: + "alerts" (alert rules engine, telemetry/alerts.py: explicit
# "alert" transition rows tallied fired/resolved and by severity;
# still-firing reconstructed by replaying transitions last-wins per
# (source, rule, labels) — a fired-then-resolved instance must read
# as closed, and one log interleaves several evaluators' sources;
# most-fired rule names the noisiest rule)
SCHEMA = "maml_tpu_telemetry_report_v18"
UNAVAILABLE = "unavailable"

Metric = Union[float, int, str]


def _finite(values: List[Optional[float]]) -> List[float]:
    return [float(v) for v in values
            if isinstance(v, (int, float)) and math.isfinite(float(v))]


def _median(values: List[float]) -> Optional[float]:
    if not values:
        return None
    s = sorted(values)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _accumulate_counter(totals: Dict[str, float],
                        prev: Dict[str, float],
                        key: str, value: float) -> None:
    """Reset-aware counter accumulation (the Prometheus rate() rule),
    shared by the resilience and data-plane sections: one log routinely
    spans several process lifetimes (preempt → restart resets every
    counter to 0), so last-row-wins would drop the killed segment. A
    value below its predecessor starts a new segment and contributes
    whole; otherwise the delta contributes."""
    p = prev.get(key, 0.0)
    totals[key] = totals.get(key, 0.0) + (value if value < p
                                          else value - p)
    prev[key] = value


def _reqtrace():
    """telemetry/reqtrace.py — the one definition of trace assembly /
    "linked" / tier attribution. Resolved lazily: the port's package
    copy when it is already imported, else a file-path load from this
    module's own directory under a port-owned alias (this module must
    stay importable by file path without torch, and reqtrace.py honors
    the same contract)."""
    import sys
    mod = sys.modules.get("howtotrainyourmamlpytorch_tpu_torch.telemetry"
                          ".reqtrace")
    if mod is None:
        mod = sys.modules.get("_maml_torch_report_reqtrace")
    if mod is None:
        import importlib.util
        import os
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "reqtrace.py")
        spec = importlib.util.spec_from_file_location(
            "_maml_torch_report_reqtrace", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["_maml_torch_report_reqtrace"] = mod
        spec.loader.exec_module(mod)
    return mod


def summarize_events(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate a run's events into the report schema.

    Tolerant by design: rows are duck-typed on their ``event`` field and
    missing keys degrade the affected metric to ``"unavailable"`` —
    the CLI must be able to read last year's logs and half-written logs
    from a live run it is tailing.
    """
    train = [e for e in events if e.get("event") == "train_epoch"]
    telemetry = [e for e in events if e.get("event") == "telemetry"]
    beats = [e for e in events if e.get("event") == "heartbeat"]

    # Step-time percentiles: per-epoch dispatch-interval quantiles from
    # the train loop's StepTimer; the cross-epoch summary is the median
    # epoch (robust to a slow first epoch that paid the compile).
    p50s = _finite([e.get("dispatch_p50_step_seconds") for e in train]
                   + [e.get("step_seconds_p50") for e in telemetry])
    p95s = _finite([e.get("dispatch_p95_step_seconds") for e in train]
                   + [e.get("step_seconds_p95") for e in telemetry])
    rates = _finite([e.get("meta_tasks_per_sec_per_chip") for e in train])
    steps = sum(int(e.get("dispatch_steps") or 0) for e in train)

    # Compile totals are cumulative counters: the LAST row wins. Both
    # per-epoch "telemetry" rows and registry-flush "metrics" rows carry
    # them; the final registry flush (after the test protocol) is the
    # most complete, and events are scanned in log order.
    compile_count: Metric = UNAVAILABLE
    compile_seconds: Metric = UNAVAILABLE
    for e in events:
        if (e.get("event") == "telemetry"
                and e.get("compile_count_total") is not None):
            compile_count = int(e["compile_count_total"])
            compile_seconds = round(
                float(e.get("compile_seconds_total") or 0.0), 3)
        elif e.get("event") == "metrics":
            m = e.get("metrics") or {}
            if m.get("compile/count") is not None:
                compile_count = int(m["compile/count"])
                compile_seconds = round(
                    float(m.get("compile/seconds") or 0.0), 3)

    # Feed stall: re-derived from per-epoch second totals (not a mean of
    # per-epoch fractions — epochs with more batches must weigh more).
    waits = _finite([e.get("feed_wait_seconds") for e in telemetry])
    dispatches = _finite([e.get("feed_dispatch_seconds")
                          for e in telemetry])
    feed_stall: Metric = UNAVAILABLE
    if waits or dispatches:
        busy = sum(waits) + sum(dispatches)
        feed_stall = round(sum(waits) / busy, 4) if busy > 0 else 0.0

    peaks = _finite([(e.get("memory") or {}).get("peak_bytes_max_device")
                     for e in telemetry])
    lives = _finite([(e.get("memory") or {}).get("live_bytes_total")
                     for e in telemetry])

    # Serving section (serve/ subsystem): serve metrics ride registry
    # "metrics" rows; counters/gauges are cumulative so the LAST row
    # carrying serve/* keys wins. Runs that never served summarize the
    # whole section to "unavailable".
    serving: Union[Dict[str, Any], str] = UNAVAILABLE
    for e in events:
        if e.get("event") != "metrics":
            continue
        m = e.get("metrics") or {}
        if not any(k.startswith("serve/") for k in m):
            continue
        latency = m.get("serve/latency_seconds") or {}

        def _ms(v: Any) -> Metric:
            return (round(float(v) * 1e3, 3)
                    if isinstance(v, (int, float)) else UNAVAILABLE)

        hits = float(m.get("serve/cache_hits") or 0)
        misses = float(m.get("serve/cache_misses") or 0)
        serving = {
            "requests": int(m.get("serve/requests_total") or 0),
            "responses": int(m.get("serve/responses_total") or 0),
            "rejected": int(m.get("serve/rejected_total") or 0),
            "deadline_misses": int(m.get("serve/deadline_misses") or 0),
            "cache_hit_frac": (round(hits / (hits + misses), 4)
                               if hits + misses > 0 else UNAVAILABLE),
            "latency_p50_ms": _ms(latency.get("p50")),
            "latency_p95_ms": _ms(latency.get("p95")),
            "queue_depth": (int(m["serve/queue_depth"])
                            if m.get("serve/queue_depth") is not None
                            else UNAVAILABLE),
        }

    # Resilience section (resilience/ subsystem): counters ride registry
    # "metrics" rows like serve/*. Unlike serving, one log routinely
    # spans SEVERAL process lifetimes (preempt → restart resets every
    # counter to 0), so last-row-wins would silently drop the killed
    # segment's rewinds — exactly the events this section exists to
    # surface. Accumulate with counter-reset detection instead (the
    # Prometheus rate() rule): a value below its predecessor starts a
    # new segment and contributes whole; otherwise the delta
    # contributes. data/corrupt_episodes belongs here too — it is the
    # loader's fail-soft skip counter. Logs predating the subsystem
    # summarize the section to "unavailable".
    _RES_KEYS = {
        "rewinds": "resilience/rewinds",
        "nan_steps": "resilience/nan_steps",
        "loss_spikes": "resilience/loss_spikes",
        "io_retries": "resilience/io_retries",
        "io_giveups": "resilience/io_giveups",
        "quarantined": "resilience/quarantined",
        "faults_injected": "resilience/faults_injected",
        "cache_errors": "resilience/cache_errors",
        "corrupt_episodes": "data/corrupt_episodes",
    }
    resilience_sec: Union[Dict[str, Any], str] = UNAVAILABLE
    totals: Dict[str, float] = {}
    prev_row: Dict[str, float] = {}
    for e in events:
        if e.get("event") != "metrics":
            continue
        m = e.get("metrics") or {}
        if not any(k.startswith("resilience/") for k in m) \
                and "data/corrupt_episodes" not in m:
            continue
        for key in _RES_KEYS.values():
            if m.get(key) is None:
                continue
            _accumulate_counter(totals, prev_row, key, float(m[key]))
        resilience_sec = {label: int(totals.get(key, 0))
                          for label, key in _RES_KEYS.items()}

    # Data-plane section (datastore/ subsystem, docs/DATA.md): which
    # source kind actually fed the run (data/source_kind/<kind> counters
    # from build_source), the packed-shard open cost and mapped bytes,
    # and the loader's corrupt-image skip counter. Counters accumulate
    # with the same reset detection as the resilience section
    # (_accumulate_counter); pack_bytes_mapped is a gauge — last row
    # wins. data/corrupt_episodes stays in the resilience section (it
    # is the episode-level fail-soft counter).
    _KIND_PREFIX = "data/source_kind/"
    data_sec: Union[Dict[str, Any], str] = UNAVAILABLE
    d_totals: Dict[str, float] = {}
    d_prev: Dict[str, float] = {}
    pack_bytes: Optional[float] = None
    for e in events:
        if e.get("event") != "metrics":
            continue
        m = e.get("metrics") or {}
        keys = [k for k in m if k.startswith("data/")
                and k != "data/corrupt_episodes"
                and isinstance(m[k], (int, float))]
        if not keys:
            continue
        for key in keys:
            if key == "data/pack_bytes_mapped":
                pack_bytes = float(m[key])
                continue
            _accumulate_counter(d_totals, d_prev, key, float(m[key]))
        kinds = sorted(k[len(_KIND_PREFIX):]
                       for k, tot in d_totals.items()
                       if k.startswith(_KIND_PREFIX) and tot > 0)
        data_sec = {
            "source_kind": ",".join(kinds) if kinds else UNAVAILABLE,
            "pack_open_seconds": (
                round(d_totals["data/pack_open_seconds"], 6)
                if "data/pack_open_seconds" in d_totals else UNAVAILABLE),
            "pack_bytes_mapped": (int(pack_bytes)
                                  if pack_bytes is not None
                                  else UNAVAILABLE),
            "corrupt_images": int(
                d_totals.get("data/corrupt_images", 0)),
        }

    # Watchdog section (resilience/watchdog.py, schema v5): trips from
    # the watchdog/trips counter on registry "metrics" rows (reset-aware
    # — a tripped run EXITS, so its final counters live in a killed
    # segment) cross-checked against explicit "watchdog_trip" event rows
    # (written even when a registry flush failed mid-death); last_phase
    # / progress_age track the most recent signal in log order, so a
    # trip row (always last in its segment) wins over earlier
    # heartbeats. Runs without a watchdog summarize to "unavailable".
    wd_totals: Dict[str, float] = {}
    wd_prev: Dict[str, float] = {}
    wd_trip_rows = 0
    wd_seen = False
    wd_last_phase: Metric = UNAVAILABLE
    wd_age: Metric = UNAVAILABLE
    for e in events:
        if e.get("event") == "metrics":
            m = e.get("metrics") or {}
            if m.get("watchdog/trips") is not None:
                wd_seen = True
                _accumulate_counter(wd_totals, wd_prev, "trips",
                                    float(m["watchdog/trips"]))
        elif e.get("event") == "heartbeat":
            if e.get("progress_age_seconds") is not None:
                wd_seen = True
                wd_age = round(float(e["progress_age_seconds"]), 3)
            if e.get("progress_phase") is not None:
                wd_last_phase = str(e["progress_phase"])
        elif e.get("event") == "watchdog_trip":
            wd_seen = True
            wd_trip_rows += 1
            if e.get("phase") is not None:
                wd_last_phase = str(e["phase"])
            if e.get("age_seconds") is not None:
                wd_age = round(float(e["age_seconds"]), 3)
    watchdog_sec: Union[Dict[str, Any], str] = UNAVAILABLE
    if wd_seen:
        watchdog_sec = {
            "trips": max(int(wd_totals.get("trips", 0)), wd_trip_rows),
            "last_phase": wd_last_phase,
            "progress_age_seconds": wd_age,
        }

    # Health section (telemetry/health.py, schema v6): "health" event
    # rows carry each fetched snapshot (last grad norm + msl vector win
    # in log order; the per-layer ratio and lslr bounds report their
    # run-wide extremes — a transient blow-up must not be hidden by a
    # calm final row); the guard's warning counter accumulates
    # reset-aware across preempt/restart segments like the watchdog's,
    # cross-checked against explicit health_grad_norm_warn event rows.
    # Runs without health metrics summarize to "unavailable".
    h_seen = False
    h_grad: Metric = UNAVAILABLE
    h_ratio: Optional[float] = None
    h_lslr_min: Optional[float] = None
    h_lslr_max: Optional[float] = None
    h_msl: Union[List[float], str] = UNAVAILABLE
    h_warn_totals: Dict[str, float] = {}
    h_warn_prev: Dict[str, float] = {}
    h_warn_rows = 0
    for e in events:
        if e.get("event") == "health":
            h_seen = True
            if isinstance(e.get("grad_norm"), (int, float)):
                h_grad = round(float(e["grad_norm"]), 6)
            elif "grad_norm" in e:
                h_grad = "non-finite"  # the logger nulls NaN/Inf; a
                #                        present-but-null norm IS the
                #                        diagnosis
            v = e.get("update_ratio_max")
            if isinstance(v, (int, float)):
                h_ratio = max(h_ratio, float(v)) \
                    if h_ratio is not None else float(v)
            v = e.get("lslr_min")
            if isinstance(v, (int, float)):
                h_lslr_min = min(h_lslr_min, float(v)) \
                    if h_lslr_min is not None else float(v)
            v = e.get("lslr_max")
            if isinstance(v, (int, float)):
                h_lslr_max = max(h_lslr_max, float(v)) \
                    if h_lslr_max is not None else float(v)
            if isinstance(e.get("msl_importance"), list):
                h_msl = [round(float(w), 6) for w in e["msl_importance"]]
        elif e.get("event") == "health_grad_norm_warn":
            h_seen = True
            h_warn_rows += 1
        elif e.get("event") == "metrics":
            m = e.get("metrics") or {}
            if m.get("health/grad_norm_warn") is not None:
                h_seen = True
                _accumulate_counter(h_warn_totals, h_warn_prev, "warns",
                                    float(m["health/grad_norm_warn"]))
    health_sec: Union[Dict[str, Any], str] = UNAVAILABLE
    if h_seen:
        health_sec = {
            "grad_norm": h_grad,
            "update_ratio_max": (round(h_ratio, 6)
                                 if h_ratio is not None else UNAVAILABLE),
            "lslr_min": (round(h_lslr_min, 6)
                         if h_lslr_min is not None else UNAVAILABLE),
            "lslr_max": (round(h_lslr_max, 6)
                         if h_lslr_max is not None else UNAVAILABLE),
            "msl_importance": h_msl,
            "grad_norm_warns": max(int(h_warn_totals.get("warns", 0)),
                                   h_warn_rows),
        }

    # Checkpoint section (ckpt/ subsystem, schema v7): the writer's
    # counters ride registry "metrics" rows like resilience/* and
    # accumulate with the same reset detection — a preempted-and-
    # restarted run's saves from the killed segment must still count.
    # The hot-swap counters are serve-side (a serving process's flushed
    # rows) but belong to the same lifecycle story. save/blocked seconds
    # are counters of SECONDS (not histograms) so they merge across
    # segments by the same rule. Runs predating the subsystem summarize
    # the section to "unavailable".
    _CKPT_KEYS = {
        "saves": "ckpt/saves",
        "save_seconds": "ckpt/save_seconds",
        "blocked_seconds": "ckpt/blocked_seconds",
        "skipped_saves": "ckpt/skipped_saves",
        "gc_deletes": "ckpt/gc_deletes",
        "hot_swaps": "serve/hot_swaps",
        "rollbacks": "serve/hot_swap_rollbacks",
    }
    ckpt_sec: Union[Dict[str, Any], str] = UNAVAILABLE
    c_totals: Dict[str, float] = {}
    c_prev: Dict[str, float] = {}
    for e in events:
        if e.get("event") != "metrics":
            continue
        m = e.get("metrics") or {}
        if not any(k.startswith("ckpt/") for k in m) \
                and "serve/hot_swaps" not in m:
            continue
        for key in _CKPT_KEYS.values():
            if m.get(key) is None:
                continue
            _accumulate_counter(c_totals, c_prev, key, float(m[key]))
        ckpt_sec = {
            label: (round(c_totals.get(key, 0.0), 3)
                    if label.endswith("_seconds")
                    else int(c_totals.get(key, 0)))
            for label, key in _CKPT_KEYS.items()}

    # Cluster section (resilience/cluster.py, schema v8): peer losses
    # from the cluster/peer_losses counter on registry "metrics" rows
    # (reset-aware — a tripped survivor EXITS 73, so its final counters
    # live in a killed segment) cross-checked against explicit
    # "peer_lost" event rows; the last suspect and the consensus epoch
    # track the most recent signal in log order; lease ages come from
    # the heartbeat rows' per-host peer_lease_age_seconds (last row
    # wins — the liveness picture at the end of the log, like the
    # watchdog's progress age). Runs without the pod fault domain
    # summarize to "unavailable".
    cl_totals: Dict[str, float] = {}
    cl_prev: Dict[str, float] = {}
    cl_rows = 0
    cl_seen = False
    cl_suspect: Metric = UNAVAILABLE
    cl_consensus: Metric = UNAVAILABLE
    cl_ages: Union[Dict[str, Any], str] = UNAVAILABLE
    for e in events:
        if e.get("event") == "metrics":
            m = e.get("metrics") or {}
            if m.get("cluster/peer_losses") is not None:
                cl_seen = True
                _accumulate_counter(cl_totals, cl_prev, "peer_losses",
                                    float(m["cluster/peer_losses"]))
            if m.get("cluster/consensus_epoch") is not None:
                cl_seen = True
                cl_consensus = int(m["cluster/consensus_epoch"])
        elif e.get("event") == "peer_lost":
            cl_seen = True
            cl_rows += 1
            suspects = e.get("suspect_hosts")
            if isinstance(suspects, list) and suspects:
                cl_suspect = int(suspects[0])
            if isinstance(e.get("peer_lease_age_seconds"), dict):
                cl_ages = e["peer_lease_age_seconds"]
        elif e.get("event") == "consensus_resume":
            cl_seen = True
            if e.get("consensus_epoch") is not None:
                cl_consensus = int(e["consensus_epoch"])
        elif e.get("event") == "heartbeat":
            if isinstance(e.get("peer_lease_age_seconds"), dict):
                cl_seen = True
                cl_ages = e["peer_lease_age_seconds"]
    cluster_sec: Union[Dict[str, Any], str] = UNAVAILABLE
    if cl_seen:
        finite_ages = (_finite(list(cl_ages.values()))
                       if isinstance(cl_ages, dict) else [])
        cluster_sec = {
            "peer_losses": max(int(cl_totals.get("peer_losses", 0)),
                               cl_rows),
            "last_suspect_host": cl_suspect,
            "consensus_epoch": cl_consensus,
            "max_peer_lease_age_seconds": (round(max(finite_ages), 3)
                                           if finite_ages
                                           else UNAVAILABLE),
        }

    # Warm-start section (parallel/aot.py, schema v9): the AOT store's
    # hit/miss/load counters ride registry "metrics" rows and accumulate
    # reset-aware like the resilience section (one log spans several
    # process lifetimes — exactly the restarts this subsystem exists
    # for); the per-start "warm_start" event row carries
    # time-to-first-step and the compile count at first dispatch — the
    # LAST row wins, i.e. the most recent (re)start, which is the one a
    # warm-start story is about. ``sessions`` counts the warm_start rows
    # so a report reader can see how many (re)starts the log spans.
    ws_totals: Dict[str, float] = {}
    ws_prev: Dict[str, float] = {}
    ws_seen = False
    ws_rows = 0
    ws_ttfs: Metric = UNAVAILABLE
    ws_compiles: Metric = UNAVAILABLE
    for e in events:
        if e.get("event") == "metrics":
            m = e.get("metrics") or {}
            if not any(k.startswith("aot/") for k in m):
                continue
            ws_seen = True
            for key in ("aot/hits", "aot/misses", "aot/load_seconds"):
                if m.get(key) is not None:
                    _accumulate_counter(ws_totals, ws_prev, key,
                                        float(m[key]))
        elif e.get("event") == "warm_start":
            ws_seen = True
            ws_rows += 1
            if e.get("time_to_first_step_seconds") is not None:
                ws_ttfs = round(float(e["time_to_first_step_seconds"]), 3)
            if e.get("compiles_before_first_step") is not None:
                ws_compiles = int(e["compiles_before_first_step"])
    warm_start_sec: Union[Dict[str, Any], str] = UNAVAILABLE
    if ws_seen:
        warm_start_sec = {
            "aot_hits": int(ws_totals.get("aot/hits", 0)),
            "aot_misses": int(ws_totals.get("aot/misses", 0)),
            "aot_load_seconds": round(
                ws_totals.get("aot/load_seconds", 0.0), 3),
            "time_to_first_step_seconds": ws_ttfs,
            "compiles_before_first_step": ws_compiles,
            "sessions": ws_rows,
        }

    # Elastic section (resilience/elastic.py, schema v10): a resharding
    # run EXECs itself per generation, so every counter crosses a
    # process boundary — reshards/degraded epochs/re-expansions
    # accumulate reset-aware (cross-checked against the explicit
    # elastic_reshard / elastic_re_expand event rows, which survive
    # even when the pre-exec registry flush was lost); the generation,
    # roster and lost-host count track the most recent signal in log
    # order — the liveness picture at the end of the log. Runs without
    # elastic_mode summarize to "unavailable".
    el_totals: Dict[str, float] = {}
    el_prev: Dict[str, float] = {}
    el_reshard_rows = 0
    el_expand_rows = 0
    el_seen = False
    el_generation: Metric = UNAVAILABLE
    el_roster: Union[List[int], str] = UNAVAILABLE
    el_lost: Metric = UNAVAILABLE
    for e in events:
        if e.get("event") == "metrics":
            m = e.get("metrics") or {}
            if not any(k.startswith("elastic/") for k in m):
                continue
            el_seen = True
            for key in ("elastic/reshards", "elastic/degraded_epochs",
                        "elastic/re_expansions"):
                if m.get(key) is not None:
                    _accumulate_counter(el_totals, el_prev, key,
                                        float(m[key]))
            if m.get("elastic/generation") is not None:
                el_generation = int(m["elastic/generation"])
            if m.get("elastic/lost_hosts") is not None:
                el_lost = int(m["elastic/lost_hosts"])
        elif e.get("event") in ("elastic_reshard", "elastic_re_expand"):
            el_seen = True
            if e.get("event") == "elastic_reshard":
                el_reshard_rows += 1
            else:
                el_expand_rows += 1
            if e.get("generation") is not None:
                el_generation = int(e["generation"])
            if isinstance(e.get("roster"), list):
                el_roster = [int(h) for h in e["roster"]]
            if isinstance(e.get("dead"), list):
                el_lost = len(e["dead"])
    elastic_sec: Union[Dict[str, Any], str] = UNAVAILABLE
    if el_seen:
        elastic_sec = {
            "reshards": max(int(el_totals.get("elastic/reshards", 0)),
                            el_reshard_rows),
            "re_expansions": max(
                int(el_totals.get("elastic/re_expansions", 0)),
                el_expand_rows),
            "degraded_epochs": int(
                el_totals.get("elastic/degraded_epochs", 0)),
            "generation": el_generation,
            "roster": el_roster,
            "lost_hosts": el_lost,
        }

    # Fleet section (serve/fleet/, schema v11): fleet/* metrics ride
    # registry "metrics" rows from replicas (the L2 tier's counters),
    # the router/controller process (membership gauges, rolling-swap
    # counters), or both — counters accumulate reset-aware (a replica
    # restart resets ITS l2 counters to 0 mid-log, and the fleet
    # section exists precisely to span replica lifetimes), gauges take
    # the most recent signal in log order. Unlike the single-process
    # sections, one fleet log legitimately INTERLEAVES rows from
    # several replicas (each ReplicaServer flush carries its `replica`
    # id), so the reset tracking is keyed per (replica, metric) — two
    # replicas' counters must not read each other's values as resets.
    # The controller's fleet-wide aggregates publish under fleet/agg_*
    # (distinct names) so a combined log never counts a hit twice.
    # Runs without the fleet layer summarize to "unavailable".
    _FLEET_COUNTERS = {
        "l2_hits": "fleet/l2_hits",
        "l2_misses": "fleet/l2_misses",
        "l2_errors": "fleet/l2_errors",
        "l2_publishes": "fleet/l2_publishes",
        "rolling_swaps": "fleet/rolling_swaps",
        "rolling_swap_halts": "fleet/rolling_swap_halts",
        "router_spills": "fleet/router_spills",
    }
    fl_totals: Dict[str, float] = {}
    fl_prev: Dict[str, float] = {}
    fl_seen = False
    fl_live: Metric = UNAVAILABLE
    fl_draining: Metric = UNAVAILABLE
    for e in events:
        if e.get("event") != "metrics":
            continue
        m = e.get("metrics") or {}
        if not any(k.startswith("fleet/") for k in m):
            continue
        fl_seen = True
        source = str(e.get("replica", ""))
        for key in _FLEET_COUNTERS.values():
            if m.get(key) is not None:
                _accumulate_counter(fl_totals, fl_prev,
                                    f"{source}:{key}", float(m[key]))
        if m.get("fleet/replicas_live") is not None:
            fl_live = int(m["fleet/replicas_live"])
        if m.get("fleet/replicas_draining") is not None:
            fl_draining = int(m["fleet/replicas_draining"])
    fleet_sec: Union[Dict[str, Any], str] = UNAVAILABLE
    if fl_seen:
        def _fl_total(key: str) -> float:
            # Totals are per (replica, metric); the section reports the
            # fleet-wide sum over sources.
            return sum(v for k, v in fl_totals.items()
                       if k.split(":", 1)[1] == key)

        hits = _fl_total("fleet/l2_hits")
        misses = _fl_total("fleet/l2_misses")
        fleet_sec = {
            "replicas_live": fl_live,
            "replicas_draining": fl_draining,
            **{label: int(_fl_total(key))
               for label, key in _FLEET_COUNTERS.items()},
            "l2_hit_frac": (round(hits / (hits + misses), 4)
                            if hits + misses > 0 else UNAVAILABLE),
        }

    # Fleet-health section (serve/fleet/supervisor.py + router breaker
    # + shed-at-admission, schema v16): the self-healing loop's ledger.
    # Counters ride the same interleaved "metrics" rows as the fleet
    # section — the supervisor flushes under replica="supervisor", the
    # router's process under its own source, replicas carry
    # serve/shed_total — so accumulation is reset-aware per
    # (source, metric). replicas_desired is a gauge (last signal).
    # Supervisor lifecycle rows ("fleet_supervisor" events) tally by
    # kind so a report shows WHICH healing paths fired (spawn /
    # restart_scheduled / crash_loop / draining / reaped), not just how
    # often counters moved. Runs without the supervisor, breaker, or
    # shed policy summarize to "unavailable".
    _FLEET_HEALTH_COUNTERS = {
        "restarts": "fleet/restarts",
        "crash_loops": "fleet/crash_loops",
        "scale_ups": "fleet/scale_ups",
        "scale_downs": "fleet/scale_downs",
        "failovers": "fleet/failovers",
        "breaker_trips": "fleet/breaker_trips",
        "sheds": "serve/shed_total",
    }
    fh_totals: Dict[str, float] = {}
    fh_prev: Dict[str, float] = {}
    fh_seen = False
    fh_desired: Metric = UNAVAILABLE
    fh_kinds: Dict[str, int] = {}
    for e in events:
        if e.get("event") == "fleet_supervisor":
            fh_seen = True
            kind = str(e.get("kind", "unknown"))
            fh_kinds[kind] = fh_kinds.get(kind, 0) + 1
            continue
        if e.get("event") != "metrics":
            continue
        m = e.get("metrics") or {}
        relevant = [key for key in _FLEET_HEALTH_COUNTERS.values()
                    if m.get(key) is not None]
        if not relevant and m.get("fleet/replicas_desired") is None:
            continue
        fh_seen = True
        source = str(e.get("replica", ""))
        for key in relevant:
            _accumulate_counter(fh_totals, fh_prev,
                                f"{source}:{key}", float(m[key]))
        if m.get("fleet/replicas_desired") is not None:
            fh_desired = int(m["fleet/replicas_desired"])
    fleet_health_sec: Union[Dict[str, Any], str] = UNAVAILABLE
    if fh_seen:
        def _fh_total(key: str) -> int:
            # Totals are per (source, metric); the section reports the
            # fleet-wide sum over sources.
            return int(sum(v for k, v in fh_totals.items()
                           if k.split(":", 1)[1] == key))

        fleet_health_sec = {
            "replicas_desired": fh_desired,
            **{label: _fh_total(key)
               for label, key in _FLEET_HEALTH_COUNTERS.items()},
            "supervisor_events": fh_kinds or UNAVAILABLE,
        }

    # Traffic section (serve/loadlab/ + continuous batching + weighted
    # canary, schema v17): continuous-batching dispatch counters come
    # from replica flushes (serve/cb_*), the traffic-split counters
    # from whichever process runs the router/controller — one log
    # interleaves several sources, so accumulation is reset-aware per
    # (source, metric) like the fleet-health section. The canary
    # weight is a gauge (the rollout ladder's CURRENT stage —
    # last-signal wins). Runs without continuous batching or a
    # weighted rollout summarize to "unavailable".
    _TRAFFIC_COUNTERS = {
        "cb_groups": "serve/cb_groups",
        "cb_fill_dispatches": "serve/cb_fill_dispatch",
        "cb_linger_dispatches": "serve/cb_linger_dispatch",
        "canary_requests": "fleet/canary_requests",
        "cohort_fallbacks": "fleet/cohort_fallbacks",
        "stage_promotions": "fleet/canary_stage_promotions",
    }
    tr_totals: Dict[str, float] = {}
    tr_prev: Dict[str, float] = {}
    tr_seen = False
    tr_weight: Metric = UNAVAILABLE
    for e in events:
        if e.get("event") != "metrics":
            continue
        m = e.get("metrics") or {}
        relevant = [key for key in _TRAFFIC_COUNTERS.values()
                    if m.get(key) is not None]
        if not relevant and m.get("fleet/canary_weight") is None:
            continue
        tr_seen = True
        source = str(e.get("replica", ""))
        for key in relevant:
            _accumulate_counter(tr_totals, tr_prev,
                                f"{source}:{key}", float(m[key]))
        if m.get("fleet/canary_weight") is not None:
            tr_weight = round(float(m["fleet/canary_weight"]), 4)
    traffic_sec: Union[Dict[str, Any], str] = UNAVAILABLE
    if tr_seen:
        def _tr_total(key: str) -> int:
            return int(sum(v for k, v in tr_totals.items()
                           if k.split(":", 1)[1] == key))

        traffic_sec = {
            **{label: _tr_total(key)
               for label, key in _TRAFFIC_COUNTERS.items()},
            "canary_weight": tr_weight,
        }

    # Perf section (telemetry/profiler.py, schema v12): each
    # "perf_profile" row is one sampled dispatch-sync window — the
    # window-split fractions and top device-time executable take the
    # most recent signal in log order (the current shape of the step);
    # sample counts accumulate reset-aware from the perf/samples
    # counter on registry "metrics" rows (one log spans preempt/restart
    # segments) cross-checked against the explicit rows. Runs without
    # profile_every_n_steps summarize to "unavailable".
    pf_totals: Dict[str, float] = {}
    pf_prev: Dict[str, float] = {}
    pf_rows = 0
    pf_seen = False
    pf_compute: Metric = UNAVAILABLE
    pf_gap: Metric = UNAVAILABLE
    pf_top: Metric = UNAVAILABLE
    pf_top_seconds: Metric = UNAVAILABLE
    for e in events:
        if e.get("event") == "metrics":
            m = e.get("metrics") or {}
            if not any(k.startswith("perf/") for k in m):
                continue
            pf_seen = True
            for key in ("perf/samples", "perf/sample_seconds"):
                if m.get(key) is not None:
                    _accumulate_counter(pf_totals, pf_prev, key,
                                        float(m[key]))
        elif e.get("event") == "perf_profile":
            pf_seen = True
            pf_rows += 1
            if isinstance(e.get("device_compute_frac"), (int, float)):
                pf_compute = round(float(e["device_compute_frac"]), 4)
            if isinstance(e.get("dispatch_gap_frac"), (int, float)):
                pf_gap = round(float(e["dispatch_gap_frac"]), 4)
            if e.get("top_executable") is not None:
                pf_top = str(e["top_executable"])
                secs = (e.get("per_executable_seconds") or {}).get(
                    e["top_executable"])
                if isinstance(secs, (int, float)):
                    pf_top_seconds = round(float(secs), 6)
    perf_sec: Union[Dict[str, Any], str] = UNAVAILABLE
    if pf_seen:
        perf_sec = {
            "samples": max(int(pf_totals.get("perf/samples", 0)),
                           pf_rows),
            "sample_seconds": round(
                pf_totals.get("perf/sample_seconds", 0.0), 3),
            "device_compute_frac": pf_compute,
            "dispatch_gap_frac": pf_gap,
            "top_executable": pf_top,
            "top_executable_seconds": pf_top_seconds,
        }

    # Tune section (tune/ + scripts/autotune.py, schema v13): tune/*
    # counters ride the sweep runner's registry "metrics" rows and
    # accumulate reset-aware — one sweep log legitimately spans several
    # runner lifetimes (the kill-and-resume contract is the ledger's
    # whole point) — cross-checked against the explicit tune_trial
    # rows. The best objective is the MAX over successful trial rows
    # (higher is better for both objective keys: mfu and
    # tasks/s/chip); the adoption verdict and tuned fingerprint take
    # the most recent tune_adopt row in log order. Logs without the
    # subsystem summarize to "unavailable".
    tn_totals: Dict[str, float] = {}
    tn_prev: Dict[str, float] = {}
    tn_seen = False
    tn_rows = 0
    tn_failed_rows = 0
    tn_best: Metric = UNAVAILABLE
    tn_objective: Metric = UNAVAILABLE
    tn_adopted: Metric = UNAVAILABLE
    tn_fingerprint: Metric = UNAVAILABLE
    for e in events:
        if e.get("event") == "metrics":
            m = e.get("metrics") or {}
            if not any(k.startswith("tune/") for k in m):
                continue
            tn_seen = True
            for key in ("tune/trials_run", "tune/trials_failed",
                        "tune/invalid_flag_failures"):
                if m.get(key) is not None:
                    _accumulate_counter(tn_totals, tn_prev, key,
                                        float(m[key]))
        elif e.get("event") == "tune_trial":
            tn_seen = True
            tn_rows += 1
            if e.get("outcome") != "ok":
                tn_failed_rows += 1
            v = e.get("objective")
            if isinstance(v, (int, float)) and math.isfinite(float(v)):
                # Anchor the unit on the FIRST scored row (the
                # baseline runs first): a trial whose flops walk
                # failed falls back from mfu to tasks/s, and a raw
                # cross-unit max would report its ~46 over everyone
                # else's ~0.04.
                key = (str(e["objective_key"])
                       if e.get("objective_key") is not None else None)
                if tn_objective == UNAVAILABLE and key is not None:
                    tn_objective = key
                if key == tn_objective and (
                        tn_best == UNAVAILABLE or float(v) > tn_best):
                    tn_best = round(float(v), 6)
        elif e.get("event") == "tune_adopt":
            tn_seen = True
            if e.get("adopted") is not None:
                tn_adopted = bool(e["adopted"])
            if e.get("tuned_fingerprint"):
                tn_fingerprint = str(e["tuned_fingerprint"])[:16]
    tune_sec: Union[Dict[str, Any], str] = UNAVAILABLE
    if tn_seen:
        tune_sec = {
            "trials_run": max(int(tn_totals.get("tune/trials_run", 0)),
                              tn_rows),
            "trials_failed": max(
                int(tn_totals.get("tune/trials_failed", 0)),
                tn_failed_rows),
            "invalid_flag_failures": int(
                tn_totals.get("tune/invalid_flag_failures", 0)),
            "best_objective": tn_best,
            "objective": tn_objective,
            "adopted": tn_adopted,
            "tuned_fingerprint": tn_fingerprint,
        }

    # Requests section (telemetry/reqtrace.py + the controller's SLO
    # ledger, schema v14): reqtrace/* span counters ride registry
    # "metrics" rows from every traced process — replicas AND the
    # jax-free router process — so, like the fleet section, reset tracking is
    # keyed per (`replica` source, metric); the explicit request_trace
    # rows are the cross-check AND the raw material: assembled into
    # traces they yield the linked fraction (causally-complete span
    # sets), the dominant latency tier and the tenant population. SLO
    # good/bad totals accumulate reset-aware; the burn-rate gauge takes
    # the most recent signal. Untraced runs summarize to "unavailable".
    _RQ_COUNTERS = {
        "spans": "reqtrace/spans",
        "dropped": "reqtrace/dropped",
        "slo_good": "fleet/slo_good_total",
        "slo_bad": "fleet/slo_bad_total",
    }
    rq_totals: Dict[str, float] = {}
    rq_prev: Dict[str, float] = {}
    rq_seen = False
    rq_burn: Metric = UNAVAILABLE
    rq_rows: List[Dict[str, Any]] = []
    for e in events:
        if e.get("event") == "metrics":
            m = e.get("metrics") or {}
            if not any(k.startswith("reqtrace/")
                       or k in ("fleet/slo_good_total",
                                "fleet/slo_bad_total",
                                "fleet/slo_burn_rate") for k in m):
                continue
            rq_seen = True
            source = str(e.get("replica", ""))
            for key in _RQ_COUNTERS.values():
                if m.get(key) is not None:
                    _accumulate_counter(rq_totals, rq_prev,
                                        f"{source}:{key}",
                                        float(m[key]))
            if m.get("fleet/slo_burn_rate") is not None:
                rq_burn = round(float(m["fleet/slo_burn_rate"]), 4)
        elif e.get("event") == "request_trace":
            rq_seen = True
            rq_rows.append(e)
    requests_sec: Union[Dict[str, Any], str] = UNAVAILABLE
    if rq_seen:
        def _rq_total(key: str) -> float:
            return sum(v for k, v in rq_totals.items()
                       if k.split(":", 1)[1] == key)

        rq = _reqtrace()
        rq_traces = rq.assemble(rq_rows)
        rq_linked = sum(1 for t in rq_traces.values() if rq.linked(t))
        rq_tiers = {tier: 0.0 for tier in rq.TIERS}
        for t in rq_traces.values():
            if rq.linked(t):
                attr = rq.attribute(t)
                for tier in rq.TIERS:
                    rq_tiers[tier] += attr[tier]
        good = _rq_total("fleet/slo_good_total")
        bad = _rq_total("fleet/slo_bad_total")
        requests_sec = {
            "spans_recorded": max(int(_rq_total("reqtrace/spans")),
                                  len(rq_rows)),
            "spans_dropped": int(_rq_total("reqtrace/dropped")),
            "trace_rows": len(rq_rows),
            "traces": len(rq_traces),
            "linked": rq_linked,
            "linked_frac": (round(rq_linked / len(rq_traces), 4)
                            if rq_traces else UNAVAILABLE),
            "dominant_tier": (max(rq.TIERS,
                                  key=lambda k: rq_tiers[k])
                              if rq_linked else UNAVAILABLE),
            "tenants": len({t["tenant"] for t in rq_traces.values()
                            if t["tenant"]}),
            "slo_good": int(good),
            "slo_bad": int(bad),
            "slo_bad_frac": (round(bad / (good + bad), 4)
                             if good + bad > 0 else UNAVAILABLE),
            "slo_burn_rate": rq_burn,
        }

    # Algo section (meta/algos/ registry, schema v15): identity and
    # adapted/total parameter counts take the most recent signal in log
    # order — a restart or hot-swap legitimately re-emits them (and an
    # ANIL swap CHANGES the adapted count; last wins is the live truth).
    # Serving metrics rows are stamped with their engine's
    # meta_algorithm, so adapt-seconds p50 is tracked per variant
    # (last-signal) and adapt-batch counters accumulate reset-aware per
    # (replica source, variant) — one log interleaves several replicas'
    # flushes across restarts. Logs predating the registry summarize to
    # "unavailable".
    al_seen = False
    al_name: Metric = UNAVAILABLE
    al_task: Metric = UNAVAILABLE
    al_adapted: Metric = UNAVAILABLE
    al_total: Metric = UNAVAILABLE
    al_adapt_p50: Dict[str, Any] = {}
    al_totals: Dict[str, float] = {}
    al_prev: Dict[str, float] = {}
    for e in events:
        if e.get("event") == "algo":
            al_seen = True
            if e.get("meta_algorithm") is not None:
                al_name = str(e["meta_algorithm"])
            if e.get("task_type") is not None:
                al_task = str(e["task_type"])
            if e.get("adapted_params") is not None:
                al_adapted = int(e["adapted_params"])
            if e.get("total_params") is not None:
                al_total = int(e["total_params"])
        elif e.get("event") == "metrics":
            m = e.get("metrics") or {}
            if m.get("algo/adapted_params") is not None:
                al_seen = True
                al_adapted = int(m["algo/adapted_params"])
            if m.get("algo/total_params") is not None:
                al_seen = True
                al_total = int(m["algo/total_params"])
            algo = e.get("meta_algorithm")
            if algo is None:
                continue
            al_seen = True
            al_name = str(algo)
            hist = m.get("serve/adapt_seconds")
            if isinstance(hist, dict) and hist.get("p50") is not None:
                al_adapt_p50[str(algo)] = round(float(hist["p50"]), 6)
            if m.get("serve/adapt_batches") is not None:
                source = str(e.get("replica", ""))
                _accumulate_counter(al_totals, al_prev,
                                    f"{source}:{algo}",
                                    float(m["serve/adapt_batches"]))
    algo_sec: Union[Dict[str, Any], str] = UNAVAILABLE
    if al_seen:
        al_batches = {
            variant: int(sum(v for k, v in al_totals.items()
                             if k.split(":", 1)[1] == variant))
            for variant in {k.split(":", 1)[1] for k in al_totals}}
        algo_sec = {
            "meta_algorithm": al_name,
            "task_type": al_task,
            "adapted_params": al_adapted,
            "total_params": al_total,
            "adapted_frac": (
                round(al_adapted / al_total, 4)
                if isinstance(al_adapted, int)
                and isinstance(al_total, int) and al_total
                else UNAVAILABLE),
            "adapt_seconds_p50": al_adapt_p50 or UNAVAILABLE,
            "adapt_batches": al_batches or UNAVAILABLE,
        }

    # Alerts section (telemetry/alerts.py, schema v18): the engine logs
    # only TRANSITIONS ("firing"/"resolved" — pending is silent), so the
    # section is a pure replay: fired/resolved tallies (and fired-by-
    # severity), plus the still-firing reconstruction — last transition
    # wins per (source, rule, labels); several evaluators (trainer,
    # serving engine, supervisor) legitimately interleave in one log,
    # and the SAME rule name firing on two sources is two instances.
    # most_fired_rule names the noisiest rule — the first thing a human
    # tunes. Runs without alert_rules_path summarize to "unavailable".
    at_fired = 0
    at_resolved = 0
    at_fired_by_sev: Dict[str, int] = {}
    at_per_rule: Dict[str, int] = {}
    at_last: Dict[str, str] = {}   # instance key -> last state
    at_seen = False
    for e in events:
        if e.get("event") != "alert":
            continue
        at_seen = True
        state = str(e.get("state", ""))
        rule = str(e.get("rule", "unknown"))
        key = "|".join((str(e.get("source", "")), rule,
                        repr(sorted((e.get("labels") or {}).items()))))
        at_last[key] = state
        if state == "firing":
            at_fired += 1
            sev = str(e.get("severity", "warn"))
            at_fired_by_sev[sev] = at_fired_by_sev.get(sev, 0) + 1
            at_per_rule[rule] = at_per_rule.get(rule, 0) + 1
        elif state == "resolved":
            at_resolved += 1
    alerts_sec: Union[Dict[str, Any], str] = UNAVAILABLE
    if at_seen:
        alerts_sec = {
            "fired": at_fired,
            "resolved": at_resolved,
            "still_firing": sum(1 for s in at_last.values()
                                if s == "firing"),
            "fired_by_severity": at_fired_by_sev or UNAVAILABLE,
            "most_fired_rule": (max(sorted(at_per_rule),
                                    key=lambda r: at_per_rule[r])
                                if at_per_rule else UNAVAILABLE),
        }

    skews = _finite([e.get("skew_frac") for e in beats])
    hosts = [int(e.get("hosts") or 1) for e in beats]
    host_skew: Union[Dict[str, Any], str] = UNAVAILABLE
    if beats:
        host_skew = {
            "hosts": max(hosts) if hosts else 1,
            "heartbeats": len(beats),
            "max_skew_frac": round(max(skews), 4) if skews else 0.0,
            "median_skew_frac": round(_median(skews) or 0.0, 4),
        }

    def _r(v: Optional[float], nd: int = 6) -> Metric:
        return UNAVAILABLE if v is None else round(v, nd)

    return {
        "schema": SCHEMA,
        "events": len(events),
        "epochs": len(train),
        "steps": steps,
        "step_seconds_p50": _r(_median(p50s)),
        "step_seconds_p95": _r(_median(p95s)),
        "meta_tasks_per_sec_per_chip": _r(_median(rates), 3),
        "compile_count": compile_count,
        "compile_seconds": compile_seconds,
        "feed_stall_frac": feed_stall,
        "peak_memory_bytes": (int(max(peaks)) if peaks else UNAVAILABLE),
        "live_memory_bytes": (int(max(lives)) if lives else UNAVAILABLE),
        "host_skew": host_skew,
        "serving": serving,
        "resilience": resilience_sec,
        "data": data_sec,
        "watchdog": watchdog_sec,
        "health": health_sec,
        "checkpoint": ckpt_sec,
        "cluster": cluster_sec,
        "warm_start": warm_start_sec,
        "elastic": elastic_sec,
        "fleet": fleet_sec,
        "fleet_health": fleet_health_sec,
        "traffic": traffic_sec,
        "perf": perf_sec,
        "tune": tune_sec,
        "requests": requests_sec,
        "algo": algo_sec,
        "alerts": alerts_sec,
    }


def _fmt(value: Any) -> str:
    if isinstance(value, float):
        return f"{value:.6g}"
    if isinstance(value, dict):
        return ", ".join(f"{k}={_fmt(v)}" for k, v in value.items())
    return str(value)


def format_table(summary: Dict[str, Any]) -> str:
    """Fixed-width two-column table of the summary (human half of the
    CLI; the JSON line is the machine half)."""
    rows = [
        ("epochs", summary["epochs"]),
        ("steps (dispatch-timed)", summary["steps"]),
        ("step seconds p50", summary["step_seconds_p50"]),
        ("step seconds p95", summary["step_seconds_p95"]),
        ("meta tasks/sec/chip", summary["meta_tasks_per_sec_per_chip"]),
        ("XLA compiles", summary["compile_count"]),
        ("XLA compile seconds", summary["compile_seconds"]),
        ("feed stall fraction", summary["feed_stall_frac"]),
        ("peak memory bytes/device", summary["peak_memory_bytes"]),
        ("live memory bytes total", summary["live_memory_bytes"]),
        ("per-host step skew", summary["host_skew"]),
        ("serving", summary["serving"]),
        ("resilience", summary["resilience"]),
        ("data plane", summary["data"]),
        ("watchdog", summary["watchdog"]),
        ("health", summary["health"]),
        ("checkpoint", summary["checkpoint"]),
        ("cluster", summary["cluster"]),
        ("warm start", summary["warm_start"]),
        ("elastic", summary["elastic"]),
        ("fleet", summary["fleet"]),
        ("fleet health", summary["fleet_health"]),
        ("traffic", summary["traffic"]),
        ("perf", summary["perf"]),
        ("tune", summary["tune"]),
        ("requests", summary["requests"]),
        ("algo", summary["algo"]),
        ("alerts", summary["alerts"]),
    ]
    width = max(len(label) for label, _ in rows)
    lines = [f"telemetry report ({summary['events']} events)"]
    lines += [f"  {label:<{width}}  {_fmt(value)}" for label, value in rows]
    return "\n".join(lines)
