"""Serving benchmark of the PyTorch port: open-loop synthetic load against
one ``ServingEngine`` (the port's counterpart of
``scripts/serve_bench.py``).

Drives the port's ``serve/`` the way a latency benchmark must be
driven: OPEN-LOOP — request arrival times are drawn up front from the
target rate and never wait on completions, so queueing delay under
overload is measured instead of hidden. Latency is measured from the
scheduled ARRIVAL instant, so coordinated omission cannot flatter the
tail.

The request mix cycles over the configured shape buckets with a
configurable task-repeat fraction (repeats exercise the adapted-params
cache exactly like real "adapt once, predict many" tenants). The engine
serves through the hand-written BN kernel (``bn_backend='pallas'``) on
the card (``--device cuda``, the default; no CPU fallback) or through
its plain version on the CPU (``--device cpu``).

Artifact contract: the LAST stdout JSON line carries every key of the
JAX script's artifact. ``compile_count_warmup`` and
``compile_count_steady_delta`` are null: eager PyTorch compiles
nothing. ``bn_act_launches`` holds the kernel's launches in this
process beside the count the engine's adapt and predict batches need,
warm-up included (none on the CPU, where the plain version runs). With
``--events PATH`` the run also writes an ``events.jsonl`` stream with
the engine's flush row.

Usage:
    python scripts/torch_serve_bench.py --quick --device cpu
    python scripts/torch_serve_bench.py --requests 200 --rate 20
    python scripts/torch_serve_bench.py --config experiment_config/x.json \\
        --checkpoint <saved_models>                        # real weights
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import numpy as np  # noqa: E402

from howtotrainyourmamlpytorch_tpu_torch.serve.loadlab.workloads import (  # noqa: E402
    synthetic_arrays)


def build_config(args):
    """The served config: ``--config`` or the defaults, ``--quick``'s tiny
    shapes, the kernel path (``bn_backend='pallas'``), and the bench's
    deadline and queue bound."""
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    if args.config:
        cfg = MAMLConfig.from_json_file(args.config)
    else:
        cfg = MAMLConfig(
            experiment_name="serve_bench",
            dataset_name="synthetic")
    if args.quick:
        cfg = cfg.replace(
            image_height=12, image_width=12, image_channels=1,
            cnn_num_filters=4, num_stages=2,
            num_classes_per_set=3, num_samples_per_class=1,
            num_target_samples=2,
            number_of_training_steps_per_iter=2,
            number_of_evaluation_steps_per_iter=2,
            serve_batch_tasks=2,
            serve_buckets=((3, 4), (6, 4)))
    # Deadlines off by default here: the artifact measures the latency
    # DISTRIBUTION; a deadline sweep is a separate experiment (pass
    # --deadline-ms to run one). --queue-depth is honored as given —
    # under overload, rejected submits are load-shedding and the
    # artifact counts them.
    return cfg.replace(bn_backend="pallas",
                       serve_default_deadline_ms=args.deadline_ms,
                       serve_max_queue_depth=args.queue_depth)


def synthetic_request(cfg, bucket, rng, fill, arrival):
    """One synthetic request at ``fill <= bucket`` occupancy with wire
    dtype matching the config (uint8 by default, like real traffic)."""
    from howtotrainyourmamlpytorch_tpu_torch.serve import FewShotRequest
    sx, sy, qx = synthetic_arrays(cfg.image_shape,
                                  cfg.num_classes_per_set,
                                  cfg.transfer_images_uint8, rng, fill)
    req = FewShotRequest(support_x=sx, support_y=sy, query_x=qx)
    req.arrival_time = arrival  # open-loop: scheduled arrival, not ctor
    return req


def build_requests(cfg, buckets, *, num_requests: int, rate: float,
                   repeat_frac: float, seed: int, start: float) -> List:
    """Pre-draw the whole arrival schedule and request mix (open loop):
    the JAX script's draws in its order, so one seed gives both benches
    the same traffic. A repeat carries ``repeat_of``, the index of the
    request whose support set it reuses; others carry None."""
    rng = np.random.RandomState(seed)
    if rate > 0:
        gaps = rng.exponential(1.0 / rate, num_requests)
        arrivals = start + np.cumsum(gaps)
    else:
        arrivals = np.full(num_requests, start)
    requests = []
    for i in range(num_requests):
        bucket = buckets[i % len(buckets)]
        fill = (max(1, bucket[0] - (i % 2)), max(1, bucket[1] - (i % 3)))
        if requests and rng.rand() < repeat_frac:
            # Repeat an earlier support set with FRESH queries: the
            # cache-hit path (adapt skipped, predict only).
            j = rng.randint(len(requests))
            prev = requests[j]
            req = synthetic_request(cfg, bucket, rng,
                                    (prev.num_support, prev.num_query),
                                    arrivals[i])
            req.support_x = prev.support_x
            req.support_y = prev.support_y
            req.repeat_of = getattr(prev, "repeat_of", None)
            if req.repeat_of is None:
                req.repeat_of = j
        else:
            req = synthetic_request(cfg, bucket, rng, fill, arrivals[i])
            req.repeat_of = None
        requests.append(req)
    return requests


def bn_per_forward(cfg, device) -> int:
    """BN-kernel launches of one forward of the served model on
    ``device``: one per batch-norm layer on the card (the VGG's stages,
    ResNet-12's 16), none on the CPU (the plain version runs) or
    without batch norm."""
    from howtotrainyourmamlpytorch_tpu_torch.models.resnet12 import (
        NORMS_PER_FORWARD)
    if (device.type != "cuda" or cfg.bn_backend != "pallas"
            or cfg.norm_layer != "batch_norm" or cfg.backbone == "mlp"):
        return 0
    return NORMS_PER_FORWARD if cfg.backbone == "resnet12" else (
        cfg.num_stages)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Open-loop synthetic load benchmark for the port's "
                    "serve/.")
    ap.add_argument("--requests", type=int, default=100,
                    help="total synthetic requests")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="offered load, requests/s (0 = as fast as the "
                         "engine drains: a throughput measurement)")
    ap.add_argument("--repeat-frac", type=float, default=0.3,
                    help="fraction of requests that repeat an earlier "
                         "support set (exercises the adapted-params "
                         "cache)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request deadline (0 = none)")
    ap.add_argument("--queue-depth", type=int, default=64)
    ap.add_argument("--config", default=None, metavar="JSON",
                    help="experiment_config/*.json to serve")
    ap.add_argument("--checkpoint", default=None, metavar="DIR",
                    help="saved_models dir to load weights from (either "
                         "package's; default: a fresh meta-init — "
                         "throughput/latency are weight-independent)")
    ap.add_argument("--events", default=None, metavar="PATH",
                    help="also write an events.jsonl telemetry stream")
    ap.add_argument("--quick", action="store_true",
                    help="tiny shapes for CI/CPU sanity")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the engine serves (the card by default)")
    args = ap.parse_args(argv)

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available: the engine serves "
                         "on the card unless --device cpu is given")
    from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
        init_train_state)
    from howtotrainyourmamlpytorch_tpu_torch.models import make_model
    from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
    from howtotrainyourmamlpytorch_tpu_torch.serve import ServingEngine
    from howtotrainyourmamlpytorch_tpu_torch.utils.tracing import (
        JsonlLogger, nearest_rank)

    cfg = build_config(args)
    device = torch.device(args.device)
    bn_act.reset_launches()
    if args.checkpoint:
        engine = ServingEngine.from_checkpoint(cfg, args.checkpoint,
                                               device=device)
    else:
        model_init, _ = make_model(cfg)
        state = init_train_state(cfg, model_init, seed=cfg.seed,
                                 device=device)
        engine = ServingEngine(cfg, state, device=device)

    t0 = time.perf_counter()
    engine.warmup()
    warmup_seconds = time.perf_counter() - t0

    start = time.monotonic() + 0.01
    requests = build_requests(
        cfg, engine.batcher.buckets, num_requests=args.requests,
        rate=args.rate, repeat_frac=args.repeat_frac, seed=args.seed,
        start=start)

    # Drive: submit every request whose arrival instant has passed, pump
    # the engine between arrivals, drain at the end.
    responses = []
    next_idx = 0
    rejected = 0
    while next_idx < len(requests) or engine.batcher.depth:
        now = time.monotonic()
        while next_idx < len(requests) and requests[next_idx].arrival_time <= now:
            try:
                engine.submit(requests[next_idx])
            except Exception:
                if args.rate > 0:
                    # Rated open-loop traffic: a full queue sheds the
                    # request (that IS the backpressure behavior under
                    # overload; the artifact counts it).
                    rejected += 1
                else:
                    # rate=0 is a backlog/throughput measurement: the
                    # queue-depth cap throttles submission, it must not
                    # discard work — retry after the next batch drains.
                    break
            next_idx += 1
        responses.extend(engine.step())
        if next_idx < len(requests) and not engine.batcher.depth:
            time.sleep(min(0.005,
                           max(requests[next_idx].arrival_time
                               - time.monotonic(), 0.0)))
    wall = time.monotonic() - start
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    ok = [r for r in responses if r.error is None]
    lat_ms = sorted(r.latency_seconds * 1e3 for r in ok)

    def pct(q, vals=lat_ms):
        # The repo's one pinned quantile definition.
        return round(nearest_rank(vals, q), 3) if vals else None

    # Per-cache-tier latency split (mirrors the fleet bench's leg
    # stats): tier "miss" = adapted from scratch, the expensive path.
    tier_lat = {"l1": [], "l2": [], "miss": []}
    for r in ok:
        tier_lat[r.cache_tier or "miss"].append(r.latency_seconds * 1e3)
    tier_latency_ms = {
        tier: ({"count": len(vals), "p50_ms": pct(0.50, sorted(vals)),
                "p95_ms": pct(0.95, sorted(vals)),
                "p99_ms": pct(0.99, sorted(vals))} if vals else None)
        for tier, vals in tier_lat.items()}

    per_forward = bn_per_forward(cfg, device)
    per_adapt = per_forward * engine.num_adapt_steps
    want = per_adapt * engine.adapt_runs + per_forward * engine.predict_runs
    launches = bn_act.launches
    hits = engine.cache.hits
    misses = engine.cache.misses
    out = {
        "metric": "serve_requests_per_sec",
        "value": round(len(ok) / wall, 3) if wall > 0 else None,
        "unit": "requests/s",
        "backend": "torch",
        "device": str(device),
        "requests": args.requests,
        "responses": len(ok),
        "deadline_misses": len(responses) - len(ok),
        "rejected": rejected,
        "serve_latency_p50_ms": pct(0.5),
        "serve_latency_p95_ms": pct(0.95),
        "serve_latency_p99_ms": pct(0.99),
        "tier_latency_ms": tier_latency_ms,
        "serve_cache_hit_frac": (round(hits / (hits + misses), 4)
                                 if hits + misses else None),
        "adapt_batches": engine.adapt_invocations,
        "meta_algorithm": cfg.meta_algorithm,
        "adapted_params": int(
            engine.registry.gauge("algo/adapted_params").value or 0),
        "total_params": int(
            engine.registry.gauge("algo/total_params").value or 0),
        "cache_entries": len(engine.cache),
        "cache_entry_bytes_mean": (
            round(engine.cache.approx_bytes / len(engine.cache), 1)
            if len(engine.cache) else None),
        "adapt_seconds_p50": engine.registry.histogram(
            "serve/adapt_seconds").quantile(0.5),
        "warmup_seconds": round(warmup_seconds, 3),
        # Eager PyTorch compiles nothing: no compile count to report.
        "compile_count_warmup": None,
        "compile_count_steady_delta": None,
        "bn_act_launches": {"launches": launches, "expected": want,
                            "per_adapt_batch": per_adapt,
                            "per_predict_batch": per_forward,
                            "adapt_runs": engine.adapt_runs,
                            "predict_runs": engine.predict_runs,
                            "ok": launches == want},
        "offered_rate": args.rate or None,
        "workload": cfg.experiment_name,
        # Fleet keys (the fleet harnesses fill them): null here so
        # single-engine and fleet captures stay schema-stable.
        "fleet_replicas": None,
        "fleet_qps": None,
        "fleet_speedup_vs_single": None,
        "fleet_l2_hit_frac": None,
        "fleet_rolling_swaps": None,
        "fleet_rolling_swap_halts": None,
        "fleet_router_spills": None,
        "fleet_trace_count": None,
        "fleet_trace_linked_frac": None,
        "fleet_trace_dominant_tier": None,
        "fleet_trace_tier_seconds": None,
        "fleet_slo_burn_rate": None,
        "fleet_slo_tenants": None,
        "fleet_shed_count": None,
        "fleet_failover_count": None,
        "fleet_restarts": None,
        # Traffic-lab keys (scripts/torch_traffic_replay.py fills them).
        "traffic_p95_ms": None,
        "traffic_slo_held": None,
        "traffic_canary_weight_final": None,
        "traffic_cb_groups": None,
        # Alert keys (scripts/torch_chaos_fleet.py fills them).
        "alerts_fired": None,
        "alerts_resolved": None,
        "alerts_active_final": None,
    }
    if args.events:
        engine.flush_metrics(JsonlLogger(args.events), phase="serve_bench")
    engine.close()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
