"""Traffic driver ``serve_open_loop``: few-shot requests offered to the
program's ``ServingEngine`` in an open loop at a fixed rate.

Set-up makes the meta-parameters from the seed, builds the engine with
the traffic's engine settings (its ``warmup`` captures the adapt and
predict graphs of the bucket), draws an image pool on the device and
serves ``warm_requests`` untimed. In the window a generator thread
submits each request at its scheduled instant (``lib/episodes.py §
arrivals``) while the main thread steps the engine; every request
carries its own support set and queries (a new tenant: the cache never
hits), and its latency counts from its scheduled instant to the moment
``engine.step`` hands back its answer, both read on this driver's clock
(not the engine's own timings), so a stall is charged to every request
it delays. The engine is drained up to
``drain_timeout_s`` past the window; a refused, failed or unanswered
request counts as missing every latency limit.

After the window the engine is closed and freed, and the plain
reference (``reference/maml.py § adapt_predict``, float32, TF32 off)
answers a sample of the served requests drawn from the seed
(``sample_requests``); ``lib/compare.py § serve_numbers`` compares
their logits.

Traffic keys: ``rate_per_s``, ``image_pool``, ``warm_requests``,
``sample_requests``, ``trace_seconds``, ``drain_timeout_s`` and
``engine`` (program settings: batch, continuous batching, linger).
"""

from __future__ import annotations

import gc
import math
import threading
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench.lib import compare, costs, episodes, port, trace, weights
from portbench.lib.weights import sub_seed
from portbench.lib.spec import Context, Outcome
from portbench.reference import maml
from portbench.reference.model import Numerics, hyper


class Requests:
    """The traffic's requests, built on demand from the image pool and a
    plan of pool indices (one row per request)."""

    def __init__(self, hp, pool: np.ndarray, plan: np.ndarray):
        self.pool, self.plan = pool, plan
        self.support = hp.num_classes * hp.shots
        # serve/loadlab/workloads.py § synthetic_arrays' labels
        self.labels = (np.arange(self.support) % hp.num_classes).astype(
            np.int32)

    def arrays(self, i: int):
        idx = self.plan[i]
        return (self.pool[idx[:self.support]], self.labels,
                self.pool[idx[self.support:]])

    def make(self, i: int, arrival: float):
        return port.request(*self.arrays(i), arrival)


def open_loop(engine, requests: Requests, first: int, times: np.ndarray,
              timeout_s: float) -> Dict[str, Any]:
    """Offer requests ``first + i`` at ``start + times[i]`` and serve them.

    Returns per request: ``scheduled``, ``sent`` and ``done`` instants
    (``time.monotonic`` read by this loop: ``done`` when ``engine.step``
    has handed back the answer, NaN for a request never answered),
    ``ok``, the served ``logits``, and ``start``/``end`` of the run."""
    n = len(times)
    refused = port.refusals()
    start = time.monotonic() + 0.005
    scheduled = start + times
    sent = np.full(n, np.nan)
    done = np.full(n, np.nan)
    ok = np.zeros(n, dtype=bool)
    logits: List[Any] = [None] * n
    ids: Dict[int, int] = {}
    errors: List[BaseException] = []
    refusals = [0]   # written by the generator thread only

    def generate():
        try:
            for i in range(n):
                delay = scheduled[i] - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                req = requests.make(first + i, float(scheduled[i]))
                ids[req.request_id] = i
                try:
                    engine.submit(req)
                except refused:
                    refusals[0] += 1
                sent[i] = time.monotonic()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    thread = threading.Thread(target=generate, name="portbench-generator")
    thread.start()
    deadline = start + times[-1] + timeout_s
    pending = n
    try:
        while time.monotonic() < deadline:
            with trace.host_range("portbench.engine_step"):
                responses = engine.step()
            answered = time.monotonic()
            for r in responses:
                i = ids[r.request_id]
                done[i] = answered
                if r.status == "ok":
                    ok[i], logits[i] = True, r.logits
                pending -= 1
            if not responses:
                if pending == refusals[0] and not thread.is_alive():
                    break
                time.sleep(0.0002)
    finally:
        thread.join()
    if errors:
        raise errors[0]
    return {"scheduled": scheduled, "sent": sent, "done": done, "ok": ok,
            "logits": logits, "start": start, "end": time.monotonic()}


def latencies(res: Dict[str, Any]) -> np.ndarray:
    """Seconds from each request's scheduled instant to its answer;
    infinite for a request refused, failed or never answered."""
    lat = res["done"] - res["scheduled"]
    return np.where(res["ok"] & np.isfinite(lat), lat, np.inf)


def _hist_counts(engine, name: str):
    h = engine.registry.histogram(name)
    return list(h.bounds), list(h.snapshot()["bucket_counts"])


def run(ctx: Context) -> Outcome:
    device = ctx.device
    traffic = ctx.traffic
    maml_config = ctx.config["maml_config"]
    hp = hyper(maml_config)
    cfg = port.config(maml_config, {
        **traffic["engine"], **ctx.program_overrides,
        "experiment_root": f"{ctx.cache_dir}/experiments"})
    params, lslr, bn_state = weights.make(hp, sub_seed(ctx.seed, 1), device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    engine = port.serving_engine(cfg, params, lslr, bn_state, device)
    engine.warmup()

    rate, seconds = float(traffic["rate_per_s"]), float(ctx.seconds)
    times = episodes.arrivals(rate, seconds, sub_seed(ctx.seed, 3))
    trace_times = (episodes.arrivals(rate, float(traffic["trace_seconds"]),
                                     sub_seed(ctx.seed, 5))
                   if ctx.trace else np.zeros(0))
    warm = int(traffic["warm_requests"])
    per = hp.num_classes * (hp.shots + hp.targets)
    pool_size = int(traffic["image_pool"])
    plan = episodes.request_plan(pool_size, per,
                                 warm + len(times) + len(trace_times),
                                 sub_seed(ctx.seed, 4))
    requests = Requests(hp, episodes.image_pool(
        hp.image_shape, pool_size, sub_seed(ctx.seed, 2), device), plan)
    now = time.monotonic()
    for i in range(warm):
        engine.submit(requests.make(i, now))
    engine.drain()
    setup_s = time.perf_counter() - ctx.t0

    adapt_before = len(engine.adapt_seconds)
    bounds, wait_before = _hist_counts(engine, "serve/queue_wait_seconds")
    res = open_loop(engine, requests, warm, times,
                    float(traffic["drain_timeout_s"]))
    _, wait_after = _hist_counts(engine, "serve/queue_wait_seconds")
    adapt_s = engine.adapt_seconds[adapt_before:]
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)

    summary = None
    if ctx.trace:
        def traced_requests():
            t = open_loop(engine, requests, warm + len(times), trace_times,
                          float(traffic["drain_timeout_s"]))
            return {"requests": int(t["ok"].sum())}
        summary = trace.traced(traced_requests, device)
    engine.close()
    del engine
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    lat = latencies(res)
    p95 = episodes.percentile(lat.tolist(), 0.95)
    if not math.isfinite(p95):
        raise RuntimeError(f"more than 5% of the window's {len(lat)} "
                           f"requests were refused, failed or unanswered")
    window_end = res["start"] + seconds
    served = int((res["ok"] & (res["done"] <= window_end)).sum())

    ok_idx = np.flatnonzero(res["ok"])
    rng = np.random.default_rng(sub_seed(ctx.seed, 6))
    sample = rng.choice(ok_idx, size=min(int(traffic["sample_requests"]),
                                         len(ok_idx)), replace=False)
    pairs = []
    with maml.TF32Off():
        for i in sample:
            sx, sy, qx = requests.arrays(warm + int(i))
            ref = maml.adapt_predict(
                hp, params, lslr, torch.from_numpy(sx).to(device),
                torch.from_numpy(sy).to(device),
                torch.from_numpy(qx).to(device), Numerics())
            pairs.append((torch.from_numpy(np.asarray(res["logits"][i])),
                          ref.cpu()))
    numbers = compare.serve_numbers(pairs)
    limits = ctx.cell["limits"]
    readings: Dict[str, Any] = {
        "adapt_seconds": list(adapt_s),
        "queue_wait": (bounds, [a - b for a, b in zip(wait_after,
                                                      wait_before)]),
        "late_seconds": (res["sent"] - res["scheduled"]).tolist(),
        "requests_per_s": served / seconds, "numbers": numbers}
    if ctx.trace:
        readings["per_request"] = costs.per_unit(hp, "request")
        readings["peak_flops"] = costs.PEAK_FLOPS[hp.compute_dtype]
    return Outcome(
        end_to_end={"setup_s": setup_s, "serve_p95_ms": p95 * 1e3,
                    "serve_tasks_per_s": served / seconds,
                    "peak_gib": peak / 2 ** 30},
        checks={k: (numbers[k], float(limits[k])) for k in limits},
        attempted=len(lat), failed=int((~np.isfinite(lat)).sum()),
        memory_peak_bytes=peak, trace=summary, readings=readings)
