"""``scripts/torch_serve_bench.py`` on the CPU: the open-loop bench of one
port ``ServingEngine`` at ``--quick`` shapes (2 stages of 4 filters,
12x12x1, 3-way, two buckets, 2 tasks per batch).

* rate 0: every request answered, none past a deadline, the cache-hit
  fraction exactly what the seeded schedule's repeats give under the
  engine's FIFO same-bucket grouping (a repeat is a hit when its
  support set was adapted in an earlier batch), and the BN kernel's
  launches 0 against 0 on the CPU, where the plain version runs;
* the artifact carries every key of the JAX script's (read from its
  source), with the compile keys null;
* a checkpoint the JAX package's ``CheckpointManager`` wrote (a fresh
  init, no training) is served through ``--checkpoint``.
"""

import argparse
import ast
import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.meta.outer import (
    init_train_state as jax_init_train_state)
from howtotrainyourmamlpytorch_tpu.models import make_model as jax_model
from howtotrainyourmamlpytorch_tpu.utils.checkpoint import (
    CheckpointManager as JaxCheckpointManager)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "scripts", "torch_serve_bench.py")
REQUESTS = 16


def _bench_module():
    spec = importlib.util.spec_from_file_location("_torch_serve_bench",
                                                  BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(*args):
    proc = subprocess.run(
        [sys.executable, BENCH, "--quick", "--device", "cpu", *args],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def rate0():
    return _run("--requests", str(REQUESTS))


def _bucket_of(shape):
    # The --quick buckets (3, 4) and (6, 4): the smallest that holds it.
    return min(b for b in ((3, 4), (6, 4))
               if shape[0] <= b[0] and shape[1] <= b[1])


def _expected_hits(requests, batch_tasks):
    """Cache hits of the engine's FIFO grouping over a fully queued
    schedule: the oldest request's bucket heads each batch, which takes
    up to ``batch_tasks`` requests of that bucket in order; a request
    hits when its support set was adapted in an earlier batch."""
    queue = list(range(len(requests)))
    adapted, hits = set(), 0
    root = [r.repeat_of if r.repeat_of is not None else i
            for i, r in enumerate(requests)]
    shapes = [(r.num_support, r.num_query) for r in requests]
    while queue:
        bucket = _bucket_of(shapes[queue[0]])
        group = [i for i in queue if _bucket_of(shapes[i]) == bucket][
            :batch_tasks]
        queue = [i for i in queue if i not in group]
        hits += sum(1 for i in group if root[i] in adapted)
        adapted.update(root[i] for i in group)
    return hits


def test_rate0_serves_every_request_with_the_schedules_hits(rate0):
    art = rate0
    assert art["metric"] == "serve_requests_per_sec"
    assert art["responses"] == art["requests"] == REQUESTS
    assert art["deadline_misses"] == 0 and art["rejected"] == 0
    mod = _bench_module()
    args = argparse.Namespace(config=None, quick=True, deadline_ms=0.0,
                              queue_depth=64)
    cfg = mod.build_config(args)
    requests = mod.build_requests(
        cfg, cfg.serve_bucket_shapes, num_requests=REQUESTS, rate=0.0,
        repeat_frac=0.3, seed=0, start=0.0)
    hits = _expected_hits(requests, cfg.serve_batch_tasks)
    assert hits > 0
    assert art["serve_cache_hit_frac"] == round(hits / REQUESTS, 4)
    kern = art["bn_act_launches"]
    assert kern["launches"] == kern["expected"] == 0 and kern["ok"]
    assert kern["adapt_runs"] >= art["adapt_batches"] > 0


def _jax_artifact_keys():
    """The keys of the JAX script's artifact: its dict literal that
    holds ``"metric"``."""
    src = open(os.path.join(REPO, "scripts", "serve_bench.py")).read()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys
                    if isinstance(k, ast.Constant)}
            if "metric" in keys:
                return keys
    raise AssertionError("no artifact dict in serve_bench.py")


def test_artifact_has_every_jax_key_and_null_compile_counts(rate0):
    want = _jax_artifact_keys()
    assert {"metric", "serve_cache_hit_frac", "compile_count_warmup",
            "alerts_active_final"} <= want
    assert want <= set(rate0)
    assert set(rate0) - want == {"backend", "device", "bn_act_launches"}
    assert rate0["compile_count_warmup"] is None
    assert rate0["compile_count_steady_delta"] is None


def test_serves_a_jax_package_checkpoint(tmp_path):
    """A fresh JAX init saved by the JAX package's CheckpointManager, at
    the bench's --quick config, served by the port's bench."""
    mod = _bench_module()
    cfg = mod.build_config(argparse.Namespace(
        config=None, quick=True, deadline_ms=0.0, queue_depth=64))
    jcfg = JaxConfig.from_dict(cfg.to_dict())
    init, _ = jax_model(jcfg)
    state = jax_init_train_state(jcfg, init, jax.random.PRNGKey(3))
    ckpt = str(tmp_path / "saved_models")
    JaxCheckpointManager(ckpt, max_to_keep=2).save(
        jax.device_get(state), epoch=0, current_iter=1, val_acc=0.5)
    art = _run("--requests", "8", "--checkpoint", ckpt)
    assert art["responses"] == 8 and art["deadline_misses"] == 0
    assert art["total_params"] == sum(
        int(np.asarray(x).size) for x in jax.tree.leaves(state.params))
