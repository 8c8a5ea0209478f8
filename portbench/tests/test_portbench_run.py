"""A whole run on the CPU at a tiny size, past the harness's look for a
card: the result line's shape, the import guard, and ``correct`` coming
out false when the timed path is broken underneath (a state left
unchanged, half of the batch left out, an answer altered where it is
produced) and when the fp8 control stands in the program's place.

The tiny cells (16x16 images, 8 filters, 2 VGG stages, 4 tasks in 2
chunks) compare the numbers their limits name; the limits here were set
from CPU readings at this size (sound program: ``loss1_gap`` at most
2.2e-4, ``grad_median_gap`` 4.5e-3; the fp8 control's ``loss1_gap`` at
least 2.3e-3, half a batch's ``grad_median_gap`` at least 0.07, a state
left unchanged 1 on ``change_median_gap``), not the cells' own limits,
which are set from the card at the cells' sizes.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import run as bench_run
from portbench.drivers import train_step as tdrv
from portbench.lib import compare, episodes, port, weights
from portbench.lib.spec import PKG_DIR, REPO_DIR, Bench
from portbench.reference import maml
from portbench.reference.model import Numerics, hyper

TRAIN_LIMITS = {"loss1_gap": 1e-3, "grad_median_gap": 0.03,
                "change_median_gap": 0.5}
SERVE_LIMITS = {"logit_gap": 0.1}
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("tinybench")
    for d in ("drivers", "metrics", "traffic", "workloads", "configs"):
        shutil.copytree(os.path.join(PKG_DIR, d), root / d)
    path = root / "configs" / "vgg_flagship.json"
    doc = json.loads(path.read_text())
    doc["maml_config"].update(image_height=16, image_width=16, num_stages=2,
                              cnn_num_filters=8, batch_size=4,
                              task_microbatches=2)
    path.write_text(json.dumps(doc))
    path = root / "traffic" / "serve_new_tenants_vgg.json"
    traffic = json.loads(path.read_text())
    traffic.update(rate_per_s=20, image_pool=256, warm_requests=8,
                   sample_requests=6)
    traffic["engine"]["watchdog_serve_timeout_s"] = 0
    path.write_text(json.dumps(traffic))
    for cell, limits in (("vgg_flagship.train", TRAIN_LIMITS),
                         ("vgg_flagship.serve", SERVE_LIMITS)):
        path = root / "workloads" / f"{cell}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()),
                                    "limits": limits}))
    shutil.copy(os.path.join(REPO_DIR, "BENCHMARK.json"), root)
    return Bench(str(root), str(root / "BENCHMARK.json")), str(root)


def _run(tiny, cell, seed=1):
    bench, root = tiny
    return bench_run.run(cell, seed, 0.5, False, CPU, bench,
                         program_overrides={},
                         cache_dir=os.path.join(root, "cache"))


def test_a_sound_train_run_is_correct_and_well_formed(tiny):
    line = _run(tiny, "vgg_flagship.train")
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(TRAIN_LIMITS)
    assert {"setup_s", "train_tasks_per_s", "peak_gib"} == set(
        line["metrics"])
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}


def test_a_sound_serve_run_is_correct(tiny):
    line = _run(tiny, "vgg_flagship.serve")
    assert line["correct"] is True, line["checks"]
    assert {"setup_s", "serve_p95_ms", "serve_tasks_per_s",
            "peak_gib"} == set(line["metrics"])
    assert line["failed"] == 0 and line["attempted"] == 10


def _broken_step(monkeypatch, wrap):
    real = port.train_step

    def train_step(cfg, state, batch, epoch, device):
        step, phase = real(cfg, state, batch, epoch, device)
        return wrap(step), phase
    monkeypatch.setattr(port, "train_step", train_step)


def test_a_step_that_returns_its_state_unchanged_is_not_correct(
        tiny, monkeypatch):
    def wrap(step):
        return lambda state, batch: (state, step(state, batch)[1])
    _broken_step(monkeypatch, wrap)
    line = _run(tiny, "vgg_flagship.train")
    assert line["correct"] is False
    assert line["checks"]["change_median_gap"]["value"] > 0.9


def test_half_of_the_batch_left_out_is_not_correct(tiny, monkeypatch):
    def wrap(step):
        return lambda state, batch: step(state, type(batch)(
            *(f[:f.shape[0] // 2] for f in batch)))
    _broken_step(monkeypatch, wrap)
    line = _run(tiny, "vgg_flagship.train")
    assert line["correct"] is False
    assert line["checks"]["grad_median_gap"]["value"] > 0.03


def test_an_answer_altered_where_it_is_produced_is_not_correct(
        tiny, monkeypatch):
    real = port.serving_engine

    def serving_engine(*args, **kwargs):
        engine = real(*args, **kwargs)
        predict = engine._run_predict

        def altered(*a, **k):
            logits = predict(*a, **k)
            logits[0] = logits[0, :, ::-1]   # one task's classes reversed
            return logits
        engine._run_predict = altered
        return engine
    monkeypatch.setattr(port, "serving_engine", serving_engine)
    line = _run(tiny, "vgg_flagship.serve")
    assert line["correct"] is False


def test_serve_latency_is_read_on_the_benchmarks_own_clock():
    """An engine whose own timings say 0 s: the open loop still charges
    each request the time until ``step`` handed back its answer."""
    from types import SimpleNamespace

    from portbench.drivers import serve_open_loop as sdrv

    class Engine:
        def __init__(self):
            self.queue = []

        def submit(self, req):
            self.queue.append(req)

        def step(self):
            if not self.queue:
                return []
            time.sleep(0.05)
            out = [SimpleNamespace(request_id=r.request_id, status="ok",
                                   logits=np.zeros((1, 5)),
                                   latency_seconds=0.0)
                   for r in self.queue]
            self.queue = []
            return out

    class Requests:
        def make(self, i, arrival):
            return SimpleNamespace(request_id=i)

    res = sdrv.open_loop(Engine(), Requests(), 0, np.array([0.0, 0.01]),
                         5.0)
    lat = sdrv.latencies(res)
    assert res["ok"].all() and (lat >= 0.04).all(), lat


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_fp8_control_in_the_programs_place_is_not_correct(tiny, seed):
    """The reference in fp8 (e4m3 operands, e5m2 gradients) against the
    float32 reference, numbered as a run numbers the program."""
    bench, _ = tiny
    hp = hyper(bench.config("vgg_flagship")["maml_config"])
    params, lslr, bn = weights.make(hp, weights.sub_seed(seed, 1), CPU)
    pool = episodes.train_pool(hp.image_shape, 5, 5, 5, 4, 3,
                               weights.sub_seed(seed, 2), CPU)
    ref, low = (tdrv.reference_steps(hp, params, lslr, bn, pool,
                                     (True, False), 99, Numerics(fp8=fp8))
                for fp8 in (False, True))
    got = tdrv.numbers_against(ref, {"params": params, "lslr": lslr,
                                     "bn_state": bn}, *low)
    assert any(got[k] > limit for k, limit in TRAIN_LIMITS.items()), got


def test_the_fp8_control_answering_requests_is_not_correct(tiny):
    bench, _ = tiny
    hp = hyper(bench.config("vgg_flagship")["maml_config"])
    params, lslr, _ = weights.make(hp, 5, CPU)
    pool = episodes.image_pool(hp.image_shape, 128, 6, CPU)
    plan = episodes.request_plan(128, 50, 6, 7)
    sy = torch.from_numpy((np.arange(25) % 5).astype(np.int32))
    pairs = []
    for i in range(6):
        sx, qx = (torch.from_numpy(pool[plan[i, :25]]),
                  torch.from_numpy(pool[plan[i, 25:]]))
        pairs.append((maml.adapt_predict(hp, params, lslr, sx, sy, qx,
                                         Numerics(fp8=True)),
                      maml.adapt_predict(hp, params, lslr, sx, sy, qx,
                                         Numerics())))
    got = compare.serve_numbers(pairs)
    assert got["logit_gap"] > SERVE_LIMITS["logit_gap"], got


def test_the_import_guard_compares_whole_top_level_names(monkeypatch):
    assert bench_run.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "howtotrainyourmamlpytorch_tpu_torch",
                        sys.modules.get("howtotrainyourmamlpytorch_tpu_torch",
                                        object()))
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    assert "howtotrainyourmamlpytorch_tpu_torch" not in \
        bench_run.forbidden_modules()
    assert "jaxtyping_like" not in bench_run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.linen", object())
    assert "flax" in bench_run.forbidden_modules()


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny, tmp_path):
    """A tiny CPU run in a fresh interpreter, then the guard's look."""
    bench, root = tiny
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {REPO_DIR!r})\n"
        "from portbench import run as r\n"
        "from portbench.lib.spec import Bench\n"
        f"b = Bench({root!r}, {os.path.join(root, 'BENCHMARK.json')!r})\n"
        "r.run('vgg_flagship.train', 3, 0.2, False, torch.device('cpu'), "
        f"b, program_overrides={{}}, cache_dir={str(tmp_path)!r})\n"
        "print(r.forbidden_modules())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_command_prints_nothing_and_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "vgg_flagship.train", "--seed", "1", "--seconds", "1"],
        cwd=REPO_DIR, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
