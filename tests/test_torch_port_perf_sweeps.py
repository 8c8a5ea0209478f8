"""The port's six perf sweeps (``scripts/torch_perf_*.py``) on the CPU.

* Each grid builds, point for point and field for field, the configs the
  JAX script builds (captured by stubbing its timer or model builder),
  with the JAX grid's two ``unroll=5`` points the only ones missing; the
  microbatch sweep's ``divisors`` equal the JAX script's.
* The eval sweep makes ceil(episodes / batch) batches of ``bench.py``'s
  synthetic episodes, as ``perf_eval.py`` does.
* Each script's ``--quick --device cpu`` run over one point prints rows
  with the JAX keys and a ``graph`` object that says the graph leg did
  not run (``aot.require_card`` refuses it on the CPU).
* A point whose timer raises is an ``error`` row and the sweep goes on;
  without ``--device cpu`` and without a card each script raises.
"""

import importlib.util
import json
import math
import os
import sys

import jax
import numpy as np
import pytest

from howtotrainyourmamlpytorch_tpu_torch.tune import points

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the quick runs are tiny, and beside other test
    workers more threads only oversubscribe the cores (ten times slower
    or worse)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Captured(Exception):
    pass


def _capturing(store):
    def capture(cfg, *args, **kwargs):
        store.append(cfg)
        raise _Captured()
    return capture


def _dicts(cfgs):
    return [c.to_dict() for c in cfgs]


def test_variants_grid(monkeypatch):
    ref, ours = _load("perf_variants"), _load("torch_perf_variants")
    seen = []
    monkeypatch.setattr(ref, "run_variant",
                        lambda cfg, steps: seen.append(cfg) or 1.0)
    monkeypatch.setattr(sys, "argv", ["perf_variants.py"])
    ref.main()
    assert _dicts(p["cfg"] for p in ours.grid(16)) == _dicts(seen)


def test_sweep_grid_drops_only_the_unroll_points(monkeypatch):
    ref, ours = _load("perf_sweep"), _load("torch_perf_sweep")
    seen = []
    monkeypatch.setattr(ref, "make_model", _capturing(seen))
    monkeypatch.setattr(sys, "argv", ["perf_sweep.py"])
    ref.main()
    want = [c for c in seen if c.inner_unroll == 1]
    assert len(seen) - len(want) == 2
    grid = ours.grid(len(jax.devices()))
    assert _dicts(p["cfg"] for p in grid) == _dicts(want)
    assert [(p["batch_per_chip"] * len(jax.devices()), p["remat"],
             p["policy"]) for p in grid] == [
        (c.batch_size, c.remat_inner_steps, c.remat_policy) for c in want]


def test_msl_grid(monkeypatch):
    ref, ours = _load("perf_msl"), _load("torch_perf_msl")
    seen = []
    monkeypatch.setattr(ref, "time_step",
                        lambda cfg, msl, steps: seen.append((cfg, msl)) or 1.)
    monkeypatch.setattr(sys, "argv", ["perf_msl.py"])
    ref.main()
    grid = ours.grid(12)
    assert _dicts(p["cfg"] for p in grid) == _dicts(c for c, _ in seen)
    assert [p["msl"] for p in grid] == [m for _, m in seen]


def test_eval_grid_and_batches(monkeypatch):
    ref, ours = _load("perf_eval"), _load("torch_perf_eval")
    import bench
    seen = []
    monkeypatch.setattr(bench, "init_backend", lambda *a, **k: None)
    monkeypatch.setattr(
        ref, "sweep_time",
        lambda cfg, eb, episodes: seen.append(
            (cfg.replace(eval_batch_size=eb), episodes)) or 1.0)
    monkeypatch.setattr(sys, "argv", ["perf_eval.py"])
    ref.main()
    grid = ours.grid()
    assert _dicts(p["cfg"] for p in grid) == _dicts(c for c, _ in seen)
    cfg = grid[0]["cfg"]
    tiny = cfg.replace(image_height=4, image_width=4)
    for eb in (12, 24, 200):
        batches = points.eval_batches(tiny, eb, 600)
        assert len(batches) == math.ceil(600 / eb)
        assert {b.support_x.shape[0] for b in batches} == {eb}
    want = bench.synthetic_batch(cfg.replace(batch_size=24), 1)
    for got, exp in zip(points.eval_batches(cfg, 24, 48)[1], want):
        np.testing.assert_array_equal(got, exp)


def test_microbatch_grid_and_divisors(monkeypatch):
    ref = _load("perf_microbatch_sweep")
    ours = _load("torch_perf_microbatch_sweep")
    assert ours.DEFAULT_TARGETS == ref.DEFAULT_TARGETS
    for n in range(1, 33):
        for cap in (1, 4, 16):
            assert ours.divisors(n, cap) == ref.divisors(n, cap)
    seen = []
    monkeypatch.setattr(ref, "init_backend", lambda timeout: [None])
    monkeypatch.setattr(ref, "build_steady_state", _capturing(seen))
    monkeypatch.setattr(sys, "argv", ["perf_microbatch_sweep.py"])
    assert ref.main() == 1          # every point "failed": no rows
    cfgs = [p["cfg"] for name in ours.DEFAULT_TARGETS
            for p in ours.grid(name, 16)[1]]
    assert len(cfgs) == 29
    assert _dicts(cfgs) == _dicts(seen)


def test_resnet12_phases(monkeypatch):
    ref = _load("perf_resnet12_sweep")
    ours = _load("torch_perf_resnet12_sweep")
    n_dev = len(jax.devices())
    for phase in ours.PHASES:
        seen = []
        monkeypatch.setattr(ref, "make_model", _capturing(seen))
        monkeypatch.setattr(sys, "argv", ["perf_resnet12_sweep.py",
                                          "--phase", phase])
        ref.main()
        grid = ours.grid(phase, n_dev)
        assert _dicts(p["cfg"] for p in grid) == _dicts(seen), phase


def _rows(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


QUICK = [
    ("torch_perf_variants", ["--points", "block_outs_fm1"],
     {"bn_fast_math", "remat_policy", "tasks_per_sec_per_chip"}),
    ("torch_perf_sweep", ["--points", "b16_remat_dots"],
     {"batch_per_chip", "remat", "policy", "unroll",
      "tasks_per_sec_per_chip"}),
    ("torch_perf_msl", ["--points", "msl_batched_out_of_scan"],
     {"variant", "tasks_per_sec_per_chip"}),
    ("torch_perf_eval", ["--points", "eb24", "--episodes", "48"],
     {"eval_batch", "sweep_seconds", "speedup_vs_train_batch"}),
    ("torch_perf_microbatch_sweep",
     ["--configs", "omniglot_maml++_5-way_5-shot.json", "--points", "mb4"],
     {"config", "mb", "tasks_per_sec_per_chip"}),
    ("torch_perf_resnet12_sweep", ["--phase", "batch", "--points", "b1"],
     {"variant", "batch_size", "task_microbatches", "bn_fast_math",
      "tasks_per_sec_per_chip", "warmup_s"}),
]


@pytest.mark.parametrize("name,argv,keys", QUICK, ids=[q[0] for q in QUICK])
def test_quick_point_rows(name, argv, keys, capsys):
    steps = [] if name == "torch_perf_eval" else ["--steps", "1"]
    assert _load(name).main(argv + steps + ["--quick", "--device",
                                            "cpu"]) == 0
    rows = _rows(capsys)
    measured = [r for r in rows if "point" in r]
    assert len(measured) == 1, rows
    row = measured[0]
    assert "error" not in row, row
    assert keys | {"step_ms", "bn_launches", "peak_memory_bytes",
                   "device_kind", "graph"} <= set(row), row
    assert row["device_kind"] == "cpu" and row["bn_launches"] == 0
    assert row["graph"]["ran"] is False
    assert "aot_store_dir" in row["graph"]["reason"]
    if name == "torch_perf_microbatch_sweep":
        verdict, summary = rows[1], rows[2]
        assert {"config", "per_chip_batch", "shipped_mb", "rows",
                "best_mb", "best_rate", "shipped_rate",
                "gain_vs_shipped"} <= set(verdict)
        assert verdict["shipped_mb"] == 4 and verdict["best_mb"] == 4
        assert summary == {"summary": {
            "omniglot_maml++_5-way_5-shot.json": 4}}


def test_a_failing_point_is_an_error_row(monkeypatch, capsys):
    ours = _load("torch_perf_variants")
    calls = []

    def timer(cfg, device, steps, **kw):
        calls.append(cfg.bn_fast_math)
        if len(calls) == 1:
            raise FloatingPointError("non-finite loss nan")
        return {"tasks_per_sec_per_chip": 1.0, "step_ms": 1.0}

    monkeypatch.setattr(points, "time_train", timer)
    assert ours.main(["--points", "nothing_fm0,nothing_fm1", "--device",
                      "cpu"]) == 0
    rows = _rows(capsys)
    assert rows[0]["point"] == "nothing_fm0"
    assert rows[0]["error"] == "FloatingPointError: non-finite loss nan"
    assert rows[1]["point"] == "nothing_fm1" and "error" not in rows[1]
    assert rows[1]["tasks_per_sec_per_chip"] == 1.0
    assert calls == [False, True]


@pytest.mark.parametrize("name", [q[0] for q in QUICK])
def test_without_a_card_each_script_raises(name):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main([])
