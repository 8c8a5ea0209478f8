"""The port's cost database (``telemetry/profiler.py § count_costs``,
``parallel/aot.py § AOTStore.record_cost_card``) against the JAX
package's cost cards, on the CPU.

Held here: the byte rule on functions counted by hand (a matrix product
and an activation; views, ``detach`` and allocations at 0; in-place ops;
a second-order ``autograd.grad``); the FLOPs of ``count_costs`` equal to
``FlopCounterMode`` alone; a counted train step bitwise an uncounted one;
the card's keys against the JAX card's and its memory's against JAX's
compiled-memory keys; the roofline verdict and a window's roofline entry
against JAX's ``roofline_verdict`` and ``attach_roofline``; the store's
card recording (writer only, ``only_if_missing``, merge, fingerprint) and
the adoption primitive's request to count; a CPU trainer run's
``logs/PROFILE.json`` under the peak overrides; the engine's copy of a
store's cards; the port's and the JAX package's perf reports over one
run; the BN kernel's byte rule at S0. The kernel branch's reported bytes
are held on the card (``tests/test_torch_port_cuda.py``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from howtotrainyourmamlpytorch_tpu.telemetry import profiler as jprof
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentBuilder
from howtotrainyourmamlpytorch_tpu_torch.meta import inner, outer
from howtotrainyourmamlpytorch_tpu_torch.models import make_model
from howtotrainyourmamlpytorch_tpu_torch.ops import bn_act
from howtotrainyourmamlpytorch_tpu_torch.parallel import aot
from howtotrainyourmamlpytorch_tpu_torch.serve import ServingEngine
from howtotrainyourmamlpytorch_tpu_torch.telemetry import profiler as prof
from howtotrainyourmamlpytorch_tpu_torch.telemetry.registry import (
    MetricsRegistry)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = 4
H100 = prof.resolve_peaks("NVIDIA H100 80GB HBM3")
TINY = dict(
    dataset_name="synthetic_costcards", image_height=10, image_width=10,
    image_channels=1, num_classes_per_set=3, num_samples_per_class=1,
    num_target_samples=2, batch_size=2, cnn_num_filters=4, num_stages=2,
    number_of_training_steps_per_iter=2,
    number_of_evaluation_steps_per_iter=1, compute_dtype="float32")


def _bytes(fn):
    return prof.count_costs(fn)[1]["bytes_accessed"]


def test_bytes_of_a_matrix_product_and_an_activation():
    x, w = torch.randn(4, 3), torch.randn(3, 5)
    out, costs = prof.count_costs(lambda: torch.relu(x @ w))
    # mm reads x and w and writes (4, 5); relu reads and writes (4, 5).
    assert costs["bytes_accessed"] == (12 + 15 + 20 + 20 + 20) * F32
    assert costs["flops"] == 2 * 4 * 3 * 5
    assert torch.equal(out, torch.relu(x @ w))


def test_views_detach_and_allocations_count_nothing():
    x = torch.randn(6, 4)
    assert _bytes(lambda: (x.view(-1), x.t(), x.detach(), x[1:3],
                           x.reshape(3, 8), x.expand(2, 6, 4))) == 0
    assert _bytes(lambda: (torch.empty(100), torch.empty_like(x),
                           torch.empty_strided((4, 4), (4, 1)),
                           x.new_empty(50))) == 0
    # A copy made by reshape is counted once (clone); its view is not.
    assert _bytes(lambda: x.t().reshape(-1)) == 2 * 24 * F32
    # A *_like factory writes its result and reads no operand.
    assert _bytes(lambda: torch.zeros_like(x)) == 24 * F32


def test_in_place_ops_count_each_operand_once():
    x, y = torch.randn(8), torch.randn(8)
    # add_ reads x and y; its result is x, counted once.
    assert _bytes(lambda: x.add_(y)) == 2 * 8 * F32
    # copy_ writes x and reads y; zero_ writes x.
    assert _bytes(lambda: x.copy_(y)) == 2 * 8 * F32
    assert _bytes(lambda: x.zero_()) == 8 * F32
    # A broadcast operand (stride 0) holds one element.
    one = torch.ones(1).expand(8)
    assert _bytes(lambda: x.mul_(one)) == (8 + 1) * F32


def test_second_order_grad_counts_its_create_graph_ops():
    """y = sum(x*x); g = dy/dx with create_graph; h = d(sum g)/dx. Ops as
    they reach the dispatcher, N = the 8 floats of x, b = one float:
    forward mul(x, x) 2N (x once), sum N + b; first backward ones_like b,
    expand 0, two mul(ones[expanded], x) b + 2N each, add 3N; second
    backward sum(g) N + b, ones_like b, expand 0, two mul(ones, ones)
    (both broadcast) 2b + N each, add 3N."""
    x = torch.arange(1.0, 9.0).requires_grad_(True)

    def second_order():
        (g,) = torch.autograd.grad((x * x).sum(), x, create_graph=True)
        return torch.autograd.grad(g.sum(), x)[0]

    n, b = 8 * F32, F32
    first = 2 * n + (n + b) + b + 2 * (b + 2 * n) + 3 * n
    second = (n + b) + b + 2 * (2 * b + n) + 3 * n
    h, costs = prof.count_costs(second_order)
    assert costs["bytes_accessed"] == first + second == 16 * n + 10 * b
    assert torch.equal(h, torch.full((8,), 2.0))


def test_count_costs_flops_equal_the_flop_counter_alone():
    # Functional, as the port's models are (FlopCounterMode's module
    # hooks refuse autograd.grad through an nn.Module).
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(8, 3, 3, 3, generator=gen, requires_grad=True)
    v = torch.randn(5, 8 * 6 * 6, generator=gen)
    x = torch.randn(2, 3, 8, 8, generator=gen, requires_grad=True)

    def step():
        h = torch.relu(torch.nn.functional.conv2d(x, w)).flatten(1)
        y = torch.nn.functional.linear(h, v).square().sum()
        (g,) = torch.autograd.grad(y, x, create_graph=True)
        return torch.autograd.grad(g.square().sum(), w)[0]

    mode = FlopCounterMode(display=False)
    with mode:
        want = step()
    got, costs = prof.count_costs(step)
    assert costs["flops"] == float(mode.get_total_flops()) > 0
    assert costs["bytes_accessed"] > 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("second_order", [False, True])
def test_counted_train_step_is_bitwise_the_uncounted_one(second_order):
    """A tiny port train step (second order: create_graph through the
    inner loop) counted and uncounted: bitwise the same state and
    metrics, and the FLOPs ``FlopCounterMode`` counts alone."""
    cfg = MAMLConfig(**TINY)
    init, apply = make_model(cfg)
    state = outer.init_train_state(cfg, init, seed=3, device="cpu")
    rng = np.random.default_rng(4)
    n, k, q = 3, 1, 2
    batch = inner.Episode(
        torch.from_numpy(rng.integers(0, 256, (2, n * k, 10, 10, 1),
                                      dtype=np.uint8)),
        torch.from_numpy(np.tile(np.arange(n, dtype=np.int32), (2, 1))),
        torch.from_numpy(rng.integers(0, 256, (2, n * q, 10, 10, 1),
                                      dtype=np.uint8)),
        torch.from_numpy(np.tile(np.repeat(np.arange(n, dtype=np.int32),
                                           q), (2, 1))))
    step = outer.make_train_step(cfg, apply)

    def run():
        return step(state, batch, 0, second_order=second_order,
                    use_msl=True)

    want, wm = run()
    (got, gm), costs = prof.count_costs(run)
    assert costs["flops"] == prof.count_flops(run)[1] > 0
    assert costs["bytes_accessed"] > 0
    wl, _ = aot.flatten((want, wm.loss, wm.accuracy))
    gl, _ = aot.flatten((got, gm.loss, gm.accuracy))
    assert len(wl) == len(gl)
    assert all(torch.equal(a, b) for a, b in zip(wl, gl))


def test_a_failed_count_reruns_uncounted_and_says_so(monkeypatch):
    calls = []

    def step():
        calls.append(1)
        return torch.ones(3) * 2

    out, costs = prof.counted(step)
    assert costs["flops_source"] == "flop_counter_mode" and len(calls) == 1

    def broken(fn):
        fn()
        raise RuntimeError("no formula")

    monkeypatch.setattr(prof, "count_costs", broken)
    out, costs = prof.counted(step)
    assert torch.equal(out, torch.full((3,), 2.0)) and len(calls) == 3
    assert costs == {"flops": 0.0, "bytes_accessed": 0.0,
                     "flops_source": "unavailable",
                     "error": "RuntimeError: no formula"}
    card = prof.card_from_costs("eval", costs, kind="H100", peaks=H100)
    assert card["bound"] == "unknown"
    assert card["count_error"] == "RuntimeError: no formula"


class _Compiled:
    """What ``memory_analysis`` of a JAX executable returns, every field."""

    def memory_analysis(self):
        class MA:
            generated_code_size_in_bytes = 1
            argument_size_in_bytes = 2
            output_size_in_bytes = 3
            temp_size_in_bytes = 4
            alias_size_in_bytes = 5
        return MA()


def test_card_keys_cover_the_jax_cards():
    memory = aot.graph_memory(
        [torch.zeros(4), torch.zeros(2, 3)],
        [torch.zeros(5)], {}, pool_bytes=100)
    card = prof.build_cost_card("eval", flops=2e9, bytes_accessed=1e8,
                                kind="NVIDIA H100 80GB HBM3", peaks=H100,
                                memory=memory, fingerprint="ab" * 8)
    jcard = jprof.build_cost_card(
        "eval", flops_info={"flops": 2e9, "source": "hlo"},
        bytes_accessed=1e8, memory=None, fingerprint=None,
        device_kind="H100", peaks=H100)
    assert set(card) >= set(jcard)
    assert set(memory) <= set(jprof._compiled_memory(_Compiled()))
    assert memory == {"argument_size_in_bytes": 40,
                      "output_size_in_bytes": 20,
                      "temp_size_in_bytes": 80, "alias_size_in_bytes": 0,
                      "peak_bytes": 140}
    assert card["bound"] == "memory" and card["arithmetic_intensity"] == 20.0


def test_graph_memory_counts_carried_outputs_as_alias():
    """A train graph's outputs are its static state (carried, not in the
    pool) and fresh metrics (in the pool)."""
    state, batch = torch.zeros(10), torch.zeros(6)
    loss = torch.zeros(1)
    mem = aot.graph_memory([state, batch], [state, loss], {0: 0},
                           pool_bytes=64)
    assert mem == {"argument_size_in_bytes": 64,
                   "output_size_in_bytes": 44, "alias_size_in_bytes": 40,
                   "temp_size_in_bytes": 60, "peak_bytes": 168}
    # A pool smaller than its fresh outputs leaves no temporaries.
    assert aot.graph_memory([batch], [loss], {}, 0)["temp_size_in_bytes"] \
        == 0


@pytest.mark.parametrize("flops, nbytes", [
    (1e12, 1e9), (5e12, 1e10), (4e12, 1e10), (1e9, 1e9), (0.0, 1e9),
    (1e12, 0.0)])
def test_roofline_and_window_entry_match_jax(flops, nbytes):
    assert prof.roofline_verdict(flops, nbytes, 989e12, 3.35e12) == \
        jprof.roofline_verdict(flops, nbytes, 989e12, 3.35e12)
    card = prof.build_cost_card("train_so1_msl0", flops=flops,
                                bytes_accessed=nbytes, kind="H100",
                                peaks=H100)
    # Two kernels end to end: the union of their spans is their sum, the
    # JAX window's per-executable seconds.
    ms = 1_000_000
    row = prof.summarize_records(
        [("conv", 0, 3 * ms, 0), ("bn_act_persistent", 3 * ms, 5 * ms, 0)],
        [], (0, 10 * ms), 0.0)
    prof.attach_card(row, "train_so1_msl0", card, H100)
    want = jprof.attach_roofline(
        {"per_executable_seconds": dict(row["per_executable_seconds"])},
        {"train_so1_msl0": card})["roofline"]
    assert row["roofline"].keys() == want.keys()
    for name, entry in want.items():
        assert row["roofline"][name].keys() == entry.keys()
        for key, value in entry.items():
            assert row["roofline"][name][key] == pytest.approx(value)
    if card["bound"] != "unknown":
        entry = row["roofline"]["train_so1_msl0"]
        assert entry["frac_of_ceiling"] == pytest.approx(
            flops / 0.005 / card["ceiling_flops_per_s"])


FP = "c0ffee" * 10 + "abcd"


def _card(name, flops=1e9):
    return prof.build_cost_card(name, flops=flops, bytes_accessed=1e7,
                                kind="H100", peaks=H100)


def test_record_cost_card_writer_only_merge_and_fingerprint(tmp_path):
    root = str(tmp_path / "store")
    store = aot.AOTStore(root, FP)
    assert store.profile_path() == os.path.join(store.dir, "PROFILE.json")
    assert store.cost_card("eval") is None
    assert store.record_cost_card("eval", _card("x", 1e9))
    assert store.record_cost_card("train_so0_msl0", _card("y", 2e9))
    doc = prof.load_profile(store.profile_path())
    assert set(doc["cards"]) == {"eval", "train_so0_msl0"}
    assert doc["fingerprint"] == FP
    assert all(c["fingerprint"] == FP[:16] for c in doc["cards"].values())
    assert doc["cards"]["eval"]["name"] == "eval"
    # only_if_missing keeps the card there; without it the newest wins.
    assert store.record_cost_card("eval", _card("eval", 7e9),
                                  only_if_missing=True)
    assert store.cost_card("eval")["flops"] == 1e9
    assert store.record_cost_card("eval", _card("eval", 7e9))
    assert store.cost_card("eval")["flops"] == 7e9
    assert store.cost_card("train_so0_msl0")["flops"] == 2e9
    # A reader records nothing; it reads the writer's cards.
    reader = aot.AOTStore(root, FP, writer=False)
    assert not reader.records_cards()
    assert not reader.record_cost_card("serve_adapt_s5", _card("z"))
    assert reader.cost_card("serve_adapt_s5") is None
    assert reader.cost_card("eval")["flops"] == 7e9
    # The JAX package's reader takes the store's PROFILE.json.
    assert set(jprof.load_profile(store.profile_path())["cards"]) == {
        "eval", "train_so0_msl0"}


class _Exec:
    """A capture's executable: counts its 'warm-up' when asked."""

    def __init__(self, error=None):
        self.asked = aot._COUNT_CAPTURE.get()
        self.costs = None
        if self.asked:
            self.costs = ({"flops": 0.0, "bytes_accessed": 0.0,
                           "flops_source": "unavailable", "error": error}
                          if error else
                          {"flops": 3e9, "bytes_accessed": 2e8,
                           "flops_source": "flop_counter_mode",
                           "memory": prof.memory_stats(10, 20, 30)})

    def record(self):
        return {"launches": 0, "graphs": []}

    def __call__(self, x):
        return x


def test_load_or_compile_counts_a_capture_only_without_a_card(tmp_path):
    sig = [[[2], "float32"]]
    reg = MetricsRegistry()
    store = aot.AOTStore(str(tmp_path), FP, registry=reg)
    made = []

    def capture():
        made.append(_Exec())
        return made[-1]

    _, hit = aot.load_or_compile(store, "eval", capture, sig, registry=reg)
    assert not hit and made[-1].asked
    card = store.cost_card("eval")
    assert (card["flops"], card["bytes_accessed"]) == (3e9, 2e8)
    assert card["memory"]["peak_bytes"] == 60
    assert card["fingerprint"] == FP[:16]
    assert card["bound"] in ("compute", "memory") or \
        card["device_kind"] == "cpu"
    # A hit with its card counts nothing.
    _, hit = aot.load_or_compile(store, "eval", capture, sig, registry=reg)
    assert hit and not made[-1].asked and not aot._COUNT_CAPTURE.get()
    # A hit whose card is missing counts and back-fills it.
    os.remove(store.profile_path())
    _, hit = aot.load_or_compile(store, "eval", capture, sig, registry=reg)
    assert hit and made[-1].asked and store.cost_card("eval") is not None
    # A store that does not write cards asks for no count.
    reader = aot.AOTStore(str(tmp_path), FP, writer=False)
    aot.load_or_compile(reader, "train_so0_msl0", capture, sig)
    assert not made[-1].asked
    # A count that failed: flops_source unavailable, one perf/errors.
    aot.load_or_compile(store, "serve_predict_q4",
                        lambda: _Exec(error="RuntimeError: boom"), sig,
                        registry=reg)
    bad = store.cost_card("serve_predict_q4")
    assert bad["flops_source"] == "unavailable" and bad["bound"] == "unknown"
    assert bad["count_error"] == "RuntimeError: boom"
    assert reg.counter(prof.ERRORS_COUNTER).value == 1


def test_byte_sinks_add_only_inside_an_active_counter():
    counter = prof.CostCounter()
    counter.add(100)   # not active: ignored
    assert counter.bytes == 0

    def launch_like():
        for sink in bn_act.byte_sinks:
            sink(bn_act.bn_act_bytes(10, 4, 2))

    _, costs = prof.count_costs(launch_like)
    assert costs["bytes_accessed"] == 2 * 10 * 4 * 2 + 16 * 4
    assert bn_act.byte_sinks == []
    # On the CPU the plain version's ops are counted by the mode.
    x = torch.randn(12, 4)
    g, b = torch.ones(4), torch.zeros(4)
    assert _bytes(lambda: bn_act.bn_act(x, g, b)) > bn_act.bn_act_bytes(
        12, 4, 4)


def test_bn_act_bytes_reproduce_the_s0_bound():
    """PERF.md's bound of the BN kernel at S0 (176400 x 384, bf16):
    2·R·P·2 B over 3.35 TB/s, 0.0809 ms; gamma, beta, mean and var add
    16·P bytes."""
    nbytes = bn_act.bn_act_bytes(176400, 384, 2)
    assert nbytes == 2 * 176400 * 384 * 2 + 16 * 384
    assert round(nbytes / 3.35e12 * 1e3, 4) == 0.0809
    assert round(2 * 176400 * 384 * 2 / 3.35e12 * 1e3, 4) == 0.0809


@pytest.fixture(scope="module")
def profiled_run(tmp_path_factory):
    """A CPU trainer run with the sampler on every step and measured-peak
    overrides (the JAX package's ``profiled_run`` fixture, minus the
    store, which needs the card)."""
    root = tmp_path_factory.mktemp("costcards")
    mp = pytest.MonkeyPatch()
    mp.setenv(prof.PEAK_FLOPS_ENV, "1e12")
    mp.setenv(prof.HBM_GBPS_ENV, "100")
    try:
        builder = ExperimentBuilder(MAMLConfig(
            experiment_root=str(root), experiment_name="cards",
            total_epochs=1, total_iter_per_epoch=3, num_evaluation_tasks=2,
            max_models_to_save=1, dispatch_sync_every=1,
            profile_every_n_steps=1, second_order=True,
            first_order_to_second_order_epoch=-1, **TINY), device="cpu")
        builder.run_experiment()
    finally:
        mp.undo()
    return builder


def test_trainer_profile_json_carries_bytes_and_a_verdict(profiled_run):
    b = profiled_run
    doc = prof.load_profile(os.path.join(b.paths["logs"], "PROFILE.json"))
    assert doc is not None and doc["peak_flops_source"] == "override"
    (name,) = [n for n in doc["cards"] if n.startswith("train_so1")]
    card = doc["cards"][name]
    assert card["flops"] > 0 and card["bytes_accessed"] > 0
    assert card["bound"] in ("compute", "memory")
    assert card["ridge_flops_per_byte"] == 10.0
    assert card["ceiling_flops_per_s"] > 0
    assert card["flops_source"] == "flop_counter_mode"
    # On the CPU the temporaries are not measured.
    mem = card["memory"]
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "peak_bytes"}
    assert mem["peak_bytes"] == (mem["argument_size_in_bytes"]
                                 + mem["output_size_in_bytes"]) > 0
    rows = [json.loads(line) for line in open(
        os.path.join(b.paths["logs"], "events.jsonl"))]
    perf = [r for r in rows if r.get("event") == "perf_profile"]
    assert perf
    for r in perf:
        entry = r["roofline"][name]
        assert entry["bound"] == card["bound"]
        assert entry["ceiling_flops_per_s"] == card["ceiling_flops_per_s"]
        assert entry["frac_of_ceiling"] == pytest.approx(
            entry["achieved_flops_per_s"] / card["ceiling_flops_per_s"])


def _report(script, path):
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                        script), path],
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stdout


def test_perf_reports_agree_over_a_run_with_bytes(profiled_run):
    logs = profiled_run.paths["logs"]
    ours, table = _report("torch_perf_report.py", logs)
    ref, _ = _report("perf_report.py", logs)
    assert ours == ref
    assert ours["top_executable"].startswith("train_so1")
    assert ours["top_executable_bound"] in ("compute", "memory")
    assert "no roofline verdict" not in table and "no peak" not in table
    row = [ln for ln in table.splitlines()
           if ln.strip().startswith("train_so1")][0]
    assert row.rstrip().endswith("%")   # the fraction of the ceiling


def test_engine_copies_the_stores_cards(tmp_path):
    cfg = MAMLConfig(experiment_root=str(tmp_path), experiment_name="srv",
                     serve_buckets=((3, 6),), serve_batch_tasks=2, **TINY)
    init, _ = make_model(cfg)
    state = outer.init_train_state(cfg, init, seed=0, device="cpu")
    with ServingEngine(cfg, state, device="cpu") as eng:
        assert eng.write_profile_json() is None   # the store is off
        store = aot.AOTStore(str(tmp_path / "store"), FP)
        eng._aot_store = store
        assert eng.write_profile_json() is None   # no cards yet
        for name in ("serve_adapt_s3", "serve_predict_q6"):
            store.record_cost_card(name, _card(name))
        path = eng.write_profile_json()
        eng._aot_store = None
    assert path == os.path.join(str(tmp_path), "srv", "logs",
                                "PROFILE.json")
    doc = prof.load_profile(path)
    assert doc["cards"] == prof.load_profile(store.profile_path())["cards"]
    assert doc["fingerprint"] == FP
    assert jprof.load_profile(path) is not None
