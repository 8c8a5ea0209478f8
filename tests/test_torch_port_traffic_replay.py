"""``scripts/torch_traffic_replay.py`` on the CPU.

* Its pure functions against the JAX script's on the same seeds and
  inputs (the JAX script loads no jax at import, so it is imported by
  path here): ``build_trace`` record for record, ``build_requests``
  array for array, ``phase_plan``, and ``operating_point`` on
  calibrations where its floors and caps bind and where none does.
* One short ``--quick --device cpu`` replay (a 12 s trace, the quick
  serving profile, replicas of one intra-op thread each): the three
  legs ran, none dropped or failed a request, continuous batching
  grouped in the cb legs only, the weighted rollout reached DONE, every
  replica's BN-kernel accounting held (0 launches against 0 on the
  CPU), and the artifact carries the schema keys. The strict p95 gate
  (cb < fixed) and the autoscale's scale-up depend on how this box
  serves against the calibrated rates; the slow test asserts the whole
  verdict on a run of its own at a heavier profile.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from helpers import _can_bind_localhost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
REPLAY = os.path.join(SCRIPTS, "torch_traffic_replay.py")
IMAGE, BUCKET, TENANTS = (12, 12, 1), (3, 4), 96

needs_sockets = pytest.mark.skipif(
    not _can_bind_localhost(),
    reason="the replay drives real replicas over localhost sockets")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_replay_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return {"jax": _load("traffic_replay"),
            "port": _load("torch_traffic_replay")}


def _trace(mod, seed):
    return mod.build_trace(duration_s=24.0, base_rate=4.0, peak_rate=40.0,
                           num_tenants=TENANTS, active_tenants=16,
                           churn_every_s=1.0, bucket=BUCKET, seed=seed)


@pytest.mark.parametrize("seed", [0, 7])
def test_build_trace_is_the_jax_scripts(scripts, seed):
    got, want = _trace(scripts["port"], seed), _trace(scripts["jax"], seed)
    assert len(got) > 100
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


def test_build_requests_is_the_jax_scripts(scripts):
    records = _trace(scripts["jax"], 0)
    reqs = {}
    for name, mod in scripts.items():
        pool = mod._workloads_mod.tenant_pool(
            IMAGE, 3, True, np.random.RandomState(0), [BUCKET], TENANTS)
        reqs[name] = mod.build_requests(records, pool, IMAGE, TENANTS)
    assert len(reqs["port"]) == len(records)
    for got, want in zip(reqs["port"], reqs["jax"]):
        assert got["tenant"] == want["tenant"]
        assert got["key"] == want["key"]
        for field in ("sx", "sy", "qx"):
            assert got[field].dtype == want[field].dtype
            np.testing.assert_array_equal(got[field], want[field])


@pytest.mark.parametrize("duration", [12.0, 24.0, 60.0])
def test_phase_plan_is_the_jax_scripts(scripts, duration):
    assert (scripts["port"].phase_plan(duration)
            == scripts["jax"].phase_plan(duration))


@pytest.mark.parametrize("cal", [
    {"probe_miss_ms": 17.13, "probe_hit_ms": 5.5},      # peak cap binds
    {"probe_miss_ms": 400.0, "probe_hit_ms": 120.0},    # no bound binds
    {"probe_miss_ms": 3000.0, "probe_hit_ms": 900.0},   # peak floor
    {"probe_miss_ms": 2.0, "probe_hit_ms": 3.0},        # cost floor
])
def test_operating_point_is_the_jax_scripts(scripts, cal):
    assert (scripts["port"].operating_point(dict(cal))
            == scripts["jax"].operating_point(dict(cal)))


def _run_replay(out, *args):
    proc = subprocess.run(
        [sys.executable, REPLAY, "--quick", "--device", "cpu", "--out",
         str(out), *args], cwd=REPO, capture_output=True, text=True,
        timeout=420, env=dict(os.environ, OMP_NUM_THREADS="1"))
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert lines, f"no artifact line\n{proc.stderr[-3000:]}"
    return proc, json.loads(lines[-1])


@needs_sockets
def test_short_replay_runs_three_legs_and_rolls_out(tmp_path):
    _, art = _run_replay(tmp_path / "tr", "--duration", "12")
    assert art["metric"] == "traffic_replay" and "error" not in art, art
    legs = art["legs"]
    assert set(legs) == {"fixed", "cb", "rollout"}
    for name, leg in legs.items():
        assert leg["offered"] == art["trace"]["records"] > 0, name
        assert leg["dropped"] == 0 and leg["failed"] == 0, name
        assert leg["kernels"]["ok"] and leg["kernels"]["total"] == 0, name
    gates = art["gates"]
    assert gates["cb_structural"] and gates["zero_dropped"]
    assert gates["rollout_done"] and gates["kernels"]
    assert legs["rollout"]["rollout"]["state"] == "done"
    assert art["canary_weights"] == [0.25, 1.0]
    assert art["traffic_canary_weight_final"] == 1.0
    assert art["traffic_cb_groups"] == legs["rollout"]["cb_groups"] > 0
    for key in ("traffic_p95_ms", "traffic_slo_held",
                "traffic_canary_weight_final", "traffic_cb_groups"):
        assert key in art
    cal = art["calibration"]
    assert cal["probe_miss_ms"] > 0 and cal["peak_rate"] > 0


# The fleet bench's small serving profile (3-way 5-shot, 24x24x1, 4
# stages of 32 filters): heavy enough on a CPU that the calibrated peak
# sits under the operating point's rate cap, so fixed-mode dispatch
# saturates as the design intends (the quick profile's peak is capped).
SMALL_PROFILE = dict(
    dataset_name="synthetic_fleet", image_height=24, image_width=24,
    image_channels=1, num_classes_per_set=3, num_samples_per_class=5,
    num_target_samples=2, batch_size=4, cnn_num_filters=32, num_stages=4,
    number_of_training_steps_per_iter=2,
    number_of_evaluation_steps_per_iter=5, second_order=False,
    use_multi_step_loss_optimization=False, compute_dtype="float32",
    serve_buckets=[[15, 2]], serve_batch_tasks=4)


@pytest.mark.slow
@needs_sockets
def test_replay_verdict_at_the_small_profile(tmp_path):
    """The whole verdict of a 24 s replay at the small profile: cb p95 <
    fixed p95, the SLO held, the rollout DONE, at least one scale-up."""
    cfg = tmp_path / "small.json"
    cfg.write_text(json.dumps(SMALL_PROFILE))
    proc, art = _run_replay(tmp_path / "tr", "--config", str(cfg))
    assert art["status"] == "ok", art.get("gates")
    assert proc.returncode == 0
    assert art["legs"]["cb"]["p95_ms"] < art["legs"]["fixed"]["p95_ms"]
