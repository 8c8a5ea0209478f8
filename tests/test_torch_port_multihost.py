"""The port's mesh across real processes: gloo ranks on the CPU, each a
separate Python process joined through ``torch.distributed``, against the
JAX package's ``make_sharded_steps`` on as many virtual CPU devices.

Geometry of tests/test_multiprocess_distributed.py: 8x8x1 images, 3-way
2-shot with 2 targets, 2 stages of 4 filters, K=2, second order + MSL,
batch 8, on the f32 exact path (``compute_dtype=float32``,
``bn_fast_math=false``, composite BN), from the JAX package's initial
weights.

* Tier 1, two ranks on a (1, 2) mesh: each rank samples only its half of
  every global batch (``assemble_global_batch``) and runs two train steps
  and one eval step through ``make_sharded_steps``. The ranks' losses
  are bitwise equal; they match the JAX package's (1, 2) mesh of two
  devices and the port's one-process run on the same 8 tasks at rtol
  1e-4 / atol 2e-4 (the port's forward-f32 tolerance). The sharded
  meta-gradient meets the per-leaf floors of
  tests/test_torch_port_train.py (rel-L2 1e-3, cosine 0.99), the updated
  weights the trajectory floors (update cosine > 0.90, rel-L2 < 0.6).
  The eval step's all-gather gives both ranks the whole batch's results.
* Slow tier: four ranks on a (2, 2) mesh against JAX's (2, 2) mesh; and
  a two-rank ``torchrun`` CLI run, an epoch of 2 iterations paused and
  resumed from its checkpoint for the second, both ranks at the same
  iteration, with only rank 0 writing ``config.json``, checkpoints and
  the CSV.

Each worker process has its own time limit (120 s). Quarantined like the
JAX package's two-process test (tests/helpers.py).
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import gloo_multiprocess_quarantine
from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.meta import inner as jinner
from howtotrainyourmamlpytorch_tpu.meta import outer as jouter
from howtotrainyourmamlpytorch_tpu.models import make_model as jax_model
from howtotrainyourmamlpytorch_tpu.ops import episode as jepisode
from howtotrainyourmamlpytorch_tpu.parallel import mesh as jmesh
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.convert import (params_from_jax,
                                                         state_from_jax)
from howtotrainyourmamlpytorch_tpu_torch.meta import inner, outer
from howtotrainyourmamlpytorch_tpu_torch.models import make_model
from howtotrainyourmamlpytorch_tpu_torch.tree import tree_map

pytestmark = gloo_multiprocess_quarantine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 120
CFG_KW = dict(
    dataset_name="synthetic_mp", image_height=8, image_width=8,
    image_channels=1, num_classes_per_set=3, num_samples_per_class=2,
    num_target_samples=2, batch_size=8, cnn_num_filters=4, num_stages=2,
    number_of_training_steps_per_iter=2,
    number_of_evaluation_steps_per_iter=2,
    second_order=True, use_multi_step_loss_optimization=True,
    learnable_per_layer_per_step_inner_loop_learning_rate=True,
    compute_dtype="float32", bn_fast_math=False, bn_backend="composite",
    seed=3, train_seed=3)
STEPS = 2
EVAL_TASKS = 16
TOL = dict(rtol=1e-4, atol=2e-4)

_WORKER = r"""
import pickle, sys
REPO, JOB, OUT = sys.argv[1:4]
sys.path.insert(0, REPO)
import numpy as np
import torch
torch.set_num_threads(1)
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.convert import state_from_jax
from howtotrainyourmamlpytorch_tpu_torch.meta.inner import Episode
from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
    make_meta_gradients)
from howtotrainyourmamlpytorch_tpu_torch.models import make_model
from howtotrainyourmamlpytorch_tpu_torch.parallel import (
    assemble_global_batch, initialize_distributed, make_mesh,
    make_sharded_steps)
from howtotrainyourmamlpytorch_tpu_torch.tree import tree_map

with open(JOB, "rb") as f:
    job = pickle.load(f)
assert initialize_distributed(device="cpu")
cfg = MAMLConfig.from_dict(job["cfg"])
_, apply = make_model(cfg)
mesh = make_mesh(cfg)
plan = make_sharded_steps(cfg, apply, mesh)
state = state_from_jax(*job["init"], device="cpu")

def local(batch, size):
    part = assemble_global_batch(
        lambda s, e: Episode(*(f[s:e] for f in batch)), size, mesh)
    return Episode(*(torch.from_numpy(np.ascontiguousarray(f))
                     for f in part))

epoch = job["epoch"]
grads = make_meta_gradients(cfg, apply, reduce_axes=mesh)(
    state, local(job["batches"][0], cfg.batch_size), epoch,
    second_order=True, use_msl=True)[4]
losses = []
for b in job["batches"]:
    state, m = plan.train_steps[(True, True)](
        state, local(b, cfg.batch_size), epoch)
    losses.append(float(m.loss).hex())
ev = job["eval"]
res = plan.eval_step(state, local(ev, ev[0].shape[0]))
out = {"rank": mesh.rank, "world": mesh.world, "losses": losses,
       "grads": tree_map(lambda t: t.numpy(), grads),
       "params": tree_map(lambda t: t.numpy(), state.params),
       "eval": [t.numpy() for t in res]}
with open(OUT, "wb") as f:
    pickle.dump(out, f)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _episodes(cfg, n, seed):
    rng = np.random.default_rng(seed)
    h, w, c = cfg.image_shape
    k, q = cfg.num_support_per_task, cfg.num_target_per_task
    n_cls = cfg.num_classes_per_set
    return jinner.Episode(
        rng.integers(0, 256, (n, k, h, w, c), dtype=np.uint8),
        np.tile(np.repeat(np.arange(n_cls, dtype=np.int32),
                          cfg.num_samples_per_class), (n, 1)),
        rng.integers(0, 256, (n, q, h, w, c), dtype=np.uint8),
        np.tile(np.repeat(np.arange(n_cls, dtype=np.int32),
                          cfg.num_target_samples), (n, 1)))


def _job(shape):
    jcfg = JaxConfig(**CFG_KW, mesh_shape=shape)
    init, _ = jax_model(jcfg)
    js = jouter.init_train_state(jcfg, init, jax.random.PRNGKey(jcfg.seed))
    return jcfg, js, {
        "cfg": dict(CFG_KW, mesh_shape=list(shape)),
        "init": _np((js.params, js.lslr, js.bn_state)),
        "epoch": 0,
        "batches": [_episodes(jcfg, jcfg.batch_size, 10 + i)
                    for i in range(STEPS)],
        "eval": _episodes(jcfg, EVAL_TASKS, 99)}


def _run_workers(job, world, tmp_path):
    """``world`` worker processes over one gloo group; their results in
    rank order. A worker that fails or overruns its limit fails the
    test (every worker is killed first)."""
    job_path = tmp_path / "job.pkl"
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        out = tmp_path / f"out{rank}.pkl"
        procs.append((subprocess.Popen(
            [sys.executable, "-c", _WORKER, REPO, str(job_path), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), out))
    logs = []
    try:
        for p, _ in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (p, out), log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    results = []
    for _, out in procs:
        with open(out, "rb") as f:
            results.append(pickle.load(f))
    return results


def _jax_mesh_run(jcfg, js, job, devices):
    """The JAX package's make_sharded_steps on ``devices``: losses after
    each step, final params and the eval results."""
    _, apply = jax_model(jcfg)
    jm = jmesh.make_mesh(jcfg, devices)
    plan = jmesh.make_sharded_steps(jcfg, apply, jm)
    state = jmesh.replicate_state(js, jm)
    losses = []
    for b in job["batches"]:
        state, m = plan.train_steps[(True, True)](
            state, jmesh.shard_batch(jinner.Episode(*map(jnp.asarray, b)),
                                     jm), jnp.float32(job["epoch"]))
        losses.append(float(m.loss))
    res = plan.eval_step(state, jmesh.shard_batch(
        jinner.Episode(*map(jnp.asarray, job["eval"])), jm))
    return losses, _np(state.params), [np.asarray(x) for x in res]


def _jax_meta_gradient(jcfg, js, batch, epoch):
    """The JAX package's meta-gradient of one global batch, the mean over
    its tasks (one device)."""
    _, apply = jax_model(jcfg)
    b = jepisode.normalize_episode(
        jcfg, jinner.Episode(*map(jnp.asarray, batch)))
    msl_w = jinner.per_step_loss_importance(jcfg, epoch)
    k = jcfg.number_of_training_steps_per_iter

    def loss_fn(trainable):
        res = jax.vmap(lambda ep: jinner.task_forward(
            jcfg, apply, trainable["params"], trainable["lslr"],
            js.bn_state, ep, num_steps=k, second_order=True, use_msl=True,
            msl_weights=msl_w))(b)
        return jnp.mean(res.loss)
    g = jax.jit(jax.grad(loss_fn))({"params": js.params, "lslr": js.lslr})
    g = _np(g)
    return {"params": params_from_jax(g["params"]),
            "lslr": tree_map(torch.from_numpy, g["lslr"])}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _cos(a, b):
    a, b = np.ravel(np.asarray(a, np.float64)), np.ravel(np.asarray(
        b, np.float64))
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _dead_bias(layer, leaf):
    """Conv biases sit before a batch-statistics BN: their meta-gradient
    is analytically zero and holds rounding noise only (docs/PARITY.md)."""
    return layer.startswith("conv") and leaf == "b"


def _check_against(results, job, jcfg, js, j_losses, j_params, j_eval):
    losses = [[float.fromhex(v) for v in r["losses"]] for r in results]
    # Bitwise equal across ranks: one program ran, on one global batch.
    assert all(r["losses"] == results[0]["losses"] for r in results)
    for a, b in zip(results[0]["eval"], results[-1]["eval"]):
        assert np.array_equal(a, b)
    np.testing.assert_allclose(losses[0], j_losses, **TOL)
    # The port's one-process run on the same 8 tasks per step.
    cfg = MAMLConfig(**CFG_KW)
    _, apply = make_model(cfg)
    state = state_from_jax(*job["init"], device="cpu")
    step = outer.make_train_step(cfg, apply)
    one = []
    for b in job["batches"]:
        state, m = step(state, inner.Episode(*map(torch.from_numpy, b)),
                        job["epoch"], second_order=True, use_msl=True)
        one.append(float(m.loss))
    np.testing.assert_allclose(losses[0], one, **TOL)
    # Eval: every rank holds the whole batch's results.
    loss, acc, logits = results[0]["eval"]
    assert loss.shape == (EVAL_TASKS,) and logits.shape[0] == EVAL_TASKS
    np.testing.assert_allclose(loss, j_eval[0], **TOL)
    np.testing.assert_allclose(logits, j_eval[2], **TOL)
    # The sharded meta-gradient against the JAX whole-batch one.
    want = _jax_meta_gradient(jcfg, js, job["batches"][0], job["epoch"])
    for top in ("params", "lslr"):
        for layer, sub in results[0]["grads"][top].items():
            for leaf, g in sub.items():
                if _dead_bias(layer, leaf):
                    continue
                w = want[top][layer][leaf].numpy()
                assert _rel(g, w) <= 1e-3, (top, layer, leaf, _rel(g, w))
                if np.abs(w).max() > 0:
                    assert _cos(g, w) >= 0.99, (top, layer, leaf)
    # Updated weights: the trajectory floors of docs/PARITY.md.
    init = params_from_jax(job["init"][0])
    jp = params_from_jax(j_params)
    for layer, sub in results[0]["params"].items():
        for leaf, p in sub.items():
            if _dead_bias(layer, leaf):
                continue
            du = p - init[layer][leaf].numpy()
            dw = jp[layer][leaf].numpy() - init[layer][leaf].numpy()
            assert _cos(du, dw) > 0.90, (layer, leaf, _cos(du, dw))
            assert _rel(du, dw) < 0.6, (layer, leaf, _rel(du, dw))


def test_two_gloo_ranks_match_the_jax_two_device_mesh(tmp_path):
    jcfg, js, job = _job((1, 2))
    results = _run_workers(job, 2, tmp_path)
    assert [(r["rank"], r["world"]) for r in results] == [(0, 2), (1, 2)]
    j_losses, j_params, j_eval = _jax_mesh_run(jcfg, js, job,
                                               jax.devices()[:2])
    _check_against(results, job, jcfg, js, j_losses, j_params, j_eval)


@pytest.mark.slow
def test_four_gloo_ranks_match_the_jax_2x2_mesh(tmp_path):
    jcfg, js, job = _job((2, 2))
    results = _run_workers(job, 4, tmp_path)
    assert [r["rank"] for r in results] == [0, 1, 2, 3]
    j_losses, j_params, j_eval = _jax_mesh_run(jcfg, js, job,
                                               jax.devices()[:4])
    _check_against(results, job, jcfg, js, j_losses, j_params, j_eval)


CLI_KW = dict(CFG_KW, experiment_name="mesh_cli", total_epochs=1,
              total_iter_per_epoch=2, num_evaluation_tasks=8,
              max_models_to_save=1, mesh_shape=[1, 2])


def _torchrun(args, tmp_path, tag):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + ([os.environ["PYTHONPATH"]]
                             if os.environ.get("PYTHONPATH") else [])))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_port", str(_free_port()), "--tee", "3",
         "--log_dir", str(tmp_path / f"logs_{tag}"), "-m",
         "howtotrainyourmamlpytorch_tpu_torch.train_maml_system",
         "--device", "cpu", *args], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=2 * WORKER_TIMEOUT)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    return proc.stdout + proc.stderr


@pytest.mark.slow
def test_torchrun_cli_pauses_and_resumes_on_two_ranks(tmp_path):
    """The CLI under torchrun on a (1, 2) mesh: 2 epochs of 2 iterations,
    paused after the first epoch, then resumed: both ranks resume at
    iteration 2, and only rank 0 wrote config.json, the checkpoints and
    the CSVs (one row per epoch); the heartbeat rows gather both
    ranks."""
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(dict(CLI_KW, total_epochs=2,
                                    experiment_root=str(tmp_path / "x"))))
    out = _torchrun(["--name_of_args_json_file", str(path),
                     "--total_epochs_before_pause", "1"], tmp_path, "a")
    assert out.count("mesh: backend=gloo, world=2, shape=(1, 2)") == 2
    out = _torchrun(["--name_of_args_json_file", str(path),
                     "--continue_from_epoch", "latest"], tmp_path, "b")
    assert out.count("resumed from checkpoint 'latest' at iter 2") == 2
    base = tmp_path / "x" / "mesh_cli"
    with open(base / "config.json") as f:
        assert json.load(f)["mesh_shape"] == [1, 2]
    models = sorted(os.listdir(base / "saved_models"))
    assert "train_model_1.ckpt" in models and "state.json" in models
    logs = sorted(os.listdir(base / "logs"))
    assert "summary_statistics.csv" in logs and "test_summary.csv" in logs
    with open(base / "logs" / "summary_statistics.csv") as f:
        assert len(f.read().strip().splitlines()) == 3  # header + 2 epochs
    with open(base / "logs" / "events.jsonl") as f:
        rows = [json.loads(line) for line in f]
    beats = [r for r in rows if r["event"] == "heartbeat"]
    assert beats and all(r["hosts"] == 2 for r in beats)
