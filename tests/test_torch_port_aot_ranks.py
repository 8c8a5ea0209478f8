"""A rank's warm start on the CPU: the train and eval steps as the pieces a
rank's CUDA graphs capture (``meta/outer.py § TrainPieces``,
``§ EvalPieces``; ``parallel/aot.py § TrainGraph``), the store's
fingerprint across world sizes, and the degraded prewarm's roster.

* The pieces compose bitwise to ``make_train_step`` and
  ``make_eval_step``, with the update reading its own copy of the
  reduced buffer as a graph's static buffer does: at a world of 1
  without a process group and with a one-rank gloo group, for both
  phase keys of a tiny flagship-shaped config, with and without an
  elastic pad task.
* Two gloo CPU ranks (separate processes) run two steps through the
  pieces: bitwise the plan's eager step and bitwise across ranks, and
  within rtol 1e-4 / atol 2e-4 of the JAX package's padded mesh step on
  two devices. The same workers read the live world size into the
  fingerprint, build a survivor roster's builder (whose fingerprint the
  prewarm's ``roster_config`` must give) and see the trainer refuse
  ``aot_store_dir`` on the CPU for the card's reason.
* The fingerprint moves with the world size on every shipped JSON, as
  the JAX one moves with ``process_count``.
* A two-graph step's record round-trips through the store with an
  injected capture (graphs need the card; their capture and replay on a
  one-rank gloo group are ``tests/test_torch_port_cuda.py``'s).
* ``scripts/torch_aot_prewarm.py --degraded 1`` refuses the CPU with
  the JAX script's keys.
"""

from __future__ import annotations

import glob
import importlib.util
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
import torch.distributed as dist

from helpers import gloo_multiprocess_quarantine
from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.meta import inner as jinner
from howtotrainyourmamlpytorch_tpu.meta import outer as jouter
from howtotrainyourmamlpytorch_tpu.models import make_model as jax_model
from howtotrainyourmamlpytorch_tpu.parallel import aot as jaot
from howtotrainyourmamlpytorch_tpu.parallel import mesh as jmesh
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.convert import (params_from_jax,
                                                         state_from_jax)
from howtotrainyourmamlpytorch_tpu_torch.meta import inner, outer
from howtotrainyourmamlpytorch_tpu_torch.models import make_model
from howtotrainyourmamlpytorch_tpu_torch.parallel import aot, mesh
from howtotrainyourmamlpytorch_tpu_torch.telemetry.registry import (
    MetricsRegistry)
from howtotrainyourmamlpytorch_tpu_torch.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "experiment_config",
                        "mini-imagenet_maml++_5-way_5-shot_DA_b12.json")
CONFIGS = sorted(glob.glob(os.path.join(REPO, "experiment_config",
                                        "*.json")))
PREWARM = os.path.join(REPO, "scripts", "torch_aot_prewarm.py")
WORKER_TIMEOUT = 120
TOL = dict(rtol=1e-4, atol=2e-4)
# The flagship's phases (epoch 0: first order + MSL; past the annealing:
# second order) at tiny widths, f32 exact path.
TINY = dict(dataset_name="syn", image_height=8, image_width=8,
            image_channels=1, num_classes_per_set=3,
            num_samples_per_class=2, num_target_samples=2,
            cnn_num_filters=4, num_stages=2,
            number_of_training_steps_per_iter=2,
            number_of_evaluation_steps_per_iter=2, batch_size=4,
            task_microbatches=2, first_order_to_second_order_epoch=1,
            multi_step_loss_num_epochs=1, total_epochs=3,
            compute_dtype="float32", bn_fast_math=False,
            bn_backend="composite")
PHASES = {(False, True): 0, (True, False): 2}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _episodes(cfg, n, seed, pad=0):
    """``n`` uint8 episodes (the wire format), the last ``pad`` of them
    all-zero elastic pads."""
    rng = np.random.default_rng(seed)
    h, w, c = cfg.image_shape
    k, q = cfg.num_support_per_task, cfg.num_target_per_task
    labels = np.repeat(np.arange(cfg.num_classes_per_set, dtype=np.int32),
                       cfg.num_samples_per_class)
    tlabels = np.repeat(np.arange(cfg.num_classes_per_set, dtype=np.int32),
                        cfg.num_target_samples)
    ep = jinner.Episode(
        rng.integers(0, 256, (n, k, h, w, c), dtype=np.uint8),
        np.tile(labels, (n, 1)),
        rng.integers(0, 256, (n, q, h, w, c), dtype=np.uint8),
        np.tile(tlabels, (n, 1)))
    if pad:
        ep = jinner.Episode(*(np.concatenate(
            [f[:n - pad], np.zeros((pad,) + f.shape[1:], f.dtype)])
            for f in ep))
    return ep


def _torch(ep):
    return inner.Episode(*(torch.from_numpy(np.asarray(f)) for f in ep))


def _state():
    """The JAX package's initial state of ``TINY``, in the port."""
    jcfg = JaxConfig(**TINY)
    init, _ = jax_model(jcfg)
    s = jouter.init_train_state(jcfg, init, jax.random.PRNGKey(0))
    return state_from_jax(*_np((s.params, s.lslr, s.bn_state)),
                          device="cpu")


def _by_pieces(cfg, plan, state, batch, epoch, key):
    """One step through the pieces as a rank's graphs run it: the local
    accumulation, its buffer copied into the update's own (a graph's
    static buffer), the collective on that copy, then the update."""
    pieces = plan.train_pieces
    scalars = outer.StepScalars("cpu").fill(cfg, state.opt_state.count,
                                            epoch)
    flat, layout = pieces.local(state, batch, scalars.epoch,
                                second_order=key[0], use_msl=key[1])
    static = flat.clone()
    pieces.reduce(static)
    return pieces.update(state, static, layout, scalars=scalars)


def _plan(cfg, m):
    return mesh.make_sharded_steps(cfg, make_model(cfg)[1], m)


def _same_step(a, b):
    (sa, ma), (sb, mb) = a, b
    leaves = lambda s: tree_leaves({"p": s.params, "l": s.lslr,  # noqa
                                    "b": s.bn_state, "m": s.opt_state.mu,
                                    "v": s.opt_state.nu})
    return (all(torch.equal(x, y) for x, y in zip(leaves(sa), leaves(sb)))
            and all(torch.equal(x, y) for x, y in zip(ma[:3], mb[:3]))
            and sa.opt_state.count == sb.opt_state.count
            and sa.step == sb.step and ma.learning_rate == mb.learning_rate)


@pytest.fixture
def gloo_world_of_one(tmp_path):
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _compose_case(pad, phase):
    cfg = MAMLConfig(**dict(TINY, batch_size=TINY["batch_size"] - pad,
                            elastic_pad_tasks=pad))
    m = mesh.make_mesh(cfg)
    plan = _plan(cfg, m)
    state = _state()
    batch = _torch(_episodes(cfg, cfg.padded_batch_size, 1, pad))
    epoch = PHASES[phase]
    eager = plan.train_step(state, batch, epoch, second_order=phase[0],
                            use_msl=phase[1])
    assert _same_step(_by_pieces(cfg, plan, state, batch, epoch,
                                 phase), eager)
    # The pieces are the step's own, and the step a plain one's bits.
    assert plan.train_pieces is plan.train_step.pieces
    plain = outer.make_train_step(cfg, make_model(cfg)[1])(
        state, batch, epoch, second_order=phase[0], use_msl=phase[1])
    assert _same_step(eager, plain)
    ev = _torch(_episodes(cfg, 6, 2))
    local = plan.eval_pieces.local(eager[0], ev)
    got = plan.eval_pieces.gather(tuple(t.clone() for t in local))
    want = plan.eval_step(eager[0], ev)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    return m


@pytest.mark.parametrize("pad", [0, 1], ids=["no_pad", "one_pad"])
@pytest.mark.parametrize("phase", list(PHASES), ids=str)
def test_pieces_compose_to_the_step_at_world_one(pad, phase):
    m = _compose_case(pad, phase)
    assert not m.communicates and m.world == 1


@pytest.mark.parametrize("pad", [0, 1], ids=["no_pad", "one_pad"])
@pytest.mark.parametrize("phase", list(PHASES), ids=str)
def test_pieces_compose_to_the_step_on_a_one_rank_gloo_group(
        gloo_world_of_one, pad, phase):
    m = _compose_case(pad, phase)
    assert m.communicates and (m.rank, m.world) == (0, 1)


# ---------------------------------------------------------------------------
# Two gloo ranks.

RANKS_KW = dict(TINY, batch_size=7, elastic_pad_tasks=1, mesh_shape=[1, 2],
                task_microbatches=2)
SURVIVOR_KW = dict(TINY, batch_size=3, mesh_shape=[3, 1],
                   task_microbatches=1, total_epochs=1,
                   total_iter_per_epoch=1, num_evaluation_tasks=4)

_WORKER = r"""
import os, pickle, sys
REPO, JOB, OUT, ROOT = sys.argv[1:5]
sys.path.insert(0, REPO)
import numpy as np
import torch
torch.set_num_threads(1)
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.convert import state_from_jax
from howtotrainyourmamlpytorch_tpu_torch.experiment import ExperimentBuilder
from howtotrainyourmamlpytorch_tpu_torch.meta import outer
from howtotrainyourmamlpytorch_tpu_torch.meta.inner import Episode
from howtotrainyourmamlpytorch_tpu_torch.models import make_model
from howtotrainyourmamlpytorch_tpu_torch.parallel import (
    aot, initialize_distributed, local_batch_positions, make_mesh,
    make_sharded_steps)
from howtotrainyourmamlpytorch_tpu_torch.resilience import elastic
from howtotrainyourmamlpytorch_tpu_torch.tree import tree_leaves, tree_map

with open(JOB, "rb") as f:
    job = pickle.load(f)
assert initialize_distributed(device="cpu")
cfg = MAMLConfig.from_dict(job["cfg"])
_, apply = make_model(cfg)
m = make_mesh(cfg)
plan = make_sharded_steps(cfg, apply, m)
pieces = plan.train_pieces
state = eager = state_from_jax(*job["init"], device="cpu")

def local(ep):
    s, e = local_batch_positions(m, ep[0].shape[0])
    return Episode(*(torch.from_numpy(np.ascontiguousarray(f[s:e]))
                     for f in ep))

losses, bitwise = [], True
for b in job["batches"]:
    batch = local(b)
    scalars = outer.StepScalars("cpu").fill(cfg, state.opt_state.count, 0)
    flat, layout = pieces.local(state, batch, scalars.epoch,
                                second_order=True, use_msl=True)
    static = flat.clone()
    pieces.reduce(static)
    new, met = pieces.update(state, static, layout, scalars=scalars)
    eager, em = plan.train_step(eager, batch, 0, second_order=True,
                                use_msl=True)
    bitwise &= all(torch.equal(x, y) for x, y in zip(
        tree_leaves({"p": new.params, "l": new.lslr, "b": new.bn_state,
                     "m": new.opt_state.mu, "v": new.opt_state.nu}),
        tree_leaves({"p": eager.params, "l": eager.lslr,
                     "b": eager.bn_state, "m": eager.opt_state.mu,
                     "v": eager.opt_state.nu})))
    bitwise &= torch.equal(met.loss, em.loss)
    state = new
    losses.append(float(met.loss).hex())
ev = local(job["eval"])
got = plan.eval_pieces.gather(tuple(
    t.clone() for t in plan.eval_pieces.local(state, ev)))
want = plan.eval_step(state, ev)
bitwise &= all(torch.equal(a, b) for a, b in zip(got, want))
out = {"rank": m.rank, "world": m.world, "losses": losses,
       "bitwise": bool(bitwise),
       "params": tree_map(lambda t: t.numpy(), state.params),
       "eval": [t.numpy() for t in got],
       "fp_live": aot.store_fingerprint(cfg, "cpu"),
       "fp_2": aot.store_fingerprint(cfg, "cpu", world_size=2)}
# The trainer with a store on the CPU refuses for the card's reason.
try:
    ExperimentBuilder(cfg.replace(aot_store_dir=os.path.join(ROOT, "st"),
                                  experiment_root=ROOT), device="cpu")
    out["refusal"] = None
except ValueError as e:
    out["refusal"] = str(e)
# A survivor roster's builder: hosts 1 and 2 of 3 at generation 1.
os.environ.update({elastic.GEN_ENV: "1", elastic.ROSTER_ENV: "1,2",
                   elastic.ORIG_ENV: "3"})
survivor = MAMLConfig.from_dict(job["survivor"]).replace(
    experiment_root=ROOT, experiment_name="survivor")
builder = ExperimentBuilder(survivor, device="cpu")
out["survivor_fp"] = aot.store_fingerprint(builder.cfg, "cpu")
out["survivor_world"] = builder.mesh.world
out["survivor_pads"] = builder.cfg.elastic_pad_tasks
with open(OUT, "wb") as f:
    pickle.dump(out, f)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _prewarm_module():
    spec = importlib.util.spec_from_file_location("torch_aot_prewarm",
                                                  PREWARM)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    jcfg = JaxConfig(**dict(RANKS_KW, mesh_shape=(1, 2)))
    init, _ = jax_model(jcfg)
    js = jouter.init_train_state(jcfg, init, jax.random.PRNGKey(0))
    job = {"cfg": RANKS_KW, "survivor": SURVIVOR_KW,
           "init": _np((js.params, js.lslr, js.bn_state)),
           "batches": [_episodes(jcfg, 8, 10 + i, pad=1) for i in range(2)],
           "eval": _episodes(jcfg, 8, 99)}
    job_path = tmp / "job.pkl"
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        out = tmp / f"out{rank}.pkl"
        root = tmp / f"root{rank}"
        procs.append((subprocess.Popen(
            [sys.executable, "-c", _WORKER, REPO, str(job_path), str(out),
             str(root)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out))
    logs = []
    try:
        for p, _ in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (p, _), log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    results = []
    for _, out in procs:
        with open(out, "rb") as f:
            results.append(pickle.load(f))
    return jcfg, js, job, results


@gloo_multiprocess_quarantine
def test_two_gloo_ranks_through_the_pieces_match_the_jax_padded_mesh(
        two_ranks):
    jcfg, js, job, results = two_ranks
    assert [(r["rank"], r["world"]) for r in results] == [(0, 2), (1, 2)]
    assert all(r["bitwise"] for r in results)
    assert results[0]["losses"] == results[1]["losses"]
    for a, b in zip(results[0]["eval"], results[1]["eval"]):
        assert np.array_equal(a, b)
    # The JAX package's padded step on a (1, 2) mesh of two devices.
    _, apply = jax_model(jcfg)
    jm = jmesh.make_mesh(jcfg, jax.devices()[:2])
    plan = jmesh.make_sharded_steps(jcfg, apply, jm)
    state = jmesh.replicate_state(js, jm)
    losses = []
    for b in job["batches"]:
        state, mt = plan.train_steps[(True, True)](
            state, jmesh.shard_batch(jinner.Episode(*map(jnp.asarray, b)),
                                     jm), jnp.float32(0.0))
        losses.append(float(mt.loss))
    res = plan.eval_step(state, jmesh.shard_batch(
        jinner.Episode(*map(jnp.asarray, job["eval"])), jm))
    got = [float.fromhex(v) for v in results[0]["losses"]]
    np.testing.assert_allclose(got, losses, **TOL)
    np.testing.assert_allclose(results[0]["eval"][0], np.asarray(res[0]),
                               **TOL)
    np.testing.assert_allclose(results[0]["eval"][2], np.asarray(res[2]),
                               **TOL)
    want = params_from_jax(_np(state.params))
    held = 0
    for layer, sub in results[0]["params"].items():
        for leaf, p in sub.items():
            # Conv biases before batch-statistics BN: rounding noise that
            # Adam scales to a full step (ROADMAP § Known reference
            # conditions).
            if layer.startswith("conv") and leaf == "b":
                continue
            held += 1
            np.testing.assert_allclose(p, want[layer][leaf].numpy(), **TOL,
                                       err_msg=f"{layer}/{leaf}")
    assert held >= 5


@gloo_multiprocess_quarantine
def test_live_world_size_reaches_the_fingerprint(two_ranks):
    _, _, _, results = two_ranks
    cfg = MAMLConfig.from_dict(RANKS_KW)
    for r in results:
        assert r["fp_live"] == r["fp_2"]
        assert r["fp_live"] == aot.store_fingerprint(cfg, "cpu",
                                                     world_size=2)
        assert r["fp_live"] != aot.store_fingerprint(cfg, "cpu")


@gloo_multiprocess_quarantine
def test_degraded_prewarm_fingerprint_is_the_survivor_builders(two_ranks):
    _, _, _, results = two_ranks
    tcfg, world = _prewarm_module().roster_config(
        MAMLConfig.from_dict(SURVIVOR_KW), survivors=2)
    assert world == 2 and tcfg.elastic_pad_tasks == 1
    want = aot.store_fingerprint(tcfg, "cpu", world_size=world)
    for r in results:
        assert (r["survivor_world"], r["survivor_pads"]) == (2, 1)
        assert r["survivor_fp"] == want
    # Another roster is another directory.
    full, w3 = _prewarm_module().roster_config(
        MAMLConfig.from_dict(SURVIVOR_KW))
    assert w3 == 3 and aot.store_fingerprint(full, "cpu", w3) != want


@gloo_multiprocess_quarantine
def test_two_cpu_ranks_with_a_store_refuse_for_the_card(two_ranks):
    _, _, _, results = two_ranks
    for r in results:
        assert r["refusal"] is not None
        assert "CUDA graphs, which need the card" in r["refusal"]
        assert "multi-process" not in r["refusal"]


# ---------------------------------------------------------------------------
# Fingerprints, records, the prewarm's CPU refusal.


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_fingerprint_moves_with_world_size_as_jax_with_process_count(path):
    with open(path) as f:
        doc = json.load(f)
    p_cfg, j_cfg = MAMLConfig.from_dict(doc), JaxConfig.from_dict(doc)
    jm = jmesh.make_mesh(j_cfg.replace(mesh_shape=(1, 1)),
                         jax.devices()[:1])
    for a, b in ((1, 2), (2, 3), (1, 4)):
        port_moves = (aot.store_fingerprint(p_cfg, "cpu", world_size=a)
                      != aot.store_fingerprint(p_cfg, "cpu", world_size=b))
        jax_moves = (jaot.store_fingerprint(j_cfg, jm, process_count=a)
                     != jaot.store_fingerprint(j_cfg, jm, process_count=b))
        assert port_moves and jax_moves
    # No process group: the live world is one process, as JAX's default.
    assert aot.store_fingerprint(p_cfg, "cpu") == aot.store_fingerprint(
        p_cfg, "cpu", world_size=1)
    assert aot.fingerprint_doc(p_cfg, "cpu", world_size=3)[
        "world_size"] == 3


class TwoGraphStub:
    """What a rank's train capture returns, without the card: the step
    through its pieces, with a two-graph record."""

    def __init__(self, cfg, plan, launches=(6, 0)):
        self.cfg, self.plan = cfg, plan
        self.stage_launches = list(launches)
        self.launches = sum(launches)

    def record(self):
        return {"name": "stub", "signature": None, "launches": self.launches,
                "graphs": [{"stage": i, "launches": n}
                           for i, n in enumerate(self.stage_launches)],
                "capture_seconds": 0.0}

    def __call__(self, state, batch, epoch, *, second_order, use_msl,
                 plain=False, health=False):
        return _by_pieces(self.cfg, self.plan, state, batch, epoch,
                          (second_order, use_msl))


def test_two_graph_record_round_trips_through_the_store(tmp_path):
    cfg = MAMLConfig(**TINY)
    plan = _plan(cfg, mesh.make_mesh(cfg))
    state = _state()
    batch = _torch(_episodes(cfg, 4, 3))
    zero = aot.zero_episode(cfg, 4, "cpu")
    sig = aot.signature_of(state, zero)
    name = aot.train_exec_name((True, False))
    reg = MetricsRegistry()
    store = aot.AOTStore(str(tmp_path), aot.store_fingerprint(cfg, "cpu"),
                         registry=reg)
    fn, hit = aot.load_or_compile(store, name,
                                  lambda: TwoGraphStub(cfg, plan), sig,
                                  registry=reg, fallback=plan.train_step)
    assert not hit
    got = fn(state, batch, 2, second_order=True, use_msl=False)
    assert _same_step(got, plan.train_step(state, batch, 2,
                                           second_order=True,
                                           use_msl=False))
    # A rank of another process: a hit on the same record, its two
    # graphs' launches as captured; nothing rewritten.
    store2 = aot.AOTStore(str(tmp_path), aot.store_fingerprint(cfg, "cpu"),
                          registry=reg, writer=False)
    _, hit2 = aot.load_or_compile(
        store2, name, lambda: TwoGraphStub(cfg, plan), sig, registry=reg,
        fallback=plan.train_step)
    record = store2.load(name, count=False)
    assert hit2 and record["signature"] == sig
    assert record["launches"] == 6 and [g["launches"] for g in
                                        record["graphs"]] == [6, 0]
    # A record whose stages captured other launches is stale: counted,
    # and the writer records the new one.
    _, hit3 = aot.load_or_compile(
        store, name, lambda: TwoGraphStub(cfg, plan, (4, 2)), sig,
        registry=reg, fallback=plan.train_step)
    assert hit3 and reg.counter(aot.ERRORS).value == 1
    assert [g["launches"] for g in store.load(name, count=False)[
        "graphs"]] == [4, 2]
    assert reg.counter(aot.EXEC_FALLBACKS).value == 0


def test_degraded_prewarm_refuses_the_cpu_with_the_jax_keys(tmp_path):
    pod = os.path.join(REPO, "experiment_config",
                       "tiered-imagenet_maml++_5-way_5-shot_resnet12_pod."
                       "json")
    proc = subprocess.run(
        [sys.executable, PREWARM, "--config", pod, "--store",
         str(tmp_path / "store"), "--degraded", "1", "--degraded-only",
         "--device", "cpu"], capture_output=True, text=True, timeout=120,
        cwd=REPO)
    assert proc.returncode == 1
    art = json.loads(proc.stdout.strip().splitlines()[-1])
    jax_keys = {"metric", "value", "unit", "ok", "hits", "misses",
                "failures", "seconds", "store_dir", "fingerprint",
                "fingerprints", "xla_compiler_options", "workload",
                "executables"}
    assert jax_keys <= set(art)
    assert art["metric"] == "aot_prewarm" and art["ok"] is False
    assert "needs the card" in art["status"]
    assert not any(e.get("disposition") == "skipped"
                   for e in art["executables"])
    assert not os.path.exists(tmp_path / "store")
