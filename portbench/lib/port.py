"""The benchmark's one door into the program under test
(``howtotrainyourmamlpytorch_tpu_torch``): its config, its train step as
the trainer runs it under graphs, and its serving engine. Everything
else in ``portbench`` is the yardstick and imports nothing of the
program.

The benchmark hands the program the tables it made from the seed
(``lib/weights.py``) and the inputs it made; what the program derives
from them stays the program's.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Tuple

import torch


def config(maml_config: Dict[str, Any], overrides: Dict[str, Any]):
    """The program's ``MAMLConfig`` of a configuration file's
    ``maml_config``, with the run's overrides (cache directories, engine
    settings)."""
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
    return MAMLConfig.from_dict({**maml_config, **overrides})


def train_state(params, lslr, bn_state):
    """A fresh ``MetaTrainState`` (Adam at zero) over copies of the
    benchmark's tables."""
    from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
        AdamState, MetaTrainState)
    from portbench.lib.weights import clone
    zeros = lambda tree: {k: zeros(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else torch.zeros_like(tree)
    params, lslr, bn_state = clone(params), clone(lslr), clone(bn_state)
    trainable = {"params": params, "lslr": lslr}
    return MetaTrainState(params=params, lslr=lslr, bn_state=bn_state,
                          opt_state=AdamState(count=0, mu=zeros(trainable),
                                              nu=zeros(trainable)))


def template(cfg) -> Tuple[Dict, Dict, Dict]:
    """The program's own freshly initialized ``(params, lslr, bn_state)``
    (on the CPU), for checking the benchmark's tables against its
    structure."""
    from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
        init_train_state)
    from howtotrainyourmamlpytorch_tpu_torch.models import make_model
    state = init_train_state(cfg, make_model(cfg)[0], seed=0, device="cpu")
    return state.params, state.lslr, state.bn_state


def numerics(cfg):
    """The trainer's numerics policy for the train step (cuDNN
    deterministic, the config's backend options)."""
    from howtotrainyourmamlpytorch_tpu_torch.device import numerics_policy
    return numerics_policy(cfg.compute_dtype, deterministic=True,
                           options=cfg.xla_compiler_options_dict)


def train_step(cfg, state, batch, epoch: int, device) -> Tuple[
        Callable[..., Any], Tuple[bool, bool]]:
    """``(step, phase)``: ``step(state, batch) -> (state, metrics)`` at
    ``epoch``'s phase key. On the card with ``aot_store_dir`` it is the
    trainer's CUDA graph of the phase key (``parallel/aot.py §
    TrainGraph`` through ``load_or_compile``, as the trainer adopts it),
    and it raises if the graph was not captured; elsewhere the eager
    step."""
    from howtotrainyourmamlpytorch_tpu_torch.meta.outer import (
        make_train_step)
    from howtotrainyourmamlpytorch_tpu_torch.models import make_model
    from howtotrainyourmamlpytorch_tpu_torch.ops import build
    from howtotrainyourmamlpytorch_tpu_torch.parallel import aot
    if cfg.compilation_cache_dir:
        build.set_cache_dir(cfg.compilation_cache_dir)
    phase = (cfg.use_second_order(epoch), cfg.use_msl(epoch))
    eager = make_train_step(cfg, make_model(cfg)[1])
    fn = eager
    if aot.enabled(cfg):
        aot.require_card(cfg, device)
        store = aot.AOTStore.from_config(cfg, device)
        zero = aot.zero_episode(cfg, cfg.padded_batch_size, device)
        with numerics(cfg):
            fn, _ = aot.load_or_compile(
                store, aot.train_exec_name(phase),
                lambda: aot.TrainGraph(cfg, eager, phase, state, zero,
                                       epoch),
                aot.signature_of(state, zero), fallback=eager)
        if not isinstance(fn, aot.GuardedExec):
            raise RuntimeError(f"the CUDA graph of phase {phase} was not "
                               f"captured")

    def step(state, batch):
        with numerics(cfg):
            out = fn(state, episode(batch), epoch, second_order=phase[0],
                     use_msl=phase[1])
        if aot.enabled(cfg) and fn.compiled is None:
            raise RuntimeError(f"the CUDA graph of phase {phase} rejected "
                               f"the step's arguments")
        return out
    return step, phase


def episode(batch):
    from howtotrainyourmamlpytorch_tpu_torch.meta.inner import Episode
    return Episode(*batch)


def serving_engine(cfg, params, lslr, bn_state, device):
    """A ``ServingEngine`` over the benchmark's tables (adapt and predict
    graphs captured by its ``warmup`` when ``aot_store_dir`` is set)."""
    from howtotrainyourmamlpytorch_tpu_torch.serve.engine import (
        ServingEngine)
    return ServingEngine(cfg, train_state(params, lslr, bn_state),
                         device=device)


def request(support_x, support_y, query_x, arrival: float):
    """A ``FewShotRequest`` whose latency counts from ``arrival`` (its
    scheduled instant on ``time.monotonic``)."""
    from howtotrainyourmamlpytorch_tpu_torch.serve.batcher import (
        FewShotRequest)
    return FewShotRequest(support_x=support_x, support_y=support_y,
                          query_x=query_x, arrival_time=arrival,
                          deadline=None)


def refusals() -> Tuple[type, ...]:
    """What ``ServingEngine.submit`` raises for a request it refuses."""
    from howtotrainyourmamlpytorch_tpu_torch.serve.batcher import (
        QueueFullError, ShedError)
    return (QueueFullError, ShedError, ValueError)


def cache_dirs(root: str) -> Dict[str, str]:
    """The program's kernel build cache and warm-start store under the
    benchmark's fixed cache directory ``root``."""
    return {"compilation_cache_dir": os.path.join(root, "kernels"),
            "aot_store_dir": os.path.join(root, "aot")}
