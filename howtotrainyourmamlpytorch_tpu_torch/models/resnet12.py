"""ResNet-12 few-shot backbone as an init/apply pair (counterpart of the
JAX ``models/resnet12.py``).

Four residual blocks (TADAM / MetaOptNet), each 3 x [3x3 conv → per-step
BN → LeakyReLU(0.1)], the last BN without activation, plus a 1x1-conv →
BN projection skip; ``leaky_relu(x + skip, 0.1)``, 2x2 max-pool; then the
global mean over H and W and a linear head. Widths ``int(f·(1, 2.5, 5,
10))`` with ``f = cfg.cnn_num_filters`` (64 → 64/160/320/640). Every BN
goes through ``layers.batch_norm_act_apply``: slope 0.1 for
``block{b}_norm0/1``, 1.0 (no activation) for ``block{b}_norm2`` and
``block{b}_skip_norm``, so on ``bn_backend='pallas'`` each forward
launches the BN kernel 16 times. Parameter names are flat
(``block{b}_conv{j}``, ``block{b}_norm{j}``, ``block{b}_skip_conv``,
``block{b}_skip_norm``, ``linear``), so the "norm"-is-slow rule of
``meta.inner.split_fast_slow`` applies unchanged::

    init(generator)                                  -> (params, bn_state)
    apply(params, bn_state, x, step, training, plain=False, remat=False)
                                                     -> (logits, new_state)

Same contract as ``models/vgg.py`` (task axis written out, NHWC input
``(T, N, H, W, C)``, f32 logits ``(T, N, out)``). ``remat=True`` runs each
residual block as one ``torch.utils.checkpoint`` segment (the JAX
package's ``block_out`` tag): the block's input stays saved, the rest is
recomputed in the backward.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.models import layers

Params = Dict[str, Any]
State = Dict[str, Any]

WIDTH_MULTS = (1.0, 2.5, 5.0, 10.0)
CONVS_PER_BLOCK = 3
# BN layers per forward: three per block plus the skip's.
NORMS_PER_FORWARD = len(WIDTH_MULTS) * (CONVS_PER_BLOCK + 1)
# The residual join's activation (jax.nn.leaky_relu's slope there).
JOIN_SLOPE = 0.1


def block_widths(cfg: MAMLConfig) -> Tuple[int, ...]:
    return tuple(int(cfg.cnn_num_filters * m) for m in WIDTH_MULTS)


def _norm_slope(j: int) -> float:
    """Leaky 0.1 after the first two convs of a block; none after the
    last (it precedes the residual add)."""
    return 0.1 if j < CONVS_PER_BLOCK - 1 else 1.0


def _apply_block(cfg: MAMLConfig, params: Params, state: State,
                 x: torch.Tensor, block: int, step: int, training: bool,
                 plain: bool) -> Tuple[torch.Tensor, State]:
    """One residual block on ``(N, T·C, H, W)``; returns the pooled output
    and the block's four norm states."""
    compute_dtype = getattr(torch, cfg.compute_dtype)
    new_state: State = {}
    residual = x
    for j in range(CONVS_PER_BLOCK):
        x = layers.conv2d_apply(params[f"block{block}_conv{j}"], x,
                                compute_dtype=compute_dtype)
        name = f"block{block}_norm{j}"
        x, new_state[name] = layers.batch_norm_act_apply(
            cfg, params[name], state[name], x, step, training=training,
            negative_slope=_norm_slope(j), plain=plain)
    residual = layers.conv2d_apply(params[f"block{block}_skip_conv"],
                                   residual, compute_dtype=compute_dtype)
    name = f"block{block}_skip_norm"
    residual, new_state[name] = layers.batch_norm_act_apply(
        cfg, params[name], state[name], residual, step, training=training,
        negative_slope=1.0, plain=plain)
    x = layers.leaky_relu(x + residual, JOIN_SLOPE)
    return layers.max_pool2d(x), new_state


def make_resnet12(cfg: MAMLConfig):
    """Build (init, apply) for ResNet-12 described by ``cfg``."""
    if cfg.norm_layer != "batch_norm":
        raise ValueError("resnet12 backbone supports norm_layer='batch_norm'")
    _, _, c = cfg.image_shape
    widths = block_widths(cfg)
    num_steps = cfg.bn_num_steps

    def init(gen: torch.Generator) -> Tuple[Params, State]:
        params: Params = {}
        state: State = {}
        in_ch = c
        for b, width in enumerate(widths):
            ch = in_ch
            for j in range(CONVS_PER_BLOCK):
                params[f"block{b}_conv{j}"] = layers.conv2d_init(gen, ch,
                                                                 width)
                params[f"block{b}_norm{j}"], state[f"block{b}_norm{j}"] = (
                    layers.batch_norm_init(width, num_steps))
                ch = width
            params[f"block{b}_skip_conv"] = layers.conv2d_init(
                gen, in_ch, width, kernel_size=1)
            (params[f"block{b}_skip_norm"],
             state[f"block{b}_skip_norm"]) = layers.batch_norm_init(
                width, num_steps)
            in_ch = width
        params["linear"] = layers.linear_init(gen, widths[-1],
                                              cfg.num_output_units)
        return params, state

    def apply(params: Params, state: State, x: torch.Tensor, step: int,
              training: bool, plain: bool = False, remat: bool = False
              ) -> Tuple[torch.Tensor, State]:
        num_tasks = x.shape[0]
        h = layers.to_task_channels(x)
        new_state: State = {}
        for b in range(len(widths)):
            args = (cfg, params, state, h, b, step, training, plain)
            if remat:
                h, block_state = checkpoint(_apply_block, *args,
                                            use_reentrant=False,
                                            preserve_rng_state=False)
            else:
                h, block_state = _apply_block(*args)
            new_state.update(block_state)
        feats = layers.global_mean_pool(h, num_tasks)
        logits = layers.linear_apply(
            params["linear"], feats,
            compute_dtype=getattr(torch, cfg.compute_dtype))
        return logits.float(), new_state

    return init, apply
