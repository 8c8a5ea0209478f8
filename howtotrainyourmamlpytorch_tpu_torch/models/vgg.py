"""VGG-style few-shot backbone as an init/apply pair (counterpart of the
JAX ``models/vgg.py``).

``num_stages`` blocks of [3x3 conv (``cnn_num_filters``) → per-step BN →
ReLU → 2x2 max-pool] → flatten (NHWC order) → linear to
``num_output_units`` logits. With ``norm_layer='layer_norm'`` each norm is
a per-sample layer norm with an elementwise affine over the conv output's
``(H, W, C)``, followed by ReLU (no per-step rows, empty norm state)::

    init(generator)                                  -> (params, bn_state)
    apply(params, bn_state, x, step, training, plain=False, remat=False)
                                                     -> (logits, new_state)

``init`` returns one task's tensors (no task axis), on the CPU.
``apply`` takes a task-batched forward: every params/state leaf has a
leading task axis ``T`` (tree.stack_tasks), ``x`` is ``(T, N, H, W, C)``
NHWC, logits are ``(T, N, out)`` f32. ``step`` picks the per-step BN
row: an int for every task, or a ``(T,)`` tensor of per-task rows (the
batched MSL target forward). ``plain=True`` runs the BN
kernel's plain PyTorch version (bn_backend='pallas' only). ``remat=True``
runs each stage (conv → BN → ReLU → pool) as one
``torch.utils.checkpoint`` segment: its input stays saved, the rest is
recomputed in the backward (meta/inner.py, ``remat_policy='block_outs'``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.models import layers
from howtotrainyourmamlpytorch_tpu_torch.models.mlp import make_mlp
from howtotrainyourmamlpytorch_tpu_torch.models.resnet12 import make_resnet12

Params = Dict[str, Any]
State = Dict[str, Any]
InitFn = Callable[[torch.Generator], Tuple[Params, State]]
ApplyFn = Callable[..., Tuple[torch.Tensor, State]]


def _compute_dtype(cfg: MAMLConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _stage_shapes(cfg: MAMLConfig) -> List[Tuple[int, int]]:
    """Spatial size of each stage's conv output, then of the tower's
    output (conv → optional pool per stage), with the JAX package's
    SAME/VALID arithmetic."""
    h, w, _ = cfg.image_shape
    stride = 1 if cfg.max_pooling else 2
    shapes = []
    for _ in range(cfg.num_stages):
        if cfg.conv_padding:
            h, w = -(-h // stride), -(-w // stride)
        else:
            h, w = (h - 3) // stride + 1, (w - 3) // stride + 1
        shapes.append((h, w))
        if cfg.max_pooling:
            h, w = (h - 2) // 2 + 1, (w - 2) // 2 + 1
        if h <= 0 or w <= 0:
            raise ValueError(
                f"image {cfg.image_shape[:2]} too small for "
                f"{cfg.num_stages} stages")
    return shapes + [(h, w)]


def _features_apply(cfg: MAMLConfig, params: Params, state: State,
                    x: torch.Tensor, step: layers.Step, training: bool,
                    plain: bool, remat: bool) -> Tuple[torch.Tensor, State]:
    """Conv tower: ``(T, N, H, W, C)`` -> ``(T, N, features)`` and the
    new norm state."""
    num_tasks = x.shape[0]
    compute_dtype = _compute_dtype(cfg)
    stride = 1 if cfg.max_pooling else 2
    padding = "SAME" if cfg.conv_padding else "VALID"

    def stage(conv, norm, norm_state, h):
        h = layers.conv2d_apply(conv, h, stride=stride, padding=padding,
                                compute_dtype=compute_dtype)
        if cfg.norm_layer == "batch_norm":
            h, new = layers.batch_norm_act_apply(
                cfg, norm, norm_state, h, step, training=training,
                negative_slope=0.0, plain=plain)
        else:
            h, new = layers.layer_norm_apply(norm, norm_state, h, step,
                                             training=training)
            h = F.relu(h)
        if cfg.max_pooling:
            h = layers.max_pool2d(h)
        return h, new

    h = layers.to_task_channels(x)
    new_state: State = {}
    for i in range(cfg.num_stages):
        args = (params[f"conv{i}"], params[f"norm{i}"], state[f"norm{i}"], h)
        if remat:
            h, new_state[f"norm{i}"] = checkpoint(
                stage, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            h, new_state[f"norm{i}"] = stage(*args)
    return layers.flatten_tasks(h, num_tasks), new_state


def make_vgg(cfg: MAMLConfig) -> Tuple[InitFn, ApplyFn]:
    """Build (init, apply) for the VGG backbone described by ``cfg``."""
    _, _, c = cfg.image_shape
    num_steps = cfg.bn_num_steps

    def init(gen: torch.Generator) -> Tuple[Params, State]:
        params: Params = {}
        state: State = {}
        in_ch = c
        *conv_out, (fh, fw) = _stage_shapes(cfg)
        for i in range(cfg.num_stages):
            params[f"conv{i}"] = layers.conv2d_init(gen, in_ch,
                                                    cfg.cnn_num_filters)
            if cfg.norm_layer == "batch_norm":
                params[f"norm{i}"], state[f"norm{i}"] = (
                    layers.batch_norm_init(cfg.cnn_num_filters, num_steps))
            else:
                params[f"norm{i}"], state[f"norm{i}"] = (
                    layers.layer_norm_init((*conv_out[i],
                                            cfg.cnn_num_filters)))
            in_ch = cfg.cnn_num_filters
        params["linear"] = layers.linear_init(
            gen, fh * fw * cfg.cnn_num_filters, cfg.num_output_units)
        return params, state

    def apply(params: Params, state: State, x: torch.Tensor, step: layers.Step,
              training: bool, plain: bool = False, remat: bool = False
              ) -> Tuple[torch.Tensor, State]:
        feats, new_state = _features_apply(cfg, params, state, x, step,
                                           training, plain, remat)
        logits = layers.linear_apply(params["linear"], feats,
                                     compute_dtype=_compute_dtype(cfg))
        return logits.float(), new_state

    return init, apply


def make_model(cfg: MAMLConfig) -> Tuple[InitFn, ApplyFn]:
    """Backbone dispatch: ``vgg`` (batch or layer norm), ``resnet12``,
    ``mlp``."""
    if cfg.backbone == "vgg":
        return make_vgg(cfg)
    if cfg.backbone == "resnet12":
        return make_resnet12(cfg)
    if cfg.backbone == "mlp":
        return make_mlp(cfg)
    raise ValueError(f"unknown backbone {cfg.backbone!r}")
