"""VGG-style few-shot backbone as an init/apply pair (counterpart of the
JAX ``models/vgg.py``).

``num_stages`` blocks of [3x3 conv (``cnn_num_filters``) → per-step BN →
ReLU → 2x2 max-pool] → flatten (NHWC order) → linear to
``num_output_units`` logits::

    init(generator)                                  -> (params, bn_state)
    apply(params, bn_state, x, step, training, plain=False)
                                                     -> (logits, new_state)

``init`` returns one task's tensors (no task axis), on the CPU.
``apply`` takes a task-batched forward: every params/state leaf has a
leading task axis ``T`` (tree.stack_tasks), ``x`` is ``(T, N, H, W, C)``
NHWC, logits are ``(T, N, out)`` f32. ``plain=True`` runs the BN
kernel's plain PyTorch version (bn_backend='pallas' only).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.models import layers

Params = Dict[str, Any]
State = Dict[str, Any]
InitFn = Callable[[torch.Generator], Tuple[Params, State]]
ApplyFn = Callable[..., Tuple[torch.Tensor, State]]


def _compute_dtype(cfg: MAMLConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _stage_geometry(cfg: MAMLConfig) -> Tuple[int, int]:
    """Spatial size after the conv tower (conv → optional pool per stage),
    with the JAX package's SAME/VALID arithmetic."""
    h, w, _ = cfg.image_shape
    stride = 1 if cfg.max_pooling else 2
    for _ in range(cfg.num_stages):
        if cfg.conv_padding:
            h, w = -(-h // stride), -(-w // stride)
        else:
            h, w = (h - 3) // stride + 1, (w - 3) // stride + 1
        if cfg.max_pooling:
            h, w = (h - 2) // 2 + 1, (w - 2) // 2 + 1
        if h <= 0 or w <= 0:
            raise ValueError(
                f"image {cfg.image_shape[:2]} too small for "
                f"{cfg.num_stages} stages")
    return h, w


def _features_apply(cfg: MAMLConfig, params: Params, state: State,
                    x: torch.Tensor, step: int, training: bool,
                    plain: bool) -> Tuple[torch.Tensor, State]:
    """Conv tower: ``(T, N, H, W, C)`` -> ``(T, N, features)`` and the
    new norm state."""
    num_tasks = x.shape[0]
    compute_dtype = _compute_dtype(cfg)
    stride = 1 if cfg.max_pooling else 2
    padding = "SAME" if cfg.conv_padding else "VALID"
    h = layers.to_task_channels(x)
    new_state: State = {}
    for i in range(cfg.num_stages):
        h = layers.conv2d_apply(params[f"conv{i}"], h, stride=stride,
                                padding=padding, compute_dtype=compute_dtype)
        h, new_state[f"norm{i}"] = layers.batch_norm_act_apply(
            cfg, params[f"norm{i}"], state[f"norm{i}"], h, step,
            training=training, negative_slope=0.0, plain=plain)
        if cfg.max_pooling:
            h = layers.max_pool2d(h)
    return layers.flatten_tasks(h, num_tasks), new_state


def make_vgg(cfg: MAMLConfig) -> Tuple[InitFn, ApplyFn]:
    """Build (init, apply) for the VGG backbone described by ``cfg``."""
    if cfg.norm_layer != "batch_norm":
        raise NotImplementedError(
            "norm_layer='layer_norm' is not ported yet (ROADMAP.md, port "
            "queue: resnet12/mlp and layer_norm)")
    _, _, c = cfg.image_shape
    num_steps = cfg.bn_num_steps

    def init(gen: torch.Generator) -> Tuple[Params, State]:
        params: Params = {}
        state: State = {}
        in_ch = c
        for i in range(cfg.num_stages):
            params[f"conv{i}"] = layers.conv2d_init(gen, in_ch,
                                                    cfg.cnn_num_filters)
            params[f"norm{i}"], state[f"norm{i}"] = layers.batch_norm_init(
                cfg.cnn_num_filters, num_steps)
            in_ch = cfg.cnn_num_filters
        fh, fw = _stage_geometry(cfg)
        params["linear"] = layers.linear_init(
            gen, fh * fw * cfg.cnn_num_filters, cfg.num_output_units)
        return params, state

    def apply(params: Params, state: State, x: torch.Tensor, step: int,
              training: bool, plain: bool = False
              ) -> Tuple[torch.Tensor, State]:
        feats, new_state = _features_apply(cfg, params, state, x, step,
                                           training, plain)
        logits = layers.linear_apply(params["linear"], feats,
                                     compute_dtype=_compute_dtype(cfg))
        return logits.float(), new_state

    return init, apply


def make_model(cfg: MAMLConfig) -> Tuple[InitFn, ApplyFn]:
    """Backbone dispatch. Only the VGG backbone is ported so far."""
    if cfg.backbone == "vgg":
        return make_vgg(cfg)
    if cfg.backbone in ("resnet12", "mlp"):
        raise NotImplementedError(
            f"backbone {cfg.backbone!r} is not ported yet (ROADMAP.md, "
            f"port queue: resnet12/mlp and layer_norm)")
    raise ValueError(f"unknown backbone {cfg.backbone!r}")
