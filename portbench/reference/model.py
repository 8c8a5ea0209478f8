"""The plain reference of the benchmark's two backbones, one task at a time.

Plain PyTorch in float32, NCHW, no fused kernel, no task packing, no
recomputation. It imports nothing of the program under test and reads
its hyper-parameters from the configuration file's ``maml_config``
mapping (:class:`Hyper`), never from the program's config class.

* VGG (MAML++, Antoniou et al., arXiv:1810.09502): ``num_stages`` x
  [3x3 conv, SAME padding -> per-step batch norm -> ReLU -> 2x2 max
  pool], flatten in (H, W, C) order, linear head.
* ResNet-12 (MetaOptNet, Lee et al., arXiv:1904.03758): four residual
  blocks of widths ``f * (1, 2.5, 5, 10)``, each 3 x [3x3 conv -> BN ->
  LeakyReLU(0.1)] with no activation after the third BN, a 1x1 conv ->
  BN projection skip, ``leaky_relu(x + skip, 0.1)``, 2x2 max pool; then
  the mean over H and W and a linear head.

Per-step batch norm (BNRS/BNWB): the statistics are the batch's own
(biased variance), gamma and beta are row ``row`` of ``(steps, C)``
tables. Parameter names and layouts (OIHW convs, ``(out, in)`` linear)
are those of the tables the benchmark makes (``lib/weights.py``).

:class:`Numerics` says how the arithmetic is rounded: not at all (the
reference, float32), or in float8 where the configuration states
bfloat16 (the control that ``correct`` must reject).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Dict[str, torch.Tensor]]

RESNET_WIDTH_MULTS = (1.0, 2.5, 5.0, 10.0)
RESNET_CONVS_PER_BLOCK = 3
LEAKY_SLOPE = 0.1
FP8_MAX = 448.0          # largest finite float8_e4m3fn
FP8_E5M2_MAX = 57344.0   # largest finite float8_e5m2


class Hyper(NamedTuple):
    """What the reference reads of a configuration (every key is
    required in the file: a key left to a default could differ from the
    program's default unseen)."""
    backbone: str
    image_shape: Tuple[int, int, int]
    num_classes: int
    shots: int
    targets: int
    num_stages: int
    filters: int
    train_steps: int
    eval_steps: int
    serve_steps: int
    per_step_bn: bool
    eps: float
    task_lr: float
    meta_lr: float
    min_lr: float
    total_epochs: int
    iters_per_epoch: int
    beta1: float
    beta2: float
    adam_eps: float
    clamp: Optional[float]
    learnable_gamma: bool
    learnable_beta: bool
    learnable_lslr: bool
    msl_epochs: int
    momentum: float
    image_mean: Tuple[float, ...]
    image_std: Tuple[float, ...]
    compute_dtype: str

    @property
    def bn_rows(self) -> int:
        return (max(self.train_steps, self.eval_steps)
                if self.per_step_bn else 1)

    @property
    def lslr_rows(self) -> int:
        return max(self.train_steps, self.eval_steps) + 1


def hyper(cfg: Dict[str, Any]) -> Hyper:
    """:class:`Hyper` of a ``maml_config`` mapping. Requires the keys the
    reference reads; the image constants follow the repository's stated
    convention (RGB pixels in [0, 1] mapped to [-1, 1]) unless given."""
    if cfg["conv_padding"] is not True or cfg["max_pooling"] is not True:
        raise ValueError("the reference has SAME convolutions with pooling")
    if cfg["norm_layer"] != "batch_norm":
        raise ValueError("the reference has batch norm only")
    if cfg["enable_inner_loop_optimizable_bn_params"]:
        raise ValueError("the reference keeps norm parameters out of the "
                         "inner loop")
    c = cfg["image_channels"]
    mean = cfg.get("image_norm_mean") or ((0.5,) * c if c > 1 else (0.0,))
    std = cfg.get("image_norm_std") or ((0.5,) * c if c > 1 else (1.0,))
    mean = tuple(mean) * (c if len(mean) == 1 else 1)
    std = tuple(std) * (c if len(std) == 1 else 1)
    eval_steps = cfg["number_of_evaluation_steps_per_iter"]
    return Hyper(
        backbone=cfg["backbone"],
        image_shape=(cfg["image_height"], cfg["image_width"], c),
        num_classes=cfg["num_classes_per_set"],
        shots=cfg["num_samples_per_class"],
        targets=cfg["num_target_samples"],
        num_stages=cfg["num_stages"], filters=cfg["cnn_num_filters"],
        train_steps=cfg["number_of_training_steps_per_iter"],
        eval_steps=eval_steps,
        serve_steps=cfg["serve_adapt_steps"] or eval_steps,
        per_step_bn=cfg["per_step_bn_statistics"],
        eps=cfg["batch_norm_eps"], task_lr=cfg["task_learning_rate"],
        meta_lr=cfg["meta_learning_rate"], min_lr=cfg["min_learning_rate"],
        total_epochs=cfg["total_epochs"],
        iters_per_epoch=cfg["total_iter_per_epoch"],
        beta1=cfg["meta_adam_beta1"], beta2=cfg["meta_adam_beta2"],
        adam_eps=cfg["meta_adam_eps"], clamp=cfg["clamp_meta_grad_value"],
        learnable_gamma=cfg["learnable_bn_gamma"],
        learnable_beta=cfg["learnable_bn_beta"],
        learnable_lslr=cfg[
            "learnable_per_layer_per_step_inner_loop_learning_rate"],
        msl_epochs=cfg["multi_step_loss_num_epochs"],
        momentum=cfg["batch_norm_momentum"],
        image_mean=tuple(float(m) for m in mean),
        image_std=tuple(float(s) for s in std),
        compute_dtype=cfg["compute_dtype"])


def _rounded(t: torch.Tensor, dtype: torch.dtype,
             largest: float) -> torch.Tensor:
    """``t`` scaled by ``largest / amax`` per tensor, rounded to ``dtype``
    and scaled back (a float8 operand with its per-tensor scale)."""
    scale = largest / t.detach().abs().amax().clamp(min=1e-30)
    return (t * scale).to(dtype).to(t.dtype) / scale


class _Fp8Operand(torch.autograd.Function):
    """Forward: the operand in float8 e4m3. Backward: the gradient that
    reaches it in float8 e5m2 (:class:`_Fp8Gradient`, itself
    differentiable, so a second-order step rounds its inner gradients
    too): the hybrid format of fp8 training."""

    @staticmethod
    def forward(ctx, t):
        return _rounded(t, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _Fp8Gradient.apply(g)


class _Fp8Gradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g):
        return _rounded(g, torch.float8_e5m2, FP8_E5M2_MAX)

    @staticmethod
    def backward(ctx, gg):
        return gg


class Numerics:
    """Operand rounding of convolutions and matrix products, and an
    optional log of batch-norm applications.

    ``fp8=False``: the operands as they are (float32), batch norm exact.
    ``fp8=True``: the configuration's arithmetic one precision lower,
    in float8 where it states bfloat16: every operand of a convolution
    or matrix product rounded to float8 e4m3 with a per-tensor scale and
    the gradient that reaches it to float8 e5m2 (:class:`_Fp8Operand`),
    accumulation in float32; batch norm in its fast-math form (float32
    statistics, then ``x * scale + shift`` with the scale, the shift
    and each result rounded, as the program does it in bfloat16).
    ``bn_log``: a list that receives ``(rows, channels)`` of every batch
    norm applied (the cost functions read it); ``bn_vars``: a list that
    receives each batch norm's per-channel unbiased batch variance."""

    def __init__(self, fp8: bool = False,
                 bn_log: Optional[List[Tuple[int, int]]] = None,
                 bn_vars: Optional[List[torch.Tensor]] = None):
        self.fp8 = fp8
        self.bn_log = bn_log
        self.bn_vars = bn_vars

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        return _Fp8Operand.apply(t) if self.fp8 else t


def normalize_images(hp: Hyper, x: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC pixels -> float32 NCHW, ``(x/255 - mean) / std``."""
    mean = torch.tensor(hp.image_mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(hp.image_std, dtype=torch.float32, device=x.device)
    xf = (x.float() / 255.0 - mean) / std
    return xf.permute(0, 3, 1, 2).contiguous()


def conv(x: torch.Tensor, p: Dict[str, torch.Tensor], padding: int,
         n: Numerics) -> torch.Tensor:
    return F.conv2d(n.operand(x), n.operand(p["w"]), p["b"],
                    padding=padding)


def linear(x: torch.Tensor, p: Dict[str, torch.Tensor],
           n: Numerics) -> torch.Tensor:
    return n.operand(x) @ n.operand(p["w"]).t() + p["b"]


def batch_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], row: int,
               hp: Hyper, n: Numerics, slope: float) -> torch.Tensor:
    """Batch-statistics BN over (N, H, W) with row ``row``'s gamma/beta,
    then ReLU (slope 0), LeakyReLU (0 < slope < 1) or nothing (1)."""
    if n.bn_log is not None:
        n.bn_log.append((x.shape[0] * x.shape[2] * x.shape[3], x.shape[1]))
    if n.bn_vars is not None:
        n.bn_vars.append(x.detach().var((0, 2, 3), unbiased=True))
    row = min(row, hp.bn_rows - 1)
    gamma = p["gamma"][row].view(1, -1, 1, 1)
    beta = p["beta"][row].view(1, -1, 1, 1)
    mean = x.mean((0, 2, 3), keepdim=True)
    var = x.var((0, 2, 3), unbiased=False, keepdim=True)
    if n.fp8:
        inv = torch.rsqrt(var + hp.eps)
        scale, shift = n.operand(inv * gamma), n.operand(beta - mean * inv
                                                         * gamma)
        y = n.operand(n.operand(n.operand(x) * scale) + shift)
    else:
        y = (x - mean) * torch.rsqrt(var + hp.eps) * gamma + beta
    if slope == 0.0:
        return F.relu(y)
    if slope == 1.0:
        return y
    return F.leaky_relu(y, slope)


def vgg(p: Params, x: torch.Tensor, row: int, hp: Hyper,
        n: Numerics) -> torch.Tensor:
    for i in range(hp.num_stages):
        x = conv(x, p[f"conv{i}"], 1, n)
        x = batch_norm(x, p[f"norm{i}"], row, hp, n, 0.0)
        x = F.max_pool2d(x, 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return linear(x, p["linear"], n)


def resnet12(p: Params, x: torch.Tensor, row: int, hp: Hyper,
             n: Numerics) -> torch.Tensor:
    for b in range(len(RESNET_WIDTH_MULTS)):
        skip = x
        for j in range(RESNET_CONVS_PER_BLOCK):
            x = conv(x, p[f"block{b}_conv{j}"], 1, n)
            x = batch_norm(x, p[f"block{b}_norm{j}"], row, hp, n,
                           LEAKY_SLOPE if j < RESNET_CONVS_PER_BLOCK - 1
                           else 1.0)
        skip = conv(skip, p[f"block{b}_skip_conv"], 0, n)
        skip = batch_norm(skip, p[f"block{b}_skip_norm"], row, hp, n, 1.0)
        x = F.max_pool2d(F.leaky_relu(x + skip, LEAKY_SLOPE), 2, 2)
    return linear(x.mean((2, 3)), p["linear"], n)


FORWARDS: Dict[str, Callable[..., torch.Tensor]] = {
    "vgg": vgg, "resnet12": resnet12}


def param_shapes(hp: Hyper) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """Every parameter table of the backbone, in forward order."""
    rows, c = hp.bn_rows, hp.image_shape[2]
    out: Dict[str, Dict[str, Tuple[int, ...]]] = {}
    norm = lambda width: {"gamma": (rows, width), "beta": (rows, width)}
    if hp.backbone == "vgg":
        h, w = hp.image_shape[:2]
        in_ch = c
        for i in range(hp.num_stages):
            out[f"conv{i}"] = {"w": (hp.filters, in_ch, 3, 3),
                               "b": (hp.filters,)}
            out[f"norm{i}"] = norm(hp.filters)
            in_ch = hp.filters
            h, w = h // 2, w // 2
        out["linear"] = {"w": (hp.num_classes, h * w * hp.filters),
                         "b": (hp.num_classes,)}
        return out
    if hp.backbone != "resnet12":
        raise ValueError(f"no reference for backbone {hp.backbone!r}")
    in_ch = c
    for b, mult in enumerate(RESNET_WIDTH_MULTS):
        width = int(hp.filters * mult)
        ch = in_ch
        for j in range(RESNET_CONVS_PER_BLOCK):
            out[f"block{b}_conv{j}"] = {"w": (width, ch, 3, 3),
                                        "b": (width,)}
            out[f"block{b}_norm{j}"] = norm(width)
            ch = width
        out[f"block{b}_skip_conv"] = {"w": (width, in_ch, 1, 1),
                                      "b": (width,)}
        out[f"block{b}_skip_norm"] = norm(width)
        in_ch = width
    out["linear"] = {"w": (hp.num_classes, in_ch), "b": (hp.num_classes,)}
    return out


def is_fast(name: str) -> bool:
    """Adapted in the inner loop: every table but the norms'."""
    return "norm" not in name
