"""ResNet-50 with the JAX package's numerics, and its global-batch BatchNorm.

Port of ``pytorch_operator_tpu/models/resnet.py`` (flax): the v1.5
bottleneck ResNet (stride on the 3x3), bf16 compute, f32 parameters and
batch statistics.  Three things of the flax module are not what
torchvision's ``resnet50`` does, and the port keeps each:

* ``SAME`` padding is lax's rule (``same_pads``): a stride-2 3x3 conv or
  max-pool on an even size pads 0 before and 1 after, not 1 and 1.
  Every conv and the max-pool pad by it (``-inf`` for the pool).
* BatchNorm is flax's: statistics in f32 as E[x^2] - E[x]^2 clipped at
  0, the running variance updated with that biased variance
  (``0.9 * ra + 0.1 * var``), the output cast back to the compute dtype.
* Under data parallelism the statistics are the global batch's, as the
  JAX trainer's GSPMD step reduces the batch mean over ``dp``.
  ``FlaxBatchNorm`` does so with one all-reduce of ``[sum x, sum x^2]``
  (2·C floats) over the model's process group in the forward, and one of
  ``[sum dy, sum dy·x_hat]`` in the closed-form backward.  It saves only
  the input (bf16) and the per-channel mean and rstd: the same formula
  as plain ops under autograd would keep several f32 copies of every
  activation.

Layout: images arrive NHWC as in JAX; ``ResNet.forward`` permutes them
to NCHW, which for a contiguous NHWC tensor is ``torch.channels_last``
without a copy (``resnet50`` and ``resnet18_thin`` put the conv weights
in that format).  Convolutions and the max-pool are PyTorch's (cuDNN on the card),
as the JAX package leaves them to XLA: the ResNet path runs no kernel of
this package.  ``load_jax_params`` carries a flax ``(params,
batch_stats)`` pair across and ``to_jax`` gives it back.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from pytorch_operator_tpu_torch.device import default_device
from pytorch_operator_tpu_torch.telemetry.spans import span

MOMENTUM = 0.9
EPSILON = 1e-5
# flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled so that its variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """lax's ``SAME`` padding of one spatial dim: the output is
    ceil(size / s) and the total padding ``max((out - 1)·s + k - size,
    0)`` splits with the smaller half before."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """``nn.Conv(use_bias=False, dtype=dtype)``: input and kernel cast to
    the compute dtype; ``padding`` "SAME" or explicit ((lo, hi), (lo,
    hi)) pairs for H and W."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding="SAME", *, dtype: torch.dtype, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            cout, cin, k, k, device=device, dtype=torch.float32))
        self.k, self.stride, self.padding, self.dtype = (
            k, stride, padding, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == "SAME":
            (t, b), (l, r) = (same_pads(n, self.k, self.stride)
                              for n in x.shape[2:])
        else:
            (t, b), (l, r) = self.padding
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        if t == b and l == r:
            return F.conv2d(x, w, stride=self.stride, padding=(t, l))
        return F.conv2d(F.pad(x, (l, r, t, b)), w, stride=self.stride)


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """``nn.max_pool(x, (k, k), strides=(s, s), padding="SAME")``."""
    (t, b), (l, r) = (same_pads(n, k, s) for n in x.shape[2:])
    if (t, l) != (b, r):
        x = F.pad(x, (l, r, t, b), value=-math.inf)
        t = l = 0
    return F.max_pool2d(x, k, s, padding=(t, l))


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


class _GlobalBatchNorm(torch.autograd.Function):
    """flax's training-mode BatchNorm over the batch of every rank of
    ``group`` (None: this process's batch).  Updates the running
    statistics in place."""

    @staticmethod
    def forward(ctx, x, scale, bias, ra_mean, ra_var, group):
        dims = (0, 2, 3)
        xf = x.float()
        sums = torch.stack([xf.sum(dims), xf.square().sum(dims)])
        n = x.numel() // x.shape[1]
        if group is not None:
            dist.all_reduce(sums, group=group)
            n *= dist.get_world_size(group)
        mean, mean_sq = sums / n
        var = torch.clamp(mean_sq - mean.square(), min=0.0)
        rstd = torch.rsqrt(var + EPSILON)
        y = (xf - _channel(mean)) * _channel(rstd * scale) + _channel(bias)
        ra_mean.copy_(MOMENTUM * ra_mean + (1 - MOMENTUM) * mean)
        ra_var.copy_(MOMENTUM * ra_var + (1 - MOMENTUM) * var)
        ctx.save_for_backward(x, mean, rstd, scale)
        ctx.group, ctx.n = group, n
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, mean, rstd, scale = ctx.saved_tensors
        with span("batch_norm"):
            dims = (0, 2, 3)
            dyf = dy.float()
            x_hat = (x.float() - _channel(mean)) * _channel(rstd)
            sums = torch.stack([dyf.sum(dims), (dyf * x_hat).sum(dims)])
            # the parameters' gradients are this rank's sums: the
            # data-parallel gradient average makes them the global batch's
            dbias, dscale = sums.clone()
            if ctx.group is not None:
                dist.all_reduce(sums, group=ctx.group)
            mean_dy, mean_dy_xhat = sums / ctx.n
            dx = _channel(scale * rstd) * (
                dyf - _channel(mean_dy) - x_hat * _channel(mean_dy_xhat))
        return dx.to(x.dtype), dscale, dbias, None, None, None


class FlaxBatchNorm(nn.Module):
    """``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW: ``scale``/
    ``bias`` parameters and ``mean``/``var`` running statistics in f32, the
    output in the input's dtype (the conv's, the model's compute dtype).
    In training mode the statistics are those of the batch of every rank
    of ``group`` (a process group, or None for this process's batch
    alone); in eval mode the running ones, left as they are."""

    def __init__(self, channels: int, *, device, group=None):
        super().__init__()
        kw = dict(device=device, dtype=torch.float32)
        self.scale = nn.Parameter(torch.ones(channels, **kw))
        self.bias = nn.Parameter(torch.zeros(channels, **kw))
        self.register_buffer("mean", torch.zeros(channels, **kw))
        self.register_buffer("var", torch.ones(channels, **kw))
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # chip_smoke.py's profile classes the BatchNorm by its span
        with span("batch_norm"):
            if self.training:
                return _GlobalBatchNorm.apply(x, self.scale, self.bias,
                                              self.mean, self.var,
                                              self.group)
            return _eval_batch_norm(x, self.scale, self.bias, self.mean,
                                    self.var)


def _eval_batch_norm(x, scale, bias, mean, var) -> torch.Tensor:
    """flax's normalisation by given statistics (eval mode's), in plain
    ops: (x - mean) · rsqrt(var + eps) · scale + bias in f32, cast to
    x's dtype."""
    mul = torch.rsqrt(var + EPSILON) * scale
    y = (x.float() - _channel(mean)) * _channel(mul) + _channel(bias)
    return y.to(x.dtype)


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int, *,
                 dtype: torch.dtype, device, group=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        bn = dict(device=device, group=group)
        cout = filters * 4
        self.conv0 = Conv(cin, filters, 1, **kw)
        self.bn0 = FlaxBatchNorm(filters, **bn)
        self.conv1 = Conv(filters, filters, 3, stride, **kw)
        self.bn1 = FlaxBatchNorm(filters, **bn)
        self.conv2 = Conv(filters, cout, 1, **kw)
        self.bn2 = FlaxBatchNorm(cout, **bn)
        # flax projects where the residual's shape differs from the
        # block's output: in both models the channels differ exactly there
        self.conv_proj = self.norm_proj = None
        if cin != cout or stride != 1:
            self.conv_proj = Conv(cin, cout, 1, stride, **kw)
            self.norm_proj = FlaxBatchNorm(cout, **bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn0(self.conv0(x)))
        y = F.relu(self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        if self.conv_proj is not None:
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y)


class ResNet(nn.Module):
    """The flax ``ResNet``: images (B, H, W, 3) NHWC -> f32 logits."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 *, device=None, group=None):
        super().__init__()
        dev = default_device(device)
        kw = dict(dtype=dtype, device=dev)
        # the data-parallel group: the BatchNorms' statistics and the
        # trainer's gradient average run over it
        self.dtype, self.group = dtype, group
        self.conv_init = Conv(3, num_filters, 7, 2, ((3, 3), (3, 3)), **kw)
        self.bn_init = FlaxBatchNorm(num_filters, device=dev, group=group)
        blocks, cin = [], num_filters
        for i, size in enumerate(stage_sizes):
            for j in range(size):
                filters = num_filters * 2 ** i
                blocks.append(BottleneckBlock(
                    cin, filters, 2 if i > 0 and j == 0 else 1, group=group,
                    **kw))
                cin = filters * 4
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes, device=dev,
                              dtype=torch.float32)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.conv_init(images.permute(0, 3, 1, 2))
        x = max_pool_same(F.relu(self.bn_init(x)))
        for block in self.blocks:
            x = block(x)
        # jnp.mean of the compute dtype: summed in f32, rounded to it
        x = x.float().mean((2, 3)).to(self.dtype)
        return self.head(x.float())


def resnet50(num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16,
             *, device=None, group=None,
             generator: torch.Generator | None = None) -> ResNet:
    """ResNet-50 (25.56M parameters at 1000 classes), initialised by
    ``init_params``, its conv weights channels_last."""
    model = ResNet([3, 4, 6, 3], num_classes, dtype=dtype, device=device,
                   group=group)
    return _ready(model, generator)


def resnet18_thin(num_classes: int = 10, dtype: torch.dtype = torch.float32,
                  *, device=None, group=None,
                  generator: torch.Generator | None = None) -> ResNet:
    """The small variant for tests and smoke runs."""
    model = ResNet([1, 1], num_classes, num_filters=8, dtype=dtype,
                   device=device, group=group)
    return _ready(model, generator)


def _ready(model: ResNet, generator) -> ResNet:
    # channels_last conv weights, as the permuted NHWC images are: their
    # gradients then come in the weights' own strides (DDP's buckets)
    return init_params(model, generator).to(memory_format=torch.channels_last)


@torch.no_grad()
def init_params(model: ResNet,
                generator: torch.Generator | None = None) -> ResNet:
    """flax's initialisers: conv and dense kernels lecun-normal
    (truncated), the last BatchNorm scale of each block zero, the other
    scales one, biases zero; running mean 0 and variance 1.
    ``generator`` (seed 0 when none is given) lives on the model's device
    and gives other numbers than ``jax.random``: parity tests carry the
    weights across with ``load_jax_params``."""
    dev = model.head.weight.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    for m in model.modules():
        if isinstance(m, (Conv, nn.Linear)):
            w = m.weight
            fan_in = w[0].numel()
            std = fan_in ** -0.5 / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        elif isinstance(m, FlaxBatchNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()
            m.mean.zero_()
            m.var.fill_(1.0)
    for block in model.blocks:
        block.bn2.scale.zero_()
    model.head.bias.zero_()
    return model


def apply(model: nn.Module, images: torch.Tensor,
          train: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(logits, batch_stats)`` as the JAX ``apply``: in training mode the
    BatchNorms normalise by the batch's statistics and update the running
    ones in place; in eval mode they use the running ones and leave them
    as they were.  ``batch_stats`` maps each running statistic's name to
    the model's own buffer.  ``model`` may be a DistributedDataParallel
    wrapper of a ``ResNet``."""
    model.train(train)
    logits = model(images)
    return logits, batch_stats(getattr(model, "module", model))


def batch_stats(model: ResNet) -> Dict[str, torch.Tensor]:
    return {name: buf for name, buf in model.named_buffers()}


# ----------------------------------------------------------------------
# the JAX layout
# ----------------------------------------------------------------------


def _jax_names(model: ResNet):
    """(JAX path, module) of every conv, BatchNorm and the Dense."""
    yield ("conv_init",), model.conv_init
    yield ("bn_init",), model.bn_init
    for i, block in enumerate(model.blocks):
        scope = f"BottleneckBlock_{i}"
        for k in range(3):
            yield (scope, f"Conv_{k}"), getattr(block, f"conv{k}")
            yield (scope, f"BatchNorm_{k}"), getattr(block, f"bn{k}")
        if block.conv_proj is not None:
            yield (scope, "conv_proj"), block.conv_proj
            yield (scope, "norm_proj"), block.norm_proj
    yield ("Dense_0",), model.head


# the JAX layout's axes in the order of the port's: conv kernels HWIO ->
# OIHW, the Dense kernel (in, out) -> (out, in)
_TO_TORCH = {4: (3, 2, 0, 1), 2: (1, 0), 1: (0,)}
_TO_JAX = {4: (2, 3, 1, 0), 2: (1, 0), 1: (0,)}


def _leaves(module) -> Dict[Tuple[str, str], torch.Tensor]:
    """Each JAX leaf of a module: (collection, name) -> its tensor."""
    if isinstance(module, Conv):
        return {("params", "kernel"): module.weight}
    if isinstance(module, nn.Linear):
        return {("params", "kernel"): module.weight,
                ("params", "bias"): module.bias}
    return {("params", "scale"): module.scale,
            ("params", "bias"): module.bias,
            ("batch_stats", "mean"): module.mean,
            ("batch_stats", "var"): module.var}


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


@torch.no_grad()
def load_jax_params(model: ResNet, params, batch_stats) -> ResNet:
    """Copy a flax ``(params, batch_stats)`` pair (nested dicts of
    arrays) into ``model``: conv kernels HWIO -> OIHW, the Dense kernel
    transposed, BatchNorm ``scale``/``bias`` and ``mean``/``var`` by name.
    Every leaf of both trees is used exactly once, and every tensor of
    the model is written: anything else raises."""
    trees = {"params": _flatten(params), "batch_stats": _flatten(batch_stats)}
    used = {c: set() for c in trees}
    for path, module in _jax_names(model):
        for (collection, leaf), t in _leaves(module).items():
            key = path + (leaf,)
            if key not in trees[collection]:
                raise KeyError(f"{collection}/{'/'.join(key)} is missing")
            a = np.asarray(trees[collection][key], np.float32)
            a = a.transpose(_TO_TORCH[a.ndim])
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{collection}/{'/'.join(key)}: shape "
                                 f"{tuple(a.shape)} does not fit "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.tensor(a))  # a copy: JAX's arrays are read-only
            used[collection].add(key)
    for collection, tree in trees.items():
        extra = sorted("/".join(k) for k in set(tree) - used[collection])
        if extra:
            raise ValueError(f"{collection} leaves the model has no place "
                             f"for: {extra}")
    return model


def to_jax(model: ResNet) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The inverse of ``load_jax_params``: ``(params, batch_stats)`` as
    nested dicts of f32 numpy arrays in the flax layout."""
    out = {"params": {}, "batch_stats": {}}
    for path, module in _jax_names(model):
        for (collection, leaf), t in _leaves(module).items():
            a = t.detach().float().cpu().numpy()
            node = out[collection]
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = np.ascontiguousarray(a.transpose(_TO_JAX[a.ndim]))
    return out["params"], out["batch_stats"]


def n_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
