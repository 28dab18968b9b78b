"""MNIST CNN with the layers of the JAX package's model.

Port of ``pytorch_operator_tpu/models/mnist_cnn.py``: conv(1->20, k5),
relu, maxpool; conv(20->50, k5), relu, maxpool; fc(800->500), relu;
fc(500->10); log_softmax.  Images come as the loader gives them,
(B, 28, 28, 1) NHWC; the convolutions run NCHW, and the (B, 50, 4, 4)
activations are flattened in NHWC order (h, w, c) as the JAX model
flattens them, so fc1's weight is the JAX ``(800, 500)`` matrix
transposed.  ``load_jax_params`` carries the JAX weights across (HWIO
kernels to OIHW).  The model has no hand-written kernel: it is the
dist-MNIST workload's model, and its products are PyTorch's.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pytorch_operator_tpu_torch.device import default_device


class MnistCNN(nn.Module):
    def __init__(self, *, device=None, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = default_device(device)
        kw = dict(device=dev, dtype=dtype)
        self.conv1 = nn.Conv2d(1, 20, 5, **kw)
        self.conv2 = nn.Conv2d(20, 50, 5, **kw)
        self.fc1 = nn.Linear(800, 500, **kw)
        self.fc2 = nn.Linear(500, 10, **kw)
        init_params(self, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, 28, 28, 1) -> log-probs (B, 10)."""
        x = images.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.conv1(x)), 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order
        x = F.relu(self.fc1(x))
        return F.log_softmax(self.fc2(x), dim=-1)


@torch.no_grad()
def init_params(model: MnistCNN,
                generator: torch.Generator | None = None) -> MnistCNN:
    """The JAX ``init_params`` distributions: weights N(0, 1) * fan_in^-1/2
    drawn in f32 and cast, biases zero.  ``generator`` (seed 0 when none
    is given) lives on the model's device and gives other numbers than
    ``jax.random``: parity tests carry weights with ``load_jax_params``."""
    dev = model.fc1.weight.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    for layer in (model.conv1, model.conv2, model.fc1, model.fc2):
        w = layer.weight
        fan_in = w[0].numel()
        w.copy_(torch.randn(w.shape, generator=generator, device=dev,
                            dtype=torch.float32) * fan_in ** -0.5)
        layer.bias.zero_()
    return model


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.nll_loss(log_probs, labels.long())


def accuracy(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (log_probs.argmax(-1) == labels).float().mean()


def sgd(model: nn.Module, lr: float, momentum: float) -> torch.optim.SGD:
    """``optax.sgd(lr, momentum)``: trace m = g + momentum * m (no
    dampening, no Nesterov), update -lr * m."""
    return torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum,
                           dampening=0.0, nesterov=False)


_LAYERS = ("conv1", "conv2", "fc1", "fc2")


@torch.no_grad()
def load_jax_params(model: MnistCNN, tree: Dict[str, Any]) -> MnistCNN:
    """Copy a JAX ``init_params`` tree (``{layer: {"w", "b"}}`` of numpy
    arrays) into ``model``: conv kernels HWIO -> OIHW, dense matrices
    (in, out) -> (out, in)."""
    for name in _LAYERS:
        layer = getattr(model, name)
        w = np.asarray(tree[name]["w"], np.float32)
        w = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T
        for p, a in ((layer.weight, w), (layer.bias, tree[name]["b"])):
            t = torch.from_numpy(np.array(a, np.float32))  # own copy
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)} does not "
                                 f"fit {tuple(p.shape)}")
            p.copy_(t)
    return model


def params_to_numpy(model: MnistCNN) -> Dict[str, Any]:
    """The inverse of ``load_jax_params``: the JAX layout, in f32."""
    out = {}
    for name in _LAYERS:
        layer = getattr(model, name)
        w = layer.weight.detach().float().cpu().numpy()
        w = w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T
        out[name] = {"w": np.ascontiguousarray(w),
                     "b": layer.bias.detach().float().cpu().numpy()}
    return out
