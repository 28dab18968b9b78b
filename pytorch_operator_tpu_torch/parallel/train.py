"""Single-device training step for the Llama model.

Port of the single-device half of ``pytorch_operator_tpu/parallel/
train.py``: next-token cross entropy (optionally with the tied head
applied per sequence chunk), the AdamW update and the global gradient
norm.  The JAX step is one jitted function over a mesh; here it is an
eager step over one device that updates the model and the optimizer in
place.  Mesh, sharding, the sequence-parallel and pipeline steps wait
for later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from pytorch_operator_tpu_torch.models.llama import Llama, LlamaConfig


@dataclasses.dataclass
class TrainState:
    model: Llama
    optimizer: torch.optim.Optimizer
    step: int = 0


def adamw(model: Llama, lr: float = 3e-4,
          weight_decay: float = 0.1) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=wd)`` in torch.

    Same betas (0.9, 0.999), eps 1e-8 outside the square root, bias
    correction, and decoupled decay lr * wd * param on every parameter.
    The moments take the parameter's dtype, as optax's default
    ``mu_dtype=None`` keeps them (bf16 moments for a bf16 model)."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def cross_entropy_loss(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy; logits (B,T,V), targets (B,T)."""
    V = logits.shape[-1]
    return F.cross_entropy(logits.float().reshape(-1, V),
                           targets.reshape(-1))


def _chunk_logp_sum(hc, embed, tc):
    logits = (hc @ embed.t()).float()
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(-1, tc[..., None]).sum()


def chunked_tied_ce(h: torch.Tensor, embed: torch.Tensor,
                    targets: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """Mean next-token CE with the tied head applied per T-chunk.

    h (B, T, D), embed (V, D), targets (B, T).  Equal to
    ``cross_entropy_loss(h @ embed^T, targets)``, but each chunk's
    (chunk, V) f32 logits are recomputed in the backward
    (``torch.utils.checkpoint``) instead of being kept, so the full
    (T, V) logits never exist at once.  A ragged last slice is a smaller
    chunk."""
    B, T, _ = h.shape
    chunk = min(chunk, T)
    total = h.new_zeros((), dtype=torch.float32)
    for i in range(0, T, chunk):
        total = total + checkpoint(_chunk_logp_sum, h[:, i:i + chunk], embed,
                                   targets[:, i:i + chunk],
                                   use_reentrant=False)
    return -total / (B * T)


def global_norm(grads) -> torch.Tensor:
    """sqrt(sum of squares) over every gradient, as ``optax.global_norm``
    (accumulated in f32)."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def make_train_step(
    cfg: LlamaConfig,
    model: Llama,
    optimizer: torch.optim.Optimizer,
    *,
    chunked_ce: bool = False,
    ce_chunk: int = 1024,
) -> Callable[[TrainState, torch.Tensor], tuple[TrainState, dict]]:
    """Build the training step ``step(state, batch) -> (state, metrics)``.

    ``batch`` is an integer (B, T+1) token array (numpy or tensor); the
    model trains on ``batch[:, :-1]`` against ``batch[:, 1:]``.  Metrics
    are ``loss`` and ``grad_norm`` (the global L2 norm of the gradients
    before the update), as 0-d tensors on the model's device.  The model
    and the optimizer update in place; the returned state carries the
    step count.  ``chunked_ce`` applies the tied head per ``ce_chunk``
    tokens (see chunked_tied_ce)."""
    if ce_chunk < 1:
        raise ValueError(f"ce_chunk must be >= 1, got {ce_chunk}")
    if model.cfg != cfg:
        raise ValueError("the model was built from another config")
    device = model.embed.device
    params = list(model.parameters())

    def loss_fn(batch: torch.Tensor) -> torch.Tensor:
        inputs, targets = batch[:, :-1], batch[:, 1:]
        if chunked_ce:
            h = model.forward_hidden(inputs)
            return chunked_tied_ce(h, model.embed, targets, ce_chunk)
        return cross_entropy_loss(model(inputs), targets)

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("state does not hold this step's model and "
                             "optimizer")
        if isinstance(batch, np.ndarray):
            batch = torch.from_numpy(batch)
        batch = batch.to(device=device, dtype=torch.long)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(batch)
        loss.backward()
        with torch.no_grad():
            gnorm = global_norm(p.grad for p in params if p.grad is not None)
        optimizer.step()
        return (TrainState(model, optimizer, state.step + 1),
                {"loss": loss.detach(), "grad_norm": gnorm})

    return step
