"""Llama-family decoder-only transformer in PyTorch.

Port of ``pytorch_operator_tpu/models/llama.py``: the same config, the
same initial distributions, GQA, half-split RoPE, RMSNorm, SwiGLU and a
weight-tied output head whose logits are cast to f32.  The JAX model
scans a stack of layer parameters with a leading L axis; here the
blocks are an ``nn.ModuleList``, and the projections are ``nn.Linear``s
whose weights are the transposes of the JAX ``(in, out)`` matrices.
``load_jax_params`` / ``params_to_numpy`` carry weights across.

``cfg.use_flash`` routes attention through the CUDA flash kernels and
``cfg.use_fused_norm`` the norms through the CUDA RMSNorm kernel (the
plain versions on CPU tensors).  ``cfg.remat`` checkpoints each layer
(non-reentrant ``torch.utils.checkpoint``); ``cfg.remat_policy`` picks
what the layer keeps, as the JAX ``make_layer_body`` does (see
``remat_context_fn``), and ``auto_remat_policy`` picks a tier from the
device's memory headroom.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from pytorch_operator_tpu_torch import ops
from pytorch_operator_tpu_torch.device import default_device
from pytorch_operator_tpu_torch.ops.rms_norm import rms_norm_reference


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False
    # None: full per-layer remat (save nothing, recompute the layer in
    # the backward).  "save_attn" keeps the flash forward's (out, lse)
    # pair per layer, so the O(T^2) forward kernel is never recomputed
    # (requires use_flash); "save_attn+<group>[+<group>...]" also keeps
    # the LAYER_SAVE_GROUPS intermediates; "dots_saveable" and
    # "dots_with_no_batch_dims_saveable" are the jax.checkpoint_policies
    # of those names.  "auto" must be resolved by auto_remat_policy first.
    remat_policy: Any = None
    use_flash: bool = False       # CUDA flash-attention kernels (ops/)
    use_fused_norm: bool = False  # CUDA RMSNorm kernel (ops/)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def __post_init__(self):
        if self.dim % self.n_heads:
            raise ValueError("dim must be divisible by n_heads")
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be divisible by n_kv_heads")


def llama2_7b(**kw) -> LlamaConfig:
    """Llama-2-7B."""
    defaults = dict(
        vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
        n_kv_heads=32, ffn_dim=11008, max_seq_len=4096,
    )
    defaults.update(kw)
    return LlamaConfig(**defaults)


def tiny(**kw) -> LlamaConfig:
    """Small config for tests."""
    defaults = dict(
        vocab_size=512, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
        ffn_dim=256, max_seq_len=256, dtype=torch.float32,
    )
    defaults.update(kw)
    return LlamaConfig(**defaults)


def flagship(**kw) -> LlamaConfig:
    """The single-device flagship: d2048 L16 h16 ffn5632, about 888M
    parameters, bf16, no remat, both kernels on
    (``scripts/bench_detail.py`` ``bench_llama_mfu``)."""
    defaults = dict(
        vocab_size=32000, dim=2048, n_layers=16, n_heads=16,
        n_kv_heads=16, ffn_dim=5632, max_seq_len=2048,
        dtype=torch.bfloat16, remat=False, use_flash=True,
        use_fused_norm=True,
    )
    defaults.update(kw)
    return LlamaConfig(**defaults)


# ---------------------------------------------------------------------------
# Forward pieces


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             fused: bool = False) -> torch.Tensor:
    """``fused``: the CUDA kernel with its analytic backward (ops/);
    else the plain version, differentiated by autograd."""
    if fused:
        return ops.rms_norm(x, weight, eps)
    return rms_norm_reference(x, weight, eps)


def rope_table(cfg: LlamaConfig, seq_len: int,
               device: torch.device | str = "cpu"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    half = cfg.head_dim // 2
    freqs = cfg.rope_theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=device) / half)
    angles = (torch.arange(seq_len, dtype=torch.float32,
                           device=device)[:, None] * freqs[None, :])
    return torch.cos(angles), torch.sin(angles)  # each (T, head_dim // 2)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    # x: (B, T, H, Dh); half-split: rotate (x[:Dh/2], x[Dh/2:]) pairs
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _attention(q, k, v, cfg: LlamaConfig):
    """Causal attention (B,T,H,Dh) x (B,T,KV,Dh) with GQA broadcast."""
    B, T, H, Dh = q.shape
    groups = cfg.n_heads // cfg.n_kv_heads
    if cfg.use_flash:
        return ops.flash_attention(q, k, v, causal=True)
    if groups > 1:
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q, k).float()
    scores = scores * (Dh ** -0.5)
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


# ---------------------------------------------------------------------------
# Rematerialisation tiers


# What each "save_attn+<group>" keeps beside the flash (out, lse) pair
# (the JAX module's LAYER_SAVE_GROUPS, whose checkpoint names become
# regions of Block.forward here):
#   qkv    the q/k/v projections -- skips re-running the three matmuls;
#          RoPE, elementwise, is recomputed from them
#   gateup the SwiGLU gate and up projections -- skips the two D x ffn_dim
#          matmuls; silu is recomputed
#   normed the two RMSNorm outputs -- skips only the norm recompute;
#          they stay the d/dW inputs of the projections either way (the
#          fused norm is one operator; the plain one keeps each of its
#          operators' outputs)
# Each keeps the same bytes per token as the JAX tier (auto_remat_policy
# prices them so), the plain norm's f32 intermediates aside.
LAYER_SAVE_GROUPS = ("qkv", "gateup", "normed")

# jax.checkpoint_policies ported, by the products they save: a dot with
# no batch dims is an mm here, a batched one a bmm.
DOTS_POLICIES = {
    "dots_saveable": (torch.ops.aten.mm.default, torch.ops.aten.bmm.default),
    "dots_with_no_batch_dims_saveable": (torch.ops.aten.mm.default,),
}

# The save group whose region Block.forward is in (None outside), read by
# the checkpoint policy as each operator runs.  Block.forward sets it on
# every call, remat or not.  The policy is right only while three things
# hold: forward and recompute run the same Block.forward, so they set the
# regions alike and the policy sees the same sequence both times; regions
# never nest (leaving one resets it to None, not to an outer one); and
# one forward or recompute runs at a time in the process (it is a module
# global, not per thread, because the recompute runs on autograd's device
# thread).
_region: str | None = None


@contextlib.contextmanager
def _save_region(group: str):
    global _region
    _region = group
    try:
        yield
    finally:
        _region = None


def _selective_policy(save_ops: tuple, groups: frozenset):
    def policy(ctx, op, *args, **kwargs):
        if op in save_ops or (_region in groups and not op.is_view):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def remat_context_fn(cfg: LlamaConfig) -> Callable:
    """The ``context_fn`` of each layer's checkpoint for
    ``cfg.remat_policy`` (``noop_context_fn``, full remat, for None), as
    JAX ``make_layer_body`` wraps the layer in ``jax.checkpoint``.

    The tiers are selective checkpointing: the policy marks the
    operators whose outputs the layer keeps (``MUST_SAVE``) and the
    checkpoint's recompute takes those from the forward instead of
    running them again.  ``save_attn`` keeps ``ptt::flash_fwd``'s
    (out, lse); each save group keeps the outputs of the operators in its
    region of ``Block.forward`` (views aside).  Raises as the JAX module
    does for ``auto``, ``save_attn`` without ``use_flash`` and an unknown
    group, and ``NotImplementedError`` for any other policy name."""
    policy = cfg.remat_policy
    if policy is None:
        return noop_context_fn
    if policy == "auto":
        raise ValueError(
            "remat_policy='auto' is a selection request, not a policy: "
            "resolve it with llama.auto_remat_policy(cfg, batch, seq_len, "
            "...) and set the returned tier on the config (train_llama "
            "does this for --remat-policy auto)")
    if isinstance(policy, str) and (policy == "save_attn"
                                    or policy.startswith("save_attn+")):
        if not cfg.use_flash:
            raise ValueError(
                "remat_policy='save_attn...' saves the flash kernel's "
                "(out, lse) residuals and requires use_flash=True")
        groups = policy.split("+")[1:]
        for group in groups:
            if group not in LAYER_SAVE_GROUPS:
                raise ValueError(
                    f"unknown save group {group!r} in remat_policy "
                    f"{policy!r}; known: {sorted(LAYER_SAVE_GROUPS)}")
        save_ops, groups = (torch.ops.ptt.flash_fwd.default,), frozenset(
            groups)
    elif policy in DOTS_POLICIES:
        save_ops, groups = DOTS_POLICIES[policy], frozenset()
    else:
        raise NotImplementedError(
            f"remat_policy {policy!r} is not ported; ported: None (full "
            f"remat), 'save_attn[+qkv][+gateup][+normed]', "
            f"{', '.join(repr(p) for p in DOTS_POLICIES)} and 'auto' "
            f"(resolved by auto_remat_policy)")
    return functools.partial(create_selective_checkpoint_contexts,
                             _selective_policy(save_ops, groups))


def auto_remat_policy(
    cfg: LlamaConfig,
    batch: int,
    seq_len: int,
    *,
    hbm_gb: float = 16.0,
    reserve_gb: float = 2.5,
    state_shards: int = 1,
    token_shards: int = 1,
) -> str:
    """Pick the richest save_attn tier whose residuals fit the device.

    A copy of the JAX ``auto_remat_policy``: the budget is ``hbm_gb``
    (GiB of device memory) minus params + optimizer state (AdamW moments
    in the param dtype) minus a transient ``reserve_gb``; each tier's
    per-layer saved residuals are priced per token and the richest tier
    that fits wins.  ``state_shards`` divides the params and optimizer
    state, ``token_shards`` the activations.  Tiers are ordered by
    recompute removed per saved byte: the SwiGLU branches and q/k/v
    carry about equal FLOPs per byte, the norm outputs only skip a
    bandwidth-bound recompute, so they come last."""
    dsize = cfg.dtype.itemsize
    state_bytes = n_params(cfg) * (dsize + 2 * dsize)  # params + mu + nu
    budget = (hbm_gb - reserve_gb) * 2 ** 30 - state_bytes / state_shards
    tokens = batch * seq_len / token_shards
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

    # bytes/token of saved residuals per layer, by component
    base = dsize * cfg.dim          # the layer-input residual h
    flash = dsize * nh * hd + 4 * nh   # flash out (dtype) + lse (f32)
    per_group = {
        "qkv": dsize * hd * (nh + 2 * nkv),
        "gateup": dsize * 2 * cfg.ffn_dim,
        "normed": dsize * 2 * cfg.dim,
    }
    for tier in ("save_attn+qkv+gateup+normed", "save_attn+qkv+gateup",
                 "save_attn+gateup", "save_attn+qkv",
                 "save_attn+normed", "save_attn"):
        per_token = base + flash + sum(
            per_group[g] for g in tier.split("+")[1:])
        if cfg.n_layers * tokens * per_token <= budget:
            return tier
    return "save_attn"


class Block(nn.Module):
    """One decoder layer: the JAX ``_layer``."""

    def __init__(self, cfg: LlamaConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        D, F_, hd = cfg.dim, cfg.ffn_dim, cfg.head_dim
        kw = dict(bias=False, device=device, dtype=cfg.dtype)
        self.attn_norm = nn.Parameter(torch.ones(D, device=device,
                                                 dtype=cfg.dtype))
        self.wq = nn.Linear(D, cfg.n_heads * hd, **kw)
        self.wk = nn.Linear(D, cfg.n_kv_heads * hd, **kw)
        self.wv = nn.Linear(D, cfg.n_kv_heads * hd, **kw)
        self.wo = nn.Linear(cfg.n_heads * hd, D, **kw)
        self.mlp_norm = nn.Parameter(torch.ones(D, device=device,
                                                dtype=cfg.dtype))
        self.w_gate = nn.Linear(D, F_, **kw)
        self.w_up = nn.Linear(D, F_, **kw)
        self.w_down = nn.Linear(F_, D, **kw)

    def forward(self, h, cos, sin):
        cfg = self.cfg
        B, T, _ = h.shape
        hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        # the save-group regions matter only under a selective remat
        # policy (remat_context_fn); elsewhere they change nothing
        with _save_region("normed"):
            x = rms_norm(h, self.attn_norm, cfg.norm_eps,
                         cfg.use_fused_norm)
        with _save_region("qkv"):
            q, k, v = self.wq(x), self.wk(x), self.wv(x)
        q = apply_rope(q.view(B, T, nh, hd), cos, sin)
        k = apply_rope(k.view(B, T, nkv, hd), cos, sin)
        attn = _attention(q, k, v.view(B, T, nkv, hd), cfg)
        h = h + self.wo(attn.reshape(B, T, nh * hd))
        with _save_region("normed"):
            x = rms_norm(h, self.mlp_norm, cfg.norm_eps, cfg.use_fused_norm)
        with _save_region("gateup"):
            gate, up = self.w_gate(x), self.w_up(x)
        return h + self.w_down(F.silu(gate) * up)


class Llama(nn.Module):
    """Embed, L blocks, final norm and the weight-tied head."""

    def __init__(self, cfg: LlamaConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        # the layers' checkpoint context (raises on a policy it cannot
        # run, as the JAX model does when it builds the layer body)
        self.remat_context = remat_context_fn(cfg) if cfg.remat else None
        dev = default_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.dim,
                                              device=dev, dtype=cfg.dtype))
        self.layers = nn.ModuleList(Block(cfg, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.ones(cfg.dim, device=dev,
                                                  dtype=cfg.dtype))
        init_params(self, generator)

    def _forward_with(self, tokens: torch.Tensor,
                      return_hidden: bool = False) -> torch.Tensor:
        cfg = self.cfg
        h = F.embedding(tokens, self.embed)
        cos, sin = rope_table(cfg, tokens.shape[1], h.device)
        for block in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                h = checkpoint(block, h, cos, sin, use_reentrant=False,
                               context_fn=self.remat_context)
            else:
                h = block(h, cos, sin)
        h = rms_norm(h, self.final_norm, cfg.norm_eps, cfg.use_fused_norm)
        if return_hidden:
            return h
        # weight-tied output head; logits in the param dtype, then f32
        return (h @ self.embed.t()).float()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, T) int -> logits (B, T, vocab) float32."""
        return self._forward_with(tokens)

    def forward_hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, T) -> final-normed hidden states (B, T, dim)."""
        return self._forward_with(tokens, return_hidden=True)


def forward(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
    return model(tokens)


def forward_hidden(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
    return model.forward_hidden(tokens)


# ---------------------------------------------------------------------------
# Parameters


@torch.no_grad()
def init_params(model: Llama, generator: torch.Generator | None = None
                ) -> Llama:
    """Fill ``model`` with the JAX ``init_params`` distributions: every
    matrix N(0, 1) * fan_in^-1/2 drawn in f32 and cast, norms ones.

    ``generator`` lives on the model's device (one is made from seed 0
    when none is given); it gives other numbers than ``jax.random`` for
    the same seed, so parity tests carry weights across with
    ``load_jax_params``."""
    cfg = model.cfg
    dev = model.embed.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def dense(p: torch.Tensor, fan_in: int):
        p.copy_(torch.randn(p.shape, generator=generator, device=dev,
                            dtype=torch.float32) * fan_in ** -0.5)

    dense(model.embed, cfg.dim)
    for blk in model.layers:
        for lin in (blk.wq, blk.wk, blk.wv, blk.wo, blk.w_gate, blk.w_up,
                    blk.w_down):
            dense(lin.weight, lin.in_features)
        blk.attn_norm.fill_(1.0)
        blk.mlp_norm.fill_(1.0)
    model.final_norm.fill_(1.0)
    return model


_LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_NORMS = ("attn_norm", "mlp_norm")


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16 from jax arrays
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


@torch.no_grad()
def load_jax_params(model: Llama, tree: Dict[str, Any]) -> Llama:
    """Copy a JAX ``init_params``-layout tree of numpy arrays into
    ``model``: ``layers/*`` leaves carry a leading L axis, and matrices
    are ``(in, out)`` (used as ``x @ w``), transposed here into
    ``nn.Linear``'s ``(out, in)``."""

    def put(p: torch.Tensor, a) -> None:
        t = _to_torch(np.asarray(a))
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"shape {tuple(t.shape)} does not fit "
                             f"parameter {tuple(p.shape)}")
        p.copy_(t.to(p.dtype))

    put(model.embed, tree["embed"])
    put(model.final_norm, tree["final_norm"])
    layers = tree["layers"]
    for i, blk in enumerate(model.layers):
        for name in _LINEARS:
            put(getattr(blk, name).weight, np.asarray(layers[name][i]).T)
        for name in _NORMS:
            put(getattr(blk, name), layers[name][i])
    return model


def params_to_numpy(model: Llama) -> Dict[str, Any]:
    """The inverse of ``load_jax_params`` (bf16 comes back as f32)."""
    blocks = model.layers
    layers = {name: np.stack([_to_numpy(getattr(b, name).weight).T
                              for b in blocks]) for name in _LINEARS}
    layers.update({name: np.stack([_to_numpy(getattr(b, name))
                                   for b in blocks]) for name in _NORMS})
    return {"embed": _to_numpy(model.embed), "layers": layers,
            "final_norm": _to_numpy(model.final_norm)}


def n_params(cfg: LlamaConfig) -> int:
    """Parameter count (embed + layers + final norm)."""
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    D, F_, L = cfg.dim, cfg.ffn_dim, cfg.n_layers
    per_layer = (D * nh * hd + 2 * D * nkv * hd + nh * hd * D
                 + 3 * D * F_ + 2 * D)
    return cfg.vocab_size * D + L * per_layer + D
