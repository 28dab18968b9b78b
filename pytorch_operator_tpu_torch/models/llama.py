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
plain versions on CPU tensors).  ``cfg.remat`` with no policy is
per-layer ``torch.utils.checkpoint``; the JAX ``save_attn*`` tiers and
``auto_remat_policy`` are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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
    # None: full per-layer remat.  The JAX tiers ("save_attn[+...]",
    # jax.checkpoint_policies names, "auto") are not ported yet.
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
        x = rms_norm(h, self.attn_norm, cfg.norm_eps, cfg.use_fused_norm)
        q = apply_rope(self.wq(x).view(B, T, nh, hd), cos, sin)
        k = apply_rope(self.wk(x).view(B, T, nkv, hd), cos, sin)
        v = self.wv(x).view(B, T, nkv, hd)
        attn = _attention(q, k, v, cfg).reshape(B, T, nh * hd)
        h = h + self.wo(attn)
        x = rms_norm(h, self.mlp_norm, cfg.norm_eps, cfg.use_fused_norm)
        return h + self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))


class Llama(nn.Module):
    """Embed, L blocks, final norm and the weight-tied head."""

    def __init__(self, cfg: LlamaConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.remat and cfg.remat_policy is not None:
            raise NotImplementedError(
                f"remat_policy {cfg.remat_policy!r} is not ported yet; "
                f"remat=True with remat_policy=None is per-layer "
                f"torch.utils.checkpoint")
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
                h = checkpoint(block, h, cos, sin, use_reentrant=False)
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
