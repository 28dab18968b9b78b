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

``forward_sp`` is the sequence-parallel forward of one rank: it runs the
stack on the rank's T/sp rows (RoPE at their true positions) with the
attention through a ring or an all-to-all over the sp group.  The JAX
``sp_param_specs`` / ``sp_fsdp_param_specs`` have no counterpart: the
parameters' layout on an sp mesh is ``parallel.train.sharded_init``'s
(replicated over sp, FSDP2 over the data dims, ``param_specs`` over tp).

``LlamaStage`` is one pipeline stage: the embedding and the final norm
(every stage holds them, as JAX ``pp_param_specs`` replicates them) and
the blocks of its contiguous layer range (``pp_param_specs``) under
their global names, so that ``load_jax_params``, ``params_to_numpy`` and
checkpoints see the plain model's keys.  ``forward_pipelined`` runs the
stack through ``parallel.pipeline.pipeline_apply``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Shard, distribute_tensor
from torch.distributed.tensor.parallel import (
    ColwiseParallel,
    ParallelStyle,
    RowwiseParallel,
)
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from pytorch_operator_tpu_torch import ops
from pytorch_operator_tpu_torch.device import default_device
from pytorch_operator_tpu_torch.ops.rms_norm import rms_norm_reference
from pytorch_operator_tpu_torch.utils import collectives


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

    def n_params(self) -> int:
        """The parameter count of the model this config builds."""
        return n_params(self)

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


def param_specs(cfg: LlamaConfig) -> Dict[str, ParallelStyle]:
    """The tensor-parallel plan for ``parallelize_module`` on the mesh's
    tp dim, the port of the JAX ``param_specs``' tp half: the q/k/v and
    SwiGLU gate/up projections split their output features over tp
    (column-wise: each rank computes n_heads/tp q heads, n_kv_heads/tp
    kv heads and ffn_dim/tp hidden units), the o and down projections
    their input features (row-wise, summed over tp); norms are absent,
    so replicated.  The embedding, a parameter of the root and not a
    module, is split by ``shard_vocab``: rows over tp, as JAX's
    ``P(tp, fsdp)``.  The fsdp half is ``fully_shard``
    (``sharded_init``), which splits the embedding's rows again where
    JAX splits its D: a layout difference, not one of values.

    Both styles keep ``use_local_output``: the attention and the norms
    get each rank's local tensors, never DTensors."""
    del cfg
    col, row = ColwiseParallel(), RowwiseParallel()
    return {f"layers.*.{name}": col
            for name in ("wq", "wk", "wv", "w_gate", "w_up")} | {
        "layers.*.wo": row, "layers.*.w_down": row}


def check_tp(cfg: LlamaConfig, tp: int) -> None:
    """Each tp rank owns whole q and kv heads (the JAX
    ``head_shard_degree`` rule) and an equal share of the vocab: tp must
    divide both head counts and ``vocab_size``."""
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(
            f"the mesh's tp degree {tp} must divide both head counts; "
            f"got n_heads={cfg.n_heads}, n_kv_heads={cfg.n_kv_heads}")
    if cfg.vocab_size % tp:
        raise ValueError(f"the mesh's tp degree {tp} must divide "
                         f"vocab_size={cfg.vocab_size}")


def shard_vocab(model, tp_mesh) -> None:
    """Split the tied embedding of ``model`` (built on the meta device) by
    rows over the 1-D ``tp_mesh``: rank r keeps rows [r·V/tp,
    (r+1)·V/tp), a ``Shard(0)`` DTensor.  The lookup and the head then
    run on those rows (``embed_tokens``, ``tied_logits``) and the loss
    is the vocab-parallel CE over ``model.vocab_group``."""
    model.embed = nn.Parameter(distribute_tensor(
        model.embed.data, tp_mesh, [Shard(0)], src_data_rank=None))
    model.vocab_group = tp_mesh.get_group()


def vocab_rows(model) -> tuple[torch.Tensor, Any]:
    """(rows, group): the tied embedding's rows this rank computes with,
    and the tp group they are split over (None: the whole table).  Under
    FSDP2 the root's parameters are gathered over the data dims while
    its forward (and, for the root, the backward after it) runs, and the
    rows are then the tp shard."""
    E = model.embed
    if model.vocab_group is None:
        return E, None
    rows = E.to_local()
    n = torch.distributed.get_world_size(model.vocab_group)
    if rows.shape[0] * n != model.cfg.vocab_size:
        raise RuntimeError(
            f"the embedding holds {rows.shape[0]} rows on this rank, not "
            f"vocab_size/tp = {model.cfg.vocab_size // n}: it is read "
            f"outside the model's forward, while FSDP2 keeps it sharded")
    return rows, model.vocab_group


def embed_tokens(model, tokens: torch.Tensor) -> torch.Tensor:
    """The lookup in the tied embedding, vocab-parallel where it is split
    over tp (``collectives.vocab_parallel_embedding``)."""
    rows, group = vocab_rows(model)
    if group is None:
        return F.embedding(tokens, rows)
    first = torch.distributed.get_rank(group) * rows.shape[0]
    return collectives.vocab_parallel_embedding(tokens, rows, first, group)


def tied_logits(model, h: torch.Tensor) -> torch.Tensor:
    """The weight-tied head: logits in the param dtype, then f32; where
    the embedding is split over tp, this rank's (…, V/tp) of them (h
    enters the split region: its gradient is summed over tp)."""
    rows, group = vocab_rows(model)
    if group is not None:
        h = collectives.copy_to_group(h, group)
    return (h @ rows.t()).float()


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
               device: torch.device | str = "cpu",
               positions: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (T, head_dim // 2), at positions 0..T-1, or at
    ``positions`` (T,) where the rows carry other ones: a sequence-
    parallel rank's rows, in the zigzag order or not."""
    half = cfg.head_dim // 2
    freqs = cfg.rope_theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=device) / half)
    if positions is None:
        pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    else:
        pos = positions.to(device=device, dtype=torch.float32)
    angles = pos[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    # x: (B, T, H, Dh); half-split: rotate (x[:Dh/2], x[Dh/2:]) pairs
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _attention(q, k, v, cfg: LlamaConfig):
    """Causal attention (B,T,H,Dh) x (B,T,KV,Dh) with GQA broadcast.

    The head counts come from the tensors: under tensor parallelism a
    rank holds n_heads/tp q heads and n_kv_heads/tp kv heads."""
    B, T, H, Dh = q.shape
    groups = H // k.shape[2]
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


def attention_params(module: nn.Module, cfg: LlamaConfig,
                     device: torch.device) -> None:
    """The attention half of a decoder layer's parameters on ``module``:
    the two norms and the q/k/v/o projections (``Block`` and the MoE
    block share them)."""
    D, hd = cfg.dim, cfg.head_dim
    kw = dict(bias=False, device=device, dtype=cfg.dtype)
    module.attn_norm = nn.Parameter(torch.ones(D, device=device,
                                               dtype=cfg.dtype))
    module.wq = nn.Linear(D, cfg.n_heads * hd, **kw)
    module.wk = nn.Linear(D, cfg.n_kv_heads * hd, **kw)
    module.wv = nn.Linear(D, cfg.n_kv_heads * hd, **kw)
    module.wo = nn.Linear(cfg.n_heads * hd, D, **kw)
    module.mlp_norm = nn.Parameter(torch.ones(D, device=device,
                                              dtype=cfg.dtype))


def attend(blk: nn.Module, h, cos, sin, attn=None) -> torch.Tensor:
    """h + the attention of layer ``blk`` (``attention_params``' names);
    ``attn(q, k, v)`` in place of the model's attention."""
    cfg = blk.cfg
    B, T, _ = h.shape
    hd = cfg.head_dim
    # the save-group regions matter only under a selective remat policy
    # (remat_context_fn); elsewhere they change nothing
    with _save_region("normed"):
        x = rms_norm(h, blk.attn_norm, cfg.norm_eps, cfg.use_fused_norm)
    with _save_region("qkv"):
        q, k, v = blk.wq(x), blk.wk(x), blk.wv(x)
    # -1 heads: a tensor-parallel rank's projections give it n_heads/tp q
    # and n_kv_heads/tp kv heads
    q = apply_rope(q.view(B, T, -1, hd), cos, sin)
    k = apply_rope(k.view(B, T, -1, hd), cos, sin)
    v = v.view(B, T, -1, hd)
    o = _attention(q, k, v, cfg) if attn is None else attn(q, k, v)
    return h + blk.wo(o.reshape(B, T, -1))


class Block(nn.Module):
    """One decoder layer: the JAX ``_layer``."""

    def __init__(self, cfg: LlamaConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        D, F_ = cfg.dim, cfg.ffn_dim
        kw = dict(bias=False, device=device, dtype=cfg.dtype)
        attention_params(self, cfg, device)
        self.w_gate = nn.Linear(D, F_, **kw)
        self.w_up = nn.Linear(D, F_, **kw)
        self.w_down = nn.Linear(F_, D, **kw)

    def forward(self, h, cos, sin, attn=None):
        """``attn(q, k, v)`` in place of the model's attention: the
        sequence-parallel forward's ring or all-to-all."""
        cfg = self.cfg
        h = attend(self, h, cos, sin, attn)
        with _save_region("normed"):
            x = rms_norm(h, self.mlp_norm, cfg.norm_eps, cfg.use_fused_norm)
        with _save_region("gateup"):
            gate, up = self.w_gate(x), self.w_up(x)
        return h + self.w_down(F.silu(gate) * up)


class Llama(nn.Module):
    """Embed, L blocks, final norm and the weight-tied head."""

    def __init__(self, cfg: LlamaConfig, *, device=None,
                 generator: torch.Generator | None = None):
        """``device="meta"`` builds the shapes only and draws nothing:
        ``parallel.train.sharded_init`` shards such a model and then
        fills each rank's shards with ``init_params``."""
        super().__init__()
        # the layers' checkpoint context (raises on a policy it cannot
        # run, as the JAX model does when it builds the layer body)
        self.remat_context = remat_context_fn(cfg) if cfg.remat else None
        meta = device is not None and torch.device(device).type == "meta"
        dev = torch.device("meta") if meta else default_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.dim,
                                              device=dev, dtype=cfg.dtype))
        self.layers = nn.ModuleList(Block(cfg, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.ones(cfg.dim, device=dev,
                                                  dtype=cfg.dtype))
        # the tp group the embedding's rows are split over (shard_vocab)
        self.vocab_group = None
        if not meta:
            init_params(self, generator)

    def _forward_with(self, tokens: torch.Tensor,
                      return_hidden: bool = False,
                      positions: torch.Tensor | None = None,
                      attn: Callable | None = None) -> torch.Tensor:
        h = embed_tokens(self, tokens)
        h = _run_blocks(self.cfg, self.layers, self.remat_context, h,
                        positions, attn)
        return _head(self, h, return_hidden)

    def forward(self, tokens: torch.Tensor,
                positions: torch.Tensor | None = None,
                attn: Callable | None = None) -> torch.Tensor:
        """tokens (B, T) int -> logits (B, T, vocab) float32 (this rank's
        (B, T, vocab/tp) where ``shard_vocab`` split the embedding).
        ``positions`` (T,): the rows' positions for RoPE (default
        0..T-1); ``attn``: the attention of every layer (default the
        model's own)."""
        return self._forward_with(tokens, False, positions, attn)

    def forward_hidden(self, tokens: torch.Tensor,
                       positions: torch.Tensor | None = None,
                       attn: Callable | None = None) -> torch.Tensor:
        """tokens (B, T) -> final-normed hidden states (B, T, dim)."""
        return self._forward_with(tokens, True, positions, attn)


def _run_blocks(cfg: LlamaConfig, blocks, remat_context, h: torch.Tensor,
                positions: torch.Tensor | None = None,
                attn: Callable | None = None) -> torch.Tensor:
    """h (B, T, D) through ``blocks``, each checkpointed under
    ``cfg.remat`` (with ``remat_context``) while autograd records."""
    cos, sin = rope_table(cfg, h.shape[1], h.device, positions)
    for block in blocks:
        if cfg.remat and torch.is_grad_enabled():
            h = checkpoint(block, h, cos, sin, attn, use_reentrant=False,
                           context_fn=remat_context)
        else:
            h = block(h, cos, sin, attn)
    return h


def _head(model, h: torch.Tensor, return_hidden: bool) -> torch.Tensor:
    """The final norm, then (unless ``return_hidden``) the weight-tied
    head: logits in the param dtype, then f32."""
    cfg = model.cfg
    h = rms_norm(h, model.final_norm, cfg.norm_eps, cfg.use_fused_norm)
    if return_hidden:
        return h
    return tied_logits(model, h)


def pp_param_specs(cfg: LlamaConfig, n_stages: int) -> list[range]:
    """The pipeline layout: the contiguous layer range of each of
    ``n_stages`` stages; the embedding and final norm are on every stage
    (JAX ``pp_param_specs`` shards the stack's L axis over pp and
    replicates the rest).  Raises where the stages cannot hold equal
    ranges."""
    if n_stages < 1 or cfg.n_layers % n_stages:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by "
                         f"{n_stages} pipeline stages")
    per = cfg.n_layers // n_stages
    return [range(s * per, (s + 1) * per) for s in range(n_stages)]


class LlamaStage(nn.Module):
    """One pipeline stage: the embedding, the blocks of ``layers`` (a
    range of global layer indices, from ``pp_param_specs``) under their
    global names (``layers.8.wq.weight``) and the final norm.  Stage 0
    uses the embedding for the lookup and the last stage for the tied
    head; the pipeline step sums their gradients over the stages."""

    def __init__(self, cfg: LlamaConfig, layers: range, *, device=None,
                 generator: torch.Generator | None = None):
        """As ``Llama``'s: ``device="meta"`` draws nothing; else the stage
        draws the whole model's stream from ``generator`` and keeps its
        own values (``init_params``), those of ``Llama`` on the same
        generator."""
        super().__init__()
        if not 0 <= layers.start <= layers.stop <= cfg.n_layers:
            raise ValueError(f"layers {layers} outside the model's "
                             f"{cfg.n_layers}")
        self.remat_context = remat_context_fn(cfg) if cfg.remat else None
        meta = device is not None and torch.device(device).type == "meta"
        dev = torch.device("meta") if meta else default_device(device)
        self.cfg = cfg
        self.layer_ids = layers
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.dim,
                                              device=dev, dtype=cfg.dtype))
        self.layers = nn.ModuleDict({str(i): Block(cfg, dev)
                                     for i in layers})
        self.final_norm = nn.Parameter(torch.ones(cfg.dim, device=dev,
                                                  dtype=cfg.dtype))
        self.vocab_group = None  # a stage's embedding is never split
        if not meta:
            init_params(self, generator)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.embed)

    def run_layers(self, h: torch.Tensor) -> torch.Tensor:
        """The stage's blocks on h (B, T, D), RoPE at positions 0..T-1."""
        return _run_blocks(self.cfg, self.layers.values(),
                           self.remat_context, h)

    def head(self, h: torch.Tensor, return_hidden: bool = False
             ) -> torch.Tensor:
        return _head(self, h, return_hidden)


def _blocks_by_layer(model) -> dict[int, Block]:
    if isinstance(model, LlamaStage):
        return {i: model.layers[str(i)] for i in model.layer_ids}
    return dict(enumerate(model.layers))


def pipeline_stages(cfg: LlamaConfig, n_stages: int, *, device=None,
                    seed: int = 0) -> nn.ModuleList:
    """The ``n_stages`` stages of the pipeline layout in this process
    (the loopback's), each drawn from ``torch.Generator(seed)`` on
    ``device``: together the values of ``Llama(cfg)`` on that
    generator, the embedding and final norm on every stage."""
    dev = default_device(device)
    return nn.ModuleList(
        LlamaStage(cfg, layers, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(seed))
        for layers in pp_param_specs(cfg, n_stages))


def forward_pipelined(model, tokens: torch.Tensor, comm, n_microbatches: int,
                      return_hidden: bool = False) -> torch.Tensor:
    """The forward through the GPipe pipeline (the JAX
    ``forward_pipelined``): stage 0 embeds the tokens, the blocks run as
    the stages of ``parallel.pipeline.pipeline_apply`` over ``comm``, and
    the final norm and the tied head run on the pipeline's output on
    every stage, as JAX runs them replicated.  ``model`` is this rank's
    ``LlamaStage`` (``PipeComm``) or the list of every stage
    (``PipeLoopback``, whose head is the last stage's).  Differentiable
    as ``pipeline_apply``: the lookup's gradient lands on stage 0's
    embedding, the head's on each stage that computes it."""
    from pytorch_operator_tpu_torch.parallel.pipeline import (
        PipeLoopback,
        pipeline_apply,
    )

    loop = isinstance(comm, PipeLoopback)
    first = model[0] if loop else model
    if loop or comm.rank == 0:
        h = first.embed_tokens(tokens)
    else:  # only stage 0 reads the pipeline's input
        h = torch.zeros(*tokens.shape, first.cfg.dim, dtype=first.cfg.dtype,
                        device=tokens.device)
    h = pipeline_apply(lambda stage, x: stage.run_layers(x),
                       list(model) if loop else model, h, comm,
                       n_microbatches)
    return (model[-1] if loop else model).head(h, return_hidden)


def forward(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
    return model(tokens)


def forward_hidden(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
    return model.forward_hidden(tokens)


SP_IMPLS = ("ulysses", "ring", "ring_zigzag")


def sp_positions(T: int, sp: int, rank: int, impl: str,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """The global positions of sp rank ``rank``'s T/sp rows: rows
    [rank·T/sp, (rank+1)·T/sp) for ulysses and ring, the rank's slice of
    ``zigzag_layout``'s permutation for ring_zigzag (the tokens are
    permuted once per forward, as in the JAX ``forward_sp``)."""
    from pytorch_operator_tpu_torch.parallel.ring_attention import (
        zigzag_layout,
    )

    if impl not in SP_IMPLS:
        raise ValueError(f"unknown sp impl {impl!r}")
    if T % sp:
        raise ValueError(f"seq len {T} not divisible by sp={sp}")
    Tl = T // sp
    if impl == "ring_zigzag":
        rows = torch.from_numpy(zigzag_layout(T, sp)[0][rank * Tl:
                                                       (rank + 1) * Tl])
    else:
        rows = torch.arange(rank * Tl, (rank + 1) * Tl)
    return rows.to(device)


def sp_attention(cfg: LlamaConfig, group, impl: str) -> Callable:
    """The attention of the sequence-parallel forward over the sp process
    group ``group``, on a rank's (B, T/sp, H_local, D) q and (B, T/sp,
    KV_local, D) k / v (under tp the local heads come from the tensors,
    so SP×TP runs the ring or the all-to-all on each tp rank's heads).

      ring         ``ring_attention`` over the unrepeated K/V chunks
      ring_zigzag  the same on the zigzag layout (``zigzag_pre``)
      ulysses      ``ulysses_attention``; where the local kv heads do not
                   divide sp, K/V repeat only to lcm(kv, sp) heads, the
                   least the all-to-all can split (the JAX forward_sp's
                   minimal repeat), and the local attention is the flash
                   kernels under ``cfg.use_flash``, else the dense path
    """
    from pytorch_operator_tpu_torch.parallel.ring_attention import (
        RingComm,
        ring_attention,
    )
    from pytorch_operator_tpu_torch.parallel.ulysses import (
        ulysses_attention,
    )

    if impl not in SP_IMPLS:
        raise ValueError(f"unknown sp impl {impl!r}")
    if impl != "ulysses":
        comm = RingComm(group)
        layout = "zigzag_pre" if impl == "ring_zigzag" else "contiguous"
        return lambda q, k, v: ring_attention(q, k, v, comm, causal=True,
                                              layout=layout)
    n = torch.distributed.get_world_size(group)

    def local(q, k, v, causal):
        return _attention(q, k, v, cfg)

    def attn(q, k, v):
        kv = k.shape[2]
        if kv % n:
            r = math.lcm(kv, n) // kv
            k = k.repeat_interleave(r, dim=2)
            v = v.repeat_interleave(r, dim=2)
        return ulysses_attention(q, k, v, group, local_attention=(
            None if cfg.use_flash else local))

    return attn


def forward_sp(model: Llama, tokens: torch.Tensor, group, *,
               impl: str = "ulysses",
               return_hidden: bool = False) -> torch.Tensor:
    """The sequence-parallel forward of one rank of the sp process group
    ``group``: tokens (B, T) are the rank's batch rows at full length;
    the stack runs on its T/sp rows (``sp_positions``), RoPE at their
    true positions, attention by ``sp_attention``.  Returns the logits
    (f32) or, with ``return_hidden``, the final-normed hidden states of
    those rows, (B, T/sp, ...)."""
    sp = torch.distributed.get_world_size(group)
    rank = torch.distributed.get_rank(group)
    pos = sp_positions(tokens.shape[1], sp, rank, impl, tokens.device)
    fn = model.forward_hidden if return_hidden else model
    return fn(tokens[:, pos], positions=pos,
              attn=sp_attention(model.cfg, group, impl))


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
    ``load_jax_params``.  A sharded model (DTensor parameters) gets the
    same values: each matrix is drawn whole, one at a time, and each
    rank keeps its shard (``assign``)."""
    cfg = model.cfg
    dev = model.embed.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def draw(shape, fan_in: int) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * fan_in ** -0.5

    assign(model.embed, draw(model.embed.shape, cfg.dim))
    blocks = _blocks_by_layer(model)
    D, F_ = cfg.dim, cfg.ffn_dim
    q_out, kv_out = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    shapes = {"wq": (q_out, D), "wk": (kv_out, D), "wv": (kv_out, D),
              "wo": (D, q_out), "w_gate": (F_, D), "w_up": (F_, D),
              "w_down": (D, F_)}
    for i in range(cfg.n_layers):
        # a stage draws the other stages' matrices too, one at a time,
        # so that the stream reaches its own where the whole model's does
        blk = blocks.get(i)
        for name in _LINEARS:
            shape = shapes[name]
            full = draw(shape, shape[1])
            if blk is not None:
                assign(getattr(blk, name).weight, full)
            del full
        if blk is not None:
            blk.attn_norm.fill_(1.0)
            blk.mlp_norm.fill_(1.0)
    model.final_norm.fill_(1.0)
    return model


_LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_NORMS = ("attn_norm", "mlp_norm")


def assign(p: torch.Tensor, full: torch.Tensor) -> None:
    """Copy the full value ``full`` into parameter ``p``, cast to its
    dtype.  For a DTensor parameter each rank keeps only its shard of
    ``full`` (which every rank holds): no communication."""
    if tuple(full.shape) != tuple(p.shape):
        raise ValueError(f"shape {tuple(full.shape)} does not fit "
                         f"parameter {tuple(p.shape)}")
    full = full.to(device=p.device, dtype=p.dtype)
    if isinstance(p, DTensor):
        full = distribute_tensor(full, p.device_mesh, p.placements,
                                 src_data_rank=None)
    p.copy_(full)


def full_value(p: torch.Tensor) -> torch.Tensor:
    """The whole value of a parameter or gradient (a DTensor is
    all-gathered)."""
    return p.full_tensor() if isinstance(p, DTensor) else p


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16 from jax arrays
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = full_value(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


@torch.no_grad()
def load_jax_params(model: Llama, tree: Dict[str, Any]) -> Llama:
    """Copy a JAX ``init_params``-layout tree of numpy arrays into
    ``model``: ``layers/*`` leaves carry a leading L axis, and matrices
    are ``(in, out)`` (used as ``x @ w``), transposed here into
    ``nn.Linear``'s ``(out, in)``.  A sharded model takes each rank's
    shard of the full arrays."""

    def put(p: torch.Tensor, a) -> None:
        assign(p, _to_torch(np.asarray(a)))

    put(model.embed, tree["embed"])
    put(model.final_norm, tree["final_norm"])
    layers = tree["layers"]
    for i, blk in _blocks_by_layer(model).items():
        for name in _LINEARS:
            put(getattr(blk, name).weight, np.asarray(layers[name][i]).T)
        for name in _NORMS:
            put(getattr(blk, name), layers[name][i])
    return model


def params_to_numpy(model: Llama) -> Dict[str, Any]:
    """The inverse of ``load_jax_params`` (bf16 comes back as f32); a
    ``LlamaStage`` gives its own layers only, in order."""
    blocks = list(_blocks_by_layer(model).values())
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
