"""Mixture-of-Experts Llama in PyTorch, with expert parallelism (ep).

Port of ``pytorch_operator_tpu/models/moe.py``: each layer's SwiGLU is a
bank of ``n_experts`` SwiGLU experts behind a top-k router.  The
dispatch is dense, as in the JAX module: every expert runs on every
token and the combine weights zero the pairs the router did not pick,
so no token is dropped and no capacity is set.  The attention half of a
layer is Llama's (``llama.attend``: RMSNorm through the CUDA kernel,
attention through the flash kernels under ``cfg.use_flash``); the
embedding and the tied head are Llama's too (``llama.embed_tokens``,
``llama.tied_logits``, vocab-parallel where they are split over tp).

The banks keep the JAX layout, ``w_gate``/``w_up`` (E, D, F) and
``w_down`` (E, F, D) a layer, the router (D, E); only the attention's
``nn.Linear`` weights are the transposes of the JAX matrices.
``load_jax_params`` / ``params_to_numpy`` carry the JAX tree across.

Expert parallelism (``shard_experts``, called by
``parallel.train.sharded_init``): ep rank r holds experts
[r·E/ep, (r+1)·E/ep), and under tp each expert's F splits over tp as
the SwiGLU's does.  Each (tp, ep) rank's partial output, in f32, is
summed by one all-reduce over the flattened (tp, ep) group
(``collectives.reduce_from_group``); the inputs of the region, x and the
combine weights, enter it by ``collectives.copy_to_group``, so that x's
and the router's gradients come out whole and equal on every rank.  The
attention, the norms, the router and the embedding are replicated over
ep, with no collective of their own.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Shard, distribute_tensor
from torch.distributed.tensor.parallel import ParallelStyle
from torch.utils.checkpoint import checkpoint

from pytorch_operator_tpu_torch.device import default_device
from pytorch_operator_tpu_torch.models import llama
from pytorch_operator_tpu_torch.models.llama import LlamaConfig
from pytorch_operator_tpu_torch.parallel.mesh import (
    AXIS_DP,
    AXIS_EP,
    AXIS_FSDP,
    AXIS_TP,
)
from pytorch_operator_tpu_torch.utils import collectives

# The weight of the load-balancing loss in the training loss, ce +
# AUX_LOSS_WEIGHT * aux: the JAX package's MoE step
# (tests/test_pipeline_moe.py:282-286).  Mixtral trains with 0.02.
AUX_LOSS_WEIGHT = 0.01

ATTENTION = ("wq", "wk", "wv", "wo")
EXPERT_BANKS = ("w_gate", "w_up", "w_down")
# The dims of each bank a layer, (E, D, F) or (E, F, D), that the ep and
# tp mesh dims split: the JAX P(None, ep, fsdp, tp) and P(None, ep, tp,
# fsdp) without the layer axis.  FSDP2 splits dim 0 again over the data
# dims where JAX splits D over fsdp: a layout difference, not one of
# values.
EXPERT_SPLITS = {"w_gate": {AXIS_EP: 0, AXIS_TP: 2},
                 "w_up": {AXIS_EP: 0, AXIS_TP: 2},
                 "w_down": {AXIS_EP: 0, AXIS_TP: 1}}


@dataclasses.dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    n_experts: int = 8
    top_k: int = 2

    def n_params(self) -> int:
        return n_params(self)


def tiny(**kw) -> MoEConfig:
    """Small config for tests (the JAX ``tiny``'s defaults)."""
    defaults = dict(
        vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=4,
        ffn_dim=128, max_seq_len=128, dtype=torch.float32,
        n_experts=4, top_k=2,
    )
    defaults.update(kw)
    return MoEConfig(**defaults)


def mixtral_8x7b(**kw) -> MoEConfig:
    """Mixtral-8x7B's widths (``mistralai/Mixtral-8x7B-v0.1``
    ``config.json``; arXiv 2401.04088): d4096, 32 layers, 32 heads, 8 kv
    heads, expert width 14336, 8 experts, top-2, vocab 32000, rope theta
    1e6, RMSNorm eps 1e-5; bf16, the kernels on, no remat.  What the
    JAX MoE makes of it: the embedding and head are tied (Mixtral's are
    not), the dispatch is dense, and the aux weight is AUX_LOSS_WEIGHT."""
    defaults = dict(
        vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        ffn_dim=14336, max_seq_len=32768, rope_theta=1e6, norm_eps=1e-5,
        n_experts=8, top_k=2, dtype=torch.bfloat16, remat=False,
        use_flash=True, use_fused_norm=True,
    )
    defaults.update(kw)
    return MoEConfig(**defaults)


def param_specs(cfg: MoEConfig) -> Dict[str, ParallelStyle]:
    """The tensor-parallel plan of the attention (``llama.param_specs``
    without the SwiGLU, which the banks replace); the router and the
    norms are absent, so replicated, as JAX's.  The banks are split by
    ``shard_experts`` (``EXPERT_SPLITS``), the embedding by
    ``llama.shard_vocab``."""
    return {k: v for k, v in llama.param_specs(cfg).items()
            if k.rsplit(".", 1)[1] in ATTENTION}


def check_ep(cfg: MoEConfig, tp: int, ep: int) -> None:
    """Each ep rank holds whole experts and each tp rank an equal share
    of an expert's width: ep must divide n_experts and tp ffn_dim."""
    if cfg.n_experts % ep:
        raise ValueError(f"the mesh's ep degree {ep} must divide "
                         f"n_experts={cfg.n_experts}")
    if cfg.ffn_dim % tp:
        raise ValueError(f"the mesh's tp degree {tp} must divide "
                         f"ffn_dim={cfg.ffn_dim}")


def moe_ffn(x: torch.Tensor, blk: "MoEBlock") -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Top-k routed expert FFN, the JAX ``moe_ffn``: x (B, T, D) ->
    (out (B, T, D) in x's dtype, aux loss f32).

    The router's logits are computed in the param dtype and cast to f32;
    softmax, top-k and the renormalised top values in f32; the combine
    weights are a scatter of them, so their gradient reaches the chosen
    probabilities only.  aux = E · Σ frac_routed · mean_prob, frac_routed
    from ``combine > 0`` without a gradient, over the global batch (the
    counts are summed over ``blk.aux_group``, the data dims, as JAX's
    mean runs over the batch its mesh splits).  The experts' products are
    plain batched products (JAX: einsums outside any Pallas kernel); the
    combine weights are cast to the activation dtype, and the partial
    sums over this rank's experts are taken in f32 and cast once after
    the all-reduce over ``blk.expert_group``."""
    cfg = blk.cfg
    E, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax((x @ blk.router).float(), dim=-1)
    top_vals, top_idx = probs.topk(k, dim=-1)
    top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
    combine = torch.zeros_like(probs).scatter(-1, top_idx, top_vals)

    with torch.no_grad():
        routed = (combine > 0).float().sum(dim=(0, 1))
        tokens = combine.shape[0] * combine.shape[1]
        if blk.aux_group is not None:
            dist.all_reduce(routed, group=blk.aux_group)
            tokens *= dist.get_world_size(blk.aux_group)
        frac_routed = routed / tokens
    aux = E * torch.sum(frac_routed * probs.mean(dim=(0, 1)))

    wg, wu, wd = (_local(getattr(blk, name)) for name in EXPERT_BANKS)
    group = blk.expert_group
    if group is not None:
        x = collectives.copy_to_group(x, group)
        combine = collectives.copy_to_group(combine, group)
    B, T, D = x.shape
    mine = combine[..., blk.expert_first:blk.expert_first + wg.shape[0]]
    mine = mine.to(x.dtype).reshape(B * T, -1)
    # every expert's products are one bmm each (aten::bmm on every
    # path, forward and backward, which the profile classes by)
    xs = x.reshape(1, B * T, D).expand(wg.shape[0], B * T, D)
    hidden = F.silu(torch.bmm(xs, wg)) * torch.bmm(xs, wu)
    y = torch.bmm(hidden, wd)                       # (E_local, B·T, D)
    out = (y.float() * mine.t().float()[..., None]).sum(0)
    if group is not None:
        out = collectives.reduce_from_group(out, group)
    return out.to(x.dtype).reshape(B, T, D), aux


def _local(p: torch.Tensor) -> torch.Tensor:
    return p.to_local() if isinstance(p, DTensor) else p


class MoEBlock(nn.Module):
    """One MoE decoder layer: the JAX ``_layer``."""

    def __init__(self, cfg: MoEConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        D, F_, E = cfg.dim, cfg.ffn_dim, cfg.n_experts
        llama.attention_params(self, cfg, device)

        def bank(*shape):
            return nn.Parameter(torch.empty(*shape, device=device,
                                            dtype=cfg.dtype))

        self.router = bank(D, E)
        self.w_gate = bank(E, D, F_)
        self.w_up = bank(E, D, F_)
        self.w_down = bank(E, F_, D)
        # set by shard_experts: the (tp, ep) group the banks split over,
        # the index of this rank's first expert, the data dims' group
        self.expert_group = None
        self.expert_first = 0
        self.aux_group = None

    def forward(self, h, cos, sin):
        """h -> (h, this layer's aux loss)."""
        cfg = self.cfg
        h = llama.attend(self, h, cos, sin)
        x = llama.rms_norm(h, self.mlp_norm, cfg.norm_eps,
                           cfg.use_fused_norm)
        out, aux = moe_ffn(x, self)
        return h + out, aux


class MoELlama(nn.Module):
    """Embed, L MoE blocks, final norm and the weight-tied head."""

    def __init__(self, cfg: MoEConfig, *, device=None,
                 generator: torch.Generator | None = None):
        """As ``llama.Llama``'s: ``device="meta"`` builds the shapes and
        draws nothing (``sharded_init`` lays such a model out and fills
        it)."""
        super().__init__()
        meta = device is not None and torch.device(device).type == "meta"
        dev = torch.device("meta") if meta else default_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.dim,
                                              device=dev, dtype=cfg.dtype))
        self.layers = nn.ModuleList(MoEBlock(cfg, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.ones(cfg.dim, device=dev,
                                                  dtype=cfg.dtype))
        self.vocab_group = None  # llama.shard_vocab's
        if not meta:
            init_params(self, generator)

    def _forward_with(self, tokens, return_hidden):
        cfg = self.cfg
        h = llama.embed_tokens(self, tokens)
        cos, sin = llama.rope_table(cfg, h.shape[1], h.device)
        auxes = []
        for block in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                h, aux = checkpoint(block, h, cos, sin, use_reentrant=False)
            else:
                h, aux = block(h, cos, sin)
            auxes.append(aux)
        h = llama.rms_norm(h, self.final_norm, cfg.norm_eps,
                           cfg.use_fused_norm)
        out = h if return_hidden else llama.tied_logits(self, h)
        return out, torch.stack(auxes).mean()

    def forward(self, tokens: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, T) int -> (logits (B, T, vocab) f32, this rank's
        (B, T, vocab/tp) where the embedding is split; the mean of the
        layers' aux losses, as JAX's ``jnp.mean(aux)``).

        Under ``cfg.remat`` each whole block is checkpointed and
        ``cfg.remat_policy`` is ignored, as the JAX MoE ignores it."""
        return self._forward_with(tokens, False)

    def forward_hidden(self, tokens: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, T) -> (final-normed hidden states (B, T, dim), aux)."""
        return self._forward_with(tokens, True)


def shard_experts(model: MoELlama, mesh) -> None:
    """Lay the banks of ``model`` (built on the meta device) out on the
    mesh's (tp, ep) dims, as ``EXPERT_SPLITS`` says, where those hold
    more than one rank, and set each block's groups: the flattened
    (tp, ep) group of the combine's all-reduce, and the data dims'
    group of the routed fraction."""
    names = mesh.mesh_dim_names or ()
    size = {d: mesh[d].size() if d in names else 1
            for d in (AXIS_TP, AXIS_EP)}
    check_ep(model.cfg, size[AXIS_TP], size[AXIS_EP])
    dims = tuple(d for d in (AXIS_TP, AXIS_EP) if size[d] > 1)
    sub = (mesh[dims] if len(dims) > 1 else mesh[dims[0]]) if dims else None
    expert_group = collectives.group_over(mesh, dims)
    aux_group = collectives.group_over(mesh, (AXIS_DP, AXIS_FSDP))
    first = (mesh[AXIS_EP].get_local_rank() * model.cfg.n_experts
             // size[AXIS_EP]) if size[AXIS_EP] > 1 else 0
    for blk in model.layers:
        if sub is not None:
            for name, split in EXPERT_SPLITS.items():
                setattr(blk, name, nn.Parameter(distribute_tensor(
                    getattr(blk, name).data, sub,
                    [Shard(split[d]) for d in dims], src_data_rank=None)))
        blk.expert_group = expert_group
        blk.expert_first = first
        blk.aux_group = aux_group


# ---------------------------------------------------------------------------
# Parameters


@torch.no_grad()
def init_params(model: MoELlama, generator: torch.Generator | None = None
                ) -> MoELlama:
    """Fill ``model`` with the JAX ``init_params`` distributions: every
    matrix and bank N(0, 1) * fan_in^-1/2 drawn in f32 and cast, norms
    ones.  ``generator`` lives on the model's device (seed 0 when none
    is given).  A sharded model gets the same values: each tensor is
    drawn whole, one at a time, and each rank keeps its shard."""
    cfg = model.cfg
    dev = model.embed.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def fill(p: torch.Tensor, fan_in: int) -> None:
        full = torch.randn(p.shape, generator=generator, device=dev,
                           dtype=torch.float32) * fan_in ** -0.5
        llama.assign(p, full)

    fill(model.embed, cfg.dim)
    for blk in model.layers:
        for name in ATTENTION:
            w = getattr(blk, name).weight
            fill(w, w.shape[1])
        fill(blk.router, cfg.dim)
        for name in EXPERT_BANKS:
            fill(getattr(blk, name), getattr(blk, name).shape[1])
        blk.attn_norm.fill_(1.0)
        blk.mlp_norm.fill_(1.0)
    model.final_norm.fill_(1.0)
    return model


_NORMS = ("attn_norm", "mlp_norm")
_RAW = ("router",) + EXPERT_BANKS + _NORMS  # in the JAX layout as they are


@torch.no_grad()
def load_jax_params(model: MoELlama, tree: Dict[str, Any]) -> MoELlama:
    """Copy a JAX ``moe.init_params``-layout tree of numpy arrays into
    ``model`` (``layers/*`` with a leading L axis: ``router`` (L, D, E),
    ``w_gate``/``w_up`` (L, E, D, F), ``w_down`` (L, E, F, D), the
    attention as Llama's).  A sharded model takes each rank's shard."""

    def put(p: torch.Tensor, a) -> None:
        llama.assign(p, llama._to_torch(np.asarray(a)))

    put(model.embed, tree["embed"])
    put(model.final_norm, tree["final_norm"])
    layers = tree["layers"]
    for i, blk in enumerate(model.layers):
        for name in ATTENTION:
            put(getattr(blk, name).weight, np.asarray(layers[name][i]).T)
        for name in _RAW:
            put(getattr(blk, name), layers[name][i])
    return model


def params_to_numpy(model: MoELlama) -> Dict[str, Any]:
    """The inverse of ``load_jax_params`` (bf16 comes back as f32)."""
    blocks = list(model.layers)
    layers = {name: np.stack([llama._to_numpy(getattr(b, name).weight).T
                              for b in blocks]) for name in ATTENTION}
    layers.update({name: np.stack([llama._to_numpy(getattr(b, name))
                                   for b in blocks]) for name in _RAW})
    return {"embed": llama._to_numpy(model.embed), "layers": layers,
            "final_norm": llama._to_numpy(model.final_norm)}


def n_params(cfg: MoEConfig) -> int:
    """Parameter count (embed + layers + final norm); with dense dispatch
    every one of them runs on every token."""
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    D, F_, L, E = cfg.dim, cfg.ffn_dim, cfg.n_layers, cfg.n_experts
    per_layer = (D * nh * hd + 2 * D * nkv * hd + nh * hd * D + 2 * D
                 + D * E + 3 * E * D * F_)
    return cfg.vocab_size * D + L * per_layer + D
