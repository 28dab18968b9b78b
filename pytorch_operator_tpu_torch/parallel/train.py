"""Training step for the Llama and MoE models, on one device or a mesh.

Port of ``pytorch_operator_tpu/parallel/train.py``: next-token cross
entropy (optionally with the tied head applied per sequence chunk), the
AdamW update, the global gradient norm, ``sharded_init``, checkpoint
save and restore at any mesh shape (``restore_on_mesh``), the in-memory
``reshard_state`` and ``with_step_profiler``, the sequence-parallel step
``make_sp_train_step`` and the pipeline steps ``make_pp_train_step``
(GPipe and 1F1B).  The JAX step is one jitted function over a mesh; here
it is an eager step that updates the model and the optimizer in place,
on one device (``mesh=None``) or on each rank of a (dp, fsdp, tp) or
(dp, fsdp, sp[, tp]) ``DeviceMesh``: parameters sharded by FSDP2 over
(dp, fsdp) and by the DTensor tp plan over tp (the tied embedding by
vocab rows, its head and CE vocab-parallel), replicated over sp, the
global batch split over (dp, fsdp).  The MoE model (``models/moe.py``)
trains on a (dp, fsdp, tp, ep) mesh, its experts split over (tp, ep).
Where the data dims hold one rank, FSDP2 is left out (it would only
copy), and a mesh of one rank runs the plain model.  On a (pp,) mesh
each rank holds one stage
(``llama.LlamaStage``) and the step runs ``parallel/pipeline.py``.
"""

from __future__ import annotations

import dataclasses
import gc
import os
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
import torch.nn.functional as F
from torch import nn
from torch.distributed.checkpoint.state_dict import (
    StateDictOptions,
    get_state_dict,
    set_state_dict,
)
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.parallel import parallelize_module
from torch.utils.checkpoint import checkpoint

from pytorch_operator_tpu_torch.models import llama, moe
from pytorch_operator_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    LlamaStage,
)
from pytorch_operator_tpu_torch.parallel.mesh import (
    AXIS_DP,
    AXIS_EP,
    AXIS_FSDP,
    AXIS_PP,
    AXIS_SP,
    AXIS_TP,
    dim_size,
    local_rows,
)
from pytorch_operator_tpu_torch.parallel.pipeline import (
    SCHEDULES,
    PipeComm,
    PipeLoopback,
    pipeline_value_and_grad,
)
from pytorch_operator_tpu_torch.telemetry import StepProfiler
from pytorch_operator_tpu_torch.utils import collectives


@dataclasses.dataclass
class TrainState:
    model: Llama | LlamaStage | nn.ModuleList
    optimizer: torch.optim.Optimizer
    step: int = 0


def adamw(model: Llama, lr: float = 3e-4,
          weight_decay: float = 0.1) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=wd)`` in torch.

    Same betas (0.9, 0.999), eps 1e-8 outside the square root, bias
    correction, and decoupled decay lr * wd * param on every parameter.
    The moments take the parameter's dtype, as optax's default
    ``mu_dtype=None`` keeps them (bf16 moments for a bf16 model).

    DTensor and plain parameters (a tp or ep layout without FSDP2 holds
    both) go in two parameter groups of the same settings: the foreach
    kernels, CUDA's default, take one kind of tensor per call."""
    params = list(model.parameters())
    groups = [g for g in ([p for p in params if isinstance(p, DTensor)],
                          [p for p in params if not isinstance(p, DTensor)])
              if g]
    return torch.optim.AdamW([{"params": g} for g in groups], lr=lr,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       group=None) -> torch.Tensor:
    """Mean next-token cross entropy; logits (B,T,V), targets (B,T).
    With ``group`` the logits are this rank's vocab slice (B,T,V/n) of a
    head split over ``group`` (``llama.shard_vocab``): the vocab-parallel
    CE, in f32 as the whole one."""
    if group is not None:
        return collectives.vocab_parallel_nll(logits.float(), targets,
                                              group).mean()
    V = logits.shape[-1]
    return F.cross_entropy(logits.float().reshape(-1, V),
                           targets.reshape(-1))


def _chunk_nll_sum(hc, embed, tc, group):
    logits = (hc @ embed.t()).float()
    if group is not None:
        return collectives.vocab_parallel_nll(logits, tc, group).sum()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, tc[..., None]).sum()


def chunked_tied_ce(h: torch.Tensor, embed: torch.Tensor,
                    targets: torch.Tensor, chunk: int = 1024,
                    group=None) -> torch.Tensor:
    """Mean next-token CE with the tied head applied per T-chunk.

    h (B, T, D), embed (V, D), targets (B, T).  Equal to
    ``cross_entropy_loss(h @ embed^T, targets)``, but each chunk's
    (chunk, V) f32 logits are recomputed in the backward
    (``torch.utils.checkpoint``) instead of being kept, so the full
    (T, V) logits never exist at once.  A ragged last slice is a smaller
    chunk.  With ``group``, ``embed`` is this rank's vocab rows of a
    head split over it: h enters the split region once (its gradient is
    summed over the group once), and each chunk's vocab-parallel CE runs
    its collectives again in the recompute, in the same order on every
    rank."""
    B, T, _ = h.shape
    chunk = min(chunk, T)
    if group is not None:
        h = collectives.copy_to_group(h, group)
    total = h.new_zeros((), dtype=torch.float32)
    for i in range(0, T, chunk):
        total = total + checkpoint(_chunk_nll_sum, h[:, i:i + chunk], embed,
                                   targets[:, i:i + chunk], group,
                                   use_reentrant=False)
    return total / (B * T)


def tied_ce(model, out: torch.Tensor, targets: torch.Tensor,
            chunked_ce: bool = False, ce_chunk: int = 1024) -> torch.Tensor:
    """The step's CE of ``model``'s output: its logits, or with
    ``chunked_ce`` its final hidden states through the tied head per
    ``ce_chunk`` tokens; vocab-parallel where its embedding is split."""
    rows, group = llama.vocab_rows(model)
    if chunked_ce:
        return chunked_tied_ce(out, rows, targets, ce_chunk, group=group)
    return cross_entropy_loss(out, targets, group=group)


def global_norm(grads) -> torch.Tensor:
    """sqrt(sum of squares) over every gradient, as ``optax.global_norm``
    (accumulated in f32): the norm of the full gradient on every rank.

    A DTensor gradient adds its local sum of squares; the sums of the
    gradients that share a mesh and placements are reduced together
    over the mesh dims that shard them (one all-reduce per layout), and
    not over the dims that replicate them or have one rank: a
    collective over one rank changes no value, and on the card it makes
    the host wait for the device."""
    plain, by_layout = [], {}
    for g in grads:
        if isinstance(g, DTensor):
            by_layout.setdefault((g.device_mesh, tuple(g.placements)),
                                 []).append(
                g.to_local().float().square().sum())
        else:
            plain.append(g.float().square().sum())
    total = sum(plain)
    for (mesh, placements), sums in by_layout.items():
        # every placement but Replicate splits the gradient (FSDP2's
        # strided shard under tp is no Shard subclass)
        partial = [Replicate() if p.is_replicate() or mesh.size(dim) == 1
                   else Partial() for dim, p in enumerate(placements)]
        sq = torch.stack(sums).sum()
        if any(p.is_partial() for p in partial):
            sq = DTensor.from_local(sq, mesh, partial,
                                    run_check=False).full_tensor()
        total = total + sq
    return torch.sqrt(total)


def _data_ranks(mesh: DeviceMesh) -> int:
    return dim_size(mesh, AXIS_DP) * dim_size(mesh, AXIS_FSDP)


def _is_sharded(model: Llama) -> bool:
    return any(isinstance(p, DTensor) for p in model.parameters())


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _arch(cfg: LlamaConfig):
    """The model family of ``cfg``: its module and its model class."""
    if isinstance(cfg, moe.MoEConfig):
        return moe, moe.MoELlama
    return llama, Llama


def _place(cfg: LlamaConfig, mesh: DeviceMesh) -> Llama:
    """The model of ``cfg`` laid out on ``mesh``, its memory allocated
    for this rank's shards and its values not set: the tp plan
    (``param_specs``) and the vocab split (``llama.shard_vocab``) over
    the mesh's tp dim when it is larger than 1, an MoE model's expert
    banks over (tp, ep) (``moe.shard_experts``), each block and then the
    root ``fully_shard``-ed over (dp, fsdp) (HSDP: replicated over dp,
    sharded over fsdp) when those dims hold more than one rank; on a
    mesh of one rank the plain model (no FSDP2, no DTensor)."""
    tp, ep = dim_size(mesh, AXIS_TP), dim_size(mesh, AXIS_EP)
    family, cls = _arch(cfg)
    llama.check_tp(cfg, tp)
    if ep > 1 and family is not moe:
        raise ValueError(f"the mesh's ep dim ({ep}) splits an MoE model's "
                         f"experts; {type(cfg).__name__} has none")
    device = _mesh_device(mesh)
    model = cls(cfg, device="meta")
    if mesh.size() > 1:
        if tp > 1:
            parallelize_module(model, mesh[AXIS_TP], family.param_specs(cfg))
            llama.shard_vocab(model, mesh[AXIS_TP])
        if family is moe:
            moe.shard_experts(model, mesh)
        if _data_ranks(mesh) > 1:
            data_mesh = mesh[AXIS_DP, AXIS_FSDP]
            for block in model.layers:
                fully_shard(block, mesh=data_mesh)
            fully_shard(model, mesh=data_mesh)
            # the chunked-CE step calls forward_hidden, not forward: it
            # must gather the root's parameters (the embedding, the final
            # norm) too
            register_fsdp_forward_method(model, "forward_hidden")
    return model.to_empty(device=device)


def sharded_init(cfg: LlamaConfig, mesh: DeviceMesh, seed: int = 0,
                 specs: list[range] | None = None) -> Llama | LlamaStage:
    """The model of ``cfg`` built straight into its shards on ``mesh``, a
    (dp, fsdp, tp) or (dp, fsdp, sp[, tp]) mesh, or for an
    ``moe.MoEConfig`` a (dp, fsdp, tp, ep) one (``_place``: FSDP2 over
    the data dims, the tp plan and the vocab split over tp, the experts
    over (tp, ep), replicated over sp, where those hold more than one
    rank).  The sp ranks hold the same shards
    (``make_sp_train_step`` averages their gradients).  ``init_params``
    draws every matrix whole, one at a time, from
    ``torch.Generator(seed)`` on the mesh's device, and each rank keeps
    its shard, so the values are bit for bit those of the unsharded
    ``Llama(cfg, generator=seed)`` (``moe.MoELlama``) on that device.

    On a mesh of one rank that is the model returned: no FSDP2, no
    DTensor, so the step costs what the single-device step costs.

    ``specs=llama.pp_param_specs(cfg, S)`` is the pipeline layout on a
    (pp,) mesh of S ranks: this rank's ``LlamaStage`` (its layer range,
    the embedding and the final norm), drawn from the same stream."""
    device = _mesh_device(mesh)
    gen = torch.Generator(device=device).manual_seed(seed)
    family, cls = _arch(cfg)
    if specs is not None:
        if family is moe:
            raise ValueError("the MoE model has no pipeline layout (nor "
                             "has the JAX package)")
        n = dim_size(mesh, AXIS_PP)
        if len(specs) != n or mesh.size() != n:
            raise ValueError(f"the pipeline layout of {len(specs)} stages "
                             f"needs a (pp,) mesh of as many ranks, got "
                             f"{mesh}")
        stage = mesh[AXIS_PP].get_local_rank() \
            if AXIS_PP in (mesh.mesh_dim_names or ()) else 0
        return LlamaStage(cfg, specs[stage], device=device, generator=gen)
    if mesh.size() == 1:
        return cls(cfg, device=device, generator=gen)
    model = _place(cfg, mesh)
    family.init_params(model, gen)
    return model


def make_train_step(
    cfg: LlamaConfig,
    model: Llama,
    optimizer: torch.optim.Optimizer,
    *,
    mesh: DeviceMesh | None = None,
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
    tokens (see chunked_tied_ce).  An ``moe.MoEConfig`` trains on the
    JAX MoE step's loss, ce + ``moe.AUX_LOSS_WEIGHT`` · aux.

    With ``mesh`` the model is ``sharded_init``'s and every rank calls
    the step with the same global batch: each takes its rows
    (``mesh.local_rows``), FSDP2 averages the gradients over (dp, fsdp)
    and the loss is all-reduced, so ``loss`` is the mean over the global
    batch and ``grad_norm`` the norm of the full gradient, as the JAX
    mesh step's.  AdamW's moments are DTensors sharded as their
    parameters.  On a mesh of one rank the step is the single-device
    one."""
    _check_step_args(cfg, model, mesh, ce_chunk)
    is_moe = _arch(cfg)[0] is moe

    def loss_fn(batch: torch.Tensor) -> torch.Tensor:
        inputs, targets = batch[:, :-1], batch[:, 1:]
        out = model.forward_hidden(inputs) if chunked_ce else model(inputs)
        if is_moe:
            out, aux = out
            return (tied_ce(model, out, targets, chunked_ce, ce_chunk)
                    + moe.AUX_LOSS_WEIGHT * aux)
        return tied_ce(model, out, targets, chunked_ce, ce_chunk)

    average_over_ep = None
    if is_moe and mesh is not None and dim_size(mesh, AXIS_EP) > 1:
        average_over_ep = _grad_averager(
            [p for name, p in model.named_parameters()
             if name.rsplit(".", 1)[-1] not in moe.EXPERT_BANKS],
            mesh[AXIS_EP])
    return _make_step(model, optimizer, mesh, loss_fn, average_over_ep)


def _grad_averager(params: list, sub_mesh: DeviceMesh) -> Callable[[], None]:
    """A function that averages the gradients of ``params``, which every
    rank of ``sub_mesh`` holds alike, over its ranks: one all-reduce per
    gradient (a DTensor's local shard), in place.  Ranks that compute the
    same gradient apart (the sp ranks; the ep ranks on the attention,
    whose fused flash backward sums dq with f32 atomics in an order that
    changes from run to run) then hold the same bits, and their copies of
    the parameters stay equal, as JAX's one logical copy is."""
    group, n = sub_mesh.get_group(), sub_mesh.size()

    def average() -> None:
        works = []
        for p in params:
            if p.grad is not None:
                g = p.grad.to_local() if isinstance(p.grad, DTensor) \
                    else p.grad
                works.append((g, dist.all_reduce(g, group=group,
                                                 async_op=True)))
        for g, work in works:
            work.wait()
            g /= n

    return average


def _check_step_args(cfg, model, mesh, ce_chunk) -> None:
    if ce_chunk < 1:
        raise ValueError(f"ce_chunk must be >= 1, got {ce_chunk}")
    if model.cfg != cfg:
        raise ValueError("the model was built from another config")
    want = mesh is not None and (_data_ranks(mesh) > 1
                                 or dim_size(mesh, AXIS_TP) > 1
                                 or dim_size(mesh, AXIS_EP) > 1)
    if _is_sharded(model) != want:
        raise ValueError("a sharded model (sharded_init) needs its mesh, "
                         "and a mesh needs sharded_init's model")


def _make_step(model, optimizer, mesh, loss_fn, after_backward=None,
               drop=False):
    """The step around ``loss_fn(local batch)``: this rank's rows of the
    global batch (``local_rows(..., drop=drop)``), backward,
    ``after_backward()``, the global gradient norm, AdamW and the loss
    averaged over the ranks."""
    device = model.embed.device
    params = list(model.parameters())

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("state does not hold this step's model and "
                             "optimizer")
        if isinstance(batch, np.ndarray):
            batch = torch.from_numpy(batch)
        if mesh is not None:
            batch = local_rows(batch, mesh, drop=drop)
        batch = batch.to(device=device, dtype=torch.long)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(batch)
        loss.backward()
        if after_backward is not None:
            after_backward()
        with torch.no_grad():
            gnorm = global_norm(p.grad for p in params if p.grad is not None)
        optimizer.step()
        loss = loss.detach()
        if mesh is not None and mesh.size() > 1:
            # equal rows (and sequence chunks) on every rank, the same
            # loss on the tp ranks of a shard: the mesh's mean is the
            # global batch's mean
            loss = _mesh_mean(loss.clone(), mesh)
        return (TrainState(model, optimizer, state.step + 1),
                {"loss": loss, "grad_norm": gnorm})

    return step


def _mesh_mean(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``mesh``."""
    if mesh.size() == dist.get_world_size():
        dist.all_reduce(x)
    else:  # a mesh over some of the group's ranks (reshard_state's)
        x = DTensor.from_local(x, mesh, [Partial()] * mesh.ndim,
                               run_check=False).full_tensor()
    return x / mesh.size()


def make_sp_train_step(
    cfg: LlamaConfig,
    model: Llama,
    optimizer: torch.optim.Optimizer,
    *,
    mesh: DeviceMesh,
    axis_name: str = AXIS_SP,
    impl: str = "ulysses",
    chunked_ce: bool = False,
    ce_chunk: int = 1024,
) -> Callable[[TrainState, torch.Tensor], tuple[TrainState, dict]]:
    """The sequence-parallel training step on a (dp, fsdp, sp[, tp]) mesh
    (``make_sp_mesh``), for ``sharded_init``'s model on it.

    Every rank calls it with the same global (B, T+1) batch.  A rank
    takes its rows over the data dims that divide B (``local_rows`` with
    ``drop``, as the JAX ``forward_sp``: at B=1 over fsdp 2 both fsdp
    ranks take the one row) and, of those, the T/sp sequence rows of
    its sp coordinate (``llama.sp_positions``:
    contiguous, or the zigzag slice for ``ring_zigzag``; the targets
    alike), and runs ``llama.forward_sp``: attention through the ring or
    the all-to-all over the mesh's sp dim (``impl``: ulysses, ring,
    ring_zigzag).  Its loss is the mean over its tokens, so with equal
    chunks the mean over the ranks is the JAX step's global mean.
    FSDP2 averages the gradients over the data dims; the sp ranks, which
    hold the same parameters, then average theirs (one all-reduce per
    gradient over sp), so every gradient is the global batch's.
    ``chunked_ce`` applies the tied head per ``ce_chunk`` of the rank's
    tokens."""
    _check_step_args(cfg, model, mesh, ce_chunk)
    if _arch(cfg)[0] is moe:
        raise ValueError("the MoE model has no sequence-parallel forward "
                         "(nor has the JAX package)")
    if impl not in llama.SP_IMPLS:
        raise ValueError(f"unknown sp impl {impl!r}")
    sp_mesh = mesh[axis_name]
    group = sp_mesh.get_group()
    sp = sp_mesh.size()

    def loss_fn(batch: torch.Tensor) -> torch.Tensor:
        inputs, targets = batch[:, :-1], batch[:, 1:]
        pos = llama.sp_positions(inputs.shape[1], sp,
                                 sp_mesh.get_local_rank(), impl,
                                 inputs.device)
        h = llama.forward_sp(model, inputs, group, impl=impl,
                             return_hidden=chunked_ce)
        return tied_ce(model, h, targets[:, pos], chunked_ce, ce_chunk)

    average_over_sp = (_grad_averager(list(model.parameters()), sp_mesh)
                       if sp > 1 else None)
    return _make_step(model, optimizer, mesh, loss_fn, average_over_sp,
                      drop=True)


def make_pp_train_step(
    cfg: LlamaConfig,
    model: LlamaStage | nn.ModuleList,
    optimizer: torch.optim.Optimizer,
    *,
    mesh: DeviceMesh | None = None,
    n_microbatches: int,
    axis_name: str = AXIS_PP,
    chunked_ce: bool = False,
    ce_chunk: int = 1024,
    schedule: str = "gpipe",
) -> Callable[[TrainState, torch.Tensor], tuple[TrainState, dict]]:
    """The training step through the microbatch pipeline (the JAX
    ``make_pp_train_step`` and ``_make_1f1b_step``).

    With ``mesh``, a (pp,) mesh: ``model`` is this rank's stage
    (``sharded_init(cfg, mesh, specs=llama.pp_param_specs(cfg, S))``)
    and the stages talk P2P over the mesh's ``axis_name`` group.  With
    ``mesh=None``: ``model`` is every stage in this process
    (``llama.pipeline_stages``), run as ``PipeLoopback``, and
    ``optimizer`` holds all of their parameters.  Every rank calls the
    step with the same global (B, T+1) batch; stage 0 embeds the inputs,
    the last stage applies the final norm, the tied head (per
    ``ce_chunk`` tokens with ``chunked_ce``) and the cross entropy of
    each microbatch pre-scaled by 1/M, whose sum is the global batch's
    mean.

    ``schedule``: ``"gpipe"`` or ``"1f1b"``
    (``parallel.pipeline.pipeline_value_and_grad``).  Both run the loss
    inside the last stage: the JAX GPipe step applies the head to the
    pipeline's replicated output on every stage instead; the values are
    the same.  The embedding's and the final norm's gradients are summed
    over the stages (JAX: ``lax.psum``), so AdamW keeps every stage's
    copy equal; ``grad_norm`` is the norm of the whole model's gradient
    and ``loss`` the global batch's, on every stage."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    if ce_chunk < 1:
        raise ValueError(f"ce_chunk must be >= 1, got {ce_chunk}")
    if mesh is None:
        stages = list(model)
        comm = PipeLoopback(len(stages))
        params = stages
    else:
        stages = [model]
        comm = PipeComm(mesh[axis_name].get_group())
        params = model
    if any(st.cfg != cfg for st in stages):
        raise ValueError("the stages were built from another config")
    M = n_microbatches
    device = stages[0].embed.device

    def first_fn(stage, tokens):
        return stage.embed_tokens(tokens)

    def stage_fn(stage, x):
        return stage.run_layers(x)

    def last_fn(stage, y, targets):
        h = stage.head(y, return_hidden=True)
        if chunked_ce:
            loss = chunked_tied_ce(h, stage.embed, targets, ce_chunk)
        else:
            loss = cross_entropy_loss((h @ stage.embed.t()).float(),
                                      targets)
        # the microbatches' losses add up to the global batch's mean
        return loss / M

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("state does not hold this step's model and "
                             "optimizer")
        if isinstance(batch, np.ndarray):
            batch = torch.from_numpy(batch)
        batch = batch.to(device=device, dtype=torch.long)
        optimizer.zero_grad(set_to_none=True)
        loss = pipeline_value_and_grad(
            first_fn, stage_fn, last_fn, params, batch[:, :-1],
            batch[:, 1:], comm, n_microbatches=M, schedule=schedule)
        with torch.no_grad():
            _sum_shared_grads(stages, comm)
            gnorm = _pp_global_norm(stages, comm)
        optimizer.step()
        if isinstance(comm, PipeComm) and comm.n > 1:
            # the loss lives on the last stage
            if loss is None:
                loss = torch.zeros((), dtype=torch.float32, device=device)
            dist.all_reduce(loss, group=comm.group)
        return (TrainState(model, optimizer, state.step + 1),
                {"loss": loss, "grad_norm": gnorm})

    return step


# the parameters every stage holds
_SHARED = ("embed", "final_norm")


def _sum_shared_grads(stages: list[LlamaStage], comm) -> None:
    """Sum the embedding's and the final norm's gradients over the
    stages (stage 0 has the lookup's, the last the head's, the others
    none), so that every stage holds the whole model's."""
    for name in _SHARED:
        ps = [getattr(st, name) for st in stages]
        gs = [p.grad if p.grad is not None else torch.zeros_like(p)
              for p in ps]
        if isinstance(comm, PipeComm):
            if comm.n > 1:
                dist.all_reduce(gs[0], group=comm.group)
            ps[0].grad = gs[0]
            continue
        total = gs[0]
        for g in gs[1:]:
            total = total + g
        for p in ps:
            p.grad = total.clone()


def _pp_global_norm(stages: list[LlamaStage], comm) -> torch.Tensor:
    """The norm of the whole model's gradient: each stage's layers once,
    the shared parameters once (stage 0's, summed already)."""
    sq = sum(p.grad.float().square().sum()
             for st in stages for name, p in st.named_parameters()
             if p.grad is not None and name not in _SHARED)
    if not isinstance(comm, PipeComm) or comm.rank == 0:
        sq = sq + sum(getattr(stages[0], name).grad.float().square().sum()
                      for name in _SHARED)
    sq = torch.as_tensor(sq, dtype=torch.float32,
                         device=stages[0].embed.device)
    if isinstance(comm, PipeComm) and comm.n > 1:
        dist.all_reduce(sq, group=comm.group)
    return torch.sqrt(sq)


# ---------------------------------------------------------------------------
# Checkpoints: torch.distributed.checkpoint, one directory per step


# The optimizer's state keyed by each parameter's name
# ("state.layers.8.wq.weight.exp_avg"), not by its place in the
# optimizer: a pipeline stage holds some of the model's parameters, and
# a checkpoint written under one layout restores under another.
_SD_OPTIONS = StateDictOptions(flatten_optimizer_state_dict=True)


def save_checkpoint(state: TrainState, directory: str | os.PathLike) -> Path:
    """Write the model and optimizer state at ``state.step`` to
    ``directory/<step>`` (every rank calls it; each writes its shards).

    The files hold global shapes and each shard's offsets, and every
    parameter under its name in the whole model (a pipeline stage's
    layers under their global names; the parameters every stage holds
    are written once), so ``restore_on_mesh`` reads them back at any
    world size and mesh shape, pipeline or not.  The AdamW step count is
    part of the optimizer state."""
    path = Path(directory) / str(state.step)
    model_sd, optim_sd = get_state_dict(state.model, state.optimizer,
                                        options=_SD_OPTIONS)
    dcp.save({"model": model_sd, "optim": optim_sd}, checkpoint_id=path)
    return path


def latest_checkpoint(directory: str | os.PathLike) -> int | None:
    """The highest step under ``directory`` whose checkpoint is whole
    (its ``.metadata`` is written last), or None."""
    root = Path(directory)
    if not root.is_dir():
        return None
    steps = [int(p.name) for p in root.iterdir()
             if p.name.isdigit() and (p / ".metadata").is_file()]
    return max(steps, default=None)


def restore_on_mesh(directory: str | os.PathLike, step: int,
                    target: TrainState) -> TrainState:
    """Read checkpoint ``step`` into ``target``'s model and optimizer, in
    their own layout (the port of the JAX ``restore_on_mesh``).

    ``target`` is a freshly built state on the current mesh, or a
    pipeline stage; the checkpoint may come from another world size or
    mesh shape, or another pipeline layout:
    ``torch.distributed.checkpoint`` reads each rank's shards out of
    the saved ones, so the restored values are the saved ones, bit for
    bit."""
    model_sd, optim_sd = get_state_dict(target.model, target.optimizer,
                                        options=_SD_OPTIONS)
    sd = {"model": model_sd, "optim": optim_sd}
    dcp.load(sd, checkpoint_id=Path(directory) / str(step))
    set_state_dict(target.model, target.optimizer,
                   model_state_dict=sd["model"], optim_state_dict=sd["optim"],
                   options=_SD_OPTIONS)
    return TrainState(target.model, target.optimizer, step)


def reshard_state(state: TrainState | None, cfg: LlamaConfig,
                  mesh: DeviceMesh) -> TrainState | None:
    """Move a live state onto another (dp, fsdp, tp) mesh of the same
    process group (the JAX ``reshard_state``): the model laid out on
    ``mesh`` (``_place``) with every parameter's and every AdamW
    moment's gathered value bit for bit the old one, the optimizer of
    the same kind and settings, and the step count.

    Every rank of the group calls it.  ``mesh`` may span fewer ranks
    (``make_mesh(..., ranks=[0, 1])``): the ranks outside it get None
    and hold nothing.  A rank outside the old mesh passes None; where
    the new mesh reaches such ranks, the values go to them from the old
    mesh's first rank.  Each value is gathered whole on the old mesh,
    one at a time, and each rank of the new one keeps its shard.

    The old state is consumed: its model and optimizer are dropped from
    it and garbage-collected (FSDP2's hooks form reference cycles), so
    their memory is free once the caller holds no other reference."""
    old_model = state.model if state is not None else None
    old_opt = state.optimizer if state is not None else None
    in_new = mesh.get_coordinate() is not None
    device = _mesh_device(mesh)
    src = None
    if old_opt is not None:
        st = next(iter(old_opt.state.values()), {})
        src = {"group": {k: v for k, v in old_opt.param_groups[0].items()
                         if k != "params"},
               "kind": type(old_opt).__name__,
               "state_keys": sorted(k for k, v in st.items()
                                    if k != "step"),
               "step": float(st["step"]) if "step" in st else None,
               "train_step": state.step}
    # who holds the old state, who gets the new, and the old settings
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, (src is not None, in_new, src))
    olds = [r for r, (has, _, _) in enumerate(seen) if has]
    if not olds:
        raise ValueError("no rank holds a state to reshard")
    info = seen[olds[0]][2]
    if info["kind"] != "AdamW":  # on every rank, so that none waits
        raise ValueError(f"reshard_state moves AdamW's state, got "
                         f"{info['kind']}")
    # the new mesh reaches ranks that hold no old value: send them
    spread = any(new and not has for has, new, _ in seen)

    new_model = _place(cfg, mesh) if in_new else None
    new_opt = None
    if in_new:
        new_opt = adamw(new_model)
        for group in new_opt.param_groups:
            group.update(info["group"])
    old_params = dict(old_model.named_parameters()) if old_model else {}
    new_params = dict(new_model.named_parameters()) if new_model else {}
    ref = _arch(cfg)[1](cfg, device="meta")

    def move(shape, old_value, target):
        """The full value of one tensor of the old state into ``target``
        (a parameter or moment of the new one, or None)."""
        full = None
        if old_value is not None:
            full = llama.full_value(old_value).detach()
        if spread:
            if full is None:
                full = torch.empty(shape, dtype=cfg.dtype, device=device)
            dist.broadcast(full, olds[0])
        if target is not None:
            llama.assign(target, full)

    with torch.no_grad():
        for name, p in ref.named_parameters():
            old_p = old_params.get(name)
            new_p = new_params.get(name)
            move(p.shape, old_p, new_p)
            if info["step"] is None:
                continue
            old_st = old_opt.state[old_p] if old_p is not None else {}
            new_st = {}
            for key in info["state_keys"]:
                if new_p is not None:
                    new_st[key] = torch.zeros_like(new_p)
                move(p.shape, old_st.get(key), new_st.get(key))
            if new_p is not None:
                new_st["step"] = torch.tensor(info["step"],
                                              dtype=torch.float32)
                new_opt.state[new_p] = new_st
    del old_params, old_model, old_opt
    if state is not None:
        state.model = state.optimizer = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if not in_new:
        return None
    return TrainState(new_model, new_opt, info["train_step"])


def with_step_profiler(
    step_fn: Callable,
    cfg: LlamaConfig,
    mesh: DeviceMesh | None = None,
    *,
    batch: int,
    seq_len: int,
    device: str | torch.device | None = None,
    job: str = "",
    jsonl_path: str | None = None,
    on_record: Callable | None = None,
    window: int = 32,
):
    """Instrument a ``make_train_step`` product with telemetry.

    Returns ``(profiled_step, profiler)``: the wrapped step has the same
    signature and return and waits for the device
    (``torch.cuda.synchronize`` on cuda) so that its time covers the
    device's work; the profiler holds the first-step vs steady split,
    rolling tokens/s and the 6·N·B·T MFU estimate sized from ``cfg``
    and the mesh (``telemetry/step_timer.py``).  The device is the
    mesh's, else ``device`` (cuda unless the caller names cpu)."""
    profiler = StepProfiler.for_llama(
        cfg, mesh, batch=batch, seq_len=seq_len, device=device, job=job,
        jsonl_path=jsonl_path, on_record=on_record, window=window)
    return profiler.wrap(step_fn), profiler
