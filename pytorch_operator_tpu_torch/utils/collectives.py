"""Collectives with their gradients, for the regions a model splits
over a process group, and the vocab-parallel lookup and cross entropy.

A region split over a group (the tied head's vocab over tp, the expert
banks over (tp, ep)) begins where a tensor that every rank holds whole
enters it and ends where the ranks' partial results are summed.  The
two are a conjugate pair (Megatron-LM's f and g):

  copy_to_group      identity forward, all-reduce backward: each rank's
                     gradient of the input is a partial one
  reduce_from_group  all-reduce forward, identity backward: the sum is
                     whole on every rank, and so is its gradient

The JAX package gets both from GSPMD; here they are written out, so that
no DTensor reaches a kernel.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, whole on every rank of ``group``, entering a split region:
    its gradient is summed over the group."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of each rank's partial ``x``, leaving a split
    region: the gradient of the sum passes to each rank's part as is."""
    return _ReduceFromGroup.apply(x, group)


def group_over(mesh, dims: tuple[str, ...]):
    """The process group of this rank over the mesh dims ``dims`` (all
    ranks that share its coordinates on the other dims), or None where
    those dims hold one rank.  For several dims every rank of the mesh
    makes every such group, in one order, as ``dist.new_group`` needs."""
    dims = tuple(d for d in dims if d in (mesh.mesh_dim_names or ())
                 and mesh[d].size() > 1)
    if not dims:
        return None
    if len(dims) == 1:
        return mesh[dims[0]].get_group()
    names = list(mesh.mesh_dim_names)
    order = [names.index(d) for d in names if d not in dims] + [
        names.index(d) for d in dims]
    rows = mesh.mesh.permute(order).reshape(
        -1, math.prod(mesh[d].size() for d in dims))
    me, mine = dist.get_rank(), None
    for row in rows.tolist():
        group = dist.new_group(row)
        if me in row:
            mine = group
    return mine


def vocab_parallel_embedding(tokens: torch.Tensor, rows: torch.Tensor,
                             first: int, group) -> torch.Tensor:
    """The lookup of ``tokens`` in a table split by rows over ``group``:
    ``rows`` are this rank's, from vocab index ``first``.  Each rank looks
    up the tokens it holds (zeros for the rest) and the sum over the
    group is the whole lookup; each rank's rows get the gradient of their
    own tokens only."""
    inside = (tokens >= first) & (tokens < first + rows.shape[0])
    h = F.embedding((tokens - first).masked_fill(~inside, 0), rows)
    return reduce_from_group(h.masked_fill(~inside[..., None], 0), group)


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token -log softmax(logits)[target] of f32 logits split over
    vocab: the max, the target's logit (from the rank that holds it) and
    the sum of exps are reduced over the group; the gradient is the
    local softmax less the one-hot target, with no collective."""

    @staticmethod
    def forward(ctx, logits, targets, group):
        V = logits.shape[-1]
        first = dist.get_rank(group) * V
        m = logits.max(dim=-1).values
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        z = logits - m[..., None]
        inside = (targets >= first) & (targets < first + V)
        local = (targets - first).masked_fill(~inside, 0)
        picked = z.gather(-1, local[..., None])[..., 0].masked_fill(~inside,
                                                                     0.0)
        e = z.exp_()
        sums = torch.stack([picked, e.sum(dim=-1)])
        dist.all_reduce(sums, group=group)
        e /= sums[1][..., None]
        ctx.save_for_backward(e, local, inside)
        return sums[1].log() - sums[0]

    @staticmethod
    def backward(ctx, grad):
        softmax, local, inside = ctx.saved_tensors
        g = softmax.clone()
        g.scatter_add_(-1, local[..., None],
                       -inside[..., None].to(g.dtype))
        return g * grad[..., None], None, None


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor,
                       group) -> torch.Tensor:
    """-log p(target) per token, (…,) from this rank's f32 logits (…, V/n)
    over vocab rows [r·V/n, (r+1)·V/n) of ``group``'s rank r."""
    if logits.dtype != torch.float32:
        raise TypeError(f"vocab-parallel CE takes f32 logits, got "
                        f"{logits.dtype}")
    return _VocabParallelNLL.apply(logits, targets, group)
