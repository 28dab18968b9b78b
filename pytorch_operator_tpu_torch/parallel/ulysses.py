"""All-to-all (Ulysses) sequence parallelism.

Port of ``pytorch_operator_tpu/parallel/ulysses.py``.  Around the
attention, two all-to-alls re-shard between sequence and head
parallelism:

    (B, T/n, H, D)  --all_to_all-->  (B, T, H/n, D)
        attention over the FULL sequence on 1/n of the heads
        (the port's flash kernels, or the dense path)
    (B, T, H/n, D)  --all_to_all-->  (B, T/n, H, D)

Each all-to-all is an ``autograd.Function`` whose backward is the
inverse all-to-all.  ``all_to_all_single`` splits and concatenates dim 0
over the ranks, so the rank dim is permuted to the front first.  Rank i
of the group holds rows [i·T/n, (i+1)·T/n) and, between the two, heads
[i·H/n, (i+1)·H/n); grouped K/V keep the query-group -> kv-head map, as
in the JAX module.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from pytorch_operator_tpu_torch import ops


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` of a tensor whose dim 0 is the rank dim."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _seq_to_heads(x, group):
    """(B, T/n, H, D) rows of this rank -> (B, T, H/n, D) heads."""
    n = dist.get_world_size(group)
    B, Tl, H, D = x.shape
    x = x.reshape(B, Tl, n, H // n, D).permute(2, 0, 1, 3, 4)
    y = _all_to_all(x, group)  # (n: source rank, B, Tl, H/n, D)
    return y.permute(1, 0, 2, 3, 4).reshape(B, n * Tl, H // n, D)


def _heads_to_seq(y, group):
    """(B, T, H/n, D) heads of this rank -> (B, T/n, H, D) rows."""
    n = dist.get_world_size(group)
    B, T, Hl, D = y.shape
    y = y.reshape(B, n, T // n, Hl, D).permute(1, 0, 2, 3, 4)
    x = _all_to_all(y, group)  # (n: source rank's heads, B, T/n, Hl, D)
    return x.permute(1, 2, 0, 3, 4).reshape(B, T // n, n * Hl, D)


class _AllToAll(torch.autograd.Function):
    """``_seq_to_heads`` (to_heads) or ``_heads_to_seq``; the backward is
    the other one."""

    @staticmethod
    def forward(ctx, x, group, to_heads):
        ctx.group, ctx.to_heads = group, to_heads
        return (_seq_to_heads if to_heads else _heads_to_seq)(x, group)

    @staticmethod
    def backward(ctx, g):
        back = _heads_to_seq if ctx.to_heads else _seq_to_heads
        return back(g, ctx.group), None, None


def check_ulysses(n: int, T: int, H: int, Hk: int,
                  axis_name: str = "sp") -> None:
    """The JAX ``ulysses_attention``'s checks on the per-shard counts,
    with its messages (T is the global length)."""
    if T % n:
        raise ValueError(f"seq len {T} not divisible by {axis_name}={n}")
    if H % n:
        raise ValueError(f"{H} heads/shard not divisible by {axis_name}={n} "
                         f"(all-to-all SP shards heads; use ring_attention "
                         f"for head counts below the mesh axis)")
    if H % Hk:
        raise ValueError(f"kv heads ({Hk}) must divide q heads ({H})")
    if Hk % n:
        raise ValueError(f"{Hk} kv heads/shard not divisible by "
                         f"{axis_name}={n} (broadcast KV heads to a "
                         f"multiple of the axis, or use ring_attention)")


def ulysses_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None, *,
    causal: bool = True,
    local_attention: Callable | None = None,
) -> torch.Tensor:
    """Exact attention of this rank's rows with the sequence split over
    ``group``: q (B, T/n, H, D), k / v (B, T/n, H_kv, D), n dividing H
    and H_kv.  ``local_attention(q, k, v, causal)`` runs on (B, T, H/n,
    D); by default ``ops.flash_attention`` (the flash kernels on CUDA).
    Returns (B, T/n, H, D); differentiable."""
    n = dist.get_world_size(group)
    check_ulysses(n, q.shape[1] * n, q.shape[2], k.shape[2])
    attend = local_attention or ops.flash_attention
    qh, kh, vh = (_AllToAll.apply(x, group, True) for x in (q, k, v))
    return _AllToAll.apply(attend(qh, kh, vh, causal=causal), group, False)
