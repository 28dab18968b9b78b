"""Ring attention: attention over a sequence split across the ranks of a
ring, through the flash kernels.

Port of ``pytorch_operator_tpu/parallel/ring_attention.py``.  Each rank
holds a chunk of T/n rows of q, k and v; the K/V chunks travel around
the ring (rank r sends to r+1 and receives from r-1) while each rank
merges its q chunk's attention over every K/V chunk with an online
softmax of the chunks' (out, lse) pairs (``_acc_merge``).  Chunks after
the q chunk are fully masked under causality and skipped (they still
travel).  Layouts, as in the JAX module:

  contiguous   rank r holds rows [r·T/n, (r+1)·T/n)
  zigzag_pre   rank r holds the global half-chunks (r, 2n-1-r) of 2n,
               rows already in that order (``zigzag_layout``), which
               evens out the causal work between ranks

The JAX module differentiates through ``ppermute`` and each chunk's
``flash_with_lse`` vjp.  Here one ``torch.autograd.Function`` carries the
whole ring with its backward written out: the forward keeps q, the local
k and v, the merged out and the merged lse; the backward computes
delta = rowsum(dO · O) once, sends K/V around the ring again, and runs
each chunk's backward kernels with the MERGED lse and delta, which give
that chunk's exact share of dq, dk and dv.  The f32 dk / dv accumulators
travel with the K/V chunks and are home after n steps.  No per-chunk
output is kept.

Every (q-chunk, kv-chunk) pair goes through the flash kernels on CUDA
(B1, and B2 or B3 + B4 by ``_use_fused_bwd`` at the chunk length),
causal on the diagonal and non-causal below it; the JAX module sends a
chunk that does not tile to dense XLA, the kernels mask any length.  On
the CPU the kernels' plain versions run, as everywhere in the port.

Communication sits behind one interface.  The ring bodies are
generators that yield the tensors to send and get back a pending
transfer whose ``wait()`` gives the tensors received; a transfer is
posted before the chunk's kernels run and waited on after, so it
overlaps them.  ``RingComm`` posts NCCL or gloo P2P
(``batch_isend_irecv``) over a process group; ``ring_attention_loopback``
runs n virtual ranks in one process in lock step, handing each the
neighbour's tensors.  Both run the same arithmetic in the same order and
give the same bits.
"""

from __future__ import annotations

from typing import Generator, Sequence

import numpy as np
import torch
import torch.distributed as dist

from pytorch_operator_tpu_torch import kernels
from pytorch_operator_tpu_torch.ops.flash_attention import (
    _reduce_kv_partials,
    flash_bwd,
    flash_fwd,
)

LAYOUTS = ("contiguous", "zigzag_pre")


def zigzag_layout(T: int, sp: int, axis_name: str = "sp"
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Global row permutation of the zigzag layout, and its inverse: rank
    i's slice of the permuted rows holds chunks (i, 2·sp-1-i) of 2·sp.  A
    copy of the JAX function, with its message."""
    if T % (2 * sp):
        raise ValueError(
            f"seq len {T} not divisible by 2*{axis_name}={2 * sp} "
            f"(zigzag splits each device's slice into front/back "
            f"half-chunks)")
    C = T // (2 * sp)
    order = []
    for i in range(sp):
        order += [i, 2 * sp - 1 - i]
    perm = np.concatenate([np.arange(c * C, (c + 1) * C) for c in order])
    inv = np.empty_like(perm)
    inv[perm] = np.arange(T)
    return perm, inv


def check_heads(H: int, Hk: int) -> None:
    if H % Hk:
        raise ValueError(f"kv heads must divide q heads: q has {H}, k/v "
                         f"have {Hk}")


# --------------------------------------------------------------------------
# one (q-chunk, kv-chunk) pair through the kernels (plain versions on CPU)
# --------------------------------------------------------------------------


def _chunk_fwd(q, k, v, scale, causal):
    """(out (B, Tc, H, D) in q's dtype, lse (B, Tc, H) f32) of one pair,
    through ``ptt::flash_fwd`` (so a save_attn remat policy keeps it)."""
    B, Tc, H, _ = q.shape
    out, lse = flash_fwd(q, k, v, scale, causal, False)
    return out, lse.view(B, H, Tc).transpose(1, 2)


def _chunk_bwd(q, k, v, g, lse, delta, scale, causal):
    """(dq (f32, or q's dtype on the two-kernel route), dk, dv (f32)) of
    one pair given the merged lse and delta ((B*H, Tc) f32): the backward
    kernels of ``_Flash.backward``'s route for the chunk length."""
    dq, dkp, dvp = flash_bwd(q, k, v, g, lse, delta, scale, causal, False)
    group = q.shape[2] // k.shape[2]
    return (dq, _reduce_kv_partials(dkp, group, torch.float32, False),
            _reduce_kv_partials(dvp, group, torch.float32, False))


def _acc_merge(acc, part):
    """Online-softmax merge of one chunk's normalised (out, lse) into the
    (o, m, l) accumulator (o f32 (B, T, H, D), m and l f32 (B, T, H)), as
    the JAX ``_acc_merge`` with m := lse, l := 1.  The JAX accumulator
    starts at (0, NEG_INF, 0), whose first merge gives (out, lse, 1)
    exactly; here a fresh accumulator is None and its first merge is the
    chunk itself, l = None standing for 1, which saves those passes."""
    if acc is None:
        return part[0], part[1], None
    o, m, l = acc
    o_p, m_p = part
    m_new = torch.maximum(m, m_p)
    a = torch.exp(m - m_new)
    b = torch.exp(m_p - m_new)
    l = a if l is None else l * a
    return (o.float() * a[..., None] + o_p.float() * b[..., None], m_new,
            l + b)


def _acc_finish(acc, dtype):
    """(out in ``dtype``, lse f32 (B, T, H)); rows with no key (l == 0)
    stay 0."""
    o, m, l = acc
    if l is None:  # one chunk: its own (out, lse)
        return o.to(dtype), m
    l = torch.where(l == 0.0, 1.0, l)
    return (o / l[..., None]).to(dtype), m + torch.log(l)


def _cat(xs):
    return xs[0] if len(xs) == 1 else torch.cat(xs, 1)


def _bh_rows(x):
    """(B, T, H) -> (B*H, T), contiguous: the kernels' lse / delta rows."""
    B, T, H = x.shape
    return x.transpose(1, 2).reshape(B * H, T).contiguous()


def _halves(x):
    C = x.shape[1] // 2
    return x[:, :C].contiguous(), x[:, C:].contiguous()


# --------------------------------------------------------------------------
# the ring bodies: generators that yield what to send and receive a
# pending transfer (``wait()`` gives what came from the previous rank)
# --------------------------------------------------------------------------

Body = Generator[list, "Pending", tuple]


def _pairs(rank: int, src: int, causal: bool, layout: str):
    """The (q part, kv part, causal) pairs rank computes against kv chunk
    ``src``; parts are 0 (all rows) for contiguous, 0 / 1 (front / back
    half) for zigzag_pre.  The rest are fully masked: skipped."""
    if layout == "contiguous":
        if not causal or src < rank:
            return [(0, 0, False)]
        return [(0, 0, True)] if src == rank else []
    pairs = []
    # front q (chunk id rank) against front kv (id src)
    if src <= rank:
        pairs.append((0, 0, src == rank))
    # back q (id 2n-1-rank >= n) against front kv (id src < n): always past
    pairs.append((1, 0, False))
    # back q against back kv (id 2n-1-src): past iff src > rank
    if src >= rank:
        pairs.append((1, 1, src == rank))
    # front q against back kv: always future
    return pairs


def _split(x, layout):
    return [x] if layout == "contiguous" else list(_halves(x))


def _ring_fwd(q, k, v, rank, n, causal, layout, scale) -> Body:
    """This rank's merged (out (B, T, H, D) in q's dtype, lse (B, T, H)
    f32); n - 1 rotations."""
    qs = _split(q, layout)
    accs = [None] * len(qs)
    kc, vc = k, v
    for s in range(n):
        src = (rank - s) % n
        pending = (yield [kc, vc]) if s < n - 1 else None
        ks, vs = _split(kc, layout), _split(vc, layout)
        for qi, ki, c in _pairs(rank, src, causal, layout):
            accs[qi] = _acc_merge(accs[qi], _chunk_fwd(qs[qi], ks[ki],
                                                       vs[ki], scale, c))
        if pending is not None:
            kc, vc = pending.wait()
    outs, lses = zip(*(_acc_finish(a, q.dtype) for a in accs))
    return _cat(outs), _cat(lses)


def _ring_bwd(q, k, v, out, lse, g, rank, n, causal, layout, scale) -> Body:
    """(dq, dk, dv) of this rank's chunks in their dtypes.  K/V take
    n - 1 rotations; the dk / dv accumulators of the chunk in hand
    travel with them and take n, which brings each home."""
    B, T, H, D = q.shape
    Hk = k.shape[2]
    delta = (g.float() * out.float()).sum(-1)  # (B, T, H)
    qs, gs = _split(q, layout), _split(g.contiguous(), layout)
    # (B*H, T) rows, split along T as the q chunks are
    lses, deltas = _split(_bh_rows(lse), layout), _split(_bh_rows(delta),
                                                         layout)
    dqs = [None] * len(qs)
    kc, vc = k, v
    dkv_pending = None
    for s in range(n):
        src = (rank - s) % n
        kv_pending = (yield [kc, vc]) if s < n - 1 else None
        ks, vs = _split(kc, layout), _split(vc, layout)
        parts = []
        for qi, ki, c in _pairs(rank, src, causal, layout):
            dq, dk, dv = _chunk_bwd(qs[qi], ks[ki], vs[ki], gs[qi],
                                    lses[qi], deltas[qi], scale, c)
            # summed in f32; a lone contribution keeps its dtype
            dqs[qi] = dq if dqs[qi] is None else dqs[qi].float() + dq
            parts.append((ki, dk, dv))
        # the accumulators of kv chunk src, from the previous rank
        if dkv_pending is None:
            dk_acc = torch.zeros(B, T, Hk, D, dtype=torch.float32,
                                 device=q.device)
            dv_acc = torch.zeros_like(dk_acc)
        else:
            dk_acc, dv_acc = dkv_pending.wait()
        half = T // len(qs)
        for ki, dk, dv in parts:
            rows = slice(ki * half, (ki + 1) * half)
            dk_acc[:, rows] += dk
            dv_acc[:, rows] += dv
        dkv_pending = yield [dk_acc, dv_acc]
        if kv_pending is not None:
            kc, vc = kv_pending.wait()
    dk_acc, dv_acc = dkv_pending.wait()
    return (_cat(dqs).to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype))


# --------------------------------------------------------------------------
# running the bodies: over a process group, or n virtual ranks in lock step
# --------------------------------------------------------------------------


class Pending:
    """A posted transfer; ``wait()`` gives the tensors received."""

    def __init__(self, received: list, works: Sequence = ()):
        self._received = received
        self._works = works

    def wait(self) -> list:
        for w in self._works:
            w.wait()
        return self._received


class RingComm:
    """The ring over the ranks of a process group: rank r of n sends to
    r+1 and receives from r-1 (P2P, NCCL on cuda, gloo on cpu)."""

    def __init__(self, group: dist.ProcessGroup | None = None):
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self._next = dist.get_global_rank(group, (self.rank + 1) % self.n) \
            if group is not None else (self.rank + 1) % self.n
        self._prev = dist.get_global_rank(group, (self.rank - 1) % self.n) \
            if group is not None else (self.rank - 1) % self.n

    def post(self, tensors: list) -> Pending:
        """Send ``tensors`` to the next rank and receive the previous
        rank's into new buffers; every request is waited on (sends too)
        before a buffer is read or reused.  A ring of one rank hands the
        tensors back."""
        if self.n == 1:
            return Pending(tensors)
        received = [torch.empty_like(t) for t in tensors]
        ops = [dist.P2POp(dist.isend, t, self._next, self.group)
               for t in tensors]
        ops += [dist.P2POp(dist.irecv, t, self._prev, self.group)
                for t in received]
        return Pending(received, dist.batch_isend_irecv(ops))


def _drive(comm: RingComm, body: Body):
    """Run one rank's body over ``comm``."""
    try:
        send = next(body)
        while True:
            send = body.send(comm.post([t.contiguous() for t in send]))
    except StopIteration as stop:
        return stop.value


def _lockstep(bodies: list[Body]) -> list:
    """Run n virtual ranks' bodies in one process: at each transfer every
    body has yielded, and rank r receives rank r-1's tensors."""
    n = len(bodies)
    results = [None] * n
    sends = None
    while True:
        nxt = []
        for r, body in enumerate(bodies):
            try:
                nxt.append(next(body) if sends is None else
                           body.send(Pending(sends[(r - 1) % n])))
            except StopIteration as stop:
                results[r] = stop.value
        if len(nxt) < n:
            if nxt:
                raise RuntimeError("ring bodies out of step")
            return results
        sends = nxt


def _check(q, k, v, layout, causal):
    if layout not in LAYOUTS:
        raise ValueError(f"unknown ring layout {layout!r}")
    if layout != "contiguous" and not causal:
        raise ValueError(f"layout={layout!r} exists to balance CAUSAL ring "
                         f"load; use the default layout for non-causal "
                         f"attention")
    if k.shape != v.shape:
        raise ValueError("k and v must have one shape")
    check_heads(q.shape[2], k.shape[2])
    if layout != "contiguous" and q.shape[1] % 2:
        raise ValueError(f"zigzag chunks split in two halves; the local "
                         f"length {q.shape[1]} is odd")


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, comm, causal, layout):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        kernels.on_cuda(q, k, v)  # another device or a DTensor raises
        scale = q.shape[-1] ** -0.5
        out, lse = _drive(comm, _ring_fwd(q, k, v, comm.rank, comm.n,
                                          causal, layout, scale))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (comm, causal, layout, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        comm, causal, layout, scale = ctx.args
        dq, dk, dv = _drive(comm, _ring_bwd(q, k, v, out, lse, g, comm.rank,
                                            comm.n, causal, layout, scale))
        return dq, dk, dv, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   comm: RingComm, *, causal: bool = True,
                   layout: str = "contiguous") -> torch.Tensor:
    """Exact attention of this rank's chunk over the ring ``comm``.

    q (B, T/n, H, D), k / v (B, T/n, H_kv, D) with H_kv dividing H: the
    ring rotates the unrepeated K/V chunks.  Returns (B, T/n, H, D) in
    q's dtype; differentiable (the backward runs the ring again)."""
    _check(q, k, v, layout, causal)
    return _RingAttention.apply(q, k, v, comm, causal, layout)


class _RingLoopback(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n, causal, layout, *qkv):
        qkv = [x.contiguous() for x in qkv]
        kernels.on_cuda(*qkv)
        qs, ks, vs = qkv[:n], qkv[n:2 * n], qkv[2 * n:]
        scale = qs[0].shape[-1] ** -0.5
        res = _lockstep([_ring_fwd(qs[r], ks[r], vs[r], r, n, causal,
                                   layout, scale) for r in range(n)])
        outs, lses = zip(*res)
        ctx.save_for_backward(*qkv, *outs, *lses)
        ctx.args = (n, causal, layout, scale)
        return outs

    @staticmethod
    def backward(ctx, *gs):
        n, causal, layout, scale = ctx.args
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        outs, lses = saved[3 * n:4 * n], saved[4 * n:]
        res = _lockstep([_ring_bwd(qs[r], ks[r], vs[r], outs[r], lses[r],
                                   gs[r], r, n, causal, layout, scale)
                         for r in range(n)])
        dqs, dks, dvs = zip(*res)
        return (None, None, None, *dqs, *dks, *dvs)


def ring_attention_loopback(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, n: int, *, causal: bool = True,
                            layout: str = "contiguous") -> torch.Tensor:
    """The ring of n virtual ranks in this process, on global (B, T, H, D)
    tensors: the sequence is cut into n chunks, each chunk's attention
    runs as on its rank (same arithmetic, same order as ``RingComm``),
    and the chunks' outputs are joined again.  ``layout`` as the JAX
    ``ring_attention``'s: ``zigzag`` permutes the rows into the zigzag
    order and back, ``zigzag_pre`` takes and returns them in that order.
    Differentiable."""
    T = q.shape[1]
    zig = layout in ("zigzag", "zigzag_pre")
    if T % (2 * n if zig else n):
        if zig:
            zigzag_layout(T, n)  # raises with the JAX message
        raise ValueError(f"seq len {T} not divisible by sp={n}")
    _check(q, k, v, "zigzag_pre" if zig else layout, causal)
    if layout == "zigzag":
        perm, inv = (torch.from_numpy(x).to(q.device)
                     for x in zigzag_layout(T, n))
        return ring_attention_loopback(q[:, perm], k[:, perm], v[:, perm], n,
                                       causal=causal,
                                       layout="zigzag_pre")[:, inv]
    outs = _RingLoopback.apply(n, causal, layout, *q.chunk(n, 1),
                               *k.chunk(n, 1), *v.chunk(n, 1))
    return torch.cat(outs, 1)


def ring_launches(n: int, causal: bool, layout: str) -> int:
    """Chunk pairs the whole ring computes (each one forward kernel call
    and one backward route): n(n+1)/2 for the contiguous causal ring, n²
    without causality, 2n+1 per rank (half chunks) for zigzag_pre."""
    return sum(len(_pairs(r, (r - s) % n, causal, layout))
               for r in range(n) for s in range(n))

