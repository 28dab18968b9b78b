"""Pipeline parallelism: microbatches through a chain of stages.

Port of ``pytorch_operator_tpu/parallel/pipeline.py``.  The layer stack
is split over the ``pp`` ranks (stage s holds n_layers/S consecutive
layers) and the global batch into M microbatches that march through the
stages: stage s hands each microbatch's activation to stage s+1 and, on
the way back, the gradient of its input to stage s-1.

Two schedules, on one clock of ticks (``Clock``):

  gpipe  every forward first (microbatch k at stage s on tick s + k),
         then every backward, the last microbatch first; each stage
         keeps the autograd graphs of its M microbatches until their
         backward: in-flight memory O(M)
  1f1b   microbatch k's forward at stage s on tick s + 2k and its
         backward on tick 2S - 1 - s + 2k, the clock of the JAX
         ``_1f1b_body``: the two have opposite parities, so a tick holds
         one F or one B.  The forward runs without autograd and saves
         only the stage's input, in a ring of S slots; the backward tick
         runs the stage again from it with autograd and backpropagates:
         at most S stage inputs are held, not M graphs.  Stage 0 saves
         nothing and embeds its tokens again in the backward, so the
         embedding's gradient flows.  The last stage runs nothing on its
         forward tick, whose output no stage reads (the JAX stage
         computes it, as SPMD must): it saves the input and runs its
         layers once, on the next tick, into the loss.

JAX differentiates through ``lax.ppermute``; PyTorch has no autograd
across processes, so the backward wave is written out: a stage receives
dY from stage s+1, calls ``torch.autograd.backward(y, dY)`` and sends
its input's gradient to stage s-1.  The parameters' gradients
accumulate in their ``.grad`` as under ``loss.backward()``.

Communication sits behind one interface, as in ``ring_attention.py``.
Each stage's schedule is a generator that yields, at the end of every
tick, what it sends (an activation to s+1, a gradient to s-1) and what
it expects, and gets back a pending transfer whose ``wait()`` gives the
tensors received.  Both sides work out from the same clock when data
is due, so only that travels: JAX sends zeros on every off tick.
``PipeComm`` posts P2P over the pp process group (``batch_isend_irecv``;
NCCL on cuda, gloo on cpu); ``PipeLoopback`` runs S virtual stages in
one process in lock step, which is how one card or the CPU tests run a
real multi-stage pipeline (NCCL will not put two ranks on one card).
Both run the same arithmetic in the same order and give the same bits.
"""

from __future__ import annotations

from typing import Any, Callable, Generator

import torch
import torch.distributed as dist

from pytorch_operator_tpu_torch.parallel.mesh import AXIS_PP
from pytorch_operator_tpu_torch.parallel.ring_attention import Pending

SCHEDULES = ("gpipe", "1f1b")

# what a stage yields at the end of a tick: (activation to s+1 or None,
# gradient to s-1 or None, expects an activation from s-1, expects a
# gradient from s+1); it gets back a Pending whose wait() gives the
# (activation, gradient) received, None where nothing was due
Transfer = tuple
Body = Generator[Transfer, Pending, Any]


# --------------------------------------------------------------------------
# the clock
# --------------------------------------------------------------------------


def is_f(t: int, s: int, M: int) -> bool:
    """1F1B: stage s runs a forward on tick t (the JAX ``is_f``)."""
    df = t - s
    return df >= 0 and df % 2 == 0 and df < 2 * M


def k_f(t: int, s: int) -> int:
    """1F1B: the microbatch of stage s's forward on tick t."""
    return (t - s) // 2


def is_b(t: int, s: int, M: int, S: int) -> bool:
    """1F1B: stage s runs a backward on tick t (the JAX ``is_b``)."""
    db = t - (2 * S - 1 - s)
    return db >= 0 and db % 2 == 0 and db < 2 * M


def k_b(t: int, s: int, S: int) -> int:
    """1F1B: the microbatch of stage s's backward on tick t."""
    return (t - (2 * S - 1 - s)) // 2


class Clock:
    """Which microbatch stage s runs forward and backward on tick t.

    Either schedule keeps the rule that lets both sides of a link work
    out what is due: a forward of microbatch k on (t, s) is followed by
    its forward on (t + 1, s + 1), a backward on (t, s) by its backward
    on (t + 1, s - 1)."""

    def __init__(self, schedule: str, M: int, S: int):
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown pipeline schedule {schedule!r}")
        self.schedule, self.M, self.S = schedule, M, S
        # gpipe: forwards on ticks [0, M + S - 1), backwards after them
        self.fwd_ticks = M + S - 1 if schedule == "gpipe" else None
        self.ticks = (2 * (M + S - 1) if schedule == "gpipe"
                      else 2 * M + 2 * S - 2)

    def fwd(self, t: int, s: int) -> int | None:
        M, S = self.M, self.S
        if self.schedule == "gpipe":
            k = t - s
            return k if 0 <= k < M else None
        return k_f(t, s) if is_f(t, s, M) else None

    def bwd(self, t: int, s: int) -> int | None:
        M, S = self.M, self.S
        if self.schedule == "gpipe":
            j = t - self.fwd_ticks - (S - 1 - s)
            return M - 1 - j if 0 <= j < M else None
        return k_b(t, s, S) if is_b(t, s, M, S) else None


# --------------------------------------------------------------------------
# transports
# --------------------------------------------------------------------------


class PipeComm:
    """Stage ``rank`` of the pp process group ``group``: activations go
    to rank+1 and come from rank-1, gradients the other way (P2P, NCCL
    on cuda, gloo on cpu).  A failure raises; nothing falls back."""

    def __init__(self, group: dist.ProcessGroup | None = None):
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

        def peer(r):
            if not 0 <= r < self.n:
                return None
            return dist.get_global_rank(group, r) if group is not None \
                else r

        self._next, self._prev = peer(self.rank + 1), peer(self.rank - 1)
        self.last = dist.get_global_rank(group, self.n - 1) \
            if group is not None else self.n - 1
        # one collective over the whole group first: NCCL builds the
        # group's communicator on it, which a batch of P2P ops that not
        # every rank joins (the pipeline's fill) must find built
        if self.n > 1:
            device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
            dist.all_reduce(torch.zeros(1, device=device), group=group)

    def post(self, transfer: Transfer, like: torch.Tensor) -> Pending:
        """Post one tick's sends and receives (receive buffers shaped as
        ``like``); a tick with nothing due posts nothing."""
        to_next, to_prev, want_prev, want_next = transfer
        ops, got = [], [None, None]
        if to_next is not None:
            ops.append(dist.P2POp(dist.isend, to_next.contiguous(),
                                  self._next, self.group))
        if to_prev is not None:
            ops.append(dist.P2POp(dist.isend, to_prev.contiguous(),
                                  self._prev, self.group))
        if want_prev:
            got[0] = torch.empty_like(like)
            ops.append(dist.P2POp(dist.irecv, got[0], self._prev,
                                  self.group))
        if want_next:
            got[1] = torch.empty_like(like)
            ops.append(dist.P2POp(dist.irecv, got[1], self._next,
                                  self.group))
        if not ops:
            return Pending(got)
        return Pending(got, [_Keep(dist.batch_isend_irecv(ops), ops)])


class _Keep:
    """A batch of P2P works; its tensors stay referenced until the wait."""

    def __init__(self, works, ops):
        self._works, self._ops = works, ops

    def wait(self):
        for w in self._works:
            w.wait()
        self._ops = None


class PipeLoopback:
    """S virtual stages in this process, run in lock step: the stage
    functions get a list of S stage parameters, one per stage."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"a pipeline needs at least one stage, got {n}")
        self.n = n


def _drive(comm: PipeComm, body: Body, like: torch.Tensor):
    """Run this rank's stage body over ``comm``."""
    try:
        transfer = next(body)
        while True:
            transfer = body.send(comm.post(transfer, like))
    except StopIteration as stop:
        return stop.value


def _lockstep(bodies: list[Body]) -> list:
    """Run S stage bodies in one process: at the end of each tick every
    body has yielded, and stage r receives stage r-1's activation and
    stage r+1's gradient, which must be due exactly where they were
    sent."""
    n = len(bodies)
    results = [None] * n
    pend = None
    while True:
        sent = []
        for r, body in enumerate(bodies):
            try:
                sent.append(next(body) if pend is None else
                            body.send(pend[r]))
            except StopIteration as stop:
                results[r] = stop.value
        if len(sent) < n:
            if sent:
                raise RuntimeError("pipeline stages out of step")
            return results
        pend = []
        for r, (_, _, want_prev, want_next) in enumerate(sent):
            act = sent[r - 1][0] if r > 0 else None
            grad = sent[r + 1][1] if r < n - 1 else None
            if (act is not None) != want_prev or \
                    (grad is not None) != want_next:
                raise RuntimeError(f"pipeline stage {r} received other "
                                   f"than it expects")
            pend.append(Pending([act, grad]))


# --------------------------------------------------------------------------
# one stage's ticks
# --------------------------------------------------------------------------


def _stage_body(s: int, S: int, clock: Clock, ticks: range,
                on_f: Callable, on_b: Callable) -> Body:
    """Stage s over ``ticks`` of ``clock``: ``on_f(k, act)`` runs the
    forward of microbatch k (``act``: the activation received, None on
    stage 0) and returns what goes to stage s+1; ``on_b(k, grad)`` runs
    its backward and returns its input's gradient for stage s-1.  Every
    tick ends in one yield, so that lock-stepped stages stay in step."""
    act = grad = None
    for t in ticks:
        kf, kb = clock.fwd(t, s), clock.bwd(t, s)
        to_next = to_prev = None
        if kf is not None:
            y = on_f(kf, act)
            to_next = y if s < S - 1 else None
        if kb is not None:
            dx = on_b(kb, grad)
            to_prev = dx if s > 0 else None
        want_prev = s > 0 and clock.fwd(t + 1, s) is not None
        want_next = s < S - 1 and clock.bwd(t + 1, s) is not None
        act, grad = (yield (to_next, to_prev, want_prev, want_next)).wait()


def _check_shape(x: torch.Tensor, y: torch.Tensor) -> None:
    if y.shape != x.shape or y.dtype != x.dtype:
        raise ValueError(f"pipeline stages must preserve the activation's "
                         f"shape and dtype ({tuple(x.shape)} {x.dtype} -> "
                         f"{tuple(y.shape)} {y.dtype})")


def _microbatches(x: torch.Tensor, M: int) -> torch.Tensor:
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    return x.reshape(M, B // M, *x.shape[1:])


def _stages(comm, stage_params) -> list[tuple[int, Any]]:
    """(stage index, its parameters) of the stages this process runs."""
    if isinstance(comm, PipeLoopback):
        if len(stage_params) != comm.n:
            raise ValueError(f"the loopback of {comm.n} stages needs "
                             f"{comm.n} stage parameters, got "
                             f"{len(stage_params)}")
        return list(enumerate(stage_params))
    return [(comm.rank, stage_params)]


def _run(comm, bodies: list[Body], like: torch.Tensor) -> list:
    if isinstance(comm, PipeLoopback):
        return _lockstep(bodies)
    return [_drive(comm, bodies[0], like)]


# --------------------------------------------------------------------------
# GPipe as a differentiable function
# --------------------------------------------------------------------------


class _GPipeStage:
    """One stage of ``pipeline_apply``: its microbatches' (input, output)
    pairs with their graphs, from the forward wave to the backward."""

    def __init__(self, s, S, params, stage_fn, x_mb, needs_dx):
        self.s, self.S, self.params = s, S, params
        self.stage_fn, self.x_mb, self.needs_dx = stage_fn, x_mb, needs_dx
        self.saved: dict[int, tuple] = {}
        self.outs: dict[int, torch.Tensor] = {}
        self.dx: dict[int, torch.Tensor] = {}
        self.g_mb = None

    def on_f(self, k, act):
        grad = torch.is_grad_enabled()
        if self.s == 0:
            x = self.x_mb[k].detach().requires_grad_(self.needs_dx and grad)
        else:
            x = act.requires_grad_(grad)
        y = self.stage_fn(self.params, x)
        _check_shape(x, y)
        self.saved[k] = (x, y)
        if self.s == self.S - 1:
            self.outs[k] = y.detach()
            return None
        return y.detach()

    def on_b(self, k, grad):
        x, y = self.saved.pop(k)
        g = self.g_mb[k] if self.s == self.S - 1 else grad
        if y.requires_grad:
            torch.autograd.backward(y, g)
        dx = x.grad if x.grad is not None else torch.zeros_like(x)
        if self.s == 0:
            self.dx[k] = dx
        return dx


def _flat_tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _flat_tensors(x)]
    return []


class _GPipe(torch.autograd.Function):
    """The forward wave in ``forward`` and the backward wave, written
    out, in ``backward``.  The stages' parameters are inputs only so that
    the output needs a gradient when they do: their gradients accumulate
    in ``.grad`` through each stage's own backward, as a reentrant
    checkpoint's do, and none is returned for them here."""

    @staticmethod
    def forward(ctx, run, x, *params):
        comm, stages, clock, grad = run
        S = clock.S
        with torch.set_grad_enabled(grad):
            _run(comm, [_stage_body(st.s, S, clock, range(clock.fwd_ticks),
                                    st.on_f, None) for st in stages],
                 stages[0].x_mb[0])
        last = stages[-1]
        if last.s == S - 1:
            out = torch.cat([last.outs.pop(k) for k in range(clock.M)])
        else:
            out = torch.empty_like(x)
        if isinstance(comm, PipeComm) and comm.n > 1:
            # every stage returns the output, as JAX's psum replicates it
            dist.broadcast(out, comm.last, group=comm.group)
        ctx.run = run
        return out

    @staticmethod
    def backward(ctx, g):
        comm, stages, clock, _ = ctx.run
        M, S = clock.M, clock.S
        for st in stages:
            if st.s == S - 1:
                # the output is one value replicated over the stages: its
                # gradient drives the wave from the last stage only
                st.g_mb = _microbatches(g.contiguous(), M)
        like = stages[0].x_mb[0]
        _run(comm, [_stage_body(st.s, S, clock,
                                range(clock.fwd_ticks, clock.ticks), None,
                                st.on_b) for st in stages], like)
        first = stages[0]
        dx = None
        if first.s == 0 and first.needs_dx:
            dx = torch.cat([first.dx.pop(k) for k in range(M)])
        ctx.run = None
        return (None, dx, *([None] * (len(ctx.needs_input_grad) - 2)))


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, comm,
                   n_microbatches: int) -> torch.Tensor:
    """Apply a stage-split function as a GPipe pipeline over ``comm``.

    ``stage_fn(params, x_mb) -> y_mb`` applies one stage's layers and
    keeps the activation's shape; ``stage_params`` is this rank's stage's
    parameters (``PipeComm``) or a list of every stage's
    (``PipeLoopback``): tensors, lists of them or a module.  ``x`` is the
    (B, ...) global batch, B divisible by ``n_microbatches``; stage 0
    consumes it.  Returns the (B, ...) output of the last stage on every
    stage (JAX's ``pipeline_apply`` replicates it with a psum).

    Differentiable: the output's gradient, taken from the last stage,
    drives the written-out backward wave; ``x`` gets its gradient on
    stage 0, the stages' parameters in their ``.grad``."""
    M = n_microbatches
    x_mb = _microbatches(x, M)
    S = comm.n
    clock = Clock("gpipe", M, S)
    stages = [_GPipeStage(s, S, p, stage_fn, x_mb, x.requires_grad)
              for s, p in _stages(comm, stage_params)]
    params = [t for _, p in _stages(comm, stage_params)
              for t in _flat_tensors(p)]
    # the stages keep their graphs only where a backward can come
    grad = torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in params))
    return _GPipe.apply((comm, stages, clock, grad), x, *params)


# --------------------------------------------------------------------------
# the training schedules: loss inside the last stage
# --------------------------------------------------------------------------


class _TrainStage:
    """One stage of ``pipeline_value_and_grad``: the callbacks of its
    forward and backward ticks under either schedule."""

    def __init__(self, s, S, params, fns, inputs_mb, targets_mb, schedule):
        self.s, self.S, self.params = s, S, params
        self.first_fn, self.stage_fn, self.last_fn = fns
        self.inputs_mb, self.targets_mb = inputs_mb, targets_mb
        self.recompute = schedule == "1f1b"
        self.saved: dict[int, Any] = {}
        self.losses: list[torch.Tensor] = []

    def _input(self, k, act, grad_mode):
        if self.s == 0:
            with torch.set_grad_enabled(grad_mode):
                return self.first_fn(self.params, self.inputs_mb[k])
        return act.requires_grad_(grad_mode)

    def _tail(self, k, y):
        loss = self.last_fn(self.params, y, self.targets_mb[k])
        self.losses.append(loss.detach())
        return loss

    def on_f(self, k, act):
        last = self.s == self.S - 1
        if not self.recompute:
            x = self._input(k, act, True)
            y = self.stage_fn(self.params, x)
            _check_shape(x, y)
            self.saved[k] = (x, self._tail(k, y) if last else y)
            return None if last else y.detach()
        if self.s > 0:
            # the 1F1B save ring: at most S stage inputs
            if len(self.saved) >= self.S:
                raise RuntimeError("1F1B holds more than S stage inputs")
            self.saved[k] = act
        if last:
            return None  # its layers run once, on the backward tick
        with torch.no_grad():
            x = self._input(k, act, False)
            y = self.stage_fn(self.params, x)
        _check_shape(x, y)
        return y

    def on_b(self, k, grad):
        last = self.s == self.S - 1
        if self.recompute:
            x = self._input(k, self.saved.pop(k, None), True)
            y = self.stage_fn(self.params, x)
            _check_shape(x, y)
            out = self._tail(k, y) if last else y
        else:
            x, out = self.saved.pop(k)
        torch.autograd.backward(out, None if last else grad)
        if self.s == 0:
            return None
        return x.grad if x.grad is not None else torch.zeros_like(x)


def pipeline_value_and_grad(
    first_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    last_fn: Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor],
    stage_params: Any,
    inputs: torch.Tensor,
    targets: torch.Tensor,
    comm,
    *,
    n_microbatches: int,
    schedule: str = "1f1b",
) -> torch.Tensor | None:
    """The loss through the pipeline, its gradients left in ``.grad``.

    ``first_fn(params, inputs_mb) -> x`` makes stage 0's input (the
    embedding); ``stage_fn(params, x) -> y`` applies one stage's layers
    and keeps the activation's shape; ``last_fn(params, y, targets_mb)``
    is the last stage's per-microbatch loss, pre-scaled so that the
    microbatches' losses SUM to the global one (mean CE / M).
    ``stage_params`` as in ``pipeline_apply``.  ``inputs`` / ``targets``:
    (B, ...) global batch, B divisible by ``n_microbatches``; stage 0
    reads the inputs and the last stage the targets.

    ``schedule`` is ``"1f1b"`` (the JAX ``pipeline_value_and_grad``: at
    most S stage inputs held, the stage run again in its backward tick)
    or ``"gpipe"`` (every forward first, M graphs held, nothing run
    twice).  Returns the loss (the sum of the microbatches' losses, f32)
    on the last stage, None on the others; the parameters each stage's
    functions use accumulate their gradients in ``.grad``.  Parameters
    several stages hold (the tied embedding, the final norm) get each
    stage's share only: the caller sums them over the pp group, as the
    JAX function's psum does."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    M = n_microbatches
    inputs_mb = _microbatches(inputs, M)
    targets_mb = _microbatches(targets, M)
    S = comm.n
    clock = Clock(schedule, M, S)
    stages = [_TrainStage(s, S, p, (first_fn, stage_fn, last_fn),
                          inputs_mb, targets_mb, schedule)
              for s, p in _stages(comm, stage_params)]
    # the activation's shape and dtype, for the receive buffers
    with torch.no_grad():
        like = first_fn(stages[0].params, inputs_mb[0])
    _run(comm, [_stage_body(st.s, S, clock, range(clock.ticks), st.on_f,
                            st.on_b) for st in stages], like)
    last = stages[-1]
    if last.s != S - 1:
        return None
    return torch.stack(last.losses).sum()


__all__ = ["AXIS_PP", "Clock", "PipeComm", "PipeLoopback", "SCHEDULES",
           "is_b", "is_f", "k_b", "k_f", "pipeline_apply",
           "pipeline_value_and_grad"]
