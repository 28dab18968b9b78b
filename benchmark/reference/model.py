"""The plain reference: the decoder's equations, its loss and AdamW in
plain PyTorch, in float32 with TF32 off, independent of the port.

It follows the published architectures (Mistral-7B, Mixtral-8x7B:
RMSNorm, half-split RoPE, grouped-query causal attention, SwiGLU, a
top-k router over SwiGLU experts) with the departures the benchmark's
configurations state: the head is tied to the embedding, and a mixture
of experts trains on ce + coef · aux, aux = E · Σ_e frac_routed_e ·
mean_prob_e.  It imports nothing of the port and takes nothing the port
made: its weights come from ``harness.weights`` by (seed, leaf name),
its batches from the harness.  Every step is computed in f32 and the
parameters are kept in the configuration's dtype (``torch_dtype``), so
a step that bf16 cannot hold (a norm weight of 1.0 moved by 3e-4) is
lost on both sides alike.

Memory: every layer is checkpointed, attention runs in blocks of query
rows (each block checkpointed, fully masked key blocks skipped) and the
tied head's cross entropy in chunks of rows, so the reference of a
cell fits beside nothing else on the card.  Under expert parallelism
(``group``) a rank holds its experts only; the experts' partial outputs
are summed by an all-reduce whose backward passes the gradient through,
and the tensors entering that region sum their gradients (the conjugate
pair of Megatron-LM's f and g, written out here).

``matmul="fp8"`` is the control: every product's operands rounded to
float8 e4m3 with a per-tensor scale (straight-through gradients), the
precision below the configurations' bfloat16; ``matmul="bf16"`` rounds
them to bfloat16, a witness of how far the configuration's own precision
moves the readings.  ``fault`` plants one of
the faults the harness must catch, in the reference put in the
program's place: ``half_batch`` (the loss over half of the batch) and
``no_exchange`` (the experts' all-reduce left out).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.harness.weights import dims, expert_of, leaves, make

BETAS = (0.9, 0.999)
EPS = 1e-8
FP8_MAX = 448.0
BLOCK_BYTES = 1 << 30   # an attention block's f32 scores
CE_ROWS = 2048          # rows of the tied head's logits at a time
FAULTS = (None, "half_batch", "no_exchange")


def _fp8(x: torch.Tensor) -> torch.Tensor:
    if not x.numel():  # an expert no token chose
        return x
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x + (x.detach().to(torch.bfloat16).to(x.dtype) - x).detach()


ROUND = {"fp8": _fp8, "bf16": _bf16}


class _SumOverGroup(torch.autograd.Function):
    """All-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _EnterGroup(torch.autograd.Function):
    """Identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class Reference:
    """The model of ``config`` at ``seed``'s weights, in f32, with its own
    AdamW state."""

    def __init__(self, config: dict, seed: int, device, *, lr: float,
                 weight_decay: float, group=None, matmul: str = "f32",
                 fault: str | None = None):
        if matmul not in ("f32", *ROUND):
            raise ValueError(f"matmul must be f32, fp8 or bf16, got "
                             f"{matmul!r}")
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.d = d = dims(config)
        self.config, self.seed, self.device = config, seed, device
        self.lr, self.wd = lr, weight_decay
        self.group, self.matmul, self.fault = group, matmul, fault
        world = dist.get_world_size(group) if group is not None else 1
        rank = dist.get_rank(group) if group is not None else 0
        if d["E"] and d["E"] % world:
            raise ValueError(f"{world} ranks cannot split {d['E']} experts")
        per = d["E"] // world if d["E"] else 0
        self.experts = range(rank * per, (rank + 1) * per)
        self.params: dict[str, torch.Tensor] = {}
        for name, shape, kind in self.leaves():
            self.params[name] = make(seed, name, shape, kind, d["std"],
                                     device, getattr(torch, config[
                                         "torch_dtype"])).float(
                                         ).requires_grad_()
        # the parameters are stored in the configuration's dtype: each
        # step is computed in f32 and its result rounded to it
        self.store = getattr(torch, config["torch_dtype"])
        self.m = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.t = 0

    def leaves(self) -> list:
        """The leaves this rank holds: all but other ranks' experts."""
        return [(n, s, k) for n, s, k in leaves(self.config)
                if expert_of(n) is None or expert_of(n) in self.experts]

    # -- the forward ----------------------------------------------------

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.matmul != "f32":
            a, b = ROUND[self.matmul](a), ROUND[self.matmul](b)
        return torch.matmul(a, b)

    def lin(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.mm(x, w.t())

    def rms(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.d["eps"]) * w

    def rope(self, T: int):
        half = self.d["Dh"] // 2
        freqs = self.d["theta"] ** (-torch.arange(
            0, half, dtype=torch.float32, device=self.device) / half)
        ang = torch.arange(T, dtype=torch.float32,
                           device=self.device)[:, None] * freqs[None, :]
        return torch.cos(ang), torch.sin(ang)

    @staticmethod
    def apply_rope(x, cos, sin):
        x1, x2 = x.chunk(2, dim=-1)
        c, s = cos[None, :, None, :], sin[None, :, None, :]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)

    def _attn_block(self, qb, k, v, first: int):
        s = self.mm(qb, k.transpose(-1, -2)) * self.d["Dh"] ** -0.5
        rows = torch.arange(first, first + qb.shape[2], device=qb.device)
        cols = torch.arange(k.shape[2], device=qb.device)
        s = s.masked_fill(cols[None, :] > rows[:, None], float("-inf"))
        return self.mm(torch.softmax(s, dim=-1), v)

    def attention(self, q, k, v):
        """Causal attention, q (B,T,H,Dh), k and v (B,T,Hk,Dh)."""
        B, T, H, _ = q.shape
        g = H // k.shape[2]
        q = q.transpose(1, 2)
        k = k.repeat_interleave(g, dim=2).transpose(1, 2)
        v = v.repeat_interleave(g, dim=2).transpose(1, 2)
        rows = max(64, BLOCK_BYTES // (B * H * T * 4))
        out = []
        for a in range(0, T, rows):
            b = min(T, a + rows)
            out.append(checkpoint(self._attn_block, q[:, :, a:b],
                                  k[:, :, :b], v[:, :, :b], a,
                                  use_reentrant=False))
        return torch.cat(out, dim=2).transpose(1, 2)

    def _experts(self, x, p: str):
        """The top-k mixture of this rank's experts (its partial output
        where a group splits them) and the layer's aux loss."""
        d = self.d
        B, T, D = x.shape
        probs = torch.softmax(self.mm(x, self.params[p + "router"]), dim=-1)
        top_vals, top_idx = probs.topk(d["k"], dim=-1)
        top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
        combine = torch.zeros_like(probs).scatter(-1, top_idx, top_vals)
        with torch.no_grad():
            frac = (combine > 0).float().sum(dim=(0, 1)) / (B * T)
        aux = d["E"] * torch.sum(frac * probs.mean(dim=(0, 1)))
        split = self.group is not None and self.fault != "no_exchange"
        if split:
            x = _EnterGroup.apply(x, self.group)
            combine = _EnterGroup.apply(combine, self.group)
        xs, cw = x.reshape(B * T, D), combine.reshape(B * T, d["E"])
        flat_idx = top_idx.reshape(B * T, -1)
        out = torch.zeros_like(xs)
        for e in self.experts:
            rows = (flat_idx == e).any(dim=-1).nonzero().squeeze(1)
            xe = xs[rows]
            h = F.silu(self.mm(xe, self.params[p + f"w_gate.{e}"])) \
                * self.mm(xe, self.params[p + f"w_up.{e}"])
            ye = self.mm(h, self.params[p + f"w_down.{e}"])
            out = out.index_add(0, rows, ye * cw[rows, e:e + 1])
        if split:
            out = _SumOverGroup.apply(out, self.group)
        return out.reshape(B, T, D), aux

    def layer(self, h, i: int, cos, sin):
        d, P = self.d, self.params
        p = f"layers.{i}."
        B, T, _ = h.shape
        x = self.rms(h, P[p + "attn_norm"])
        q = self.lin(x, P[p + "wq"]).view(B, T, d["H"], d["Dh"])
        k = self.lin(x, P[p + "wk"]).view(B, T, d["Hk"], d["Dh"])
        v = self.lin(x, P[p + "wv"]).view(B, T, d["Hk"], d["Dh"])
        o = self.attention(self.apply_rope(q, cos, sin),
                           self.apply_rope(k, cos, sin), v)
        h = h + self.lin(o.reshape(B, T, -1), P[p + "wo"])
        x = self.rms(h, P[p + "mlp_norm"])
        if d["E"]:
            out, aux = self._experts(x, p)
            return h + out, aux
        mlp = F.silu(self.lin(x, P[p + "w_gate"])) * self.lin(x, P[p + "w_up"])
        return h + self.lin(mlp, P[p + "w_down"]), h.new_zeros(())

    def _ce_sum(self, hc, tc):
        logits = self.mm(hc, self.params["embed"].t())
        return F.cross_entropy(logits, tc, reduction="sum")

    def loss(self, batch: torch.Tensor) -> torch.Tensor:
        """The training loss of a (B, T+1) batch (the mean over its
        tokens; under ``half_batch`` over half of them)."""
        inputs, targets = batch[:, :-1], batch[:, 1:]
        if self.fault == "half_batch":
            if inputs.shape[0] > 1:
                inputs = inputs[:inputs.shape[0] // 2]
                targets = targets[:targets.shape[0] // 2]
            else:
                inputs = inputs[:, :inputs.shape[1] // 2]
                targets = targets[:, :targets.shape[1] // 2]
        B, T = inputs.shape
        h = F.embedding(inputs, self.params["embed"])
        cos, sin = self.rope(T)
        auxes = []
        for i in range(self.d["L"]):
            h, aux = checkpoint(self.layer, h, i, cos, sin,
                                use_reentrant=False)
            auxes.append(aux)
        h = self.rms(h, self.params["final_norm"]).reshape(B * T, -1)
        t = targets.reshape(B * T)
        total = h.new_zeros(())
        for a in range(0, B * T, CE_ROWS):
            total = total + checkpoint(self._ce_sum, h[a:a + CE_ROWS],
                                       t[a:a + CE_ROWS], use_reentrant=False)
        loss = total / (B * T)
        if self.d["E"]:
            loss = loss + self.d["aux_coef"] * torch.stack(auxes).mean()
        return loss

    # -- the step -------------------------------------------------------

    def step(self, batch: torch.Tensor, grad_norms: bool = False
             ) -> tuple[float, dict[str, float]]:
        """One AdamW step (torch.optim.AdamW's equations: decoupled decay
        first, bias-corrected moments, eps outside the root); the loss,
        and with ``grad_norms`` each leaf's gradient norm."""
        for p in self.params.values():
            p.grad = None
        loss = self.loss(batch)
        loss.backward()
        norms = ({n: float(p.grad.norm()) for n, p in self.params.items()}
                 if grad_norms else {})
        self.t += 1
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        with torch.no_grad():
            for n, p in self.params.items():
                g, m, v = p.grad, self.m[n], self.v[n]
                p.mul_(1 - self.lr * self.wd)
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v.sqrt() / math.sqrt(c2)).add_(EPS)
                p.addcdiv_(m, denom, value=-self.lr / c1)
                p.copy_(p.to(self.store))
                p.grad = None
        return float(loss.detach()), norms

    def change_norms(self) -> dict[str, float]:
        """‖p − p0‖ of every leaf this rank holds, p0 made again."""
        out = {}
        with torch.no_grad():
            for name, shape, kind in self.leaves():
                p0 = make(self.seed, name, shape, kind, self.d["std"],
                          self.device, self.store).float()
                out[name] = float((self.params[name] - p0).norm())
        return out


def follow(config: dict, seed: int, batches: list, device, *, lr: float,
           weight_decay: float, group=None, matmul: str = "f32",
           fault: str | None = None) -> dict:
    """The readings the comparison takes from the reference over
    ``batches`` (one step each): each step's loss, each leaf's first
    gradient norm and each leaf's change after the last step."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = Reference(config, seed, device, lr=lr,
                        weight_decay=weight_decay, group=group,
                        matmul=matmul, fault=fault)
        losses, grads = [], {}
        for i, batch in enumerate(batches):
            loss, norms = ref.step(batch, grad_norms=i == 0)
            losses.append(loss)
            grads = grads or norms
        out = {"losses": losses, "grad_norms": grads,
               "change_norms": ref.change_norms()}
        del ref
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
