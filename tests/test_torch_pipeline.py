"""The port's pipeline (``parallel/pipeline.py``) against the JAX one,
on the CPU: ``pipeline_apply`` beside JAX's on tanh stages, the
pipelined Llama forward beside the plain one, the clock, the 1F1B save
ring and the errors.  ``tests/test_torch_pp_train.py`` holds the
training step.

The loopback runs every stage in this process (``PipeLoopback``); the JAX
side runs on a (pp,) mesh of the host devices ``tests/conftest.py``
forces.  Inputs come from numpy seeds; the tolerances are those of the
JAX tests (``tests/test_pipeline_moe.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_operator_tpu.parallel import make_named_mesh
from pytorch_operator_tpu.parallel import pipeline_apply as jax_pipeline_apply
from pytorch_operator_tpu_torch.models import llama
from pytorch_operator_tpu_torch.parallel import pipeline as pl
from pytorch_operator_tpu_torch.parallel.train import (
    TrainState,
    adamw,
    make_pp_train_step,
)

T = 16


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def tokens(seed, B, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, T + 1))


def jax_stage_fn(w_local, h):
    return jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), None), h, w_local)[0]


def stage_fn(w_local, h):
    for w in w_local:
        h = torch.tanh(h @ w)
    return h


@pytest.mark.parametrize("pp,n_mb", [(2, 2), (4, 4), (4, 8)])
def test_pipeline_apply_matches_jax(pp, n_mb):
    """GPipe of tanh layers: the output and the gradients of sum(out²)
    with respect to the layers and the input, as JAX differentiates
    through its ppermutes."""
    L, D, B = 2 * pp, 16, n_mb * 2
    ws, x = randn(0, L, D, D) * 0.3, randn(1, B, D)
    mesh = make_named_mesh({"pp": pp})

    def jloss(w, x):
        return jnp.sum(jax_pipeline_apply(w, x, jax_stage_fn, mesh,
                                          n_microbatches=n_mb) ** 2)

    jout = jax_pipeline_apply(jnp.asarray(ws), jnp.asarray(x), jax_stage_fn,
                              mesh, n_microbatches=n_mb)
    jgw, jgx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(ws),
                                               jnp.asarray(x))
    wt = torch.tensor(ws, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    out = pl.pipeline_apply(stage_fn, list(wt.chunk(pp)), xt,
                            pl.PipeLoopback(pp), n_mb)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-5,
                               rtol=1e-4)


def test_forward_pipelined_matches_the_plain_forward():
    """The Llama stack as 4 GPipe stages: the logits of the plain model,
    and the gradients of every layer, the tied embedding (stage 0's
    lookup plus the last stage's head) and the final norm."""
    cfg = llama.tiny(n_layers=8, max_seq_len=T)
    stages = llama.pipeline_stages(cfg, 4, device="cpu")
    plain = llama.Llama(cfg, device="cpu")
    toks = torch.from_numpy(tokens(1, 8, cfg.vocab_size)[:, :-1])
    out = llama.forward_pipelined(list(stages), toks, pl.PipeLoopback(4), 4)
    ref = plain(toks)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=1e-5)
    g = torch.from_numpy(randn(2, *ref.shape))
    (out * g).sum().backward()
    (ref * g).sum().backward()
    grads = {n: p.grad for st in stages for n, p in st.named_parameters()
             if p.grad is not None and n not in ("embed", "final_norm")}
    grads["embed"] = stages[0].embed.grad + stages[-1].embed.grad
    grads["final_norm"] = stages[-1].final_norm.grad
    for name, p in plain.named_parameters():
        # f32 sums of order 100 over 8 layers, in another order
        torch.testing.assert_close(grads[name], p.grad, rtol=1e-5,
                                   atol=1e-6 * p.grad.abs().max().item(),
                                   msg=name)


def test_errors():
    cfg = llama.tiny(n_layers=2, max_seq_len=T)
    stages = llama.pipeline_stages(cfg, 2, device="cpu")
    opt = adamw(stages)
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        make_pp_train_step(cfg, stages, opt, n_microbatches=2,
                           schedule="2f2b")
    step = make_pp_train_step(cfg, stages, opt, n_microbatches=3)
    with pytest.raises(ValueError, match="not divisible"):
        step(TrainState(stages, opt), tokens(0, 5, cfg.vocab_size))
    with pytest.raises(ValueError, match="not divisible"):
        llama.pp_param_specs(cfg, 3)
    x = torch.zeros(4, 8)
    for schedule in pl.SCHEDULES:
        with pytest.raises(ValueError, match="preserve the activation"):
            pl.pipeline_value_and_grad(
                lambda p, t: t, lambda p, h: h[:, :4],
                lambda p, y, t: y.sum(), [None, None], x, x,
                pl.PipeLoopback(2), n_microbatches=2, schedule=schedule)


def test_1f1b_holds_at_most_s_stage_inputs():
    """The memory property: across the 1F1B clock a stage never holds
    more than S inputs (the save ring), where GPipe holds M graphs."""
    S, M = 2, 8
    held = []

    class Probe(pl._TrainStage):
        def on_f(self, k, act):
            out = super().on_f(k, act)
            held.append(len(self.saved))
            return out

    fns = (lambda w, t: t @ w, lambda w, h: torch.tanh(h @ w),
           lambda w, y, t: (y - t).square().sum())
    stages = [Probe(s, S, torch.eye(4, requires_grad=True), fns,
                    torch.ones(M, 2, 4), torch.zeros(M, 2, 4), "1f1b")
              for s in range(S)]
    clock = pl.Clock("1f1b", M, S)
    pl._lockstep([pl._stage_body(st.s, S, clock, range(clock.ticks),
                                 st.on_f, st.on_b) for st in stages])
    assert max(held) <= S
    assert len(stages[-1].losses) == M


def test_clock_matches_the_jax_1f1b_clock():
    """Each tick holds one F or one B on a stage, every microbatch gets
    both on every stage, and what a stage sends is due at its neighbour
    on the next tick."""
    for S, M in ((2, 3), (4, 8), (1, 2)):
        for schedule in pl.SCHEDULES:
            c = pl.Clock(schedule, M, S)
            for s in range(S):
                fs = [c.fwd(t, s) for t in range(c.ticks)]
                bs = [c.bwd(t, s) for t in range(c.ticks)]
                assert sorted(k for k in fs if k is not None) == list(
                    range(M))
                assert sorted(k for k in bs if k is not None) == list(
                    range(M))
                assert all(f is None or b is None for f, b in zip(fs, bs))
                for t in range(c.ticks):
                    if fs[t] is not None and s < S - 1:
                        assert c.fwd(t + 1, s + 1) == fs[t]
                    if bs[t] is not None and s > 0:
                        assert c.bwd(t + 1, s - 1) == bs[t]
        assert [pl.is_f(t, 1, 3) for t in range(6)] == [
            False, True, False, True, False, True]
        assert pl.k_b(2 * S - 1, 0, S) == 0
