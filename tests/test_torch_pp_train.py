"""The port's pipeline training step (``make_pp_train_step``, GPipe and
1F1B through the loopback) against the JAX one, on the CPU.

The JAX side runs on a (pp,) mesh of the host devices
``tests/conftest.py`` forces; weights cross over through
``load_jax_params`` and the batches come from numpy seeds.  Losses and
grad norms over three AdamW steps at rtol 1e-4, the bound of the JAX
1F1B test (``tests/test_pipeline_moe.py``); the first step's gradients
against the port's plain step at atol 1e-6, rtol 1e-5 (f32, the
microbatches summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from pytorch_operator_tpu.models import llama as jllama
from pytorch_operator_tpu.parallel import make_named_mesh
from pytorch_operator_tpu.parallel import make_pp_train_step as jax_pp_step
from pytorch_operator_tpu.parallel import sharded_init as jax_sharded_init
from pytorch_operator_tpu_torch.models import llama
from pytorch_operator_tpu_torch.parallel.train import (
    TrainState,
    adamw,
    make_pp_train_step,
    make_train_step,
)
from test_torch_pipeline import T, tokens

LR, WD = 3e-4, 0.1


def _jax_run(cfg, pp, n_mb, schedule, batch, steps=3, **kw):
    mesh = make_named_mesh({"pp": pp})
    opt = optax.adamw(LR, weight_decay=WD)
    state = jax_sharded_init(cfg, mesh, opt,
                             specs=jllama.pp_param_specs(cfg))
    tree = jax.tree.map(np.asarray, state.params)  # before donation
    step = jax_pp_step(cfg, mesh, opt, n_microbatches=n_mb,
                       schedule=schedule, **kw)
    out = []
    for _ in range(steps):
        state, m = step(state, jnp.asarray(batch))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return tree, out


def _port_run(cfg, pp, n_mb, schedule, tree, batch, steps=3, **kw):
    stages = llama.pipeline_stages(cfg, pp, device="cpu")
    for st in stages:
        llama.load_jax_params(st, tree)
    opt = adamw(stages, LR, weight_decay=WD)
    step = make_pp_train_step(cfg, stages, opt, n_microbatches=n_mb,
                              schedule=schedule, **kw)
    state, out, first = TrainState(stages, opt), [], None
    for i in range(steps):
        state, m = step(state, batch)
        if i == 0:
            first = {n: p.grad.clone() for st in stages
                     for n, p in st.named_parameters()}
        out.append((m["loss"].item(), m["grad_norm"].item()))
    return out, first


def _plain_first_grads(cfg, tree, batch, **kw):
    model = llama.load_jax_params(llama.Llama(cfg, device="cpu"), tree)
    opt = adamw(model, LR, weight_decay=WD)
    step = make_train_step(cfg, model, opt, **kw)
    step(TrainState(model, opt), batch)
    return {n: p.grad for n, p in model.named_parameters()}


SMALL = dict(dim=64, n_heads=4, n_kv_heads=4, ffn_dim=128, vocab_size=256,
             max_seq_len=T)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pp_train_step_matches_jax(schedule):
    """Three AdamW steps of the 4-stage pipeline, 4 microbatches: losses
    and grad norms at the JAX 1F1B test's rtol 1e-4; the first step's
    gradients (each stage's layers, the embedding and final norm summed
    over the stages) those of the port's plain step."""
    pp = n_mb = 4
    jcfg, cfg = jllama.tiny(n_layers=pp, **SMALL), llama.tiny(n_layers=pp,
                                                              **SMALL)
    batch = tokens(5, n_mb * 2, cfg.vocab_size)
    tree, want = _jax_run(jcfg, pp, n_mb, schedule, batch)
    got, first = _port_run(cfg, pp, n_mb, schedule, tree, batch)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    plain = _plain_first_grads(cfg, tree, batch)
    for name, g in first.items():
        np.testing.assert_allclose(g.numpy(), plain[name].numpy(), atol=1e-6,
                                   rtol=1e-5, err_msg=name)


def test_pp_gqa_and_chunked_ce_match_jax():
    """GQA (8 q heads, 2 kv) with the tied head per 8 tokens under 1F1B,
    against the JAX step, and against the port's GPipe."""
    kw = dict(SMALL, n_heads=8, n_kv_heads=2, n_layers=4)
    jcfg, cfg = jllama.tiny(**kw), llama.tiny(**kw)
    batch = tokens(7, 8, cfg.vocab_size)
    tree, want = _jax_run(jcfg, 4, 4, "1f1b", batch, chunked_ce=True,
                          ce_chunk=8)
    got, _ = _port_run(cfg, 4, 4, "1f1b", tree, batch, chunked_ce=True,
                       ce_chunk=8)
    gpipe, _ = _port_run(cfg, 4, 4, "gpipe", tree, batch)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(gpipe, want, rtol=1e-4)


def test_pp_remat_stage_body_matches_jax():
    """cfg.remat checkpoints each block inside the stage (and inside the
    1F1B backward tick's rerun), as the JAX stages reuse make_layer_body:
    the same steps as JAX's remat pipeline and as no remat."""
    kw = dict(SMALL, dim=32, ffn_dim=64, vocab_size=128, n_layers=2)
    jcfg = jllama.tiny(remat=True, **kw)
    cfg, plain_cfg = llama.tiny(remat=True, **kw), llama.tiny(**kw)
    batch = tokens(9, 4, cfg.vocab_size)
    tree, want = _jax_run(jcfg, 2, 2, "1f1b", batch)
    got, _ = _port_run(cfg, 2, 2, "1f1b", tree, batch)
    ref, _ = _port_run(plain_cfg, 2, 2, "1f1b", tree, batch)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
