"""Parity of the torch port's MoE Llama with the JAX MoE, on the CPU.

The JAX ``moe.tiny`` weights go into the port through
``moe.load_jax_params``; the same seeded numpy tokens go through both.
``lax.top_k`` and ``torch.topk`` may break ties in other ways, so every
case first checks that its routing has none: the k-th probability of
each token in each layer exceeds the next by more than 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

from pytorch_operator_tpu.models import moe as jmoe
from pytorch_operator_tpu_torch.models import llama, moe
from pytorch_operator_tpu_torch.parallel.train import (
    TrainState,
    adamw,
    make_train_step,
    sharded_init,
)

T, B, STEPS, LR, WD, CE_CHUNK = 16, 2, 3, 3e-3, 0.1, 6
GRAD = dict(atol=1e-6, rtol=1e-5)
MARGIN = 1e-4


def jax_loss_fn(cfg, batch):
    """The JAX MoE step's loss (tests/test_pipeline_moe.py:282-286)."""

    def loss(p):
        logits, aux = jmoe.forward(p, batch[:, :-1], cfg)
        lp = jax.nn.log_softmax(logits)
        ce = -jnp.mean(jnp.take_along_axis(lp, batch[:, 1:, None], -1))
        return ce + 0.01 * aux

    return loss


def tokens(seed, n=T + 1, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, n))


def jax_tree(cfg, seed=0):
    params = jmoe.init_params(jax.random.key(seed), cfg)
    return params, jax.tree.map(np.asarray, params)


def port_model(cfg, tree):
    return moe.load_jax_params(moe.MoELlama(cfg, device="cpu"), tree)


@torch.no_grad()
def router_margin(model, inputs) -> float:
    """The least gap, over tokens and layers, between the k-th and the
    (k+1)-th router probability: the routing has no tie above it."""
    cfg = model.cfg
    h = llama.embed_tokens(model, torch.as_tensor(inputs))
    cos, sin = llama.rope_table(cfg, h.shape[1])
    least = float("inf")
    for blk in model.layers:
        h = llama.attend(blk, h, cos, sin)
        x = llama.rms_norm(h, blk.mlp_norm, cfg.norm_eps)
        p = torch.softmax((x @ blk.router).float(), dim=-1)
        top = p.topk(cfg.top_k + 1, dim=-1).values
        least = min(least, float((top[..., -2] - top[..., -1]).min()))
        h = h + moe.moe_ffn(x, blk)[0]
    return least


def grads_to_numpy(model):
    """Gradients in the JAX tree layout."""
    blocks = model.layers
    layers = {n: np.stack([getattr(b, n).weight.grad.numpy().T
                           for b in blocks]) for n in moe.ATTENTION}
    for n in ("router", "w_gate", "w_up", "w_down", "attn_norm",
              "mlp_norm"):
        layers[n] = np.stack([getattr(b, n).grad.numpy() for b in blocks])
    return {"embed": model.embed.grad.numpy(), "layers": layers,
            "final_norm": model.final_norm.grad.numpy()}


@pytest.mark.parametrize("top_k,flash", [(2, False), (1, False),
                                         (2, True)],
                         ids=["top2", "top1", "top2-kernels"])
def test_logits_and_aux_match_jax(top_k, flash):
    """Logits and the aux loss; with the kernels' flags on, the JAX side
    runs its Pallas kernels in interpret mode and the port its plain
    versions."""
    kw = dict(top_k=top_k, use_flash=flash, use_fused_norm=flash,
              max_seq_len=T)
    jcfg, cfg = jmoe.tiny(**kw), moe.tiny(**kw)
    params, tree = jax_tree(jcfg)
    toks = tokens(2)[:, :T]
    model = port_model(cfg, tree)
    assert router_margin(model, toks) > MARGIN
    ref_logits, ref_aux = jmoe.forward(params, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(toks))
    assert logits.dtype == torch.float32 and logits.shape == (B, T, 512)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(aux.item(), float(ref_aux), rtol=1e-5)


@pytest.mark.parametrize("top_k,remat", [(2, False), (1, False), (2, True)],
                         ids=["top2", "top1", "top2-remat"])
def test_grads_match_jax(top_k, remat):
    """One step's gradients of ce + 0.01 · aux: the router's only through
    the chosen probabilities and the aux term, the banks' and the
    embedding's (tied) whole; under remat (each block checkpointed,
    JAX's ``jax.checkpoint``) the same."""
    kw = dict(top_k=top_k, remat=remat, max_seq_len=T)
    jcfg, cfg = jmoe.tiny(**kw), moe.tiny(**kw)
    params, tree = jax_tree(jcfg, seed=3)
    toks = tokens(4)
    model = port_model(cfg, tree)
    assert router_margin(model, toks[:, :-1]) > MARGIN
    jl, jg = jax.value_and_grad(jax_loss_fn(jcfg, jnp.asarray(toks)))(
        params)
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    _, m = make_train_step(cfg, model, opt)(TrainState(model, opt), toks)
    np.testing.assert_allclose(m["loss"].item(), float(jl), rtol=1e-5)
    got = jax.tree_util.tree_leaves_with_path(grads_to_numpy(model))
    want = dict(jax.tree_util.tree_leaves_with_path(jg))
    assert len(got) == len(want)
    for path, g in got:
        np.testing.assert_allclose(g, np.asarray(want[path]), **GRAD,
                                   err_msg=jax.tree_util.keystr(path))
    np.testing.assert_allclose(m["grad_norm"].item(),
                               float(optax.global_norm(jg)), rtol=1e-5)


def jax_steps(jcfg, params, batches):
    """The JAX MoE step (tests/test_pipeline_moe.py:282-293) with
    optax.adamw on one device: losses and grad norms."""
    opt = optax.adamw(LR, weight_decay=WD)
    state = opt.init(params)
    losses, norms = [], []
    for b in batches:
        loss, g = jax.value_and_grad(jax_loss_fn(jcfg, jnp.asarray(b)))(
            params)
        u, state = opt.update(g, state, params)
        params = optax.apply_updates(params, u)
        losses.append(float(loss))
        norms.append(float(optax.global_norm(g)))
    return losses, norms


@pytest.mark.parametrize("chunked_ce", [False, True])
def test_train_steps_match_jax(chunked_ce):
    """Three AdamW steps of make_train_step on an MoEConfig against the
    JAX step, the routing checked for ties at every step's weights."""
    jcfg, cfg = jmoe.tiny(max_seq_len=T), moe.tiny(max_seq_len=T)
    params, tree = jax_tree(jcfg, seed=5)
    batches = [tokens(10 + i) for i in range(STEPS)]
    jlosses, jnorms = jax_steps(jcfg, params, batches)
    model = port_model(cfg, tree)
    opt = adamw(model, LR, weight_decay=WD)
    step = make_train_step(cfg, model, opt, chunked_ce=chunked_ce,
                           ce_chunk=CE_CHUNK)
    state, losses, norms = TrainState(model, opt), [], []
    for b in batches:
        assert router_margin(model, b[:, :-1]) > MARGIN
        state, m = step(state, b)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    np.testing.assert_allclose(norms, jnorms, rtol=1e-4)
    assert losses[-1] < losses[0]


def test_load_and_export_round_trip():
    jcfg, cfg = jmoe.tiny(), moe.tiny()
    _, tree = jax_tree(jcfg)
    back = moe.params_to_numpy(port_model(cfg, tree))
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_init_distributions_and_count():
    """The port's init draws the JAX distributions (N(0, 1/fan_in), norms
    ones) from its own generator; n_params counts the JAX tree."""
    cfg = moe.tiny(n_experts=4, ffn_dim=256, dim=128)
    model = moe.MoELlama(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    blk = model.layers[0]
    for p, fan_in in ((blk.router, 128), (blk.w_gate, 128),
                      (blk.w_down, 256)):
        assert abs(p.float().std().item() * fan_in ** 0.5 - 1) < 0.05
    assert torch.equal(blk.mlp_norm, torch.ones(128))
    jtree = jax.eval_shape(lambda k: jmoe.init_params(k, jmoe.tiny(
        n_experts=4, ffn_dim=256, dim=128)), jax.random.key(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jtree))
    assert moe.n_params(cfg) == want == sum(p.numel()
                                            for p in model.parameters())


def test_mixtral_widths():
    cfg = moe.mixtral_8x7b()
    assert (cfg.dim, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.ffn_dim, cfg.n_experts, cfg.top_k, cfg.vocab_size,
            cfg.rope_theta, cfg.norm_eps) == (
        4096, 32, 32, 8, 128, 14336, 8, 2, 32000, 1e6, 1e-5)
    # 46.57B with the tied embedding (Mixtral's untied head adds 131M)
    assert moe.n_params(cfg) == 46_571_720_704
    assert cfg.dtype == torch.bfloat16 and cfg.use_flash


def test_specs_mirror_the_jax_param_specs():
    """The banks' ep and tp dims are JAX's without the layer axis; the
    attention keeps Llama's tp plan; the router and norms replicate."""
    jspecs = jmoe.param_specs(jmoe.tiny())["layers"]
    for name, splits in moe.EXPERT_SPLITS.items():
        spec = tuple(jspecs[name])[1:]
        assert splits == {a: spec.index(a) for a in ("ep", "tp")}, name
    assert tuple(jspecs["router"]) == (None, None, None)
    plan = moe.param_specs(moe.tiny())
    assert sorted(plan) == sorted(f"layers.*.{n}" for n in moe.ATTENTION)
    assert isinstance(plan["layers.*.wq"], ColwiseParallel)
    assert isinstance(plan["layers.*.wo"], RowwiseParallel)


def test_ep_and_tp_must_divide():
    moe.check_ep(moe.tiny(n_experts=4, ffn_dim=128), 2, 4)
    with pytest.raises(ValueError, match="ep degree 3 must divide"):
        moe.check_ep(moe.tiny(n_experts=4), 1, 3)
    with pytest.raises(ValueError, match="tp degree 3 must divide"):
        moe.check_ep(moe.tiny(ffn_dim=128), 3, 1)


def test_moe_refuses_sp_and_pp():
    """The JAX package has no sequence-parallel or pipelined MoE."""
    import torch.distributed as dist

    from pytorch_operator_tpu_torch.parallel import mesh as tmesh
    from pytorch_operator_tpu_torch.parallel.train import make_sp_train_step

    assert not dist.is_initialized()
    try:
        mesh = tmesh.make_named_mesh({"pp": 1}, "cpu")
        with pytest.raises(ValueError, match="no pipeline layout"):
            sharded_init(moe.tiny(), mesh,
                         specs=llama.pp_param_specs(moe.tiny(), 1))
        cfg = moe.tiny()
        model = moe.MoELlama(cfg, device="cpu")
        spm = tmesh.make_sp_mesh(1, 1, device="cpu")
        with pytest.raises(ValueError, match="no sequence-parallel"):
            make_sp_train_step(cfg, model, adamw(model), mesh=spm)
    finally:
        dist.destroy_process_group()


def test_remat_policy_is_ignored():
    """A remat tier's name changes nothing: each block is checkpointed
    whole (the JAX MoE ignores the policy too)."""
    cfg = moe.tiny(remat=True)
    toks = torch.from_numpy(tokens(7)[:, :T])
    out = []
    for c in (cfg, dataclasses.replace(cfg, remat_policy="save_attn+qkv")):
        model = moe.MoELlama(c, device="cpu",
                             generator=torch.Generator().manual_seed(0))
        logits, aux = model(toks)
        (logits.square().mean() + aux).backward()
        out.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_step_profiler_counts_every_expert():
    """with_step_profiler's 6·N·B·T counts every expert (dense dispatch)."""
    from pytorch_operator_tpu_torch.telemetry import StepProfiler

    cfg = moe.tiny()
    prof = StepProfiler.for_llama(cfg, batch=2, seq_len=T, device="cpu")
    assert prof.n_params == moe.n_params(cfg) > llama.n_params(cfg)
