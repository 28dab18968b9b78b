"""Parity of the torch port's Llama with the JAX model, on the CPU.

The JAX ``tiny`` model's weights go into the port through
``load_jax_params``; the same seeded numpy tokens go through both.  The
JAX side runs its Pallas kernels in interpret mode where the config
turns them on; the port takes its ops' plain versions on CPU tensors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_operator_tpu.models import llama as jllama
from pytorch_operator_tpu.parallel.train import (
    cross_entropy_loss as jax_cross_entropy,
)
from pytorch_operator_tpu_torch.models import llama
from pytorch_operator_tpu_torch.parallel.train import cross_entropy_loss

LOGITS = dict(atol=2e-4, rtol=1e-3)
GRAD = dict(atol=5e-5, rtol=1e-3)
T = 64

KERNEL_FLAGS = [(False, False), (True, False), (False, True), (True, True)]


def configs(use_flash, use_fused_norm, **kw):
    flags = dict(use_flash=use_flash, use_fused_norm=use_fused_norm,
                 max_seq_len=T, **kw)
    return jllama.tiny(**flags), llama.tiny(**flags)


def jax_tree(cfg, seed=0):
    params = jllama.init_params(jax.random.key(seed), cfg)
    return params, jax.tree.map(np.asarray, params)


def port_model(cfg, tree):
    return llama.load_jax_params(llama.Llama(cfg, device="cpu"), tree)


def tokens(seed=1, B=2, n=T + 1):
    return np.random.default_rng(seed).integers(0, 512, (B, n))


def grads_to_numpy(model):
    """Gradients in the JAX tree layout (matrices as (in, out))."""
    blocks = model.layers
    lin = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    layers = {n: np.stack([getattr(b, n).weight.grad.numpy().T
                           for b in blocks]) for n in lin}
    for n in ("attn_norm", "mlp_norm"):
        layers[n] = np.stack([getattr(b, n).grad.numpy() for b in blocks])
    return {"embed": model.embed.grad.numpy(), "layers": layers,
            "final_norm": model.final_norm.grad.numpy()}


@pytest.mark.parametrize("use_flash,use_fused_norm", KERNEL_FLAGS)
def test_logits_match_jax(use_flash, use_fused_norm):
    jcfg, tcfg = configs(use_flash, use_fused_norm)
    params, tree = jax_tree(jcfg)
    toks = tokens()[:, :T]
    ref = jllama.forward(params, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        out = llama.forward(port_model(tcfg, tree), torch.from_numpy(toks))
    assert out.dtype == torch.float32 and out.shape == (2, T, 512)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LOGITS)


@pytest.mark.parametrize("use_flash,use_fused_norm", [(False, False),
                                                      (True, True)])
def test_grads_match_jax(use_flash, use_fused_norm):
    jcfg, tcfg = configs(use_flash, use_fused_norm)
    params, tree = jax_tree(jcfg, seed=3)
    toks = tokens(seed=4)

    def jloss(p):
        return jax_cross_entropy(
            jllama.forward(p, jnp.asarray(toks[:, :-1]), jcfg),
            jnp.asarray(toks[:, 1:]))

    jl, jg = jax.value_and_grad(jloss)(params)
    model = port_model(tcfg, tree)
    batch = torch.from_numpy(toks)
    loss = cross_entropy_loss(model(batch[:, :-1]), batch[:, 1:])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    got = jax.tree_util.tree_leaves_with_path(grads_to_numpy(model))
    want = dict(jax.tree_util.tree_leaves_with_path(jg))
    for path, g in got:
        np.testing.assert_allclose(g, np.asarray(want[path]), **GRAD,
                                   err_msg=jax.tree_util.keystr(path))


def test_load_and_export_round_trip():
    jcfg, tcfg = configs(False, False)
    _, tree = jax_tree(jcfg)
    back = llama.params_to_numpy(port_model(tcfg, tree))
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_load_bf16_tree():
    # a bf16 JAX tree arrives as ml_dtypes bfloat16 numpy arrays
    jcfg, tcfg = configs(False, False)
    _, tree = jax_tree(dataclasses.replace(jcfg, dtype=jnp.bfloat16))
    model = port_model(dataclasses.replace(tcfg, dtype=torch.bfloat16), tree)
    assert model.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(model.embed.detach().float().numpy(),
                                  tree["embed"].astype(np.float32))


def test_n_params_matches_jax_and_module():
    for jcfg, tcfg in (configs(False, False),
                       (jllama.llama2_7b(), llama.llama2_7b())):
        assert llama.n_params(tcfg) == jllama.n_params(jcfg)
    _, tcfg = configs(False, False)
    model = llama.Llama(tcfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == llama.n_params(tcfg)
    assert 880e6 < llama.n_params(llama.flagship()) < 890e6


def test_rope_is_half_split_like_jax():
    jcfg, tcfg = configs(False, False)
    x = np.random.default_rng(5).standard_normal((2, T, 4, 16)).astype(
        np.float32)
    jc, js = jllama.rope_table(jcfg, T)
    tc, ts = llama.rope_table(tcfg, T)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    ref = jllama.apply_rope(jnp.asarray(x), jc, js)
    out = llama.apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_init_distributions():
    _, tcfg = configs(False, False)
    gen = torch.Generator().manual_seed(7)
    model = llama.Llama(tcfg, device="cpu", generator=gen).requires_grad_(
        False)
    D, F = tcfg.dim, tcfg.ffn_dim
    np.testing.assert_allclose(float(model.embed.std()), D ** -0.5,
                               rtol=0.05)
    blk = model.layers[0]
    np.testing.assert_allclose(float(blk.wq.weight.std()), D ** -0.5,
                               rtol=0.05)
    np.testing.assert_allclose(float(blk.w_down.weight.std()), F ** -0.5,
                               rtol=0.05)
    assert bool((blk.attn_norm == 1).all() and (model.final_norm == 1).all())
    again = llama.Llama(tcfg, device="cpu",
                        generator=torch.Generator().manual_seed(7))
    assert torch.equal(again.embed, model.embed)


def test_remat_matches_no_remat():
    _, tcfg = configs(True, True)
    toks = torch.from_numpy(tokens(seed=8))
    grads = []
    for remat in (False, True):
        model = llama.Llama(dataclasses.replace(tcfg, remat=remat),
                            device="cpu",
                            generator=torch.Generator().manual_seed(9))
        cross_entropy_loss(model(toks[:, :-1]), toks[:, 1:]).backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("policy", ["nothing_saveable"])
def test_unported_remat_policies_raise(policy):
    # the ported tiers are held in tests/test_torch_remat.py
    _, tcfg = configs(True, False, remat=True, remat_policy=policy)
    with pytest.raises(NotImplementedError, match="save_attn"):
        llama.Llama(tcfg, device="cpu")
