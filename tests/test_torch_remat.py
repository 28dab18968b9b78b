"""The port's rematerialisation tiers against the JAX model, on the CPU.

The JAX ``tiny`` weights go into the port through ``load_jax_params``;
each ``remat_policy`` the port runs is held against no remat and against
the JAX model's grads under the same policy (Pallas in interpret mode).
What each tier recomputes is counted with a ``TorchDispatchMode``: the
flash forward operator (``ptt::flash_fwd``) and the matmuls, as
``tests/test_models.py`` counts pallas calls and dot_generals in the
JAX grad's jaxpr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pytorch_operator_tpu.models import llama as jllama
from pytorch_operator_tpu.parallel.train import (
    cross_entropy_loss as jax_cross_entropy,
)
from pytorch_operator_tpu_torch.models import llama
from pytorch_operator_tpu_torch.parallel.train import cross_entropy_loss

GRAD = dict(atol=5e-5, rtol=1e-3)  # tests/test_torch_llama.py's
T = 64

PORTED = ["save_attn", "save_attn+qkv", "save_attn+gateup",
          "save_attn+normed", "save_attn+qkv+gateup+normed",
          "dots_saveable", "dots_with_no_batch_dims_saveable"]


class OpCounts(TorchDispatchMode):
    """Counts every operator that runs, by name.  Under selective
    checkpointing an operator whose output was saved is answered from the
    cache above this mode and is not counted in the recompute."""

    def __init__(self):
        super().__init__()
        self.counts: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def configs(policy, remat=True, **kw):
    flags = dict(use_flash=True, use_fused_norm=True, max_seq_len=T,
                 remat=remat, remat_policy=policy, **kw)
    return jllama.tiny(**flags), llama.tiny(**flags)


def tokens(seed=4, B=2):
    return np.random.default_rng(seed).integers(0, 512, (B, T + 1))


def port_grads(tcfg, tree, toks):
    """(grads in model.parameters() order, operator counts) of one
    forward + backward."""
    model = llama.load_jax_params(llama.Llama(tcfg, device="cpu"), tree)
    batch = torch.from_numpy(toks)
    with OpCounts() as mode:
        cross_entropy_loss(model(batch[:, :-1]), batch[:, 1:]).backward()
    return model, [p.grad for p in model.parameters()], mode.counts


def grads_to_numpy(model):
    """Gradients in the JAX tree layout (matrices as (in, out))."""
    lin = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    layers = {n: np.stack([getattr(b, n).weight.grad.numpy().T
                           for b in model.layers]) for n in lin}
    for n in ("attn_norm", "mlp_norm"):
        layers[n] = np.stack([getattr(b, n).grad.numpy()
                              for b in model.layers])
    return {"embed": model.embed.grad.numpy(), "layers": layers,
            "final_norm": model.final_norm.grad.numpy()}


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = configs(None)
    params = jllama.init_params(jax.random.key(3), jcfg)
    return params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def no_remat(weights):
    _, tcfg = configs(None, remat=False)
    _, grads, counts = port_grads(tcfg, weights[1], tokens())
    return grads, counts


@pytest.mark.parametrize("policy", [None] + PORTED)
def test_tier_grads_match_no_remat_and_jax(weights, no_remat, policy):
    params, tree = weights
    jcfg, tcfg = configs(policy)
    toks = tokens()

    def jloss(p):
        return jax_cross_entropy(
            jllama.forward(p, jnp.asarray(toks[:, :-1]), jcfg),
            jnp.asarray(toks[:, 1:]))

    jg = jax.grad(jloss)(params)
    model, grads, _ = port_grads(tcfg, tree, toks)
    # remat recomputes the same operators on the same inputs: exact
    for a, b in zip(grads, no_remat[0]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    want = dict(jax.tree_util.tree_leaves_with_path(jg))
    for path, g in jax.tree_util.tree_leaves_with_path(
            grads_to_numpy(model)):
        np.testing.assert_allclose(g, np.asarray(want[path]), **GRAD,
                                   err_msg=jax.tree_util.keystr(path))


def test_save_attn_remat_skips_flash_recompute(weights, no_remat):
    """One flash forward per layer per step under save_attn (the saved
    (out, lse) answer the recompute), two under full remat."""
    L = llama.tiny().n_layers
    flash = {}
    for policy in (None, "save_attn"):
        _, tcfg = configs(policy)
        _, _, counts = port_grads(tcfg, weights[1], tokens())
        flash[policy] = counts["flash_fwd"]
    assert no_remat[1]["flash_fwd"] == L
    assert flash == {None: 2 * L, "save_attn": L}


@pytest.mark.parametrize("policy,norms", [
    ("save_attn", 2), ("save_attn+qkv", 2), ("save_attn+gateup", 2),
    ("save_attn+normed", 0), ("save_attn+qkv+gateup+normed", 0)])
def test_composite_save_tiers_exact_and_fewer_recomputes(weights, no_remat,
                                                         policy, norms):
    """Each save group removes its own recompute: qkv the three q/k/v
    matmuls per layer, gateup the two SwiGLU ones, normed the two norms;
    the flash forward is never recomputed."""
    L = llama.tiny().n_layers
    _, tcfg = configs(policy)
    _, _, counts = port_grads(tcfg, weights[1], tokens())
    base = no_remat[1]
    groups = policy.split("+")[1:]
    saved_mm = 3 * ("qkv" in groups) + 2 * ("gateup" in groups)
    # the recompute runs six of the layer's seven projections: no saved
    # tensor needs w_down's output, so it stops before (early stop)
    assert counts["mm"] - base["mm"] == L * (6 - saved_mm)
    assert counts["rms_norm_fwd"] - base["rms_norm_fwd"] == L * norms
    assert counts["flash_fwd"] == base["flash_fwd"] == L


def test_dots_policies_save_the_matmuls(weights, no_remat):
    """dots_* keep every projection's product (none recomputed) and, as
    in JAX, not the flash forward, which is no dot."""
    L = llama.tiny().n_layers
    for policy in ("dots_saveable", "dots_with_no_batch_dims_saveable"):
        _, tcfg = configs(policy)
        _, _, counts = port_grads(tcfg, weights[1], tokens())
        assert counts["mm"] == no_remat[1]["mm"]
        assert counts["flash_fwd"] == 2 * L


@pytest.mark.parametrize("kw,match", [
    (dict(remat_policy="save_attn", use_flash=False), "use_flash"),
    (dict(remat_policy="save_attn+bogus"), "unknown save group"),
    (dict(remat_policy="auto"), "auto_remat_policy")])
def test_bad_policies_raise_like_jax(kw, match):
    cfg = llama.tiny(**{**dict(use_flash=True, remat=True), **kw})
    with pytest.raises(ValueError, match=match):
        llama.Llama(cfg, device="cpu")


def test_policy_is_ignored_without_remat():
    cfg = llama.tiny(remat=False, remat_policy="auto")
    llama.Llama(cfg, device="cpu")


FLAGSHIP = dict(vocab_size=32000, dim=2048, n_layers=16, n_heads=16,
                n_kv_heads=16, ffn_dim=5632, max_seq_len=32768,
                use_flash=True, remat=True)


@pytest.mark.parametrize("batch,seq,kw", [
    (2, 4096, {}), (1, 32768, {}), (1, 4096, {}), (1, 8192, {}),
    (1, 16384, {}), (1, 65536, {}),
    (8, 32768, dict(state_shards=8, token_shards=8)),
    (8, 32768, dict(state_shards=1, token_shards=8)),
    (1, 16384, dict(hbm_gb=80.0)), (1, 32768, dict(hbm_gb=80.0)),
    (2, 65536, dict(hbm_gb=80.0)), (8, 65536, dict(hbm_gb=80.0))])
def test_auto_remat_policy_matches_jax(batch, seq, kw):
    """The grid of tests/test_models.py's headroom test, plus an 80 GB
    card."""
    jcfg = jllama.LlamaConfig(dtype=jnp.bfloat16, **FLAGSHIP)
    tcfg = llama.LlamaConfig(dtype=torch.bfloat16, **FLAGSHIP)
    want = jllama.auto_remat_policy(jcfg, batch, seq, **kw)
    assert llama.auto_remat_policy(tcfg, batch, seq, **kw) == want

