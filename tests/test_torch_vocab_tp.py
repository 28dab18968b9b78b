"""The tied embedding and head split over vocab on tp, against JAX, on
the CPU.

JAX lays the embedding out ``P(tp, fsdp)`` (``models/llama.py:151``) and
GSPMD partitions the tied head and its CE over vocab; the port keeps rows
[r·V/tp, (r+1)·V/tp) on tp rank r (``llama.shard_vocab``), looks tokens
up where they live and sums over tp, and runs the vocab-parallel CE
(``utils/collectives.py``).  On four gloo ranks
(``tests/torch_dist_workers.py``): one step's loss and gathered
gradients through the plain head, the chunked head and ``forward_sp`` at
sp 2 x tp 2 against JAX's on one device (loss rtol 1e-4, gradients atol
1e-6, rtol 1e-5, ``tests/test_torch_distributed.py``'s), and a tp 2
state restored at tp 1 and resharded back bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

import torch_dist_workers as workers
from pytorch_operator_tpu.models import llama as jllama
from pytorch_operator_tpu.parallel.train import (
    chunked_tied_ce as jax_chunked_tied_ce,
)
from pytorch_operator_tpu.parallel.train import (
    cross_entropy_loss as jax_cross_entropy,
)
from pytorch_operator_tpu_torch.models import llama
from pytorch_operator_tpu_torch.parallel import mesh as tmesh
from pytorch_operator_tpu_torch.utils import collectives

CFG = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
           vocab_size=128, max_seq_len=16)
B, T = 4, 16


def test_tp_must_divide_the_vocab():
    llama.check_tp(llama.tiny(vocab_size=512), 4)
    with pytest.raises(ValueError, match="must divide vocab_size=510"):
        llama.check_tp(llama.tiny(vocab_size=510), 4)
    # the head counts are checked first, with their message
    with pytest.raises(ValueError, match="both head counts"):
        llama.check_tp(llama.tiny(vocab_size=510, n_kv_heads=2), 4)


@pytest.fixture()
def one_rank_group():
    assert not dist.is_initialized()
    tmesh.make_mesh(1, 1, 1, "cpu")
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_vocab_parallel_pieces_at_one_rank(one_rank_group):
    """Over a group of one rank the lookup, the CE and the pair of
    region collectives are the plain operations, values and gradients."""
    group = one_rank_group
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(3, 5, 11, generator=g, requires_grad=True)
    targets = torch.randint(0, 11, (3, 5), generator=g)
    nll = collectives.vocab_parallel_nll(logits, targets, group)
    want = F.cross_entropy(logits.reshape(-1, 11), targets.reshape(-1),
                           reduction="none").reshape(3, 5)
    torch.testing.assert_close(nll, want, rtol=1e-6, atol=1e-6)
    (gw,) = torch.autograd.grad(want.sum() * 0.5, logits)
    (gn,) = torch.autograd.grad(nll.sum() * 0.5, logits)
    torch.testing.assert_close(gn, gw, rtol=1e-6, atol=1e-7)
    with pytest.raises(TypeError, match="f32 logits"):
        collectives.vocab_parallel_nll(logits.double(), targets, group)

    table = torch.randn(11, 4, generator=g, requires_grad=True)
    got = collectives.vocab_parallel_embedding(targets, table, 0, group)
    assert torch.equal(got, F.embedding(targets, table))
    x = torch.randn(4, generator=g, requires_grad=True)
    y = collectives.reduce_from_group(collectives.copy_to_group(x, group),
                                      group)
    (y * 3).sum().backward()
    assert torch.equal(y, x) and torch.equal(x.grad, torch.full((4,), 3.))
    assert collectives.group_over(tmesh.make_mesh(1, 1, 1, "cpu"),
                                  ("tp",)) is None


def jax_reference(tree_params, jcfg, batch, chunked):
    """JAX's loss and gradients of the tied-head CE on one device."""
    inputs, targets = jnp.asarray(batch[:, :-1]), jnp.asarray(batch[:, 1:])

    def loss(p):
        if chunked:
            h = jllama.forward_hidden(p, inputs, jcfg)
            return jax_chunked_tied_ce(h, p["embed"], targets, 6)
        return jax_cross_entropy(jllama.forward(p, inputs, jcfg), targets)

    return jax.value_and_grad(loss)(tree_params)


def by_name(jgrads) -> dict:
    out = {"embed": jgrads["embed"], "final_norm": jgrads["final_norm"]}
    for name, g in jgrads["layers"].items():
        for i, gi in enumerate(np.asarray(g)):
            key = f"layers.{i}.{name}"
            out[key if name.endswith("norm") else f"{key}.weight"] = (
                gi if name.endswith("norm") else gi.T)
    return {k: np.asarray(v) for k, v in out.items()}


def test_vocab_split_head_on_four_ranks(tmp_path):
    jcfg = jllama.tiny(**CFG)
    params = jllama.init_params(jax.random.key(13), jcfg)
    tree = jax.tree.map(np.asarray, params)
    batch = np.random.default_rng(500).integers(0, CFG["vocab_size"],
                                                (B, T + 1))
    np.savez(tmp_path / "in.npz", cfg=json.dumps(CFG), batch=batch,
             embed=tree["embed"], final_norm=tree["final_norm"],
             **{f"layers/{k}": v for k, v in tree["layers"].items()})
    workers.spawn(workers.vocab_tp_worker, 4, str(tmp_path / "in.npz"),
                  str(tmp_path), timeout=180)
    res = json.loads((tmp_path / "res.json").read_text())
    grads = dict(np.load(tmp_path / "grads.npz"))

    V, D = CFG["vocab_size"], CFG["dim"]
    for name, chunked in (("plain", False), ("chunked", True),
                          ("sp_ring", False), ("sp_ulysses_chunked", True)):
        r = res[name]
        # tp rank r holds rows [r·V/2, (r+1)·V/2), a Shard(0) over tp
        assert r["embed_local"] == [V // 2, D], (name, r)
        assert r["embed_placements"][-1] == "S(0)", (name, r)
        jl, jg = jax_reference(params, jcfg, batch, chunked)
        np.testing.assert_allclose(r["loss"], float(jl), rtol=1e-4,
                                   err_msg=name)
        want = by_name(jg)
        assert {k.split("/", 2)[2] for k in grads
                if k.startswith(name + "/")} == set(want)
        for n, g in want.items():
            np.testing.assert_allclose(grads[f"{name}/grad/{n}"], g,
                                       atol=1e-6, rtol=1e-5,
                                       err_msg=f"{name} {n}")
    # tp 1 on fsdp 4: the rows split over fsdp alone
    assert res["tp1_embed_local"] == [V // 4, D]
    assert res["restored_at_tp1"] and res["resharded_to_tp2"], res
    assert res["resharded_embed_local"] == [V // 2, D]


def test_adamw_keeps_dtensor_and_plain_parameters_apart(one_rank_group):
    """A tp or ep layout without FSDP2 holds DTensor and plain parameters;
    the foreach AdamW (CUDA's default) takes one kind per call, so adamw
    gives each kind its own group, whose step is the one-group step."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from pytorch_operator_tpu_torch.parallel.train import adamw

    mesh = init_device_mesh("cpu", (1,))
    g = torch.Generator().manual_seed(1)
    w, b = torch.randn(4, 4, generator=g), torch.randn(4, generator=g)
    mixed = torch.nn.Module()
    mixed.w = torch.nn.Parameter(distribute_tensor(w, mesh, [Shard(0)]))
    mixed.b = torch.nn.Parameter(b.clone())
    plain = torch.nn.Module()
    plain.w, plain.b = torch.nn.Parameter(w.clone()), torch.nn.Parameter(
        b.clone())
    for model in (mixed, plain):
        opt = adamw(model, 1e-2, weight_decay=0.1)
        for group in opt.param_groups:
            group["foreach"] = True
        model.w.grad = torch.ones_like(model.w)
        model.b.grad = torch.ones_like(model.b)
        opt.step()
    assert len(adamw(mixed).param_groups) == 2
    assert len(adamw(plain).param_groups) == 1
    assert torch.equal(mixed.w.full_tensor(), plain.w)
    assert torch.equal(mixed.b, plain.b)
