"""The port's sequence-parallel training step against the JAX one, on the
CPU.

``make_sp_train_step`` runs on gloo ranks (``tests/torch_dist_workers.py``)
over (dp, fsdp, sp) meshes, for each of ulysses, ring and ring_zigzag;
JAX ``make_sp_train_step`` runs in this process on the host devices that
``tests/conftest.py`` forces, with ``sp_param_specs`` or
``sp_fsdp_param_specs`` as the JAX entry picks them, and its
``sharded_init`` weights go to the port through ``load_jax_params``.  The
same numpy-seeded global batches feed both.  Losses and grad norms agree
at rtol 2e-4 (``tests/test_parallel.py``'s SP bound); the first step's
gradients, gathered whole, agree with the single-device port's at atol
1e-6, rtol 1e-5 (``tests/test_torch_distributed.py``'s).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax

import torch_dist_workers as workers
from pytorch_operator_tpu.models import llama as jllama
from pytorch_operator_tpu.parallel import make_sp_mesh as jax_make_sp_mesh
from pytorch_operator_tpu.parallel import (
    make_sp_train_step as jax_make_sp_step,
)
from pytorch_operator_tpu.parallel import sharded_init as jax_sharded_init
from pytorch_operator_tpu_torch.models import llama
from pytorch_operator_tpu_torch.parallel.train import (
    TrainState,
    adamw,
    make_train_step,
)

CFG = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
           vocab_size=128, max_seq_len=16)
T, STEPS, LR, WD, CE_CHUNK = 16, 3, 3e-4, 0.1, 6
IMPLS = ("ulysses", "ring", "ring_zigzag")


def batches(B, n=STEPS):
    return [np.random.default_rng(300 + i).integers(
        0, CFG["vocab_size"], (B, T + 1)) for i in range(n)]


def jax_sp_reference(shape, impl, B, chunked_ce):
    """The JAX SP step's losses and grad norms on ``shape`` = (dp, fsdp,
    sp, tp), and its initial weights (numpy)."""
    dp, fsdp, sp, tp = shape
    jcfg = jllama.tiny(**CFG)
    opt = optax.adamw(LR, weight_decay=WD)
    mesh = jax_make_sp_mesh(dp=dp, sp=sp, fsdp=fsdp, tp=tp)
    if tp > 1:
        specs = jllama.param_specs(jcfg)
    elif fsdp > 1:
        specs = jllama.sp_fsdp_param_specs(jcfg)
    else:
        specs = jllama.sp_param_specs(jcfg)
    jstate = jax_sharded_init(jcfg, mesh, opt, seed=11, specs=specs)
    tree = jax.tree.map(np.asarray, jstate.params)  # before donation
    jstep = jax_make_sp_step(jcfg, mesh, opt, impl=impl,
                             chunked_ce=chunked_ce, ce_chunk=CE_CHUNK)
    losses, norms = [], []
    for b in batches(B):
        jstate, m = jstep(jstate, jnp.asarray(b))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return tree, losses, norms


def single_device_grads(tree, B, chunked_ce):
    """The first step's gradients of the single-device port step."""
    cfg = llama.tiny(**CFG)
    model = llama.load_jax_params(llama.Llama(cfg, device="cpu"), tree)
    opt = adamw(model, LR, weight_decay=WD)
    step = make_train_step(cfg, model, opt, chunked_ce=chunked_ce,
                           ce_chunk=CE_CHUNK)
    step(TrainState(model, opt), batches(B, 1)[0])
    return {n: p.grad.numpy().copy() for n, p in model.named_parameters()}


def run_sp_step(tmp_path, shape, B, chunked_ce, impls=IMPLS,
                remat_policy=None):
    """The port's SP step on gloo ranks for each impl, held against JAX
    make_sp_train_step and the single-device port's first-step grads."""
    refs = {impl: jax_sp_reference(shape, impl, B, chunked_ce)
            for impl in impls}
    tree = refs[impls[0]][0]
    arrays = {"embed": tree["embed"], "final_norm": tree["final_norm"],
              **{f"layers/{k}": v for k, v in tree["layers"].items()},
              **{f"batch{i}": b for i, b in enumerate(batches(B))}}
    np.savez(tmp_path / "in.npz", **arrays)
    spec = {"cfg": CFG, "mesh": list(shape), "impls": list(impls),
            "steps": STEPS, "lr": LR, "wd": WD, "init_seed": 5,
            "arrays": str(tmp_path / "in.npz"), "chunked_ce": chunked_ce,
            "ce_chunk": CE_CHUNK, "remat_policy": remat_policy}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    out = str(tmp_path / "out.npz")
    workers.spawn(workers.sp_step_worker, int(np.prod(shape)),
                  str(tmp_path / "spec.json"), out)
    res = json.loads(open(out + ".json").read())
    grads = dict(np.load(out))
    want_grads = single_device_grads(tree, B, chunked_ce)
    for impl in impls:
        _, jlosses, jnorms = refs[impl]
        got = res[impl]
        assert got["init_bitwise"], impl
        np.testing.assert_allclose(got["losses"], jlosses, rtol=2e-4,
                                   err_msg=impl)
        np.testing.assert_allclose(got["norms"], jnorms, rtol=2e-4,
                                   err_msg=impl)
        for n, g in want_grads.items():
            np.testing.assert_allclose(grads[f"grad/{impl}/{n}"], g,
                                       atol=1e-6, rtol=1e-5,
                                       err_msg=f"{impl} {n}")
    return res


def test_sp2(tmp_path):
    """(dp, fsdp, sp) = (1, 1, 2): the parameters replicated plain
    tensors (the data dims hold one rank: no FSDP2), gradients averaged
    over sp."""
    res = run_sp_step(tmp_path, (1, 1, 2, 1), B=2, chunked_ce=False)
    assert not any(r["dtensor"] for r in res.values())


def test_fsdp2_sp2_batch_of_one(tmp_path):
    """(1, 2, 2), the Llama-2-7B layout (weights over fsdp, sequence over
    sp), at B=1 with the tied head per 6 tokens: the batch is too small
    for fsdp 2, so both fsdp ranks take the one row (data_axes' drop, as
    the JAX forward_sp does)."""
    res = run_sp_step(tmp_path, (1, 2, 2, 1), B=1, chunked_ce=True)
    assert all(r["dtensor"] for r in res.values())
