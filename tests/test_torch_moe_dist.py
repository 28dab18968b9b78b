"""The port's MoE step with expert parallelism against the JAX MoE step,
on the CPU.

``make_train_step`` on an ``MoEConfig`` runs on gloo ranks
(``tests/torch_dist_workers.py``) over (dp, fsdp, tp, ep) meshes; the JAX
MoE step (``tests/test_pipeline_moe.py:282-293``, with optax.adamw) runs
in this process on one device.  The JAX ``init_params`` weights go to the
port through ``moe.load_jax_params``; the same numpy-seeded global
batches feed both, their routing checked for ties (the k-th router
probability above the next by 1e-4) at every step's weights on the
single-device port.  Losses and grad norms agree at rtol 1e-4, the
first step's gradients, gathered whole, with JAX's at atol 1e-6, rtol
1e-5 (``tests/test_torch_distributed.py``'s), and the parameters the ep
ranks replicate are bit for bit equal on every rank after the steps,
also where the ranks compute their gradients apart.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_workers as workers
from pytorch_operator_tpu.models import moe as jmoe
from pytorch_operator_tpu_torch.models import moe
from pytorch_operator_tpu_torch.parallel.train import (
    TrainState,
    adamw,
    make_train_step,
)
from test_torch_moe import jax_loss_fn, jax_steps, router_margin

CFG = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
           vocab_size=128, max_seq_len=16, n_experts=4, top_k=2)
B, T, STEPS, LR, WD, CE_CHUNK = 4, 16, 3, 3e-3, 0.1, 6
# the batches' seeds, whose routing has no near-tie at any step
BATCH_SEED = 409


def batches():
    return [np.random.default_rng(BATCH_SEED + i).integers(
        0, CFG["vocab_size"], (B, T + 1)) for i in range(STEPS)]


@pytest.fixture(scope="module")
def reference():
    """The JAX weights, losses, grad norms and first-step gradients."""
    jcfg = jmoe.tiny(**CFG)
    params = jmoe.init_params(jax.random.key(11), jcfg)
    tree = jax.tree.map(np.asarray, params)
    losses, norms = jax_steps(jcfg, params, batches())
    grads = jax.grad(jax_loss_fn(jcfg, jnp.asarray(batches()[0])))(params)
    # the routing of every step's weights has no tie (the single-device
    # port's steps: their weights agree with JAX's)
    cfg = moe.tiny(**CFG)
    model = moe.load_jax_params(moe.MoELlama(cfg, device="cpu"), tree)
    opt = adamw(model, LR, weight_decay=WD)
    step, state = make_train_step(cfg, model, opt), TrainState(model, opt)
    for b in batches():
        assert router_margin(model, b[:, :-1]) > 1e-4
        state, _ = step(state, b)
    return tree, losses, norms, grads


def grad_by_name(jgrads) -> dict:
    """JAX gradients under the port's parameter names and layout."""
    out = {"embed": jgrads["embed"], "final_norm": jgrads["final_norm"]}
    for name, g in jgrads["layers"].items():
        for i, gi in enumerate(np.asarray(g)):
            key = f"layers.{i}.{name}"
            if name in moe.ATTENTION:
                out[f"{key}.weight"] = gi.T
            else:
                out[key] = gi
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("shape,chunked_ce", [
    ((1, 1, 1, 2), False), ((2, 1, 1, 2), False), ((1, 1, 2, 2), True),
    ((1, 2, 1, 2), False)],
    ids=["ep2", "dp2-ep2", "tp2-ep2-chunked-ce", "fsdp2-ep2"])
def test_moe_step_matches_jax(shape, chunked_ce, reference, tmp_path):
    tree, jlosses, jnorms, jgrads = reference
    arrays = {"embed": tree["embed"], "final_norm": tree["final_norm"],
              **{f"layers/{k}": v for k, v in tree["layers"].items()},
              **{f"batch{i}": b for i, b in enumerate(batches())}}
    np.savez(tmp_path / "in.npz", **arrays)
    spec = {"cfg": CFG, "mesh": list(shape), "steps": STEPS, "lr": LR,
            "wd": WD, "init_seed": 5, "arrays": str(tmp_path / "in.npz"),
            "chunked_ce": chunked_ce, "ce_chunk": CE_CHUNK}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    out = str(tmp_path / "out.npz")
    world = int(np.prod(shape))
    workers.spawn(workers.moe_step_worker, world, str(tmp_path / "spec.json"),
                  out, timeout=180)
    res = json.loads(open(out + ".json").read())
    grads = dict(np.load(out))

    assert res["init_bitwise"], "sharded_init differs from the plain init"
    assert "has none" in res["refusal"]
    np.testing.assert_allclose(res["losses"], jlosses, rtol=1e-4)
    np.testing.assert_allclose(res["norms"], jnorms, rtol=1e-4)
    want = grad_by_name(jgrads)
    assert set(grads) == {f"grad/{n}" for n in want}
    for n, g in want.items():
        np.testing.assert_allclose(grads[f"grad/{n}"], g, atol=1e-6,
                                   rtol=1e-5, err_msg=n)

    # the banks split over ep, tp and fsdp; the embedding over tp and
    # fsdp; the rest over fsdp only
    dp, fsdp, tp, ep = shape
    for n, (local, full) in res["sizes"].items():
        leaf = n.split(".")[-2] if n.endswith(".weight") else \
            n.rsplit(".", 1)[-1]
        split = fsdp * {"w_gate": tp * ep, "w_up": tp * ep,
                        "w_down": tp * ep, "embed": tp, "wq": tp, "wk": tp,
                        "wv": tp, "wo": tp}.get(leaf, 1)
        assert local * split == full, (n, local, full)

    # what the ep ranks replicate is bit for bit equal on every rank
    ranks = [dict(np.load(f"{out}.{r}.npz")) for r in range(world)]
    assert ranks[0] and all(sorted(r) == sorted(ranks[0]) for r in ranks)
    for n in ranks[0]:
        assert not n.rsplit(".", 1)[-1] in moe.EXPERT_BANKS
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[n], ranks[0][n], err_msg=n)


def test_ep_ranks_average_what_they_replicate(tmp_path):
    """The ep ranks' gradients of the replicated parameters are averaged
    before the update: with each rank's attention gradients scaled
    apart, the replicated parameters and gradients stay bit for bit
    equal over ep, and wq's gradient is the ranks' mean."""
    out = str(tmp_path / "out.json")
    workers.spawn(workers.moe_ep_average_worker, 2, out, timeout=120)
    res = json.loads(open(out).read())
    assert res["params_equal"] == [True, True]
    assert res["grads_equal"] == [True, True]
    assert max(res["wq_grad_rel_err"]) < 1e-6, res
