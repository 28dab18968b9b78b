"""The port's multi-process layer against the JAX mesh step, on the CPU.

Ranks are gloo processes (``tests/torch_dist_workers.py``), each on a
free port.  The JAX reference runs in this process on the host devices
that ``tests/conftest.py`` forces: the same tiny f32 model, its
``sharded_init`` weights carried into the port with
``load_jax_params``, and the same numpy-seeded global batches.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

import torch_dist_workers as workers
from pytorch_operator_tpu.models import llama as jllama
from pytorch_operator_tpu.parallel import make_mesh as jax_make_mesh
from pytorch_operator_tpu.parallel import make_train_step as jax_make_step
from pytorch_operator_tpu.parallel import sharded_init as jax_sharded_init
from pytorch_operator_tpu.parallel.mesh import (
    factor_devices as jax_factor_devices,
)
from pytorch_operator_tpu_torch import ops, train_llama
from pytorch_operator_tpu_torch.models import llama
from pytorch_operator_tpu_torch.parallel import mesh as tmesh
from pytorch_operator_tpu_torch.parallel.train import (
    TrainState,
    adamw,
    make_train_step,
    sharded_init,
)
from pytorch_operator_tpu_torch.utils import distributed as tdist
from pytorch_operator_tpu_torch.utils import maybe_init_distributed

CFG = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
           vocab_size=128, max_seq_len=16)
B, T, STEPS, LR, WD = 4, 16, 3, 3e-4, 0.1
CE_CHUNK = 6  # two full chunks and a ragged one
TP_PLANNED = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@pytest.fixture()
def rendezvous_env(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.fixture()
def one_rank_group():
    """A world-1 gloo group in this process, destroyed afterwards."""
    assert not dist.is_initialized()
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_factor_devices_matches_jax():
    for n in range(1, 65):
        for tp_max in (8, 4, 2):
            assert (tmesh.factor_devices(n, tp_max)
                    == jax_factor_devices(n, tp_max)), (n, tp_max)
    with pytest.raises(ValueError):
        tmesh.factor_devices(0)


class TestMaybeInitDistributed:
    def test_world_one_initialises_nothing(self, rendezvous_env):
        assert maybe_init_distributed("cpu") == (0, 1)
        rendezvous_env.setenv("WORLD_SIZE", "1")
        rendezvous_env.setenv("RANK", "0")
        assert maybe_init_distributed("cpu") == (0, 1)
        assert not dist.is_initialized()

    def test_world_two_gloo(self, tmp_path):
        workers.spawn(workers.init_worker, 2, str(tmp_path), timeout=120)
        got = [json.loads((tmp_path / f"rank{r}.json").read_text())
               for r in range(2)]
        assert [g["got"] for g in got] == [[0, 2], [1, 2]]
        assert {g["backend"] for g in got} == {"gloo"}
        assert {g["sum"] for g in got} == {3.0}

    def test_bad_env_raises(self, rendezvous_env):
        rendezvous_env.setenv("WORLD_SIZE", "2")
        rendezvous_env.setenv("RANK", "2")
        with pytest.raises(ValueError, match="outside WORLD_SIZE"):
            maybe_init_distributed("cpu")
        rendezvous_env.setenv("RANK", "zero")
        with pytest.raises(ValueError, match="not an integer"):
            maybe_init_distributed("cpu")

    def test_nccl_failure_raises_and_never_takes_gloo(self, rendezvous_env):
        """cuda runs NCCL on card LOCAL_RANK; a failed start raises and
        no gloo group is tried in its place."""
        rendezvous_env.setenv("WORLD_SIZE", "2")
        rendezvous_env.setenv("RANK", "1")
        rendezvous_env.setenv("LOCAL_RANK", "1")
        rendezvous_env.setattr(torch.cuda, "is_available", lambda: True)
        rendezvous_env.setattr(torch.cuda, "device_count", lambda: 2)
        cards = []
        rendezvous_env.setattr(torch.cuda, "set_device", cards.append)
        calls = []

        def fail(backend, **kw):
            calls.append((backend, kw))
            raise RuntimeError("NCCL error: unhandled system error")

        rendezvous_env.setattr(tdist.dist, "init_process_group", fail)
        rendezvous_env.setattr(tdist.dist, "is_nccl_available", lambda: True)
        with pytest.raises(RuntimeError, match="NCCL error"):
            maybe_init_distributed("cuda")
        assert [c[0] for c in calls] == ["nccl"]
        assert calls[0][1]["init_method"] == "tcp://localhost:23456"
        assert cards == [1]
        rendezvous_env.setattr(tdist.dist, "is_nccl_available",
                               lambda: False)
        with pytest.raises(RuntimeError, match="no NCCL"):
            maybe_init_distributed("cuda")
        assert len(calls) == 1


class TestOneRank:
    def test_make_mesh_starts_a_world_one_group(self, one_rank_group):
        mesh = tmesh.make_mesh(1, 1, 1, "cpu")
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert mesh.mesh_dim_names == ("dp", "fsdp", "tp")
        assert tmesh.data_axes(mesh) == ("dp", "fsdp")
        assert tmesh.data_coordinate(mesh) == (0, 1)
        batch = torch.arange(12).view(4, 3)
        assert torch.equal(tmesh.local_rows(batch, mesh), batch)
        with pytest.raises(ValueError, match="needs 2 processes"):
            tmesh.make_mesh(1, 2, 1, "cpu")

    def test_mesh_beyond_one_rank_needs_the_processes(self):
        assert not dist.is_initialized()
        with pytest.raises(ValueError, match="WORLD_SIZE=4"):
            tmesh.make_mesh(1, 2, 2, "cpu")
        assert not dist.is_initialized()

    @pytest.mark.parametrize("remat_policy,chunked_ce", [
        (None, False), (None, True), ("save_attn+qkv", True),
        ("save_attn+qkv+gateup+normed", False)])
    def test_sharded_step_at_one_rank_is_the_single_device_step(
            self, one_rank_group, remat_policy, chunked_ce):
        """The (1, 1, 1) mesh runs the plain model (sharded_init leaves
        FSDP2 out at one rank): the same values as the unsharded model
        and step (the path the card runs), also under the remat tiers
        (the kernels' plain versions stand in on the CPU), and with the
        chunked tied-head CE, which calls forward_hidden and the
        embedding outside forward."""
        cfg = llama.tiny(**CFG)
        if remat_policy:
            cfg = dataclasses.replace(cfg, remat=True, use_flash=True,
                                      use_fused_norm=True,
                                      remat_policy=remat_policy)
        mesh = tmesh.make_mesh(1, 1, 1, "cpu")
        sharded = sharded_init(cfg, mesh, seed=7)
        plain = llama.Llama(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(7))
        for p, r in zip(sharded.parameters(), plain.parameters()):
            assert torch.equal(llama.full_value(p), r)
        out = {}
        for name, model, m in (("sharded", sharded, mesh),
                               ("plain", plain, None)):
            opt = adamw(model, LR, weight_decay=WD)
            step = make_train_step(cfg, model, opt, mesh=m,
                                   chunked_ce=chunked_ce, ce_chunk=6)
            state, got = TrainState(model, opt), []
            for b in _batches(2):
                state, metrics = step(state, b)
                got.append((metrics["loss"].item(),
                            metrics["grad_norm"].item()))
            out[name] = got
        np.testing.assert_allclose(out["sharded"], out["plain"], rtol=1e-6)
        # a sharded model (here FSDP2 over the one rank) needs its mesh
        fsdp = llama.Llama(cfg, device="meta")
        fully_shard(fsdp, mesh=mesh["dp", "fsdp"])
        with pytest.raises(ValueError, match="needs its mesh"):
            make_train_step(cfg, fsdp, adamw(fsdp))

    def test_dtensor_reaching_a_kernel_wrapper_raises(self, one_rank_group):
        tmesh.make_mesh(1, 1, 1, "cpu")
        dmesh = init_device_mesh("cpu", (1,))
        x = torch.randn(4, 8)
        w = torch.ones(8)
        dx = distribute_tensor(x, dmesh, [Shard(0)])
        dw = distribute_tensor(w, dmesh, [Replicate()])
        for args in ((dx, w), (x, dw)):
            with pytest.raises(TypeError, match="DTensor"):
                ops.rms_norm(*args)
        q = torch.randn(1, 8, 2, 16)
        dq = distribute_tensor(q, dmesh, [Replicate()])
        with pytest.raises(TypeError, match="DTensor"):
            ops.flash_attention(dq, dq, dq)
        with pytest.raises(TypeError, match="DTensor"):
            ops.flash_attention(q, dq, q)


def test_tp_must_divide_both_head_counts():
    llama.check_tp(llama.tiny(n_heads=8, n_kv_heads=4), 4)
    with pytest.raises(ValueError, match="must divide both head counts"):
        llama.check_tp(llama.tiny(n_heads=6, n_kv_heads=3, dim=96), 2)
    with pytest.raises(ValueError, match="must divide both head counts"):
        llama.check_tp(llama.tiny(n_heads=8, n_kv_heads=2), 4)


def test_tp_plan_mirrors_the_jax_param_specs():
    """Column-wise where JAX shards the output features over tp, row-wise
    where it shards the input features; norms absent (replicated)."""
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel)
    plan = llama.param_specs(llama.tiny())
    jspecs = jllama.param_specs(jllama.tiny())["layers"]
    for name, spec in jspecs.items():
        key = f"layers.*.{name}"
        if spec == jax.sharding.PartitionSpec(None, "fsdp", "tp"):
            assert isinstance(plan[key], ColwiseParallel), name
        elif spec == jax.sharding.PartitionSpec(None, "tp", "fsdp"):
            assert isinstance(plan[key], RowwiseParallel), name
        else:
            assert key not in plan, name
    assert len(plan) == len(TP_PLANNED)


@pytest.mark.parametrize("flag", ["--pp", "--sp"])
def test_unported_layouts_raise(flag, capsys):
    """--pp and --sp are ported and parse, with their defaults (their
    checks: tests/test_torch_pp_cli.py, _sp_cli.py); no layout is left
    that the trainer refuses as unported."""
    argv = ["--device", "cpu", flag, "2"]
    args = train_llama.parse_args(argv)
    if flag == "--sp":
        assert (args.sp, args.sp_impl) == (2, "ulysses")
    else:
        assert (args.pp, args.microbatches, args.pp_schedule) == (
            2, 4, "gpipe")
    assert "not ported" not in capsys.readouterr().err


def test_mesh_flags_go_together_and_fill_the_world(capsys):
    with pytest.raises(SystemExit):
        train_llama.parse_args(["--device", "cpu", "--fsdp", "2"])
    assert "must be given together" in capsys.readouterr().err
    args = train_llama.parse_args(["--device", "cpu", "--dp", "1",
                                   "--fsdp", "2", "--tp", "2"])
    with pytest.raises(SystemExit, match="!= 2 processes"):
        train_llama.mesh_shape(args, 2)
    assert train_llama.mesh_shape(args, 4) == (1, 2, 2)
    args = train_llama.parse_args(["--device", "cpu"])
    assert train_llama.mesh_shape(args, 8) == jax_factor_devices(8, 4)


def test_auto_remat_charges_the_mesh(capsys):
    args = train_llama.parse_args(["--device", "cpu", "--model", "7b",
                                   "--flash", "--remat-policy", "auto",
                                   "--batch-size", "8", "--seq-len", "4096"])
    cfg = train_llama.build_config(args, torch.device("cpu"), (2, 2, 2),
                                   rank=3, world=8)
    want = llama.auto_remat_policy(cfg, 8, 4096, state_shards=4,
                                   token_shards=4)
    assert cfg.remat_policy == want
    assert ("[worker 3/8] --remat-policy auto -> " + want
            + " (state/4, tokens/4)") in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the sharded step on 2 and 4 ranks against the JAX mesh step


def _batches(n):
    return [np.random.default_rng(200 + i).integers(
        0, CFG["vocab_size"], (B, T + 1)) for i in range(n)]


def _jax_reference(shape, chunked_ce):
    jcfg = jllama.tiny(**CFG)
    opt = optax.adamw(LR, weight_decay=WD)
    mesh = jax_make_mesh(*shape)
    jstate = jax_sharded_init(jcfg, mesh, opt, seed=11)
    tree = jax.tree.map(np.asarray, jstate.params)  # before donation
    jstep = jax_make_step(jcfg, mesh, opt, chunked_ce=chunked_ce,
                          ce_chunk=CE_CHUNK)
    losses, norms = [], []
    for b in _batches(STEPS):
        jstate, m = jstep(jstate, jnp.asarray(b))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return tree, losses, norms


def _single_device(tree, chunked_ce):
    cfg = llama.tiny(**CFG)
    model = llama.load_jax_params(llama.Llama(cfg, device="cpu"), tree)
    opt = adamw(model, LR, weight_decay=WD)
    step = make_train_step(cfg, model, opt, chunked_ce=chunked_ce,
                           ce_chunk=CE_CHUNK)
    state, losses, norms, grads = TrainState(model, opt), [], [], {}
    for i, b in enumerate(_batches(STEPS)):
        state, m = step(state, b)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        if i == 0:
            grads = {n: p.grad.numpy().copy()
                     for n, p in model.named_parameters()}
    return losses, norms, grads


@pytest.mark.parametrize("shape,chunked_ce", [
    ((1, 2, 1), False), ((2, 2, 1), False), ((1, 2, 2), True)],
    ids=["dp1-fsdp2-tp1", "dp2-fsdp2-tp1", "dp1-fsdp2-tp2-chunked-ce"])
def test_sharded_step_matches_jax_mesh_step(shape, chunked_ce, tmp_path):
    tree, jlosses, jnorms = _jax_reference(shape, chunked_ce)
    slosses, snorms, sgrads = _single_device(tree, chunked_ce)
    arrays = {"embed": tree["embed"], "final_norm": tree["final_norm"],
              **{f"layers/{k}": v for k, v in tree["layers"].items()},
              **{f"batch{i}": b for i, b in enumerate(_batches(STEPS))}}
    np.savez(tmp_path / "in.npz", **arrays)
    spec = {"cfg": CFG, "mesh": list(shape), "steps": STEPS, "lr": LR,
            "wd": WD, "init_seed": 5, "arrays": str(tmp_path / "in.npz"),
            "chunked_ce": chunked_ce, "ce_chunk": CE_CHUNK}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    out = str(tmp_path / "out.npz")
    workers.spawn(workers.step_worker, int(np.prod(shape)),
                  str(tmp_path / "spec.json"), out)
    res = json.loads(open(out + ".json").read())
    grads = dict(np.load(out))

    assert res["init_bitwise"], "sharded_init differs from the unsharded init"
    n = shape[0] * shape[1]
    assert res["refusal"] == (f"global batch 1 is not divisible by "
                              f"dp*fsdp = {n}")
    # losses and grad norms: the JAX mesh step's and the single-device
    # port's within 1e-4 relative at every step -- Adam's first update is
    # about lr * sign(g), so a near-zero gradient whose sign differs
    # between summation orders moves by 2 lr (test_torch_train.py)
    for ref_l, ref_n in ((jlosses, jnorms), (slosses, snorms)):
        np.testing.assert_allclose(res["losses"], ref_l, rtol=1e-4)
        np.testing.assert_allclose(res["norms"], ref_n, rtol=1e-4)
    # first-step gradients, gathered whole, against the single-device
    # port's (f32; measured max |err| about 1e-7)
    assert set(grads) == {f"grad/{n}" for n in sgrads}
    for n, g in sgrads.items():
        np.testing.assert_allclose(grads[f"grad/{n}"], g, atol=1e-6,
                                   rtol=1e-5, err_msg=n)
    # each rank holds 1/(fsdp*tp) of a tp-planned matrix and 1/fsdp of
    # the embedding and norms (replicated over tp), moments alike
    dp, fsdp, tp = shape
    for n, s in res["sizes"].items():
        module = n.split(".")[-2] if "." in n else n
        split = fsdp * tp if module in TP_PLANNED else fsdp
        assert s["local"] * split == s["full"], (n, s)
        assert s["moments"] == [s["local"], s["local"]], (n, s)
        assert s["moments_dtensor"], n
