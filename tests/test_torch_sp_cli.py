"""The sequence-parallel trainer's command line, the world-1 step, the
batch drop and the flash wrappers' new inputs, on the CPU.

- ``train_llama --sp`` refuses what the JAX entry refuses, with the JAX
  entry's own messages (it runs in a subprocess on host devices), and
  trains on two gloo ranks under ``torch.distributed.run``.
- At world size 1 the mesh step is the plain one (no FSDP2, no DTensor)
  and bitwise equal to it.
- ``data_axes`` drops the trailing data dims that do not divide the
  batch, as the JAX function does; ``local_rows`` applies the drop for
  the sequence-parallel step only, and otherwise refuses such a batch.
- Head dims between the kernels' ones and fp16: the plain path against
  JAX ``flash_attention``, and the zero padding the CUDA wrappers apply
  changing nothing.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import torch_dist_workers as workers
from pytorch_operator_tpu.ops import flash_attention as jax_flash
from pytorch_operator_tpu.ops.flash_attention import _auto_block
from pytorch_operator_tpu.parallel.mesh import data_axes as jax_data_axes
from pytorch_operator_tpu.parallel.mesh import (
    head_shard_degree as jax_head_shard_degree,
)
from pytorch_operator_tpu_torch import train_llama
from pytorch_operator_tpu_torch.models import llama
from pytorch_operator_tpu_torch.ops import flash_attention
from pytorch_operator_tpu_torch.ops.flash_attention import (
    _flash_bwd_reference,
    _flash_fwd_reference,
)
from pytorch_operator_tpu_torch.parallel import mesh as tmesh
from pytorch_operator_tpu_torch.parallel.train import (
    TrainState,
    adamw,
    make_train_step,
    sharded_init,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ENTRY = os.path.join(REPO, "examples", "llama", "train_llama.py")


def _jax_entry_error(argv, devices):
    """The JAX entry's parser error for ``argv`` on ``devices`` host
    devices (the text after "error: ")."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    proc = subprocess.run([sys.executable, JAX_ENTRY, *argv], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2, proc.stderr[-2000:]
    return proc.stderr.strip().splitlines()[-1].split("error: ", 1)[1]


@pytest.mark.parametrize("argv,world", [
    (["--sp", "3"], 8),
    (["--sp", "2", "--fsdp", "4", "--seq-len", "31"], 8),
    (["--sp", "2", "--fsdp", "4", "--batch-size", "6"], 8),
    (["--sp", "1", "--tp", "8"], 8),
    (["--sp", "3", "--dp", "2", "--seq-len", "48"], 6)],
    ids=["mesh-product", "seq-len", "batch", "tp-heads", "ulysses-heads"])
def test_sp_argument_errors_match_jax(argv, world):
    argv = ["--model", "tiny", *argv]
    want = _jax_entry_error(argv, world)
    args = train_llama.parse_args(["--device", "cpu", *argv])
    with pytest.raises(SystemExit) as e:
        train_llama.sp_mesh_shape(args, world,
                                  train_llama.MODELS[args.model]())
    assert str(e.value) == f"train_llama: error: {want}"


def test_sp_flags_parse_and_shape_the_mesh():
    args = train_llama.parse_args(["--device", "cpu", "--sp", "2",
                                   "--fsdp", "2", "--sp-impl",
                                   "ring_zigzag", "--seq-len", "64"])
    assert args.sp_impl == "ring_zigzag"
    assert train_llama.sp_mesh_shape(args, 4, llama.tiny()) == (1, 2, 2, 1)
    with pytest.raises(SystemExit):
        train_llama.parse_args(["--device", "cpu", "--sp", "2",
                                "--sp-impl", "spiral"])


def _run_trainer(world, extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    launch = [sys.executable]
    if world > 1:
        launch += ["-m", "torch.distributed.run", "--nproc-per-node",
                   str(world), "--master-addr", "127.0.0.1",
                   "--master-port", str(workers.free_port())]
    proc = subprocess.run(
        launch + ["-m", "pytorch_operator_tpu_torch.train_llama", "--model",
                  "tiny", "--device", "cpu", "--batch-size", "2",
                  "--seq-len", "32", "--steps", "3", "--log-interval", "1",
                  *extra],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_train_llama_sp_on_two_gloo_ranks():
    """The README's command: --sp 2 --sp-impl ring_zigzag on two
    processes trains the losses of the one-process run (f32: the ring
    only sums in another order)."""
    out = _run_trainer(2, ["--sp", "2", "--sp-impl", "ring_zigzag"])
    assert ("[worker 0/2] sequence-parallel mesh dp=1 fsdp=1 sp=2 tp=1 "
            "(ring_zigzag)") in out
    assert "training complete" in out
    losses = re.findall(r"^step \d+: loss=(\S+)", out, re.MULTILINE)
    whole = re.findall(r"^step \d+: loss=(\S+)", _run_trainer(1, []),
                       re.MULTILINE)
    assert len(losses) == len(whole) == 3
    np.testing.assert_allclose(np.array(losses, float),
                               np.array(whole, float), rtol=1e-4)


def test_world_one_step_is_the_plain_step_bitwise():
    """The (1, 1, 1) mesh's model holds no DTensor and is no FSDP2 module,
    and two steps through make_train_step(mesh=...) leave the losses,
    grad norms and parameters of the single-device step bit for bit."""
    assert not dist.is_initialized()
    cfg = llama.tiny(dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                     ffn_dim=128, vocab_size=128)
    batch = np.random.default_rng(9).integers(0, 128, (2, 17))
    try:
        mesh = tmesh.make_mesh(1, 1, 1, "cpu")
        model = sharded_init(cfg, mesh, seed=3)
        assert type(model) is llama.Llama
        assert not any(type(p) is not torch.nn.Parameter
                       for p in model.parameters())
        plain = llama.Llama(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(3))
        got = {}
        for name, m, msh in (("mesh", model, mesh), ("plain", plain, None)):
            opt = adamw(m)
            step = make_train_step(cfg, m, opt, mesh=msh)
            state, out = TrainState(m, opt), []
            for _ in range(2):
                state, metrics = step(state, batch)
                out.append((metrics["loss"], metrics["grad_norm"]))
            got[name] = out
        for (a, b), (c, d) in zip(got["mesh"], got["plain"]):
            assert torch.equal(a, c) and torch.equal(b, d)
        for p, r in zip(model.parameters(), plain.parameters()):
            assert torch.equal(p, r)
    finally:
        dist.destroy_process_group()


class _Mesh:
    """Sizes and a coordinate of a DeviceMesh, for data_axes."""

    def __init__(self, sizes, coords):
        self.mesh_dim_names = tuple(sizes)
        self.sizes, self.coords = sizes, coords

    def __getitem__(self, name):
        return type("Dim", (), {"size": lambda _: self.sizes[name]})()

    def get_local_rank(self, name):
        return self.coords[name]


@pytest.mark.parametrize("sizes,B", [
    (dict(dp=1, fsdp=2, sp=2), 1), (dict(dp=2, fsdp=2, sp=2), 2),
    (dict(dp=2, fsdp=2, sp=1), 4), (dict(dp=2, fsdp=4, sp=1), 6),
    (dict(dp=1, fsdp=2, sp=2, tp=2), 3)])
def test_data_axes_drop_matches_jax(sizes, B):
    jmesh = Mesh(np.array(jax.devices()[:int(np.prod(list(
        sizes.values())))]).reshape(tuple(sizes.values())), tuple(sizes))
    want = jax_data_axes(jmesh, B)
    mesh = _Mesh(sizes, {a: s - 1 for a, s in sizes.items()})
    assert tmesh.data_axes(mesh, B) == want
    assert tmesh.data_axes(mesh) == tuple(
        a for a in ("dp", "fsdp") if a in sizes)
    rows = torch.arange(B * 3).view(B, 3)
    n = int(np.prod([sizes[a] for a in want]))
    mine = tmesh.local_rows(rows, mesh, drop=True)
    assert mine.shape[0] == B // n
    # the last coordinate on every kept dim takes the last rows
    assert torch.equal(mine, rows[B - B // n:])
    # without the drop (the plain mesh step) every data dim splits B, or
    # the batch is refused
    full = int(np.prod([sizes[a] for a in ("dp", "fsdp")]))
    if B % full:
        with pytest.raises(ValueError, match=f"not divisible by dp\\*fsdp "
                                             f"= {full}"):
            tmesh.local_rows(rows, mesh)
    else:
        assert torch.equal(tmesh.local_rows(rows, mesh),
                           rows[B - B // full:])


@pytest.mark.parametrize("sizes,axes,H,Hk", [
    (dict(dp=1, fsdp=2, sp=2, tp=2), ("tp",), 8, 4),
    (dict(dp=1, fsdp=1, sp=2, tp=4), ("tp",), 8, 2),
    (dict(dp=2, fsdp=1, sp=2), (), 8, 2)])
def test_head_shard_degree_matches_jax(sizes, axes, H, Hk):
    jmesh = Mesh(np.array(jax.devices()[:int(np.prod(list(
        sizes.values())))]).reshape(tuple(sizes.values())), tuple(sizes))
    mesh = _Mesh(sizes, {a: 0 for a in sizes})
    try:
        want = jax_head_shard_degree(jmesh, axes, H, Hk)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.head_shard_degree(mesh, axes, H, Hk)
        assert str(got.value) == str(e)
    else:
        assert tmesh.head_shard_degree(mesh, axes, H, Hk) == want


@pytest.mark.parametrize("D,dtype", [(96, np.float32), (48, np.float32),
                                     (64, np.float16)])
def test_new_head_dims_and_fp16_match_jax(D, dtype):
    """The plain path at D 96 / 48 and in fp16 against JAX
    flash_attention (Pallas in interpret mode), forward and grads."""
    rng = np.random.default_rng(D)
    q, k, v = (rng.standard_normal((1, 128, 4, D)).astype(dtype) * s
               for s in (1.0, 1.0, 1.0))
    k, v = k[:, :, :2], v[:, :, :2]  # GQA 2:1
    b = _auto_block(128, D)
    gj = jax.value_and_grad(
        lambda *a: jnp.sum(jax_flash(*a, causal=True, block_q=b,
                                     block_k=b).astype(jnp.float32) ** 2),
        argnums=(0, 1, 2))
    jloss, jgrads = gj(*map(jnp.asarray, (q, k, v)))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    loss = (flash_attention(*ts, causal=True).float() ** 2).sum()
    loss.backward()
    tol = 2e-2 if dtype == np.float16 else 1e-4
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=tol)
    for a, g in zip(ts, jgrads):
        g = np.asarray(g, np.float32)
        err = np.abs(a.grad.float().numpy() - g).max()
        assert err <= tol * np.abs(g).max() + 1e-5, err


@pytest.mark.parametrize("D,Dk", [(96, 128), (48, 64), (200, 256)])
def test_zero_padded_head_dims_change_nothing(D, Dk):
    """What the CUDA wrappers do for a head dim between the kernels'
    ones: zero columns up to the kernel's dim, the scale of the true D,
    the outputs sliced back.  On the plain versions it gives the
    unpadded answer (out, lse, dq, dk, dv)."""
    rng = np.random.default_rng(D)
    q, g = (torch.tensor(rng.standard_normal((1, 64, 4, D)),
                         dtype=torch.float32) for _ in range(2))
    k, v = (torch.tensor(rng.standard_normal((1, 64, 2, D)),
                         dtype=torch.float32) for _ in range(2))
    scale = D ** -0.5

    def pad(x):
        return torch.nn.functional.pad(x, (0, Dk - D))

    out, lse = _flash_fwd_reference(q, k, v, scale, True, False)
    out_p, lse_p = _flash_fwd_reference(pad(q), pad(k), pad(v), scale, True,
                                        False)
    torch.testing.assert_close(out_p[..., :D], out, atol=1e-5, rtol=1e-5)
    assert not out_p[..., D:].any()
    torch.testing.assert_close(lse_p, lse, atol=1e-5, rtol=1e-5)
    delta = (g * out).sum(-1).transpose(1, 2).reshape(4, 64)
    args = (lse.reshape(4, 64), delta, scale, True, False)
    grads = _flash_bwd_reference(q, k, v, g, *args)
    grads_p = _flash_bwd_reference(pad(q), pad(k), pad(v), pad(g), *args)
    for a, b in zip(grads_p, grads):
        torch.testing.assert_close(a[..., :D], b, atol=1e-5, rtol=1e-5)
