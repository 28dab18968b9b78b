"""Checkpoint and resume of the port's trainer at another world size.

``train_llama --device cpu --model tiny`` trains 4 steps at world 2
(fsdp 2, two gloo processes under ``torch.distributed.run``) and
checkpoints at steps 2 and 4; a second run resumes from step 4 to step
6 at world 1 and another at world 4 (fsdp 2 x tp 2), as
``tests/test_checkpoint_resume.py`` drives the JAX example: the same
log strings, no step before 4 retrained, and the losses of steps 4-5
those of an uninterrupted run.  The restored parameters and AdamW
moments are the saved ones, bit for bit.
"""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.checkpoint.format_utils import dcp_to_torch_save

import torch_dist_workers as workers
from pytorch_operator_tpu_torch.models import llama
from pytorch_operator_tpu_torch.parallel import mesh as tmesh
from pytorch_operator_tpu_torch.parallel.train import (
    TrainState,
    adamw,
    latest_checkpoint,
    restore_on_mesh,
    sharded_init,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--model", "tiny", "--device", "cpu", "--batch-size", "4",
        "--seq-len", "32", "--log-interval", "1"]


def _run(world: int, steps: int, extra: list[str]) -> str:
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    launch = [sys.executable]
    if world > 1:
        launch += ["-m", "torch.distributed.run", "--nproc-per-node",
                   str(world), "--master-addr", "127.0.0.1",
                   "--master-port", str(workers.free_port())]
    proc = subprocess.run(
        launch + ["-m", "pytorch_operator_tpu_torch.train_llama", *ARGS,
                  "--steps", str(steps), *extra],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _losses(out: str) -> dict[int, float]:
    return {int(i): float(x)
            for i, x in re.findall(r"^step (\d+): loss=(\S+)", out,
                                   re.MULTILINE)}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The world-2 run, with a copy of its checkpoints for each resume,
    and an uninterrupted world-1 run of 6 steps."""
    root = tmp_path_factory.mktemp("ckpt")
    ckpt = root / "w2"
    out = _run(2, 4, ["--dp", "1", "--fsdp", "2", "--tp", "1",
                      "--checkpoint-dir", str(ckpt),
                      "--checkpoint-every", "2"])
    copies = {}
    for name in ("w1", "w4", "restore"):
        copies[name] = root / name
        shutil.copytree(ckpt, copies[name])
    return {"out": out, "dirs": copies, "whole": _losses(_run(1, 6, []))}


def test_save_at_world_two(saved):
    out = saved["out"]
    assert "[worker 0/2] mesh dp=1 fsdp=2 tp=1" in out
    assert "checkpointed step 2" in out
    assert "checkpointed step 4" in out
    assert "restored checkpoint" not in out  # fresh start
    assert "training complete" in out
    assert latest_checkpoint(saved["dirs"]["w1"]) == 4
    # the first four steps are the uninterrupted run's
    np.testing.assert_allclose(
        [_losses(out)[i] for i in range(4)],
        [saved["whole"][i] for i in range(4)], rtol=1e-4)


@pytest.mark.parametrize("world,mesh", [(1, []),
                                        (4, ["--dp", "1", "--fsdp", "2",
                                             "--tp", "2"])],
                         ids=["world1", "world4-fsdp2-tp2"])
def test_resume_at_another_world_size(saved, world, mesh):
    ckpt = saved["dirs"][f"w{world}"]
    trace = ckpt.parent / f"trace{world}"
    out = _run(world, 6, [*mesh, "--checkpoint-dir", str(ckpt),
                          "--checkpoint-every", "2",
                          "--profile-dir", str(trace),
                          "--profile-steps", "1"])
    assert f"restored checkpoint at step 4 onto {world} device(s)" in out
    losses = _losses(out)
    # resumes from 4: steps 0-3 are NOT retrained
    assert sorted(losses) == [4, 5], out
    assert "checkpointed step 6" in out
    assert "training complete" in out
    # the losses continue those of the uninterrupted run, within the
    # 1e-4 of the sharded-step tests (Adam's sign(g) under another
    # summation order)
    np.testing.assert_allclose([losses[4], losses[5]],
                               [saved["whole"][4], saved["whole"][5]],
                               rtol=1e-4)
    assert "profile trace written" in out
    assert os.path.getsize(trace / "trace_rank0.json") > 0


def _saved_state(ckpt, step, tmp_path):
    """The checkpoint as full tensors, read without a process group."""
    path = str(tmp_path / "saved.pt")
    dcp_to_torch_save(str(ckpt / str(step)), path)
    return torch.load(path, weights_only=False)


def _assert_restored(saved_sd, get):
    # the optimizer's state is saved keyed by parameter name
    # ("state.<name>.exp_avg": save_checkpoint flattens it)
    model, optim = saved_sd["model"], saved_sd["optim"]
    assert model and len([k for k in optim if k.startswith("state.")]) \
        == 3 * len(model)
    for name, value in model.items():
        assert torch.equal(get(f"model/{name}"), value), name
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(get(f"optim/{name}/{k}"),
                               optim[f"state.{name}.{k}"]), (name, k)
        assert float(get(f"optim/{name}/step")) == float(
            optim[f"state.{name}.step"]) == 4.0


def test_restore_at_world_four_is_bitwise(saved, tmp_path):
    ckpt = saved["dirs"]["restore"]
    out = str(tmp_path / "restored.npz")
    workers.spawn(workers.restore_worker, 4, str(ckpt), 4, (1, 2, 2), out)
    got = np.load(out)
    assert int(got["step"]) == 4
    _assert_restored(_saved_state(ckpt, 4, tmp_path),
                     lambda key: torch.from_numpy(got[key]))


def test_restore_at_world_one_is_bitwise(saved, tmp_path):
    ckpt = saved["dirs"]["restore"]
    assert not dist.is_initialized()
    try:
        mesh = tmesh.make_mesh(1, 1, 1, "cpu")
        model = sharded_init(llama.tiny(max_seq_len=32, remat=True), mesh)
        opt = adamw(model, 3e-4, weight_decay=0.1)
        state = restore_on_mesh(ckpt, 4, TrainState(model, opt))
        assert state.step == 4
        params = dict(model.named_parameters())

        def get(key):
            kind, name, *moment = key.split("/")
            p = params[name]
            t = opt.state[p][moment[0]] if kind == "optim" else p
            return llama.full_value(t).detach()

        _assert_restored(_saved_state(ckpt, 4, tmp_path), get)
    finally:
        dist.destroy_process_group()
