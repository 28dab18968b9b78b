"""Data-parallel ResNet training over gloo ranks, and the collective smoke
test, on the CPU.

Two ranks that each take half of a global batch (``train_resnet``'s step:
DistributedDataParallel, the BatchNorms' statistics all-reduced over the
world) end where one process on the whole batch ends: the losses, every
gradient, parameter and momentum, and the running statistics, each
leaf's largest error within 1e-4 of its largest magnitude (f32; the
ranks sum in another order).  With each rank's BatchNorm on its own
rows they do not: that is the JAX step's GSPMD batch mean, which the
port writes out.  The CLIs run under ``torch.distributed.run`` as the
operator's env drives them.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from pytorch_operator_tpu_torch import train_resnet
from pytorch_operator_tpu_torch.models import resnet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-4


def _batches(path, B=8, size=32):
    rng = np.random.default_rng(11)
    arrays = {}
    for i in range(2):
        arrays[f"x{i}"] = rng.standard_normal(
            (B, size, size, 3)).astype(np.float32)
        arrays[f"y{i}"] = rng.integers(0, 10, B)
    np.savez(path, **arrays)
    return [(arrays[f"x{i}"], arrays[f"y{i}"]) for i in range(2)]


def _one_process(batches) -> dict:
    model = resnet.resnet18_thin(10, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    optimizer = train_resnet.sgd(model, 0.1, 0.9)
    step = train_resnet.make_train_step(model, optimizer, 0.1, 2)
    return workers.resnet_record(model, optimizer, step, batches,
                                 slice(None), 1)


def _worst(got, want, keys=None) -> float:
    """The largest leaf error over that leaf's largest magnitude."""
    return max(float(np.abs(got[k] - want[k]).max())
               / max(float(np.abs(want[k]).max()), 1e-12)
               for k in (keys or want))


@pytest.fixture(scope="module")
def one_and_two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resnet_dist")
    batches = _batches(tmp / "in.npz")
    one = _one_process(batches)
    two = {}
    for global_bn in (True, False):
        out = tmp / f"two_{global_bn}.npz"
        workers.spawn(workers.resnet_step_worker, 2, str(tmp / "in.npz"),
                      global_bn, str(out), timeout=120)
        two[global_bn] = dict(np.load(out))
    return one, two


def test_two_ranks_equal_one_process_on_the_global_batch(one_and_two):
    one, two = one_and_two
    assert sorted(two[True]) == sorted(one)
    assert {k.split("/")[1] for k in one if "/" in k} == {
        "grad", "param", "momentum", "stat"}
    assert _worst(two[True], one) <= REL


def test_per_rank_batch_norm_is_another_function(one_and_two):
    """Without the statistics' all-reduce each rank normalises by its own
    four images: the first step's loss departs from the global batch's by
    over 40 times the tolerance (4.4e-3), its gradients and running
    statistics by over 5000 times (0.69, 0.58)."""
    one, two = one_and_two
    for part, factor in (("loss0", 10), ("0/grad/", 1000), ("0/stat/", 1000)):
        keys = [k for k in one if k.startswith(part)]
        assert _worst(two[False], one, keys) > factor * REL, part


def _torchrun(module, world, *argv):
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         str(world), "--master-addr", "127.0.0.1", "--master-port",
         str(workers.free_port()), "-m", module, *argv],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_train_resnet_cli_on_two_ranks():
    """The tiny trainer under torch.distributed.run: the batch rounded up
    to the world size, and its first loss that of one process on the
    global batch the two ranks' pools make (rank r's rows of the batch
    that the one node draws from seed 0, as the JAX example's one
    process on two devices)."""
    out = _torchrun("pytorch_operator_tpu_torch.train_resnet", 2,
                    "--device", "cpu", "--tiny", "--steps", "2",
                    "--batch-size", "7", "--image-size", "32",
                    "--log-interval", "1")
    assert "[worker 0/2] 2 x cpu" in out
    assert "[worker 0] rounding batch 7 -> 8 for 2 devices" in out
    losses = [float(x) for x in re.findall(r"^step \d: loss=(\S+) "
                                           r"images/sec=\d+$", out, re.M)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert out.rstrip().endswith("training complete")
    parts = [train_resnet.batch_pool(0, r, 2, 8, 32, 1000, 2, "cpu")[0]
             for r in range(2)]
    x, y = (torch.cat(t) for t in zip(*parts))
    model = resnet.resnet18_thin(1000, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    step = train_resnet.make_train_step(
        model, train_resnet.sgd(model, 0.1, 0.9), 0.1, 2)
    assert float(step(x, y)) == pytest.approx(losses[0], abs=1e-4)


def test_dist_allreduce_on_two_ranks():
    out = _torchrun("pytorch_operator_tpu_torch.dist_allreduce", 2,
                    "--device", "cpu")
    assert out.count("all_reduce ok: psum(rank) == 1 on all 2 devices") == 2
    assert out.count("ppermute ring echo ok") == 2
    assert out.count("smoke-dist passed") == 2
