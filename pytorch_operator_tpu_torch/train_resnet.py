"""ResNet-50 data-parallel training: BASELINE config 4's workload.

Port of ``examples/resnet/train_resnet.py``, the "ResNet-50/ImageNet
PyTorchJob, 4 Workers" configuration: bf16 ResNet-50
(``models/resnet.py``), the global batch split over the processes, SGD
with Nesterov momentum under optax's cosine decay.  Multi-process runs
read the env the operator injects (``WORLD_SIZE``, ``RANK``,
``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``) through
``maybe_init_distributed``, one process per GPU (NCCL; gloo with
``--device cpu``):

    python -m pytorch_operator_tpu_torch.train_resnet --steps 100
    python -m torch.distributed.run --nproc-per-node 4 \\
        -m pytorch_operator_tpu_torch.train_resnet --batch-size 1024
    python -m torch.distributed.run --nproc-per-node 2 \\
        -m pytorch_operator_tpu_torch.train_resnet --device cpu --tiny

A pod of a PyTorchJob with several cards
(``manifests/pytorch_job_resnet.yaml``) runs it through the launcher,
one process a card; started there directly it refuses to train on one
card of several:

    python -m pytorch_operator_tpu_torch.launch \\
        pytorch_operator_tpu_torch.train_resnet --batch-size 1024

The step is the JAX step's function over the global batch:

* the BatchNorms normalise by the global batch's statistics (one
  all-reduce of 2·C floats a layer each way, ``models/resnet.py``), as
  GSPMD reduces the JAX step's batch mean over ``dp``;
* the gradients are averaged over the processes (DistributedDataParallel;
  the running statistics it broadcasts from rank 0 before each forward
  are the ones every rank computed);
* ``torch.optim.SGD(momentum, nesterov=True, dampening=0)`` is
  ``optax.sgd(..., nesterov=True)``, and its learning rate is set before
  each update to optax's closed form ``lr·0.5·(1 + cos(π·min(k, steps) /
  steps))``, k the updates done.

The data are the JAX example's: each rank draws a pool of ``min(4,
steps)`` global NHWC batches from ``np.random.default_rng(p)``, p the
process index in the JAX sense (``utils.process_index``: the node rank
under the launcher or torchrun, the pod's ``RANK`` at one process a
pod), images then labels per entry, and keeps its rows ``[r·B/n,
(r+1)·B/n)`` on the device before the clock starts: the rows the JAX
example's process p puts on its devices.  Lines printed:
``[worker r/n] ...``, ``step i: loss=... images/sec=...`` (the global
batch's loss; images/s from the first step, warm-up included) and
``training complete``; on cuda each rank ends with ``[worker r/n]
peak_mem_gib=... launches={...}`` (the port's kernel launches, as
train_llama's).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from pytorch_operator_tpu_torch import kernels
from pytorch_operator_tpu_torch.device import default_device
from pytorch_operator_tpu_torch.models import resnet
from pytorch_operator_tpu_torch.utils import (
    maybe_init_distributed,
    process_index,
)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="ResNet-50")
    parser.add_argument("--batch-size", type=int, default=256,
                        help="global batch size")
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--log-interval", type=int, default=10)
    parser.add_argument("--tiny", action="store_true",
                        help="thin model + small images (CI/smoke)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.steps < 1:  # optax's cosine schedule needs decay_steps > 0
        parser.error("--steps must be at least 1")
    return args


def cosine_lr(lr: float, k: int, steps: int) -> float:
    """``optax.cosine_decay_schedule(lr, steps)`` at count ``k``."""
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(k, steps) / steps))


def sgd(model: torch.nn.Module, lr: float,
        momentum: float) -> torch.optim.SGD:
    """``optax.sgd(lr, momentum, nesterov=True)``: trace t = g + μ·t,
    update -lr·(g + μ·t)."""
    return torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum,
                           dampening=0.0, nesterov=True)


def make_train_step(model: resnet.ResNet, optimizer: torch.optim.SGD,
                    lr: float, steps: int) -> Callable:
    """``step(images, labels) -> loss``: one update on this rank's rows
    of the global batch.  Where the model's data-parallel group
    (``model.group``, over which its BatchNorms reduce their statistics)
    holds more than one rank, the model goes into DistributedDataParallel
    on that group (gradients averaged) and ``loss`` is this rank's
    mean."""
    net = model
    if model.group is not None and dist.get_world_size(model.group) > 1:
        dev = model.head.weight.device
        net = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=[dev.index] if dev.type == "cuda" else None,
            process_group=model.group)
    done = 0

    def step(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        nonlocal done
        for group in optimizer.param_groups:
            group["lr"] = cosine_lr(lr, done, steps)
        optimizer.zero_grad(set_to_none=True)
        logits, _ = resnet.apply(net, images, train=True)
        loss = F.cross_entropy(logits, labels)
        loss.backward()
        optimizer.step()
        done += 1
        return loss.detach()

    return step


def batch_pool(process: int, rank: int, world: int, batch: int,
               image_size: int, num_classes: int, entries: int,
               device: torch.device) -> list:
    """The JAX example's pool: ``entries`` global batches drawn from
    ``np.random.default_rng(process)`` (f32 NHWC images, then int64
    labels), of which global rank ``rank`` keeps rows ``[r·B/n,
    (r+1)·B/n)`` on ``device``.  ``process`` is the JAX process index
    (``utils.process_index``): the JAX example's process p seeds its
    draw with p and its devices, ranks p·k to p·k + k - 1 of the mesh's
    n, hold those rows of it."""
    rng = np.random.default_rng(process)
    shape = (batch, image_size, image_size, 3)
    rows = slice(rank * batch // world, (rank + 1) * batch // world)
    pool = []
    for _ in range(entries):
        images = rng.standard_normal(shape, dtype=np.float32)[rows]
        labels = rng.integers(0, num_classes, batch)[rows]
        pool.append((torch.from_numpy(images).to(device),
                     torch.from_numpy(labels).to(device)))
    return pool


def main(argv=None) -> int:
    args = parse_args(argv)
    device = default_device(args.device)
    created_group = not dist.is_initialized()
    rank, world = maybe_init_distributed(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"[worker {rank}/{world}] {world} x {name}", flush=True)

    group = dist.group.WORLD if world > 1 else None
    gen = torch.Generator(device=device).manual_seed(0)
    if args.tiny:
        model = resnet.resnet18_thin(args.num_classes, device=device,
                                     group=group, generator=gen)
        args.image_size = min(args.image_size, 64)
    else:
        model = resnet.resnet50(args.num_classes, device=device, group=group,
                                generator=gen)

    if args.batch_size % world:
        rounded = args.batch_size + world - args.batch_size % world
        print(f"[worker {rank}] rounding batch {args.batch_size} -> "
              f"{rounded} for {world} devices", flush=True)
        args.batch_size = rounded

    optimizer = sgd(model, args.lr, args.momentum)
    step = make_train_step(model, optimizer, args.lr, args.steps)
    pool = batch_pool(process_index(), rank, world, args.batch_size,
                      args.image_size, args.num_classes, min(4, args.steps),
                      device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for i in range(args.steps):
        images, labels = pool[i % len(pool)]
        loss = step(images, labels)
        if i % args.log_interval == 0 or i == args.steps - 1:
            if world > 1:  # the global batch's mean
                dist.all_reduce(loss)
                loss /= world
            loss = float(loss)  # waits for the step
            dt = time.perf_counter() - t0
            if rank == 0:
                print(f"step {i}: loss={loss:.4f} "
                      f"images/sec={(i + 1) * args.batch_size / dt:.0f}",
                      flush=True)
    if rank == 0:
        print("training complete", flush=True)
    if device.type == "cuda":
        # the launches of the port's kernels: none on this path
        print(f"[worker {rank}/{world}] peak_mem_gib="
              f"{torch.cuda.max_memory_allocated(device) / 2 ** 30:.3f} "
              f"launches={json.dumps(kernels.launch_counts())}", flush=True)
    if created_group and dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
