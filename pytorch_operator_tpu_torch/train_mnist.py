"""Distributed MNIST: the data-plane workload of a PyTorchJob.

Port of ``examples/mnist/train_mnist.py``.  Multi-process runs read the
env the operator injects (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_RANK``) through ``maybe_init_distributed``,
one process per GPU, and wrap the model in ``DistributedDataParallel``
(NCCL; gloo with ``--device cpu``):

    python -m pytorch_operator_tpu_torch.train_mnist --epochs 3
    python -m torch.distributed.run --nproc-per-node 2 \\
        -m pytorch_operator_tpu_torch.train_mnist --device cpu

A pod of a PyTorchJob with several cards
(``manifests/pytorch_job_mnist.yaml``) runs it through the launcher, one
process a card; started there directly it refuses to train on one card
of several:

    python -m pytorch_operator_tpu_torch.launch \\
        pytorch_operator_tpu_torch.train_mnist --epochs 10

``--batch-size`` is the global batch, as in the JAX example: every rank
loads the same seeded set, walks the same shuffled batches and trains
on its rows ``[r·B/W, (r+1)·B/W)`` of each, so W ranks take the same
steps as one rank on the whole batch.  (The JAX example seeds worker p's
training set with seed + p; here all ranks share one set, which is what
makes the W-rank run equal the one-rank run.)  SGD with momentum is
``optax.sgd(lr, momentum)``.  Each epoch prints ``Train Epoch: ...``
lines, the test set's loss and accuracy with images/s, and
``accuracy={:.4f}``, the success signal the e2e flow reads from the log.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from pytorch_operator_tpu_torch.data import mnist as mnist_data
from pytorch_operator_tpu_torch.device import default_device
from pytorch_operator_tpu_torch.models import mnist_cnn
from pytorch_operator_tpu_torch.telemetry.trace import StepTrace
from pytorch_operator_tpu_torch.utils import maybe_init_distributed


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="distributed MNIST")
    parser.add_argument("--batch-size", type=int, default=64,
                        help="per-step GLOBAL batch size")
    parser.add_argument("--test-batch-size", type=int, default=1000)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--momentum", type=float, default=0.5)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--log-interval", type=int, default=10)
    parser.add_argument("--data-dir", type=str, default=None,
                        help="dir with MNIST idx files; synthetic if absent")
    parser.add_argument("--synthetic-size", type=int, default=16384)
    parser.add_argument("--target-accuracy", type=float, default=0.0,
                        help="exit once test accuracy reaches this")
    parser.add_argument("--save-model", type=str, default=None,
                        help="write the parameters (JAX layout) to this "
                             ".npz on rank 0")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler trace (Chrome JSON) "
                             "of the first epoch's steps "
                             "1..--profile-steps here (rank 0)")
    parser.add_argument("--profile-steps", type=int, default=10)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = default_device(args.device)
    created_group = not dist.is_initialized()
    rank, world = maybe_init_distributed(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    lead = rank == 0
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"[worker {rank}/{world}] devices: {world} x {name}", flush=True)

    if args.batch_size % world:
        rounded = args.batch_size + world - args.batch_size % world
        print(f"[worker {rank}] --batch-size {args.batch_size} is not "
              f"divisible by {world} processes; using {rounded}", flush=True)
        args.batch_size = rounded
    rows = args.batch_size // world

    xtr, ytr = mnist_data.load(args.data_dir, split="train",
                               synthetic_size=args.synthetic_size,
                               seed=args.seed)
    xte, yte = mnist_data.load(args.data_dir, split="test",
                               synthetic_size=max(args.synthetic_size // 8,
                                                  512),
                               seed=args.seed)
    xte_t = torch.from_numpy(xte).to(device)
    yte_t = torch.from_numpy(yte).to(device)

    net = mnist_cnn.MnistCNN(device=device, generator=torch.Generator(
        device=device).manual_seed(args.seed))
    model = net
    if world > 1:
        model = torch.nn.parallel.DistributedDataParallel(
            net, device_ids=[device.index] if device.type == "cuda"
            else None)
    opt = mnist_cnn.sgd(net, args.lr, args.momentum)

    # --profile-dir: steps 1..--profile-steps of the first epoch, rank 0
    trace = StepTrace(args.profile_dir if lead else None, args.profile_steps,
                      0, device, rank)
    steps_per_epoch = len(xtr) // args.batch_size
    for epoch in range(1, args.epochs + 1):
        t0 = time.perf_counter()
        for i, (x, y) in enumerate(
                mnist_data.batches(xtr, ytr, args.batch_size, seed=epoch)):
            if epoch == 1:
                trace.before(i)
            x = torch.from_numpy(x[rank * rows:(rank + 1) * rows]).to(device)
            y = torch.from_numpy(y[rank * rows:(rank + 1) * rows]).to(device)
            opt.zero_grad(set_to_none=True)
            loss = mnist_cnn.nll_loss(model(x), y)
            loss.backward()  # DDP averages the gradients over the ranks
            opt.step()
            if epoch == 1:
                trace.after(i)
            if i % args.log_interval == 0:
                loss = loss.detach().clone()
                if world > 1:  # the global batch's mean
                    dist.all_reduce(loss)
                    loss /= world
                if lead:
                    print(f"Train Epoch: {epoch} [{i * args.batch_size}/"
                          f"{len(xtr)} ({100. * i / steps_per_epoch:.0f}%)]"
                          f"\tloss={float(loss):.4f}", flush=True)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        trace.stop()  # an epoch shorter than --profile-steps
        train_dt = time.perf_counter() - t0

        total_loss, total_correct = 0.0, 0
        with torch.no_grad():
            for s in range(0, len(xte), args.test_batch_size):
                logp = net(xte_t[s:s + args.test_batch_size])
                yb = yte_t[s:s + args.test_batch_size]
                total_loss += float(mnist_cnn.nll_loss(logp, yb)) * len(yb)
                total_correct += int((logp.argmax(-1) == yb).sum())
        acc = total_correct / len(xte)
        img_per_sec = steps_per_epoch * args.batch_size / train_dt
        if lead:
            print(f"\nTest set: Average loss: {total_loss / len(xte):.4f}, "
                  f"Accuracy: {total_correct}/{len(xte)} "
                  f"({100. * acc:.0f}%); {img_per_sec:.0f} img/s\n",
                  flush=True)
            print(f"accuracy={acc:.4f}", flush=True)
        if args.target_accuracy and acc >= args.target_accuracy:
            if lead:
                print(f"reached target accuracy {args.target_accuracy}",
                      flush=True)
            break

    if args.save_model and lead:
        flat = {f"['{layer}']['{k}']": v
                for layer, leaves in mnist_cnn.params_to_numpy(net).items()
                for k, v in leaves.items()}
        np.savez(args.save_model, **flat)
        print(f"saved model to {args.save_model}", flush=True)
    if created_group and dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
