"""Smoke test of the collective wiring a PyTorchJob's env sets up.

Port of ``examples/smoke-dist/dist_allreduce.py``.  One process per
card, under the env the operator injects (``WORLD_SIZE``, ``RANK``,
``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``; ``torch.distributed.run``
sets the same), through ``maybe_init_distributed`` (NCCL; gloo with
``--device cpu``):

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m pytorch_operator_tpu_torch.dist_allreduce
    python -m torch.distributed.run --nproc-per-node 2 \\
        -m pytorch_operator_tpu_torch.dist_allreduce --device cpu

A pod of a PyTorchJob with several cards
(``manifests/pytorch_job_sendrecv.yaml``) runs it through the launcher,
one process a card, so that the check spans every card of every pod;
started there directly it refuses to run on one card of several:

    python -m pytorch_operator_tpu_torch.launch \\
        pytorch_operator_tpu_torch.dist_allreduce

It checks, on every rank of n:

  1. all-reduce: the sum of every rank's index is n(n-1)/2;
  2. ring echo: rank d sends d^2 to rank d+1 and receives from d-1 in
     one ``batch_isend_irecv``, so it holds ((d-1) mod n)^2, the JAX
     script's ``ppermute`` echo.

A check that fails raises; each passes with the JAX script's lines
(``all_reduce ok: ...``, ``ppermute ring echo ok``, ``smoke-dist
passed``), and on cuda each rank ends with ``[worker r/n]
peak_mem_gib=... launches={...}`` as the trainers do.  With one process
(no ``WORLD_SIZE``) the ring is the rank itself and the sum its own 0.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.distributed as dist

from pytorch_operator_tpu_torch import kernels
from pytorch_operator_tpu_torch.device import default_device
from pytorch_operator_tpu_torch.utils import maybe_init_distributed


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="collective smoke test")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = default_device(args.device)
    created_group = not dist.is_initialized()
    rank, n = maybe_init_distributed(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    print(f"[worker {rank}/{n}] global devices: {n}", flush=True)

    total = torch.tensor([float(rank)], device=device)
    mine = torch.tensor([float(rank) ** 2], device=device)
    echoed = mine.clone()
    if n > 1:
        dist.all_reduce(total)
        echoed = torch.empty_like(mine)
        ops = [dist.P2POp(dist.isend, mine, (rank + 1) % n),
               dist.P2POp(dist.irecv, echoed, (rank - 1) % n)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    expect_total = n * (n - 1) / 2
    if float(total) != expect_total:
        raise RuntimeError(f"rank {rank}: all_reduce gave {float(total)}, "
                           f"not {expect_total}")
    expect_echo = float(((rank - 1) % n) ** 2)
    if float(echoed) != expect_echo:
        raise RuntimeError(f"rank {rank}: the ring echo gave "
                           f"{float(echoed)}, not {expect_echo}")
    print(f"all_reduce ok: psum(rank) == {expect_total:.0f} on all {n} "
          f"devices", flush=True)
    print("ppermute ring echo ok", flush=True)
    print("smoke-dist passed", flush=True)
    if device.type == "cuda":
        # as the trainers' last line: the port's kernels launch none here
        print(f"[worker {rank}/{n}] peak_mem_gib="
              f"{torch.cuda.max_memory_allocated(device) / 2 ** 30:.3f} "
              f"launches={json.dumps(kernels.launch_counts())}", flush=True)
    if created_group and dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
