"""Multi-process initialisation from the operator-injected rendezvous env.

Port of ``pytorch_operator_tpu/utils/distributed.py``.  The operator
injects ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``
into every pod (``torch.distributed.run`` sets the same variables and
``LOCAL_RANK``).  A workload calls :func:`maybe_init_distributed` once
at startup: one process when ``WORLD_SIZE`` is absent or 1, as the
reference example's ``should_distribute()`` decides.

``RANK`` stands where the JAX version reads ``TPU_WORKER_ID``.  The
backend follows the device: NCCL for ``cuda`` (each process on the card
``LOCAL_RANK``), gloo for ``cpu``, which the caller must name.  A CUDA
run never falls back to gloo: a failed NCCL start raises.

The operator gives a pod one ``RANK`` and sets no ``LOCAL_RANK``, while
a JAX process drives every chip of its host.  A pod with several cards
therefore runs ``python -m pytorch_operator_tpu_torch.launch``, one
process a card; a process started there directly refuses to train on
one card of several.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from pytorch_operator_tpu_torch.device import default_device


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    if value is None or value == "":
        return default
    try:
        return int(value)
    except ValueError:
        raise ValueError(f"{name}={value!r} is not an integer") from None


def process_index() -> int:
    """This process's host index in the JAX sense (the ``pid`` the JAX
    ``maybe_init_distributed`` returns): torchrun's ``GROUP_RANK`` (the
    node rank, which the launcher sets to the pod's ``RANK``) where it
    is set, else ``RANK`` (the operator's env: one process a pod), else
    0."""
    return _env_int("GROUP_RANK", _env_int("RANK", 0))


def maybe_init_distributed(device: str | torch.device | None = None
                           ) -> tuple[int, int]:
    """Initialise ``torch.distributed`` when ``WORLD_SIZE`` > 1.

    Returns ``(rank, world_size)``.  At world size 1 nothing is
    initialised and ``(0, 1)`` comes back.  Above 1 the process group
    starts at ``tcp://MASTER_ADDR:MASTER_PORT`` (defaults
    ``localhost:23456``, as in the JAX version) with NCCL on ``cuda``
    and gloo on ``cpu``.  A process group that already exists is kept
    if it agrees with the env.

    Under the operator's env (``WORLD_SIZE`` set, no ``LOCAL_RANK``) on
    a host with more than one visible card it raises: that pod needs
    the launcher."""
    dev = default_device(device)
    if (os.environ.get("WORLD_SIZE") and "LOCAL_RANK" not in os.environ
            and dev.type == "cuda" and torch.cuda.device_count() > 1):
        raise RuntimeError(
            f"WORLD_SIZE is set without LOCAL_RANK (the operator's env: one "
            f"process a pod) and {torch.cuda.device_count()} CUDA devices "
            f"are visible, so this process would train on one of them; "
            f"start the pod's processes with python -m "
            f"pytorch_operator_tpu_torch.launch <module> [args], one a card")
    world_size = _env_int("WORLD_SIZE", 1)
    if world_size <= 1:
        return 0, 1
    rank = _env_int("RANK", 0)
    local_rank = _env_int("LOCAL_RANK", 0)
    if not 0 <= rank < world_size:
        raise ValueError(f"RANK={rank} is outside WORLD_SIZE={world_size}")
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this torch build has no NCCL; a cuda run "
                               "does not fall back to gloo")
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK={local_rank} but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    else:
        backend = "gloo"
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world_size):
            raise RuntimeError(
                f"a process group of rank {dist.get_rank()}/"
                f"{dist.get_world_size()} exists, the env says "
                f"{rank}/{world_size}")
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} process group "
                               f"exists; {dev.type} needs {backend}")
        return rank, world_size
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = _env_int("MASTER_PORT", 23456)
    kw = {}
    if backend == "nccl":
        # binds the group to this card now, so the first collective does
        # not have to guess it
        kw["device_id"] = torch.device("cuda", local_rank)
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world_size, **kw)
    return rank, world_size
