"""Device mesh for dp/fsdp/tp parallelism.

Port of ``pytorch_operator_tpu/parallel/mesh.py`` (``factor_devices``,
``make_mesh``, ``data_axes``, the batch rule of ``batch_spec``).  The
mesh is a ``torch.distributed.DeviceMesh`` over the process group's
ranks, one process per device, with dims named as the JAX axes:

  dp    data parallelism: parameters replicated, gradients all-reduced
  fsdp  data parallelism with parameters, gradients and optimizer state
        sharded (FSDP2; with dp, HSDP: replicate over dp, shard over
        fsdp)
  tp    tensor parallelism: attention heads and the MLP hidden width
        sharded (DTensor, ``llama.param_specs``)

tp is the innermost dim (its collectives run every layer), dp the
outermost.  A batch is split over (dp, fsdp) and shared by the tp ranks
(``local_rows``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from pytorch_operator_tpu_torch.device import default_device

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_TP = "tp"
MESH_DIMS = (AXIS_DP, AXIS_FSDP, AXIS_TP)


def factor_devices(n: int, tp_max: int = 8) -> tuple[int, int, int]:
    """Factor ``n`` devices into (dp, fsdp, tp), preferring tp then fsdp.

    A copy of the JAX function: tp takes the small power-of-two factors
    first (up to ``tp_max``), fsdp up to 4 of the rest, dp the
    remainder."""
    if n < 1:
        raise ValueError(f"need at least one device, got {n}")
    tp = 1
    while tp * 2 <= tp_max and n % (tp * 2) == 0:
        tp *= 2
    rest = n // tp
    fsdp = 1
    while fsdp * 2 <= rest and rest % (fsdp * 2) == 0 and fsdp < 4:
        fsdp *= 2
    dp = rest // fsdp
    return dp, fsdp, tp


def _start_one_rank_group(backend: str) -> None:
    """A world-1 process group on an in-process store: no port, no
    network, so that one rank runs the same mesh code as many."""
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh(dp: int = 1, fsdp: int = 1, tp: int = 1,
              device: str | torch.device | None = None) -> DeviceMesh:
    """A (dp, fsdp, tp) ``DeviceMesh`` over every rank of the process
    group, on ``device``'s type (``cuda`` unless the caller names
    ``cpu``).

    With no process group, one is started at world size 1 (NCCL on
    cuda, gloo on cpu); with one, its world size must equal
    dp * fsdp * tp."""
    dev = default_device(device)
    for name, size in zip(MESH_DIMS, (dp, fsdp, tp)):
        if size < 1:
            raise ValueError(f"mesh dim {name} must be >= 1, got {size}")
    n = dp * fsdp * tp
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"mesh ({dp},{fsdp},{tp}) needs {n} processes; start them "
                f"with WORLD_SIZE={n} (maybe_init_distributed)")
        _start_one_rank_group("nccl" if dev.type == "cuda" else "gloo")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh ({dp},{fsdp},{tp}) needs {n} processes, "
                         f"the process group has {world}")
    return init_device_mesh(dev.type, (dp, fsdp, tp),
                            mesh_dim_names=MESH_DIMS)


def data_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """The mesh dims a (B, ...) batch splits over: (dp, fsdp) as far as
    they are in ``mesh`` (the JAX function's; its trailing-dim drop for
    a batch too small is not ported: ``local_rows`` requires dp * fsdp
    to divide the batch, as the JAX step's input sharding does)."""
    names = mesh.mesh_dim_names or ()
    return tuple(a for a in (AXIS_DP, AXIS_FSDP) if a in names)


def data_coordinate(mesh: DeviceMesh) -> tuple[int, int]:
    """(index, count) of this rank's batch shard: its coordinate on
    (dp, fsdp), row-major, and dp * fsdp.  tp ranks share a shard."""
    index, count = 0, 1
    for a in data_axes(mesh):
        index = index * mesh[a].size() + mesh.get_local_rank(a)
        count *= mesh[a].size()
    return index, count


def local_rows(batch: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's rows of the global batch: ``[r·B/n, (r+1)·B/n)`` for
    its (dp, fsdp) coordinate r of n (``batch_spec``'s layout, which
    needs n to divide B, as the JAX step's input sharding does)."""
    r, n = data_coordinate(mesh)
    B = batch.shape[0]
    if B % n:
        raise ValueError(f"global batch {B} is not divisible by dp*fsdp "
                         f"= {n}")
    rows = B // n
    return batch[r * rows:(r + 1) * rows]
