"""Device meshes for dp/fsdp/sp/tp parallelism.

Port of ``pytorch_operator_tpu/parallel/mesh.py`` (``factor_devices``,
``make_mesh``, ``make_sp_mesh``, ``make_named_mesh``,
``head_shard_degree``, ``data_axes`` with its batch-size drop, the batch
rule of ``batch_spec``).  A mesh is a ``torch.distributed.DeviceMesh``
over the process group's ranks, one process per device, with dims named
as the JAX axes:

  dp    data parallelism: parameters replicated, gradients all-reduced
  fsdp  data parallelism with parameters, gradients and optimizer state
        sharded (FSDP2; with dp, HSDP: replicate over dp, shard over
        fsdp)
  sp    sequence parallelism: each rank holds T/sp rows of every
        activation; attention runs a ring or an all-to-all over sp
        (``parallel/ring_attention.py``, ``parallel/ulysses.py``);
        parameters replicated over it
  tp    tensor parallelism: attention heads, the MLP hidden width and
        the tied embedding's vocab rows sharded (DTensor,
        ``llama.param_specs``, ``llama.shard_vocab``)
  ep    expert parallelism: the MoE model's experts sharded
        (``moe.shard_experts``; a (dp, fsdp, tp, ep) mesh), the rest
        replicated over it
  pp    pipeline parallelism: a mesh of its own
        (``make_named_mesh({"pp": S})``), each rank one stage's layers
        (``llama.pp_param_specs``, ``parallel/pipeline.py``)

tp is the innermost dim (its collectives run every layer) but for ep,
which follows it so that the experts' all-reduce over (tp, ep) spans
neighbouring ranks; sp comes before tp, dp is the outermost.  A batch is
split over the data dims (dp, fsdp) and shared by the sp, tp and ep
ranks (``local_rows``); the sequence-parallel
step keeps only the data dims that divide it, as the JAX ``forward_sp``.
``batch_spec`` has no counterpart: ``local_rows`` is its layout.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from pytorch_operator_tpu_torch.device import default_device

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_TP = "tp"
AXIS_SP = "sp"
AXIS_PP = "pp"
AXIS_EP = "ep"
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


def make_named_mesh(axes: dict[str, int],
                    device: str | torch.device | None = None,
                    ranks: list[int] | None = None) -> DeviceMesh:
    """A ``DeviceMesh`` with the named dims of ``axes`` (outermost first)
    over every rank of the process group, on ``device``'s type (``cuda``
    unless the caller names ``cpu``).

    With no process group, one is started at world size 1 (NCCL on
    cuda, gloo on cpu); with one, its world size must equal the product
    of the sizes.  ``ranks``: a mesh over these ranks of the group only
    (every rank of the group calls it; the others are outside the mesh,
    ``mesh.get_coordinate()`` is None there)."""
    dev = default_device(device)
    for name, size in axes.items():
        if size < 1:
            raise ValueError(f"mesh dim {name} must be >= 1, got {size}")
    n = math.prod(axes.values())
    shape = "(" + ",".join(str(s) for s in axes.values()) + ")"
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"mesh {shape} needs {n} processes; start them with "
                f"WORLD_SIZE={n} (maybe_init_distributed)")
        _start_one_rank_group("nccl" if dev.type == "cuda" else "gloo")
    world = dist.get_world_size()
    if ranks is not None:
        if len(ranks) != n or not set(ranks) <= set(range(world)):
            raise ValueError(f"mesh {shape} needs {n} of the group's "
                             f"{world} ranks, got {ranks}")
        return DeviceMesh(dev.type, torch.tensor(ranks).reshape(
            tuple(axes.values())), mesh_dim_names=tuple(axes))
    if world != n:
        raise ValueError(f"mesh {shape} needs {n} processes, the process "
                         f"group has {world}")
    return init_device_mesh(dev.type, tuple(axes.values()),
                            mesh_dim_names=tuple(axes))


def make_mesh(dp: int = 1, fsdp: int = 1, tp: int = 1,
              device: str | torch.device | None = None,
              ranks: list[int] | None = None) -> DeviceMesh:
    """A (dp, fsdp, tp) mesh (``make_named_mesh``)."""
    return make_named_mesh(dict(zip(MESH_DIMS, (dp, fsdp, tp))), device,
                           ranks)


def make_sp_mesh(dp: int = 1, sp: int = 1, *, fsdp: int = 1, tp: int = 1,
                 device: str | torch.device | None = None) -> DeviceMesh:
    """A (dp, fsdp, sp[, tp]) mesh for sequence-parallel training, in the
    JAX function's order; a tp=1 mesh keeps the (dp, fsdp, sp) dim set.
    With fsdp, parameters and optimizer state shard over fsdp (the
    Llama-2-7B layout: weights ZeRO-3 over fsdp, sequence over sp, batch
    over dp x fsdp)."""
    axes = {AXIS_DP: dp, AXIS_FSDP: fsdp, AXIS_SP: sp}
    if tp > 1:
        axes[AXIS_TP] = tp
    return make_named_mesh(axes, device)


def dim_size(mesh: DeviceMesh, name: str) -> int:
    """The size of mesh dim ``name``, 1 where the mesh has no such dim."""
    names = mesh.mesh_dim_names or ()
    return mesh[name].size() if name in names else 1


def head_shard_degree(mesh: DeviceMesh, head_axes: tuple[str, ...],
                      n_heads: int, n_kv_heads: int) -> int:
    """Product of the head-sharding (tensor-parallel) dims, validated: it
    must divide both head counts (each tp shard owns whole q and kv
    heads).  A copy of the JAX function, with its message."""
    if not head_axes:
        return 1
    deg = math.prod(dim_size(mesh, a) for a in head_axes)
    if n_heads % deg or n_kv_heads % deg:
        raise ValueError(
            f"the mesh's head axes {head_axes} (product {deg}) must "
            f"divide both head counts for SP×TP; got n_heads={n_heads}, "
            f"n_kv_heads={n_kv_heads}")
    return deg


def data_axes(mesh: DeviceMesh,
              batch_size: int | None = None) -> tuple[str, ...]:
    """The mesh dims a (B, ...) batch splits over: (dp, fsdp) as far as
    they are in ``mesh``.  With ``batch_size``, trailing dims are dropped
    until their product divides B, as the JAX function does: a batch too
    small for dp x fsdp is shared by the fsdp ranks (B=1 over fsdp 2:
    both take the same rows)."""
    names = mesh.mesh_dim_names or ()
    axes = [a for a in (AXIS_DP, AXIS_FSDP) if a in names]
    if batch_size is not None:
        while axes and batch_size % math.prod(mesh[a].size() for a in axes):
            axes.pop()
    return tuple(axes)


def data_coordinate(mesh: DeviceMesh,
                    batch_size: int | None = None) -> tuple[int, int]:
    """(index, count) of this rank's batch shard: its coordinate on the
    data dims (``data_axes(mesh, batch_size)``), row-major, and their
    product.  sp and tp ranks share a shard."""
    index, count = 0, 1
    for a in data_axes(mesh, batch_size):
        index = index * mesh[a].size() + mesh.get_local_rank(a)
        count *= mesh[a].size()
    return index, count


def local_rows(batch: torch.Tensor, mesh: DeviceMesh, *,
               drop: bool = False) -> torch.Tensor:
    """This rank's rows of the global batch: ``[r·B/n, (r+1)·B/n)`` for
    its coordinate r of n on the data dims (``batch_spec``'s layout).
    Those are (dp, fsdp), whose product must divide B, as the JAX mesh
    step's input sharding requires; with ``drop`` (the sequence-parallel
    step, as the JAX ``forward_sp``) the data dims that divide B
    (``data_axes(mesh, B)``)."""
    B = batch.shape[0]
    r, n = data_coordinate(mesh, B if drop else None)
    if B % n:
        raise ValueError(f"global batch {B} is not divisible by dp*fsdp "
                         f"= {n}")
    rows = B // n
    return batch[r * rows:(r + 1) * rows]
