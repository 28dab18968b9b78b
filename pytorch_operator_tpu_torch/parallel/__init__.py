"""The (dp, fsdp, tp), (dp, fsdp, sp[, tp]), (dp, fsdp, tp, ep) and
(pp,) meshes, the training steps over them, the sequence-parallel attention (ring and
Ulysses) and the pipeline (GPipe and 1F1B)."""

from pytorch_operator_tpu_torch.parallel.mesh import (
    AXIS_DP,
    AXIS_EP,
    AXIS_FSDP,
    AXIS_PP,
    AXIS_SP,
    AXIS_TP,
    data_axes,
    factor_devices,
    head_shard_degree,
    local_rows,
    make_mesh,
    make_named_mesh,
    make_sp_mesh,
)
from pytorch_operator_tpu_torch.parallel.pipeline import (
    PipeComm,
    PipeLoopback,
    pipeline_apply,
    pipeline_value_and_grad,
)
from pytorch_operator_tpu_torch.parallel.ring_attention import (
    RingComm,
    ring_attention,
    ring_attention_loopback,
    zigzag_layout,
)
from pytorch_operator_tpu_torch.parallel.train import (
    TrainState,
    adamw,
    chunked_tied_ce,
    cross_entropy_loss,
    latest_checkpoint,
    make_pp_train_step,
    make_sp_train_step,
    make_train_step,
    reshard_state,
    restore_on_mesh,
    save_checkpoint,
    sharded_init,
    with_step_profiler,
)
from pytorch_operator_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = ["AXIS_DP", "AXIS_EP", "AXIS_FSDP", "AXIS_PP", "AXIS_SP", "AXIS_TP",
           "PipeComm", "PipeLoopback", "RingComm", "TrainState", "adamw",
           "chunked_tied_ce", "cross_entropy_loss", "data_axes",
           "factor_devices", "head_shard_degree", "latest_checkpoint",
           "local_rows", "make_mesh", "make_named_mesh",
           "make_pp_train_step", "make_sp_mesh", "make_sp_train_step",
           "make_train_step", "pipeline_apply", "pipeline_value_and_grad",
           "reshard_state", "restore_on_mesh", "ring_attention",
           "ring_attention_loopback", "save_checkpoint", "sharded_init",
           "ulysses_attention", "with_step_profiler", "zigzag_layout"]
