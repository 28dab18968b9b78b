"""The (dp, fsdp, tp) mesh and the training step over it."""

from pytorch_operator_tpu_torch.parallel.mesh import (
    data_axes,
    factor_devices,
    local_rows,
    make_mesh,
)
from pytorch_operator_tpu_torch.parallel.train import (
    TrainState,
    adamw,
    chunked_tied_ce,
    cross_entropy_loss,
    latest_checkpoint,
    make_train_step,
    restore_on_mesh,
    save_checkpoint,
    sharded_init,
    with_step_profiler,
)

__all__ = ["TrainState", "adamw", "chunked_tied_ce", "cross_entropy_loss",
           "data_axes", "factor_devices", "latest_checkpoint", "local_rows",
           "make_mesh", "make_train_step", "restore_on_mesh",
           "save_checkpoint", "sharded_init", "with_step_profiler"]
