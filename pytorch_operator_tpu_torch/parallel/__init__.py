"""Training steps (single device so far)."""

from pytorch_operator_tpu_torch.parallel.train import (
    TrainState,
    adamw,
    chunked_tied_ce,
    cross_entropy_loss,
    make_train_step,
)

__all__ = ["TrainState", "adamw", "chunked_tied_ce", "cross_entropy_loss",
           "make_train_step"]
