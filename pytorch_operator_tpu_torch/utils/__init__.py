"""Process-level utilities: ``torch.distributed`` initialisation."""

from pytorch_operator_tpu_torch.utils.distributed import maybe_init_distributed

__all__ = ["maybe_init_distributed"]
