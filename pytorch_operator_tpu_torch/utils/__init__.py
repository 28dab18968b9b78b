"""Process-level utilities: ``torch.distributed`` initialisation."""

from pytorch_operator_tpu_torch.utils.distributed import (
    maybe_init_distributed,
    process_index,
)

__all__ = ["maybe_init_distributed", "process_index"]
