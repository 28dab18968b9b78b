"""The hot ops, each with a hand-written CUDA kernel and a plain version.

Counterpart of ``pytorch_operator_tpu/ops``: flash attention (forward;
backward fused, or as a dq and a dk/dv kernel for long sequences) and
RMSNorm.  CUDA tensors launch the kernels in
``csrc/``; CPU tensors take the plain PyTorch versions.
"""

from pytorch_operator_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_with_lse,
)
from pytorch_operator_tpu_torch.ops.rms_norm import rms_norm

__all__ = ["flash_attention", "flash_with_lse", "rms_norm"]
