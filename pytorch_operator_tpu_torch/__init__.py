"""PyTorch/CUDA port of the pytorch_operator_tpu data plane.

The JAX package (``pytorch_operator_tpu``) stays the reference; this
package is its counterpart for NVIDIA Hopper GPUs.  It imports ``torch``
and ``numpy`` only, never ``jax`` and nothing of the JAX package.

What is ported so far is the single-GPU Llama training step:

  models.llama      Llama decoder (nn.Module) with the JAX weight layout
                    carried across by ``load_jax_params``, and the JAX
                    remat tiers (save_attn[+groups], dots policies, auto)
  parallel.train    cross-entropy, chunked tied-head CE, AdamW step
  ops.rms_norm      RMSNorm, forward through a CUDA kernel
  ops.flash_attention
                    flash attention, forward and backward (fused, or dq
                    then dk/dv for long sequences) through CUDA kernels
  kernels           nvcc build of ``csrc/*.cu`` and the ctypes binding
  train_llama       ``python -m pytorch_operator_tpu_torch.train_llama``

Entry points run on ``cuda`` unless the caller asks for ``cpu``; on CPU
tensors every kernel wrapper takes its plain PyTorch version.
"""

from pytorch_operator_tpu_torch.device import default_device

__all__ = ["default_device"]
