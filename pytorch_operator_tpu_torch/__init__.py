"""PyTorch/CUDA port of the pytorch_operator_tpu data plane.

The JAX package (``pytorch_operator_tpu``) stays the reference; this
package is its counterpart for NVIDIA Hopper GPUs.  It imports ``torch``
and ``numpy`` only, never ``jax`` and nothing of the JAX package.

What is ported so far is Llama and MoE training on one GPU or many,
ResNet-50 data-parallel training, dist-MNIST and the job-side operator
seams (the collective smoke test, the push client):

  models.llama      Llama decoder (nn.Module) with the JAX weight layout
                    carried across by ``load_jax_params``, the JAX remat
                    tiers (save_attn[+groups], dots policies, auto) and
                    the tensor-parallel plan (``param_specs``)
  models.moe        the Mixture-of-Experts Llama (top-k router, dense
                    dispatch) and its expert layout over (tp, ep)
  models.mnist_cnn  the MNIST CNN
  models.resnet     ResNet-50 with flax's SAME padding and BatchNorm, its
                    statistics over the global batch of a process group
  parallel.mesh     the (dp, fsdp, tp[, ep]) DeviceMesh, the batch split
  parallel.train    cross-entropy (vocab-parallel where the tied head is
                    split over tp), chunked tied-head CE, AdamW step on
                    one device or over the mesh (FSDP2 + DTensor tp,
                    experts over ep), sharded init, checkpoints at any
                    world size
  telemetry         the step profiler (tokens/s, MFU, JSONL step log)
                    and the push client to the operator
  utils.distributed torch.distributed from the operator's rendezvous env,
                    the JAX process index
  utils.collectives the collectives of a split region with their
                    gradients, the vocab-parallel lookup and CE
  data.mnist        the synthetic digits and the IDX loader (numpy)
  ops.rms_norm      RMSNorm, forward through a CUDA kernel
  ops.flash_attention
                    flash attention, forward and backward (fused, or dq
                    then dk/dv for long sequences) through CUDA kernels
  kernels           nvcc build of ``csrc/*.cu`` and the ctypes binding
  train_llama       ``python -m pytorch_operator_tpu_torch.train_llama``
  train_mnist       ``python -m pytorch_operator_tpu_torch.train_mnist``
  train_resnet      ``python -m pytorch_operator_tpu_torch.train_resnet``
  dist_allreduce    ``python -m pytorch_operator_tpu_torch.dist_allreduce``
  launch            ``python -m pytorch_operator_tpu_torch.launch <module>``:
                    one process a card in a pod the operator starts
  manifests/        an H100 PyTorchJob for each job of the JAX examples

Entry points run on ``cuda`` unless the caller asks for ``cpu``; on CPU
tensors every kernel wrapper takes its plain PyTorch version.
"""

from pytorch_operator_tpu_torch.device import default_device

__all__ = ["default_device"]
