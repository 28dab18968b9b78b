"""RMSNorm with a CUDA forward kernel and an analytic backward.

Port of ``pytorch_operator_tpu/ops/rms_norm.py``.  The forward of a CUDA
tensor launches ``csrc/rms_norm.cu``'s ``rms_norm_sm90_kernel`` (the
counterpart of the TPU kernel ``_rms_kernel``); a CPU tensor takes
``rms_norm_reference``, the plain version.  As the JAX module, it takes x
in float32, bfloat16 or float16 with a weight in any of the three, does
the math in f32 and returns x's dtype.  The forward is the operator
``torch.ops.ptt.rms_norm_fwd``: a kernel launched through ctypes is
invisible to a checkpoint policy, so as one operator its output is what
the ``normed`` region of ``models/llama.py`` saves, and the recompute
takes it from the forward instead of launching the kernel again.  The
backward is the JAX module's analytic VJP (``_rms_vjp_bwd``) in plain
torch on either device: the JAX backward is no Pallas kernel either.

The TPU dispatch limits (rows a multiple of the row block, D <= 2048,
the VMEM budget of the row block) were TPU VMEM constants; the CUDA
kernel takes every N and D, so they are not carried over.  Rows wider
than 2048, which the JAX module sends to XLA, run the kernel, as the
7B's and Mixtral's 4096 do (``chip_smoke.py`` phase 3 times it there
beside ``F.rms_norm``; ``PERF.md`` §6).
"""

from __future__ import annotations

import ctypes

import torch

from pytorch_operator_tpu_torch import kernels

# the C entries' dtype codes (csrc/common.cuh ptt::Dtype)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_HEAD = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int]
KERNEL = kernels.CudaKernel("rms_norm_fwd",
                            _HEAD + [ctypes.c_int, ctypes.c_void_p])
# the one-block-a-row kernel it replaced, on no route: the yardstick that
# chip_smoke.py names by ``kernel=`` (weight in x's dtype only)
ROWBLOCK_KERNEL = kernels.CudaKernel("rms_norm_rowblock_fwd",
                                     _HEAD + [ctypes.c_void_p])


def rms_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                       eps: float = 1e-5) -> torch.Tensor:
    """Plain version: x * rsqrt(mean(x^2) + eps) * w in f32, in x's dtype."""
    xf = x.float()
    inv = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * inv * weight.float()).to(x.dtype)


def rms_norm_cuda(x2: torch.Tensor, weight: torch.Tensor, eps: float,
                  kernel: kernels.CudaKernel | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on an (N, D) tensor, or ``kernel`` where the
    caller names one (``chip_smoke.py`` times ``ROWBLOCK_KERNEL`` beside
    the Hopper one on the same inputs)."""
    for name, t in (("x", x2), ("weight", weight)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"rms_norm kernel takes {name} in float32, "
                            f"bfloat16 or float16, got {t.dtype}")
    if weight.shape != (x2.shape[-1],):
        raise ValueError(f"weight must be ({x2.shape[-1]},), got "
                         f"{tuple(weight.shape)}")
    if kernel is ROWBLOCK_KERNEL and weight.dtype != x2.dtype:
        raise ValueError(f"the row-block kernel takes a weight in x's dtype "
                         f"{x2.dtype}, got {weight.dtype}")
    if weight.device != x2.device:
        raise ValueError("x and weight must be on the same device")
    if not x2.is_cuda:
        raise ValueError(f"the rms_norm kernel takes CUDA tensors, got "
                         f"{x2.device}")
    x2 = x2.contiguous()
    weight = weight.contiguous()
    out = torch.empty_like(x2)
    N, D = x2.shape
    args = [kernels.ptr(x2), kernels.ptr(weight), kernels.ptr(out), N, D,
            float(eps), _DTYPES[x2.dtype]]
    if kernel is ROWBLOCK_KERNEL:
        kernel(*args, kernels.stream(x2.device))
    else:
        KERNEL(*args, _DTYPES[weight.dtype], kernels.stream(x2.device))
    return out


def rms_norm_backward(x2: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
                      eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Analytic VJP of ``_rms_vjp_bwd``.

    y_j = w_j x_j inv with inv = (mean(x^2) + eps)^-1/2:
      gx_i = inv * (g_i w_i - x_i inv^2 / D * sum_j g_j w_j x_j)
      gw_j = sum over rows of g_j x_j inv
    """
    xf, gf, wf = x2.float(), g.float(), weight.float()
    D = x2.shape[-1]
    inv = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    gw = (gf * xf * inv).sum(0).to(weight.dtype)
    gx_hat = gf * wf
    dot = (gx_hat * xf).sum(-1, keepdim=True)
    gx = inv * (gx_hat - xf * (inv * inv / D) * dot)
    return gx.to(x2.dtype), gw


@torch.library.custom_op("ptt::rms_norm_fwd", mutates_args=())
def rms_norm_fwd(x2: torch.Tensor, weight: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """The kernel (CUDA tensors) or its plain version (CPU tensors) as one
    operator, which a checkpoint policy can name."""
    return kernels.dispatch(x2, rms_norm_cuda, rms_norm_reference, x2,
                            weight, eps)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, weight, eps):
        ctx.save_for_backward(x2, weight)
        ctx.eps = eps
        kernels.on_cuda(x2, weight)  # another device or a DTensor raises
        return rms_norm_fwd(x2, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x2, weight = ctx.saved_tensors
        gx, gw = rms_norm_backward(x2, weight, g, ctx.eps)
        return gx, gw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis; x (..., D), weight (D,)."""
    shape = x.shape
    return _RMSNorm.apply(x.reshape(-1, shape[-1]), weight,
                          eps).reshape(shape)
