"""Flash attention with CUDA forward and backward kernels.

Port of ``pytorch_operator_tpu/ops/flash_attention.py``.  One
``torch.autograd.Function`` carries both public entries:

  flash_attention(q, k, v, causal)       (B, T, H, D), GQA, any T >= 1
  flash_with_lse(q, k, v, scale, causal) (BH, T, D) -> (out, lse), both
                                         outputs take gradients

For CUDA tensors the forward launches ``csrc/flash_fwd_sm90.cu`` or
``csrc/flash_fwd.cu`` (counterparts of the TPU kernel ``_fwd_kernel``).
The backward takes one of the JAX module's two routes, by the same rule
(``_use_fused_bwd``):

  fused       ``csrc/flash_bwd_sm90.cu`` or ``csrc/flash_bwd.cu``
              (``_bwd_fused_kernel``): one pass, dq summed with f32
              atomics
  two-kernel  ``csrc/flash_bwd_dq_sm90.cu`` or ``csrc/flash_bwd_dq.cu``
              (``_bwd_dq_kernel``), then ``csrc/flash_bwd_dkv_sm90.cu``
              or ``csrc/flash_bwd_dkv.cu`` (``_bwd_dkv_kernel``): no
              atomics, dq bit-identical from run to run

Each of the four kernels has two versions, picked by a fixed rule per
kernel, dtype and (kernel) head dim (``SM90_RULE``, ``_sm90``), not a
fallback.  The Hopper versions are built on ``wgmma``, TMA and a
warp-specialized mbarrier ring (f32 as TF32, with the transposed copies
of V, Q, dO and K that TF32 ``wgmma`` needs written in shared memory;
the backward kernels at f32 D 256 on clusters of two CTAs that split D
and exchange their partial scores through shared memory; at D 16 and 32
every kernel on one slab of 32-, 64- or 128-byte swizzled rows a tile).
All four run them at every dtype (bf16, fp16, f32) and every kernel
head dim (16, 32, 64, 128, 256), so no call reaches a WMMA version
(``flash_fwd.cu``, ``flash_bwd.cu``, ``flash_bwd_dq.cu``,
``flash_bwd_dkv.cu``): those stay as the yardsticks ``chip_smoke.py``
names by ``kernel=``.  Every model's attention but the tiny ones' is
bf16 at D 64 or 128; the tiny Llama and MoE have D 16, and the trainer's
default model is the tiny Llama in f32.  A build or launch failure
raises.

On the TPU the rule was a VMEM budget: the fused kernel keeps the whole
(T, D) f32 dq resident, so past ``_FUSED_DQ_BYTES`` (T > 8192 at
D = 128) the JAX backward runs the two kernels.  Nothing on the H100
binds at that size (dq lives in device memory); the rule is kept so that
the same shapes reach the same kernels as in the reference, and
``PERF.md`` records B2 against B3 + B4 at T8192 and T16384 for a later
re-derivation.  As in the JAX module, two pieces of the backward stay
outside the kernels, in plain torch:

  delta = rowsum(dO * O) - g_lse   (the lse cotangent only shifts delta:
                                    ds = p * (dp - delta) picks up
                                    + p * g_lse, since d lse_i / d s_ij
                                    = p_ij; both routes)
  _reduce_kv_partials              per-q-head dk / dv summed over each
                                   GQA group

CPU tensors take the plain versions beside each kernel
(``_flash_fwd_reference``, ``_flash_bwd_reference``,
``_flash_bwd_dq_reference``, ``_flash_bwd_dkv_reference``), and
``_dense_reference`` / ``_dense_path`` are as in the JAX module.  The
forward is the operator ``torch.ops.ptt.flash_fwd`` so that a
checkpoint policy can name it (``models/llama.py``'s ``save_attn``).

The rest of the TPU-tuned dispatch is not carried over: ``_auto_block``
and the short-T dense route (``_DENSE_FWD_MAX_T`` / ``_route_small_t``).
On CUDA every call, forward-only or not, goes through the kernels, which
tile T by 32, 64 or 128 and mask the tail themselves, and any B * H (the
grid is one dimension of tiles times B * H).  The kernels take float32,
bfloat16 or float16 at D in {16, 32, 64, 128, 256}.  A head dim between
two of these runs at the next one: the wrappers pad q, k, v (and dO)
with zero columns, which change neither the scores nor the true columns
of out, dq, dk and dv, pass the scale of the true D and slice the
outputs back.  Anything else on a CUDA tensor raises: D above 256 too,
which no model of either package has and at which the JAX kernel's block
picker stops (``_auto_block``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pytorch_operator_tpu_torch import kernels

NEG_INF = -1e30
# the C entries' dtype codes, and the head dims they are built for
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TAIL = [_I] * 6 + [_F, _I, _I, _P]  # B H Hk T D bh, scale causal dtype s
FWD_KERNEL = kernels.CudaKernel("flash_fwd", [_P] * 5 + _TAIL)
BWD_KERNEL = kernels.CudaKernel("flash_bwd", [_P] * 9 + _TAIL)
FWD_SM90_KERNEL = kernels.CudaKernel("flash_fwd_sm90", [_P] * 5 + _TAIL)
BWD_SM90_KERNEL = kernels.CudaKernel("flash_bwd_sm90", [_P] * 9 + _TAIL)
BWD_DQ_KERNEL = kernels.CudaKernel("flash_bwd_dq", [_P] * 7 + _TAIL)
BWD_DKV_KERNEL = kernels.CudaKernel("flash_bwd_dkv", [_P] * 8 + _TAIL)
BWD_DQ_SM90_KERNEL = kernels.CudaKernel("flash_bwd_dq_sm90", [_P] * 7 + _TAIL)
BWD_DKV_SM90_KERNEL = kernels.CudaKernel("flash_bwd_dkv_sm90",
                                         [_P] * 8 + _TAIL)

# The JAX module's _FUSED_DQ_VMEM_BYTES: the fused backward while its
# (T, D) f32 dq takes at most this many bytes, else the two kernels.
_FUSED_DQ_BYTES = 4 * 1024 * 1024


# Per flash kernel and dtype, the kernel head dims its Hopper version
# takes: every one, for all four kernels at every dtype.
_HOPPER_DIMS = dict.fromkeys(KERNEL_DTYPES, KERNEL_HEAD_DIMS)
SM90_RULE = dict.fromkeys(("fwd", "bwd", "dq", "dkv"), _HOPPER_DIMS)


def _sm90(kernel: str, dtype: torch.dtype, D: int) -> bool:
    """True where flash kernel ``kernel`` ("fwd", "bwd", "dq" or "dkv")
    runs its Hopper version for ``dtype`` at (kernel) head dim ``D``, by
    SM90_RULE: at every dtype and kernel head dim.  Elsewhere its WMMA
    version (``flash_fwd``, ``flash_bwd``, ``flash_bwd_dq``,
    ``flash_bwd_dkv``) would run; no call reaches one."""
    return D in SM90_RULE[kernel].get(dtype, ())


def _use_fused_bwd(T: int, D: int) -> bool:
    """The JAX dispatch rule (``_use_fused_bwd`` there, whose tile clamp
    never binds at the port's 64-row tiles)."""
    return T * D * 4 <= _FUSED_DQ_BYTES


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _dense_reference(q, k, v, scale, causal):
    """Dense attention over (BH, T, D), as the JAX module's."""
    s = torch.einsum("bqd,bkd->bqk", q, k).float() * scale
    if causal:
        s = torch.where(_causal_mask(q.shape[1], q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(v.dtype), v)


def _dense_path(q, k, v, scale, causal):
    """Dense attention on (B, T, H, D) tensors with the GQA repeat."""
    B, T, H, D = q.shape
    Hk = k.shape[2]
    if Hk != H:
        k = k.repeat_interleave(H // Hk, dim=2)
        v = v.repeat_interleave(H // Hk, dim=2)

    def bh(x):
        return x.transpose(1, 2).reshape(B * H, T, D)

    out = _dense_reference(bh(q), bh(k), bh(v), scale, causal)
    return out.reshape(B, H, T, D).transpose(1, 2)


def _heads_first(x, bh):
    """(B, T, Hx, D) or (B*Hx, T, D) -> a (B, Hx, T, D) view."""
    return x.unsqueeze(0) if bh else x.transpose(1, 2)


def _from_heads_first(x, bh):
    return x.squeeze(0) if bh else x.transpose(1, 2)


def _causal_mask(T, device):
    return torch.ones(T, T, dtype=torch.bool, device=device).tril()


def _flash_fwd_reference(q, k, v, scale, causal, bh):
    """Plain version of the forward kernel: (out, lse (B*H, 1, T) f32)."""
    q4, k4, v4 = (_heads_first(x, bh) for x in (q, k, v))
    B, H, T, _ = q4.shape
    group = H // k4.shape[1]
    k4 = k4.repeat_interleave(group, dim=1)
    v4 = v4.repeat_interleave(group, dim=1)
    # the scores in f32, as the kernels' products accumulate them
    s = (q4.float() @ k4.float().transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(T, s.device), NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = (p.to(v4.dtype) @ v4).contiguous()
    return (_from_heads_first(out, bh).contiguous(),
            lse.reshape(B * H, 1, T))


def _bwd_probs(q, k, v, g, lse, delta, scale, causal, bh):
    """The backward's recomputed p and ds, (B, H, T, T) f32, with q, k
    (repeated per q head) and g as (B, H, T, D) f32.  lse and delta are
    (B*H, T) f32."""
    q4, k4, v4, g4 = (_heads_first(x, bh).float() for x in (q, k, v, g))
    B, H, T, _ = q4.shape
    group = H // k4.shape[1]
    k4 = k4.repeat_interleave(group, dim=1)
    v4 = v4.repeat_interleave(group, dim=1)
    p = torch.exp((q4 @ k4.transpose(-1, -2)) * scale
                  - lse.reshape(B, H, T, 1))
    if causal:
        p = p.masked_fill(~_causal_mask(T, p.device), 0.0)
    dp = g4 @ v4.transpose(-1, -2)
    ds = p * (dp - delta.reshape(B, H, T, 1)) * scale
    return q4, k4, g4, p, ds


def _flash_bwd_reference(q, k, v, g, lse, delta, scale, causal, bh):
    """Plain version of the fused backward kernel, in f32: dq and the
    per-q-head dk / dv partials, all f32 in q's layout."""
    q4, k4, g4, p, ds = _bwd_probs(q, k, v, g, lse, delta, scale, causal, bh)
    out = (ds @ k4, ds.transpose(-1, -2) @ q4, p.transpose(-1, -2) @ g4)
    return tuple(_from_heads_first(x, bh).contiguous() for x in out)


def _flash_bwd_dq_reference(q, k, v, g, lse, delta, scale, causal, bh):
    """Plain version of the dq kernel: dq = ds K in f32, in q's dtype and
    layout."""
    _, k4, _, _, ds = _bwd_probs(q, k, v, g, lse, delta, scale, causal, bh)
    return _from_heads_first(ds @ k4, bh).to(q.dtype).contiguous()


def _flash_bwd_dkv_reference(q, k, v, g, lse, delta, scale, causal, bh):
    """Plain version of the dk / dv kernel: the per-q-head partials
    ds^T Q and p^T dO, f32 in q's layout."""
    q4, _, g4, p, ds = _bwd_probs(q, k, v, g, lse, delta, scale, causal, bh)
    out = (ds.transpose(-1, -2) @ q4, p.transpose(-1, -2) @ g4)
    return tuple(_from_heads_first(x, bh).contiguous() for x in out)


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------


def _dims(q, k, bh):
    """(B, H, Hk, T, D) of a call in either layout."""
    if bh:
        BH, T, D = q.shape
        return 1, BH, k.shape[0], T, D
    B, T, H, D = q.shape
    return B, H, k.shape[2], T, D


def _kernel_dim(D: int) -> int:
    """The head dim the kernels run a call of head dim ``D`` at: the
    least of KERNEL_HEAD_DIMS that holds it; a larger D raises."""
    for d in KERNEL_HEAD_DIMS:
        if D <= d:
            return d
    raise ValueError(f"flash attention kernels take head dims up to "
                     f"{KERNEL_HEAD_DIMS[-1]}, got {D}")


def _checked_inputs(q, k, bh, tensors):
    """(B, H, Hk, T, D) of a kernel call and ``tensors`` zero-padded to the
    kernels' head dim (``_kernel_dim``), after checking that they are
    what the kernels take."""
    B, H, Hk, T, D = _dims(q, k, bh)
    dev, dtype = q.device, q.dtype
    for t in tensors:
        if t.device != dev:
            raise ValueError("flash attention inputs must share one device")
        if t.dtype != dtype or dtype not in KERNEL_DTYPES:
            raise TypeError(f"flash attention kernels take float32, "
                            f"bfloat16 or float16 inputs of one dtype, got "
                            f"{[x.dtype for x in tensors]}")
    Dk = _kernel_dim(D)
    if dev.type != "cuda":
        raise ValueError(f"flash attention kernels take CUDA tensors, got "
                         f"{dev}")
    if Dk != D:
        tensors = tuple(F.pad(t, (0, Dk - D)) for t in tensors)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash attention kernels take 16-byte aligned "
                         "tensors")
    return (B, H, Hk, T, D), tensors


def _launch(kernel, tensors, q, k, bh, scale, causal):
    B, H, Hk, T, D = _dims(q, k, bh)
    kernel(*(kernels.ptr(t) for t in tensors), B, H, Hk, T, D, int(bh),
           float(scale), int(causal), KERNEL_DTYPES[q.dtype],
           kernels.stream(q.device))


def _unpad(D, *outs):
    """The outputs of a call padded to a larger head dim, sliced back to
    the true ``D`` (contiguous)."""
    if outs[0].shape[-1] == D:
        return outs
    return tuple(x[..., :D].contiguous() for x in outs)


def _flash_fwd_cuda(q, k, v, scale, causal, bh, kernel=None):
    """The forward kernel ``_sm90`` picks, or ``kernel`` where the caller
    names one (``chip_smoke.py`` times the WMMA kernel beside the Hopper
    one on the same inputs)."""
    (B, H, _, T, D), (q, k, v) = _checked_inputs(q, k, bh, (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty(B * H, 1, T, dtype=torch.float32, device=q.device)
    if kernel is None:
        kernel = FWD_SM90_KERNEL if _sm90("fwd", q.dtype, q.shape[-1]) \
            else FWD_KERNEL
    _launch(kernel, (q, k, v, out, lse), q, k, bh, scale, causal)
    return _unpad(D, out)[0], lse


def _flash_bwd_cuda(q, k, v, g, lse, delta, scale, causal, bh, kernel=None):
    """The fused backward kernel ``_sm90`` picks, or ``kernel``."""
    (*_, D), (q, k, v, g) = _checked_inputs(q, k, bh, (q, k, v, g))
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dkp = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dvp = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if kernel is None:
        kernel = BWD_SM90_KERNEL if _sm90("bwd", q.dtype, q.shape[-1]) \
            else BWD_KERNEL
    _launch(kernel, (q, k, v, g, lse, delta, dq, dkp, dvp), q, k, bh, scale,
            causal)
    return _unpad(D, dq, dkp, dvp)


def _flash_bwd_dq_cuda(q, k, v, g, lse, delta, scale, causal, bh,
                       kernel=None):
    """The dq kernel ``_sm90`` picks, or ``kernel``."""
    (*_, D), (q, k, v, g) = _checked_inputs(q, k, bh, (q, k, v, g))
    dq = torch.empty_like(q)
    if kernel is None:
        kernel = BWD_DQ_SM90_KERNEL if _sm90("dq", q.dtype, q.shape[-1]) \
            else BWD_DQ_KERNEL
    _launch(kernel, (q, k, v, g, lse, delta, dq), q, k, bh, scale, causal)
    return _unpad(D, dq)[0]


def _flash_bwd_dkv_cuda(q, k, v, g, lse, delta, scale, causal, bh,
                        kernel=None):
    """The dk / dv kernel ``_sm90`` picks, or ``kernel``."""
    (*_, D), (q, k, v, g) = _checked_inputs(q, k, bh, (q, k, v, g))
    dkp = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dvp = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if kernel is None:
        kernel = BWD_DKV_SM90_KERNEL if _sm90("dkv", q.dtype, q.shape[-1]) \
            else BWD_DKV_KERNEL
    _launch(kernel, (q, k, v, g, lse, delta, dkp, dvp), q, k, bh, scale,
            causal)
    return _unpad(D, dkp, dvp)


@torch.library.custom_op("ptt::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, causal: bool, bh: bool
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel (CUDA tensors) or its plain version (CPU
    tensors) as one operator, which a checkpoint policy can name."""
    return kernels.dispatch(q, _flash_fwd_cuda, _flash_fwd_reference, q, k,
                            v, scale, causal, bh)


def _reduce_kv_partials(partials, group, out_dtype, bh):
    """Per-q-head dk / dv partials (f32, q's layout) -> per-kv-head grads.

    Consecutive q heads of a group share a kv head, so the reduction is a
    contiguous reshape-sum, as in the JAX module."""
    if group > 1:
        if bh:
            BH, T, D = partials.shape
            partials = partials.view(BH // group, group, T, D).sum(1)
        else:
            B, T, H, D = partials.shape
            partials = partials.view(B, T, H // group, group, D).sum(3)
    return partials.to(out_dtype)


def flash_bwd(q, k, v, g, lse, delta, scale, causal, bh):
    """dq and the per-q-head dk / dv partials (f32, q's layout) of one
    call given its lse and delta ((B*H, T) f32), by the route
    ``_use_fused_bwd`` picks: the fused kernel (dq f32) or the dq then
    dk / dv kernels (dq in q's dtype); CPU tensors take the plain
    versions."""
    args = (q, k, v, g, lse, delta, scale, causal, bh)
    T, D = _dims(q, k, bh)[3:]
    if _use_fused_bwd(T, D):
        return kernels.dispatch(q, _flash_bwd_cuda, _flash_bwd_reference,
                                *args)
    dq = kernels.dispatch(q, _flash_bwd_dq_cuda, _flash_bwd_dq_reference,
                          *args)
    return (dq, *kernels.dispatch(q, _flash_bwd_dkv_cuda,
                                  _flash_bwd_dkv_reference, *args))


class _Flash(torch.autograd.Function):
    """(out, lse) of flash attention; ``bh`` selects the (BH, T, D) layout
    (else (B, T, H, D))."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, bh):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        kernels.on_cuda(q, k, v)  # another device or a DTensor raises
        out, lse = flash_fwd(q, k, v, scale, causal, bh)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal, ctx.bh = scale, causal, bh
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        bh = ctx.bh
        B, H, Hk, T, D = _dims(q, k, bh)
        g = torch.zeros_like(out) if g is None else g.contiguous()
        # delta = rowsum(dO * O) - g_lse, (B*H, T) f32
        delta = (g.float() * out.float()).sum(-1)
        if not bh:
            delta = delta.transpose(1, 2).reshape(B * H, T)
        if g_lse is not None:
            delta = delta - g_lse.reshape(B * H, T).float()
        dq, dkp, dvp = flash_bwd(q, k, v, g, lse.reshape(B * H, T),
                                 delta.contiguous(), ctx.scale, ctx.causal,
                                 bh)
        group = H // Hk
        return (dq.to(q.dtype), _reduce_kv_partials(dkp, group, k.dtype, bh),
                _reduce_kv_partials(dvp, group, v.dtype, bh), None, None,
                None)


def flash_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float, causal: bool
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable (out, lse) over (BH, T, D) inputs; k / v may carry
    BH / group rows (GQA, row b reads kv row b // group).  lse is
    (BH, 1, T) f32."""
    if q.dim() != 3 or k.shape != v.shape or q.shape[0] % k.shape[0]:
        raise ValueError(f"q (BH, T, D) and k / v (BH/group, T, D) "
                         f"expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return _Flash.apply(q, k, v, scale, causal, True)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention over (B, T, H, D) queries, any T >= 1.

    GQA-native: k / v may carry H_kv heads with H % H_kv == 0; q head h
    reads kv head h // (H / H_kv), and dk / dv come back at H_kv heads."""
    H, Hk = q.shape[2], k.shape[2]
    if v.shape[2] != Hk or H % Hk:
        raise ValueError(
            f"kv heads must divide q heads: q has {H}, k/v have "
            f"{k.shape[2]}/{v.shape[2]}")
    return _Flash.apply(q, k, v, q.shape[-1] ** -0.5, causal, False)[0]
