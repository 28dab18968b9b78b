"""Parity of the port's flash attention with the JAX package at the
dtypes and head dims the Hopper kernels take beyond bf16 at D 64/128:
fp16 at D 64 and 128, bf16 and fp16 at D 256, f32 at D 64, 128 and 256
(the TF32 kernels; at D 256 the fused, dq and dk / dv kernels on
clusters of two CTAs), and bf16 at D 32 and fp16 at D 16 (the fused and
dk / dv kernels' narrow-slab walk; the forward and dq kernel there are
WMMA).

On the CPU the port runs its kernels' plain versions (the forward, the
fused backward, and the dq and dk / dv kernels on the two-kernel route),
so these tests pin the function that the card's kernels are held to
(``chip_smoke.py`` phase 2) to the JAX reference at the same shapes.
The same seeded numpy inputs, rounded to the working dtype, go through
the JAX ``flash_attention`` (Pallas kernels in interpret mode, as
tests/test_ops.py runs them) and through the port, both in that dtype.

Tolerance: max|err| <= 1e-2 * max|ref| + 1e-3 for out, dq, dk and dv,
the bound the card's bf16 / fp16 flash tests hold the kernels to
(tests/test_torch_cuda.py ``TOL``): the two packages round the scores,
p and the outputs to the working dtype at different places (the port's
plain forward rounds q k^T to the working dtype, JAX keeps it in f32:
bf16 at D 256 comes to 0.95e-2 * max|ref|, fp16 to 0.1e-2).

The f32 Hopper kernels multiply in TF32, and ``wgmma`` reads its f32
operands from shared memory by dropping their low 13 mantissa bits.
``test_tf32_truncation_fits_the_f32_bounds`` runs the port's f32 plain
pieces with q, k, v, dO and p so truncated and holds the result to the
JAX f32 reference within the card's f32 bounds (``chip_smoke.py`` phase
2): out max|err| <= 2e-2 and relative Frobenius error <= 1e-2, grads
max|err| <= 1e-2 * max|ref| and relative <= 1e-2, lse within 1e-2 of the
plain version's.  ``test_split_d_dq_fits_the_f32_bounds`` replays the
f32 dq kernel at D 256, whose two CTAs each hold half of D and exchange
their partial scores, and holds its dq to the same bounds.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_operator_tpu.ops import flash_attention as jax_flash
from pytorch_operator_tpu.ops.flash_attention import _auto_block
from pytorch_operator_tpu_torch.ops import flash_attention

jax_fa = importlib.import_module("pytorch_operator_tpu.ops.flash_attention")
fa = importlib.import_module("pytorch_operator_tpu_torch.ops.flash_attention")

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "fp16": (torch.float16, jnp.float16),
          "f32": (torch.float32, jnp.float32)}
REL, ABS = 1e-2, 1e-3

# (dtype, D): the Hopper instantiations this parity covers
INSTANCES = [("fp16", 64), ("fp16", 128), ("bf16", 256), ("fp16", 256),
             ("f32", 64), ("f32", 128), ("f32", 256), ("bf16", 32),
             ("fp16", 16)]
# (B, T, H, Hk, causal): one ragged T, causal and not, GQA
SHAPES = [(1, 128, 2, 2, False), (1, 200, 4, 2, True),
          (1, 384, 2, 1, True)]


def inputs(seed, B, T, H, Hk, D, dtype):
    """q, k, v and the output cotangent g from numpy, rounded to
    ``dtype``: float32 numpy arrays holding values of that dtype."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, T, h, D)).astype(np.float32)
              for h in (H, Hk, Hk, H)]
    return [torch.tensor(a).to(dtype).float().numpy() for a in arrays]


def jax_run(q, k, v, g, causal, jdt):
    """JAX out and grads of sum(out * g), pinned to the Pallas kernels by
    explicit blocks (tests/test_ops.py flash_pallas)."""
    b = _auto_block(q.shape[1], q.shape[-1])

    def f(q, k, v):
        return jax_flash(q, k, v, causal=causal, block_q=b, block_k=b)

    qkv = [jnp.asarray(x, dtype=jdt) for x in (q, k, v)]
    gj = jnp.asarray(g, dtype=jdt)
    out = f(*qkv)
    grads = jax.grad(
        lambda *a: jnp.sum(f(*a).astype(jnp.float32)
                           * gj.astype(jnp.float32)),
        argnums=(0, 1, 2))(*qkv)
    assert out.dtype == jdt and all(x.dtype == jdt for x in grads)
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def port_run(q, k, v, g, causal, tdt):
    ts = [torch.tensor(x).to(tdt).requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*ts, causal=causal)
    (out.float() * torch.tensor(g).to(tdt).float()).sum().backward()
    assert out.dtype == tdt and all(x.grad.dtype == tdt for x in ts)
    return [x.detach().float().numpy() for x in (out, *(t.grad for t in ts))]


def assert_close(got, want):
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        err = float(np.abs(a - b).max())
        assert err <= REL * float(np.abs(b).max()) + ABS, (name, err)


@pytest.mark.parametrize("B,T,H,Hk,causal", SHAPES)
@pytest.mark.parametrize("dtype,D", INSTANCES)
def test_fused_route_matches_jax(dtype, D, B, T, H, Hk, causal):
    """The forward and the fused backward (T * D * 4 <= 4 MiB: both
    packages take it)."""
    tdt, jdt = DTYPES[dtype]
    assert fa._use_fused_bwd(T, D)
    q, k, v, g = inputs(D + T, B, T, H, Hk, D, tdt)
    assert_close(port_run(q, k, v, g, causal, tdt),
                 jax_run(q, k, v, g, causal, jdt))


@pytest.mark.parametrize("B,T,H,Hk,causal", SHAPES)
@pytest.mark.parametrize("dtype,D", INSTANCES)
def test_two_kernel_route_matches_jax(monkeypatch, dtype, D, B, T, H, Hk,
                                      causal):
    """The forward, then the dq and dk / dv kernels' plain versions, both
    packages forced onto the two-kernel route as tests/test_ops.py forces
    the JAX one."""
    monkeypatch.setattr(jax_fa, "_FUSED_DQ_VMEM_BYTES", 0)
    monkeypatch.setattr(fa, "_FUSED_DQ_BYTES", 0)
    ran = []
    for name in ("_flash_bwd_dq_reference", "_flash_bwd_dkv_reference"):
        fn = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, fn=fn, name=name: (
            ran.append(name), fn(*a))[1])
    tdt, jdt = DTYPES[dtype]
    q, k, v, g = inputs(D + T + 1, B, T, H, Hk, D, tdt)
    got = port_run(q, k, v, g, causal, tdt)
    assert ran == ["_flash_bwd_dq_reference", "_flash_bwd_dkv_reference"]
    assert_close(got, jax_run(q, k, v, g, causal, jdt))


def tf32_trunc(x):
    """x (f32) with the low 13 mantissa bits of each value zeroed: the
    TF32 value wgmma reads from an f32 operand in shared memory."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def port_tf32_truncated(q, k, v, g, causal):
    """The port's f32 plain forward and backward pieces (``_flash_fwd_
    reference``, ``_bwd_probs``, ``_reduce_kv_partials``) on (B, T, H, D)
    numpy inputs, with q, k, v, dO and p truncated to TF32 where the
    Hopper kernels' wgmma reads them: out = p v and the backward's
    products on truncated operands, lse and ds in f32 as the kernels form
    them.  Returns out, dq, dk, dv and lse as numpy."""
    B, T, H, D = q.shape
    group = H // k.shape[2]
    scale = D ** -0.5
    q, k, v, g = (tf32_trunc(torch.tensor(x)) for x in (q, k, v, g))
    _, lse = fa._flash_fwd_reference(q, k, v, scale, causal, False)
    lse = lse.reshape(B * H, T)
    zeros = torch.zeros(B * H, T)
    _, _, _, p, _ = fa._bwd_probs(q, k, v, g, lse, zeros, scale, causal,
                                  False)
    v4 = fa._heads_first(v, False).repeat_interleave(group, dim=1)
    out = fa._from_heads_first(tf32_trunc(p) @ v4, False)
    delta = (g * out).sum(-1).transpose(1, 2).reshape(B * H, T)
    q4, k4, g4, p, ds = fa._bwd_probs(q, k, v, g, lse, delta, scale,
                                      causal, False)
    dq = fa._from_heads_first(ds @ k4, False)
    dk, dv = (fa._reduce_kv_partials(
        fa._from_heads_first(x, False).contiguous(), group, torch.float32,
        False) for x in (ds.transpose(-1, -2) @ q4,
                         tf32_trunc(p).transpose(-1, -2) @ g4))
    return [x.numpy() for x in (out, dq, dk, dv, lse)]


@pytest.mark.parametrize("B,T,H,Hk,causal", SHAPES)
@pytest.mark.parametrize("D", [64, 128, 256])
def test_tf32_truncation_fits_the_f32_bounds(D, B, T, H, Hk, causal):
    q, k, v, g = inputs(D + T + 2, B, T, H, Hk, D, torch.float32)
    *got, lse = port_tf32_truncated(q, k, v, g, causal)
    want = jax_run(q, k, v, g, causal, jnp.float32)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        err = float(np.abs(a - b).max())
        rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        bound = 2e-2 if name == "out" else 1e-2 * float(np.abs(b).max())
        assert err <= bound and rel <= 1e-2, (name, err, rel)
    _, plain_lse = fa._flash_fwd_reference(
        *(torch.tensor(x) for x in (q, k, v)), D ** -0.5, causal, False)
    assert float(np.abs(lse - plain_lse.reshape(lse.shape).numpy()).max()) \
        <= 1e-2


def port_split_d_dq(q, k, v, g, causal):
    """The f32 dq kernel at D 256 (``csrc/flash_bwd_dq_sm90.cu``, a
    cluster of two CTAs) replayed in plain f32 torch on (B, T, H, D)
    numpy inputs: CTA r holds columns [128 r, 128 r + 128) of q, k, v,
    dO and dq, forms the partial S = Q_r K_r^T and dP = dO_r V_r^T over
    them on TF32-truncated operands, and adds the peer's partials to its
    own; P and dS come from those sums in f32, and dq is the two halves'
    dS K_r side by side, dS truncated to TF32 as its product reads it.
    lse and delta are what the route gives the kernel (the forward and
    rowsum(dO * out)).  Returns dq as numpy."""
    B, T, H, D = q.shape
    group = H // k.shape[2]
    scale = D ** -0.5
    q, k, v, g = (tf32_trunc(torch.tensor(x)) for x in (q, k, v, g))
    _, lse = fa._flash_fwd_reference(q, k, v, scale, causal, False)
    q4, g4 = (fa._heads_first(x, False) for x in (q, g))
    k4, v4 = (fa._heads_first(x, False).repeat_interleave(group, dim=1)
              for x in (k, v))
    halves = (slice(0, D // 2), slice(D // 2, D))
    s_part = [q4[..., c] @ k4[..., c].transpose(-1, -2) for c in halves]
    dp_part = [g4[..., c] @ v4[..., c].transpose(-1, -2) for c in halves]
    # CTA r: its own partial plus the peer's; the two orders give the
    # same bits, so both CTAs hold the same P and dS
    st = [s_part[r] + s_part[1 - r] for r in (0, 1)]
    dp = [dp_part[r] + dp_part[1 - r] for r in (0, 1)]
    assert torch.equal(st[0], st[1]) and torch.equal(dp[0], dp[1])
    p = torch.exp(st[0] * scale - lse.reshape(B, H, T, 1))
    if causal:
        p = p.masked_fill(~fa._causal_mask(T, p.device), 0.0)
    out = tf32_trunc(p) @ v4
    delta = (g4 * out).sum(-1, keepdim=True)
    ds = tf32_trunc(p * (dp[0] - delta) * scale)
    dq = torch.cat([ds @ k4[..., c] for c in halves], dim=-1)
    return fa._from_heads_first(dq, False).numpy()


@pytest.mark.parametrize("B,T,H,Hk,causal", SHAPES)
def test_split_d_dq_fits_the_f32_bounds(B, T, H, Hk, causal):
    q, k, v, g = inputs(T + 3, B, T, H, Hk, 256, torch.float32)
    got = port_split_d_dq(q, k, v, g, causal)
    want = jax_run(q, k, v, g, causal, jnp.float32)[1]
    err = float(np.abs(got - want).max())
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert err <= 1e-2 * float(np.abs(want).max()) and rel <= 1e-2, \
        (err, rel)
