"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (the kernels build with nvcc at first use and have no CPU mode).
On a GPU machine, which need not have JAX (``--noconftest`` skips
``tests/conftest.py``, which imports it):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

``chip_smoke.py`` makes the same checks at the main path's full shapes;
these are small and quick.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from pytorch_operator_tpu_torch import kernels, train_llama
from pytorch_operator_tpu_torch.models import llama

fa = importlib.import_module("pytorch_operator_tpu_torch.ops.flash_attention")
rn = importlib.import_module("pytorch_operator_tpu_torch.ops.rms_norm")

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("N,D,dtype", [(256, 2048, torch.bfloat16),
                                       (21, 100, torch.bfloat16),
                                       (64, 512, torch.float32)])
def test_rms_norm_kernel_matches_plain(cuda, N, D, dtype):
    x = torch.randn(N, D, generator=cuda, device="cuda").to(dtype)
    w = (1 + 0.1 * torch.randn(D, generator=cuda, device="cuda")).to(dtype)
    before = kernels.KERNELS["rms_norm_fwd"].launches
    got = rn.rms_norm(x, w).float()
    torch.cuda.synchronize()
    assert kernels.KERNELS["rms_norm_fwd"].launches == before + 1
    ref = rn.rms_norm_reference(x, w).float()
    # the same f32 math, summed in another order: one ulp of the output
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
    assert bool(((got - ref).abs() <= ulp * ref.abs() + 1e-6).all())


@pytest.mark.parametrize("B,T,H,Hk,D,causal", [
    (2, 256, 4, 4, 128, True), (1, 200, 4, 2, 64, True),
    (2, 130, 2, 1, 128, False), (1, 1, 2, 2, 64, True)])
def test_flash_kernels_match_plain(cuda, B, T, H, Hk, D, causal):
    def r(h):
        return torch.randn(B, T, h, D, generator=cuda,
                           device="cuda").bfloat16()

    q, k, v, g = r(H), r(Hk), r(Hk), r(H)
    qk = [x.clone().requires_grad_(True) for x in (q, k, v)]
    counts = _launches()
    out = fa.flash_attention(*qk, causal=causal)
    out.backward(g)
    torch.cuda.synchronize()
    # bf16 at D 64/128: the Hopper kernels, never the WMMA ones
    assert {n: c - counts[n] for n, c in _launches().items()} == _want(
        torch.bfloat16, D, two=False)

    qf = [x.float().requires_grad_(True) for x in (q, k, v)]
    ref = fa._dense_path(*qf, D ** -0.5, causal)
    ref.backward(g.float())
    # bf16 out and bf16 p / ds before their products, dq summed by f32
    # atomics in a varying order: 1e-2 of the largest reference value
    for a, b in zip([out] + [x.grad for x in qk],
                    [ref] + [x.grad for x in qf]):
        err = (a.float() - b).abs().max().item()
        assert err <= 1e-2 * b.abs().max().item() + 1e-3, err


def test_tiny_llama_kernels_match_plain(cuda):
    cfg = llama.tiny(n_heads=2, n_kv_heads=1, dtype=torch.float32,
                     remat=False)
    model = llama.Llama(cfg, device="cuda", generator=cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 97))).cuda()
    with torch.no_grad():
        ref = model(toks)
    on = llama.Llama(dataclasses.replace(cfg, dtype=torch.bfloat16,
                                         use_flash=True, use_fused_norm=True),
                     device="cuda")
    on.load_state_dict(model.state_dict())
    off = llama.Llama(dataclasses.replace(on.cfg, use_flash=False,
                                          use_fused_norm=False),
                      device="cuda")
    off.load_state_dict(model.state_dict())
    with torch.no_grad():
        e_on = (on(toks) - ref).abs()
        e_off = (off(toks) - ref).abs()
    # against the f32 model, the kernels add no more than the bf16
    # rounding the plain bf16 model already has (see chip_smoke.py)
    assert e_on.max() <= 2 * e_off.max() + 2e-3
    assert e_on.mean() <= 2 * e_off.mean() + 2e-3


FLASH_KERNELS = ("flash_fwd_sm90", "flash_bwd_sm90", "flash_bwd_dq_sm90",
                 "flash_bwd_dkv_sm90", "flash_fwd", "flash_bwd",
                 "flash_bwd_dq", "flash_bwd_dkv")


def _launches():
    return {n: kernels.KERNELS[n].launches for n in FLASH_KERNELS}


def _hopper(kernel, dtype, D):
    """The stated route at head dim ``D`` (padded to the kernels' next):
    B1-B4 run Hopper at every dtype and D; no call runs a WMMA kernel."""
    assert kernel in ("fwd", "bwd", "dq", "dkv")
    assert dtype in (torch.bfloat16, torch.float16, torch.float32)
    return any(D <= d for d in (16, 32, 64, 128, 256))


def _want(dtype, D, two):
    """One forward and backward's launches by the route: the Hopper or
    the WMMA version of each kernel; the fused backward or B3 + B4."""
    want = dict.fromkeys(FLASH_KERNELS, 0)
    for kernel, name in (("fwd", "flash_fwd"), ("bwd", "flash_bwd"),
                         ("dq", "flash_bwd_dq"), ("dkv", "flash_bwd_dkv")):
        if {"fwd": True, "bwd": not two}.get(kernel, two):
            want[name + ("_sm90" if _hopper(kernel, dtype, D) else "")] = 1
    return want


def _flash_case(gen, B, T, H, Hk, D, causal, dtype, bh):
    def r(h):
        shape = (B * h, T, D) if bh else (B, T, h, D)
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v, g = r(H), r(Hk), r(Hk), r(H)
    g_lse = (torch.randn(B * H, 1, T, generator=gen, device="cuda")
             if bh else None)

    def grads(xs, ref):
        xs = [x.detach().requires_grad_(True) for x in xs]
        fwd = fa._flash_fwd_reference if ref else fa._Flash.apply
        out, lse = fwd(*xs, D ** -0.5, causal, bh)
        loss = (out.float() * g.float()).sum()
        if g_lse is not None:
            loss = loss + (lse * g_lse).sum()
        loss.backward()
        return [out] + [x.grad for x in xs]

    before = _launches()
    got = grads((q, k, v), ref=False)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in _launches().items()}
    want = grads([x.float() for x in (q, k, v)], ref=True)
    return got, want, launched


# bf16: p and ds rounded to bf16 before their products, bf16 outputs;
# f32 runs its products in TF32 (10-bit mantissa)
TOL = {torch.bfloat16: 1e-2, torch.float32: 5e-3}


@pytest.mark.parametrize("route", ["fused", "two_kernel"])
@pytest.mark.parametrize("dtype,D,B,T,H,Hk,causal,bh", [
    (torch.bfloat16, 16, 2, 200, 4, 2, True, False),
    (torch.bfloat16, 32, 1, 130, 4, 4, False, False),
    (torch.bfloat16, 128, 1, 300, 4, 1, True, True),
    (torch.float32, 16, 2, 200, 4, 2, True, False),
    (torch.float32, 64, 1, 257, 2, 2, False, False),
    (torch.float32, 128, 1, 300, 4, 2, True, True)])
def test_flash_routes_dtypes_and_head_dims(cuda, monkeypatch, route, dtype,
                                           D, B, T, H, Hk, causal, bh):
    """B1 with B2 (fused) or B3 + B4 (two-kernel, forced as the JAX tests
    force it) at every kernel dtype and head dim, against autograd
    through the f32 plain forward, with exact launch counts: the Hopper
    kernels at every dtype and D, none of the WMMA ones."""
    if route == "two_kernel":
        monkeypatch.setattr(fa, "_FUSED_DQ_BYTES", 0)
    got, want, launched = _flash_case(cuda, B, T, H, Hk, D, causal, dtype,
                                      bh)
    assert launched == _want(dtype, D, two=route == "two_kernel")
    assert got[1].dtype == dtype
    for a, b in zip(got, want):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= TOL[dtype] * b.abs().max().item() + 1e-3, err


TOL[torch.float16] = 1e-2


@pytest.mark.parametrize("route", ["fused", "two_kernel"])
@pytest.mark.parametrize("dtype,D", [
    (torch.float16, 64), (torch.float16, 128), (torch.float16, 256),
    (torch.float16, 80), (torch.bfloat16, 96), (torch.bfloat16, 48),
    (torch.bfloat16, 256), (torch.bfloat16, 200), (torch.float32, 96),
    (torch.float32, 256)])
def test_flash_fp16_and_padded_head_dims(cuda, monkeypatch, route, dtype,
                                         D):
    """fp16, D 256 and head dims between the kernels' ones zero-padded to
    the next, against autograd through the f32 plain forward at the true
    D, with exact launch counts by the route (GQA H4 / Hk2, ragged T):
    Hopper B1-B4 for bf16 and fp16 up to 256, and f32 on the Hopper TF32
    kernels (B2, B3 and B4 at D 256 on clusters of two CTAs)."""
    if route == "two_kernel":
        monkeypatch.setattr(fa, "_FUSED_DQ_BYTES", 0)
    got, want, launched = _flash_case(cuda, 2, 200, 4, 2, D, True, dtype,
                                      False)
    assert launched == _want(dtype, D, two=route == "two_kernel")
    for a, b in zip(got, want):
        assert a.shape == b.shape
        err = (a.float() - b.float()).abs().max().item()
        assert err <= TOL[dtype] * b.abs().max().item() + 1e-3, err


@pytest.mark.parametrize("route", ["fused", "two_kernel"])
@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 64),
                                     (torch.float16, 64)])
def test_flash_batch_heads_past_the_grid_y_limit(cuda, monkeypatch, route,
                                                 dtype, D):
    """B * H = 65,536 (one past a grid's y limit): every kernel runs it on
    its one-dimensional grid, the last heads as right as the first."""
    if route == "two_kernel":
        monkeypatch.setattr(fa, "_FUSED_DQ_BYTES", 0)
    got, want, launched = _flash_case(cuda, 4096, 65, 16, 8, D, True, dtype,
                                      False)
    assert launched == _want(dtype, D, two=route == "two_kernel")
    for a, b in zip(got, want):
        for part in (slice(0, 8), slice(-8, None)):
            x, y = a[part].float(), b[part].float()
            err = (x - y).abs().max().item()
            assert err <= TOL[dtype] * y.abs().max().item() + 1e-3, err


@pytest.mark.parametrize("D", [32, 128])
def test_sm90_dkv_forms_ds_from_f32_p(cuda, D):
    """The Hopper B4 forms dS from the f32 P, as the WMMA B4 does: against
    the f32 plain version its dk error is no larger than the WMMA B4's
    on the same inputs (bf16, T2048, GQA 16 / 4; at D 32 the walk's
    narrow slabs), beyond summation order."""
    args = _bwd_args(cuda, 1, 2048, 16, 4, D, torch.bfloat16)
    ref = fa._flash_bwd_dkv_reference(*(x.float() if torch.is_tensor(x)
                                        and x.dtype == torch.bfloat16
                                        else x for x in args))
    errs = {}
    for name, kernel in (("sm90", fa.BWD_DKV_SM90_KERNEL),
                         ("wmma", fa.BWD_DKV_KERNEL)):
        dk, _ = fa._flash_bwd_dkv_cuda(*args, kernel=kernel)
        errs[name] = (dk - ref[0]).abs().max().item()
    assert errs["sm90"] <= 1.5 * errs["wmma"], errs


def _bwd_args(gen, B, T, H, Hk, D, dtype, bh=False, causal=True):
    """Backward-kernel arguments from the forward kernel's lse and the
    delta of its out."""
    def r(h):
        shape = (B * h, T, D) if bh else (B, T, h, D)
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v, g = r(H), r(Hk), r(Hk), r(H)
    out, lse = fa._flash_fwd_cuda(q, k, v, D ** -0.5, causal, bh)
    delta = (g.float() * out.float()).sum(-1)
    if not bh:
        delta = delta.transpose(1, 2)
    return (q, k, v, g, lse.reshape(B * H, T),
            delta.reshape(B * H, T).contiguous(), D ** -0.5, causal, bh)


@pytest.mark.parametrize("bh", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 128),
                                     (torch.float32, 64),
                                     (torch.float32, 128),
                                     (torch.float32, 256),
                                     (torch.float16, 64),
                                     (torch.float16, 128),
                                     (torch.bfloat16, 256),
                                     (torch.float16, 256),
                                     (torch.bfloat16, 16),
                                     (torch.bfloat16, 32),
                                     (torch.float16, 16),
                                     (torch.float16, 32),
                                     (torch.float32, 16),
                                     (torch.float32, 32)])
def test_two_kernel_dq_is_bitwise_stable(cuda, dtype, D, causal, bh):
    """B3 sums dq without atomics: two runs give the same bits (the
    Hopper B3 at each of its instantiations, at f32 D 256 on clusters of
    two CTAs, at D 16/32 on narrow slabs, f32 on 64- or 128-byte rows).
    B4 is the fused kernel's walk without dq: the Hopper B4 (bf16, fp16,
    and f32 on the TF32 walk, at D 256 on clusters of two CTAs, at D
    16/32 on 128-row q tiles) gives the Hopper B2's dk / dv bit for bit
    at each instantiation (GQA H16 / Hk4, ragged T)."""
    args = _bwd_args(cuda, 1, 1000, 16, 4, D, dtype, bh, causal)
    before = _launches()
    first = fa._flash_bwd_dq_cuda(*args)
    second = fa._flash_bwd_dq_cuda(*args)
    torch.cuda.synchronize()
    assert _launches()["flash_bwd_dq_sm90"] == before["flash_bwd_dq_sm90"] + 2
    assert first.dtype == dtype
    assert torch.equal(first, second)
    dkv = fa._flash_bwd_dkv_cuda(*args)
    fused = fa._flash_bwd_cuda(*args)
    torch.cuda.synchronize()
    for a, b in zip(dkv, fused[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bh", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [129, 1000])
@pytest.mark.parametrize("dtype,D", [(torch.float16, 64),
                                     (torch.float16, 128),
                                     (torch.bfloat16, 256),
                                     (torch.float16, 256),
                                     (torch.float32, 64),
                                     (torch.float32, 128),
                                     (torch.float32, 256),
                                     (torch.bfloat16, 16),
                                     (torch.bfloat16, 32),
                                     (torch.float16, 16),
                                     (torch.float16, 32)])
def test_sm90_dq_matches_plain(cuda, dtype, D, T, causal, bh):
    """The Hopper B3 at each instantiation beyond bf16 D 64/128 (fp16,
    D 256, f32 as TF32, at D 256 on clusters of two CTAs, and 16-bit D
    16/32 on narrow slabs) against its plain version on the same inputs,
    lse and delta: GQA H16 / Hk4, ragged T, both layouts, causal and
    not, one launch of it."""
    assert _hopper("dq", dtype, D)
    args = _bwd_args(cuda, 1, T, 16, 4, D, dtype, bh, causal)
    before = _launches()
    got = fa._flash_bwd_dq_cuda(*args)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in _launches().items()}
    assert launched == {n: int(n == "flash_bwd_dq_sm90")
                        for n in FLASH_KERNELS}
    ref = fa._flash_bwd_dq_reference(*args)
    assert got.dtype == ref.dtype == dtype
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * ref.float().abs().max().item() + 1e-3, err


@pytest.mark.parametrize("bh", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [1, 129, 1000])
@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 16),
                                     (torch.bfloat16, 32),
                                     (torch.float16, 16),
                                     (torch.float16, 32)])
def test_sm90_narrow_fwd_matches_plain(cuda, dtype, D, T, causal, bh):
    """The Hopper B1 on narrow slabs (16-bit D 16/32) against its plain
    version on the same inputs: out within the bound of the other
    forward checks (p rounded to the input type before p v), lse to f32
    rounding; GQA H16 / Hk4, T = 1, ragged T and T1000, both layouts,
    causal and not, one launch of it and none of the WMMA forward."""
    assert _hopper("fwd", dtype, D)

    def r(h):
        shape = (h, T, D) if bh else (1, T, h, D)
        return torch.randn(*shape, generator=cuda, device="cuda").to(dtype)

    q, k, v = r(16), r(4), r(4)
    before = _launches()
    out, lse = fa._flash_fwd_cuda(q, k, v, D ** -0.5, causal, bh)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in _launches().items()}
    assert launched == {n: int(n == "flash_fwd_sm90") for n in FLASH_KERNELS}
    ref_out, ref_lse = fa._flash_fwd_reference(q.float(), k.float(),
                                               v.float(), D ** -0.5, causal,
                                               bh)
    assert out.dtype == dtype
    err = (out.float() - ref_out).abs().max().item()
    assert err <= TOL[dtype] * ref_out.abs().max().item() + 1e-3, err
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.parametrize("bh", [False, True])
@pytest.mark.parametrize("T", [1, 129, 1000, 2048])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_sm90_kernels_match_plain(cuda, D, causal, T, bh):
    """flash_fwd_sm90 and flash_bwd_sm90 (bf16, GQA H16 / Hk4) against
    autograd through the f32 plain forward, at T = 1, ragged T (not a
    multiple of the 64- and 128-row tiles) and T2048, in both layouts,
    with exactly one launch of each and none of the WMMA kernels (at D
    16/32 both on narrow slabs)."""
    got, want, launched = _flash_case(cuda, 1, T, 16, 4, D, causal,
                                      torch.bfloat16, bh)
    assert launched == _want(torch.bfloat16, D, two=False)
    for a, b in zip(got, want):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= TOL[torch.bfloat16] * b.abs().max().item() + 1e-3, err


@pytest.mark.parametrize("bh", [False, True])
@pytest.mark.parametrize("T", [1, 129, 1000, 2048])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_sm90_two_kernel_match_plain(cuda, monkeypatch, D, causal, T, bh):
    """flash_bwd_dq_sm90 and flash_bwd_dkv_sm90 (bf16, GQA H16 / Hk4, the
    two-kernel route forced) against autograd through the f32 plain
    forward, at T = 1, ragged T and T2048, in both layouts, with exactly
    one launch of each and none of the WMMA kernels (at D 16/32 all on
    narrow slabs)."""
    monkeypatch.setattr(fa, "_FUSED_DQ_BYTES", 0)
    got, want, launched = _flash_case(cuda, 1, T, 16, 4, D, causal,
                                      torch.bfloat16, bh)
    assert launched == _want(torch.bfloat16, D, two=True)
    for a, b in zip(got, want):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= TOL[torch.bfloat16] * b.abs().max().item() + 1e-3, err


@pytest.mark.parametrize("route", ["fused", "two_kernel"])
@pytest.mark.parametrize("bh", [False, True])
@pytest.mark.parametrize("T", [1, 129, 1000])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,D", [(torch.float16, 64),
                                     (torch.float16, 128),
                                     (torch.bfloat16, 256),
                                     (torch.float16, 256),
                                     (torch.float16, 16),
                                     (torch.float16, 32)])
def test_sm90_fp16_and_d256_match_plain(cuda, monkeypatch, dtype, D, causal,
                                        T, bh, route):
    """The Hopper instantiations beyond bf16 at D 16-128 (GQA H16 / Hk4):
    B1 with B2, or B1 with B3 + B4, against
    autograd through the f32 plain forward at T = 1, ragged T (not a
    multiple of the 64- and 128-row tiles) and T1000, in both layouts,
    with exact launch counts."""
    if route == "two_kernel":
        monkeypatch.setattr(fa, "_FUSED_DQ_BYTES", 0)
    got, want, launched = _flash_case(cuda, 1, T, 16, 4, D, causal, dtype,
                                      bh)
    assert launched == _want(dtype, D, two=route == "two_kernel")
    for a, b in zip(got, want):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= TOL[dtype] * b.abs().max().item() + 1e-3, err


@pytest.mark.parametrize("route", ["fused", "two_kernel"])
@pytest.mark.parametrize("bh", [False, True])
@pytest.mark.parametrize("T", [2, 129, 1000])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_sm90_f32_match_plain(cuda, monkeypatch, D, causal, T, bh, route):
    """The Hopper TF32 instantiations (GQA H16 / Hk4): B1 with B2, or B1
    with B3 + B4, at D 64/128/256 (B2, B3 and B4 at D 256 on clusters of
    two CTAs), against autograd through the f32 plain
    forward at T = 2 (below every tile), ragged T and T1000, in both
    layouts, with exact launch counts.
    Not T = 1: there the plain grads are exactly 0 (one key), and every
    TF32 kernel, the WMMA ones too, forms dP from dO rounded to TF32
    against delta from the f32 dO, which leaves grads of about 1e-3 where
    the bound's absolute term is 1e-3."""
    if route == "two_kernel":
        monkeypatch.setattr(fa, "_FUSED_DQ_BYTES", 0)
    got, want, launched = _flash_case(cuda, 1, T, 16, 4, D, causal,
                                      torch.float32, bh)
    assert launched == _want(torch.float32, D, two=route == "two_kernel")
    assert launched["flash_fwd_sm90"] == 1
    for a, b in zip(got, want):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= TOL[torch.float32] * b.abs().max().item() + 1e-3, err


@pytest.mark.parametrize("kernel", ["bwd", "dkv"])
@pytest.mark.parametrize("bh", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [2, 129, 1000])
@pytest.mark.parametrize("D", [16, 32])
def test_sm90_f32_narrow_walk_matches_plain(cuda, D, T, causal, bh, kernel):
    """The Hopper TF32 walk at f32 D 16/32 (128-row q tiles): B2 (dq, dk
    and dv partials) or B4 (dk and dv partials) against its plain version
    on the same inputs, lse and delta, within the f32 bound (TF32
    products): GQA H16 / Hk4, T = 2, a ragged T (one 128-row q tile and a
    row) and T1000, both layouts, causal and not, one launch of it and
    none of any other flash kernel.  Not T = 1, for the reason
    test_sm90_f32_match_plain gives."""
    assert _hopper(kernel, torch.float32, D)
    args = _bwd_args(cuda, 1, T, 16, 4, D, torch.float32, bh, causal)
    run, plain, name = {
        "bwd": (fa._flash_bwd_cuda, fa._flash_bwd_reference,
                "flash_bwd_sm90"),
        "dkv": (fa._flash_bwd_dkv_cuda, fa._flash_bwd_dkv_reference,
                "flash_bwd_dkv_sm90")}[kernel]
    before = _launches()
    got = run(*args)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in _launches().items()}
    assert launched == {n: int(n == name) for n in FLASH_KERNELS}
    ref = plain(*args)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        err = (a - b).abs().max().item()
        assert err <= TOL[torch.float32] * b.abs().max().item() + 1e-3, err


@pytest.mark.parametrize("kernel", ["fwd", "dq"])
@pytest.mark.parametrize("bh", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [2, 129, 1000])
@pytest.mark.parametrize("D", [16, 32])
def test_sm90_f32_narrow_fwd_dq_matches_plain(cuda, D, T, causal, bh,
                                              kernel):
    """The Hopper TF32 forward (B1) and dq kernel (B3) at f32 D 16/32
    (64-key tiles on one slab of 64- or 128-byte rows) against their
    plain versions on the same inputs (B3: lse and delta from the
    forward), within the f32 bound (TF32 products; the forward's lse to
    1e-2, f32 math on TF32 products): GQA H16 / Hk4, T = 2, a ragged T
    (one 128-row q tile and a row) and T1000, both layouts, causal and
    not, one launch of it and none of any other flash kernel.  Not T = 1,
    for the reason test_sm90_f32_match_plain gives."""
    assert _hopper(kernel, torch.float32, D)
    args = _bwd_args(cuda, 1, T, 16, 4, D, torch.float32, bh, causal)
    name = {"fwd": "flash_fwd_sm90", "dq": "flash_bwd_dq_sm90"}[kernel]
    before = _launches()
    if kernel == "fwd":
        got = fa._flash_fwd_cuda(*args[:3], D ** -0.5, causal, bh)
    else:
        got = (fa._flash_bwd_dq_cuda(*args),)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in _launches().items()}
    assert launched == {n: int(n == name) for n in FLASH_KERNELS}
    if kernel == "fwd":
        ref = fa._flash_fwd_reference(*args[:3], D ** -0.5, causal, bh)
        assert (got[1] - ref[1]).abs().max().item() <= 1e-2
        got, ref = got[:1], ref[:1]
    else:
        ref = (fa._flash_bwd_dq_reference(*args),)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == torch.float32
        err = (a - b).abs().max().item()
        assert err <= TOL[torch.float32] * b.abs().max().item() + 1e-3, err


def test_train_llama_tiny_on_cuda(cuda, capsys):
    """The trainer's default tiny model (f32, head dim 16) through the
    kernels: two steps, the Hopper TF32 forward and walk (the fused
    backward), no WMMA flash kernel."""
    before = kernels.launch_counts()
    rc = train_llama.main(["--model", "tiny", "--steps", "2",
                           "--batch-size", "2", "--seq-len", "64",
                           "--log-interval", "1"])
    out = capsys.readouterr().out
    assert rc == 0 and "training complete" in out
    assert "flash=True fused_norm=True" in out
    after = kernels.launch_counts()
    assert all(after[n] > before[n] for n in ("flash_fwd_sm90",
                                              "flash_bwd_sm90",
                                              "rms_norm_fwd"))
    assert all(after[n] == before[n] for n in ("flash_fwd", "flash_bwd",
                                               "flash_bwd_dq",
                                               "flash_bwd_dkv"))


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_ring_loopback_through_the_kernels(cuda, layout):
    """The ring of 4 virtual ranks on the card (bf16, GQA 8 / 4, T1024):
    every chunk pair through B1 and the fused B2 (256-row chunks, 128-row
    halves), exactly the pairs the ring computes, against autograd
    through the f32 dense path over the whole sequence."""
    ra = importlib.import_module(
        "pytorch_operator_tpu_torch.parallel.ring_attention")
    B, T, H, Hk, D, n = 1, 1024, 8, 4, 64, 4

    def r(h):
        return torch.randn(B, T, h, D, generator=cuda,
                           device="cuda").bfloat16()

    q, k, v, g = r(H), r(Hk), r(Hk), r(H)
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = _launches()
    out = ra.ring_attention_loopback(*xs, n, causal=True, layout=layout)
    out.backward(g)
    torch.cuda.synchronize()
    pairs = ra.ring_launches(n, True, "zigzag_pre" if layout == "zigzag"
                             else layout)
    want = {name: 0 for name in FLASH_KERNELS}
    want.update(flash_fwd_sm90=pairs, flash_bwd_sm90=pairs)
    assert {name: c - before[name] for name, c in _launches().items()} \
        == want
    ref = [x.float().requires_grad_(True) for x in (q, k, v)]
    dense = fa._dense_path(*ref, D ** -0.5, True)
    dense.backward(g.float())
    for a, b in zip([out] + [x.grad for x in xs],
                    [dense] + [x.grad for x in ref]):
        err = (a.float() - b).abs().max().item()
        assert err <= TOL[torch.bfloat16] * b.abs().max().item() + 1e-3, err
