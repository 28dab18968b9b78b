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
        hopper=True, two=False)

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


FLASH_KERNELS = ("flash_fwd_sm90", "flash_bwd_sm90", "flash_fwd",
                 "flash_bwd", "flash_bwd_dq", "flash_bwd_dkv")


def _launches():
    return {n: kernels.KERNELS[n].launches for n in FLASH_KERNELS}


def _want(hopper, two):
    """One forward and backward's launches: the Hopper forward and fused
    backward or the WMMA ones; the fused backward or B3 + B4."""
    return {"flash_fwd_sm90": int(hopper), "flash_fwd": int(not hopper),
            "flash_bwd_sm90": int(hopper and not two),
            "flash_bwd": int(not hopper and not two),
            "flash_bwd_dq": int(two), "flash_bwd_dkv": int(two)}


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
@pytest.mark.parametrize("dtype,D,B,T,H,Hk,causal,bh,hopper", [
    (torch.bfloat16, 16, 2, 200, 4, 2, True, False, False),
    (torch.bfloat16, 32, 1, 130, 4, 4, False, False, False),
    (torch.bfloat16, 128, 1, 300, 4, 1, True, True, True),
    (torch.float32, 16, 2, 200, 4, 2, True, False, False),
    (torch.float32, 64, 1, 257, 2, 2, False, False, False),
    (torch.float32, 128, 1, 300, 4, 2, True, True, False)])
def test_flash_routes_dtypes_and_head_dims(cuda, monkeypatch, route, dtype,
                                           D, B, T, H, Hk, causal, bh,
                                           hopper):
    """B1 with B2 (fused) or B3 + B4 (two-kernel, forced as the JAX tests
    force it) at every kernel dtype and head dim, against autograd
    through the f32 plain forward, with exact launch counts: the Hopper
    forward and fused backward for bf16 at D 128 only, the WMMA ones for
    f32 and D 16/32."""
    if route == "two_kernel":
        monkeypatch.setattr(fa, "_FUSED_DQ_BYTES", 0)
    got, want, launched = _flash_case(cuda, B, T, H, Hk, D, causal, dtype,
                                      bh)
    assert launched == _want(hopper, two=route == "two_kernel")
    assert got[1].dtype == dtype
    for a, b in zip(got, want):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= TOL[dtype] * b.abs().max().item() + 1e-3, err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_two_kernel_dq_is_bitwise_stable(cuda, dtype):
    """B3 sums dq without atomics: two runs give the same bits."""
    B, T, H, D = 1, 700, 4, 64
    q, k, v, g = (torch.randn(B, T, H, D, generator=cuda,
                              device="cuda").to(dtype) for _ in range(4))
    out, lse = fa._flash_fwd_cuda(q, k, v, D ** -0.5, True, False)
    lse2 = lse.reshape(B * H, T)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).reshape(
        B * H, T).contiguous()
    args = (q, k, v, g, lse2, delta, D ** -0.5, True, False)
    first = fa._flash_bwd_dq_cuda(*args)
    second = fa._flash_bwd_dq_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    # the dk / dv kernel is the WMMA fused kernel's walk without dq
    dkv = fa._flash_bwd_dkv_cuda(*args)
    fused = fa._flash_bwd_cuda(*args, kernel=fa.BWD_KERNEL)
    torch.cuda.synchronize()
    for a, b in zip(dkv, fused[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bh", [False, True])
@pytest.mark.parametrize("T", [1, 129, 1000, 2048])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
def test_sm90_kernels_match_plain(cuda, D, causal, T, bh):
    """flash_fwd_sm90 and flash_bwd_sm90 (bf16, GQA H16 / Hk4) against
    autograd through the f32 plain forward, at T = 1, ragged T (not a
    multiple of the 64- and 128-row tiles) and T2048, in both layouts,
    with exactly one launch of each and none of the WMMA kernels."""
    got, want, launched = _flash_case(cuda, 1, T, 16, 4, D, causal,
                                      torch.bfloat16, bh)
    assert launched == _want(hopper=True, two=False)
    for a, b in zip(got, want):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= TOL[torch.bfloat16] * b.abs().max().item() + 1e-3, err


def test_train_llama_tiny_on_cuda(cuda, capsys):
    """The trainer's default tiny model (f32, head dim 16) through the
    kernels: two steps."""
    before = kernels.launch_counts()
    rc = train_llama.main(["--model", "tiny", "--steps", "2",
                           "--batch-size", "2", "--seq-len", "64",
                           "--log-interval", "1"])
    out = capsys.readouterr().out
    assert rc == 0 and "training complete" in out
    assert "flash=True fused_norm=True" in out
    after = kernels.launch_counts()
    assert all(after[n] > before[n] for n in ("flash_fwd", "flash_bwd",
                                              "rms_norm_fwd"))
