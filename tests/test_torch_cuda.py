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

from pytorch_operator_tpu_torch import kernels
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
    counts = {n: kernels.KERNELS[n].launches for n in ("flash_fwd",
                                                       "flash_bwd")}
    out = fa.flash_attention(*qk, causal=causal)
    out.backward(g)
    torch.cuda.synchronize()
    assert {n: kernels.KERNELS[n].launches - c
            for n, c in counts.items()} == {"flash_fwd": 1, "flash_bwd": 1}

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
