#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py            # every phase, needs one CUDA card

Phases, in order; any failure exits non-zero and prints no ``ok`` line:

1. card     nvidia-smi's name and power limit, the device name, and the
            nvcc build of every kernel from pytorch_operator_tpu_torch/
            csrc (timed, with ptxas' register and spill counts);
2. kernels  each CUDA kernel against its plain PyTorch version on the
            card, at the main path's shapes (plus GQA, a ragged T,
            non-causal, D=64 and the (BH, T, D) flash_with_lse layout);
3. timing   each kernel, its plain version and the one PyTorch library
            call that computes the same function (a yardstick only: the
            port never calls it): device time per call from
            torch.profiler, and CUDA events around repeated calls;
4. main     the flagship Llama (d2048 L16 h16 ffn5632, ~888M params) in
            bf16 through make_train_step with AdamW(3e-4, wd 0.1) at
            B2 x T2048 on one fixed seeded batch: loss finite and
            falling, exact kernel launch counts per step, step time,
            tokens/s, MFU and peak memory, then one profiled step's
            device time by kernel;
5. model    the tiny model in bf16 with the kernels on against the same
            weights with them off: logits and the loss after one step.

The last lines are the card (nvidia-smi), one ``{"kernels": [...]}``
JSON line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): the bounds and MFU are stated
# against these, beside the card's own power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

MAIN = dict(B=2, T=2048, H=16, D=128)
STEPS = 6


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stdout}")
    return out.stdout.strip().splitlines()[0]


def device_events(prof) -> list:
    """The profiler's kernels and copies.  A record_function range (the
    optimizer's, say) also shows on the device and would count its
    kernels twice, so ranges are left out."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def time_ms(fn, warmup: int = 3, iters: int = 10, reps: int = 5) -> dict:
    """Time per call of ``fn`` on the card, after ``warmup`` calls.

    ``event_ms``: median over ``reps`` of the mean of ``iters`` calls
    between two CUDA events; it includes any gap in which the device
    waits for the host to launch.  ``device_ms``: the device time of the
    kernels and copies of ``iters`` calls under torch.profiler, per call,
    without those gaps (None if the profiler saw no device time).  ``ms``
    is ``device_ms`` where there is one: a 10 us kernel launched from
    Python is otherwise timed by its launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    device = sum(e.device_time_total for e in device_events(prof)) / 1e3
    event_ms = statistics.median(times)
    device_ms = device / iters if device > 0 else None
    return {"ms": device_ms or event_ms, "event_ms": event_ms,
            "device_ms": device_ms}


def timed(kernel, plain, library, plain_kw=None) -> dict:
    """``ms``, ``plain_ms`` and ``library_ms`` (None without a library
    call) of one kernel, with each one's CUDA-event time beside it."""
    t = {"kernel": time_ms(kernel), "plain": time_ms(plain, **(plain_kw or {})),
         "library": library and time_ms(library)}
    return {"ms": t["kernel"]["ms"], "plain_ms": t["plain"]["ms"],
            "library_ms": t["library"] and t["library"]["ms"],
            "event_ms": {k: v and v["event_ms"] for k, v in t.items()}}


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def causal_pairs(T: int, causal: bool) -> int:
    return T * (T + 1) // 2 if causal else T * T


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------


def check_rms_norm(torch, gen) -> dict:
    from pytorch_operator_tpu_torch.ops.rms_norm import (
        rms_norm_cuda,
        rms_norm_reference,
    )

    worst = {}
    # main path (N = B*T, D = dim) bf16, a ragged scalar-load shape, f32
    for label, (N, D, dtype) in {
            "main": (MAIN["B"] * MAIN["T"], 2048, torch.bfloat16),
            "ragged": (21, 100, torch.bfloat16),
            "f32": (4096, 2048, torch.float32)}.items():
        x = torch.randn(N, D, generator=gen, device="cuda").to(dtype)
        w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(dtype)
        got = rms_norm_cuda(x, w, 1e-5).float()
        ref = rms_norm_reference(x, w, 1e-5).float()
        torch.cuda.synchronize()
        err = (got - ref).abs()
        # both round the same f32 math (summed in another order) to the
        # output dtype: at most one ulp of it apart
        ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
        ok = bool((err <= ulp * ref.abs() + 1e-6).all())
        worst[label] = float(err.max())
        emit({"check": "rms_norm", "case": label, "shape": [N, D],
              "dtype": str(dtype), "max_abs_err": worst[label],
              "tolerance": "|err| <= 1 ulp of the output dtype * |ref|: "
                           "same f32 math, sum of squares in another "
                           "order", "ok": ok})
        require(ok, f"rms_norm {label} disagrees with its plain version")
    return {"max_abs_err": worst["main"]}


FLASH_CASES = {
    # name: (B, T, H, Hk, D, causal, bh_layout)
    "main": (2, 2048, 16, 16, 128, True, False),
    "gqa_h16_kv4": (2, 2048, 16, 4, 128, True, False),
    "ragged_t1000": (2, 1000, 16, 16, 128, True, False),
    "non_causal": (2, 2048, 16, 16, 128, False, False),
    "d64_gqa_ragged": (2, 333, 8, 2, 64, True, False),
    "with_lse_bh": (1, 1000, 32, 16, 128, True, True),
}


def _flash_inputs(torch, gen, B, T, H, Hk, D, bh):
    def r(h):
        shape = (B * h, T, D) if bh else (B, T, h, D)
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    return r(H), r(Hk), r(Hk), r(H)


def _rel_errs(got, ref) -> tuple[float, float]:
    got, ref = got.detach().float(), ref.detach().float()
    d = got - ref
    return (float(d.abs().max()),
            float(d.norm() / ref.norm().clamp_min(1e-30)))


def check_flash(torch, gen) -> tuple[dict, dict]:
    from pytorch_operator_tpu_torch.ops.flash_attention import (
        _Flash,
        _flash_fwd_reference,
    )

    fwd_worst = bwd_worst = None
    for name, (B, T, H, Hk, D, causal, bh) in FLASH_CASES.items():
        q, k, v, g = _flash_inputs(torch, gen, B, T, H, Hk, D, bh)
        g_lse = (torch.randn(B * H, 1, T, generator=gen, device="cuda")
                 if bh else None)
        scale = D ** -0.5
        qk = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out, lse = _Flash.apply(*qk, scale, causal, bh)
        loss = (out.float() * g.float()).sum()
        if g_lse is not None:
            loss = loss + (lse * g_lse).sum()
        loss.backward()

        qf = [x.float().requires_grad_(True) for x in (q, k, v)]
        ref_out, ref_lse = _flash_fwd_reference(*qf, scale, causal, bh)
        ref_loss = (ref_out * g.float()).sum()
        if g_lse is not None:
            ref_loss = ref_loss + (ref_lse * g_lse).sum()
        ref_loss.backward()
        torch.cuda.synchronize()

        o_err, o_rel = _rel_errs(out, ref_out)
        l_err, _ = _rel_errs(lse, ref_lse)
        # out is bf16 and p is rounded to bf16 before p v: a few bf16
        # ulps of |out| <~ 4; lse is f32 math on the same products
        fwd_ok = o_err <= 2e-2 and o_rel <= 1e-2 and l_err <= 1e-3
        emit({"check": "flash_fwd", "case": name, "shape": [B, T, H, Hk, D],
              "causal": causal, "max_abs_err": o_err, "rel_fro_err": o_rel,
              "lse_max_abs_err": l_err,
              "tolerance": "out: max|err| <= 2e-2 and rel <= 1e-2 (bf16 "
                           "output, bf16 p before p v); lse: 1e-3 (f32)",
              "ok": fwd_ok})
        require(fwd_ok, f"flash_fwd {name} disagrees with its plain version")

        errs = {}
        bwd_ok = True
        for gname, a, b in zip(("dq", "dk", "dv"), qk, qf):
            err, rel = _rel_errs(a.grad, b.grad)
            scale_ref = float(b.grad.abs().max())
            errs[gname] = {"max_abs_err": err, "max_abs_ref": scale_ref,
                           "rel_fro_err": rel}
            bwd_ok &= err <= 1e-2 * scale_ref and rel <= 1e-2
        emit({"check": "flash_bwd", "case": name,
              "shape": [B, T, H, Hk, D], "causal": causal, **errs,
              "tolerance": "max|err| <= 1e-2 * max|ref| and rel <= 1e-2, "
                           "against autograd through the plain version "
                           "in f32: p and ds are rounded to bf16 before "
                           "their products, dk/dv/dq are cast to bf16, and "
                           "dq's f32 atomics sum in an order that changes "
                           "from run to run",
              "ok": bwd_ok})
        require(bwd_ok, f"flash_bwd {name} disagrees with its plain version")
        if name == "main":
            fwd_worst = {"max_abs_err": o_err}
            bwd_worst = {"max_abs_err": max(e["max_abs_err"]
                                            for e in errs.values())}
        del qk, qf, out, lse, ref_out, ref_lse
        torch.cuda.empty_cache()
    return fwd_worst, bwd_worst


# --------------------------------------------------------------------------
# phase 3: timing
# --------------------------------------------------------------------------


def time_kernels(torch, gen) -> dict:
    import torch.nn.functional as F

    from pytorch_operator_tpu_torch.ops.flash_attention import (
        _flash_bwd_cuda,
        _flash_bwd_reference,
        _flash_fwd_cuda,
        _flash_fwd_reference,
    )
    from pytorch_operator_tpu_torch.ops.rms_norm import (
        rms_norm_cuda,
        rms_norm_reference,
    )

    res = {}
    N, D = MAIN["B"] * MAIN["T"], 2048
    x = torch.randn(N, D, generator=gen, device="cuda").bfloat16()
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).bfloat16()
    b_ms, b_by = bound(2 * N * D * 2 + D * 2, 4 * N * D)
    # x is 16.8 MB: cycle four copies (67 MB) so that no launch finds
    # its input in the 50 MB L2
    xs = itertools.cycle([x.clone() for _ in range(4)])
    res["rms_norm"] = {
        **timed(lambda: rms_norm_cuda(next(xs), w, 1e-5),
                lambda: rms_norm_reference(next(xs), w, 1e-5),
                lambda: F.rms_norm(next(xs), (D,), w, 1e-5)),
        "library": "torch.nn.functional.rms_norm",
        "bound_ms": b_ms, "bound_by": b_by, "shape": [N, D]}

    B, T, H, Dh = MAIN["B"], MAIN["T"], MAIN["H"], MAIN["D"]
    q, k, v, g = _flash_inputs(torch, gen, B, T, H, H, Dh, False)
    scale = Dh ** -0.5
    pairs = B * H * causal_pairs(T, True)
    io = B * T * H * Dh * 2  # one (B, T, H, D) bf16 tensor
    b_ms, b_by = bound(4 * io + B * H * T * 4, 4 * Dh * pairs)
    qt, kt, vt, gt = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    slow = dict(warmup=1, iters=3, reps=3)  # the plain versions
    res["flash_fwd"] = {
        **timed(lambda: _flash_fwd_cuda(q, k, v, scale, True, False),
                lambda: _flash_fwd_reference(q, k, v, scale, True, False),
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True),
                slow),
        "library": "torch.nn.functional.scaled_dot_product_attention",
        "bound_ms": b_ms, "bound_by": b_by, "shape": [B, T, H, H, Dh]}

    out, lse = _flash_fwd_cuda(q, k, v, scale, True, False)
    lse2 = lse.reshape(B * H, T)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).reshape(
        B * H, T).contiguous()
    b_ms, b_by = bound(7 * io + 2 * B * H * T * 4, 10 * Dh * pairs)

    def lib_bwd():
        # the backward alone of PyTorch's flash attention (aten's private
        # op, whose signature may move between releases: null if so)
        try:
            lib = torch.ops.aten._scaled_dot_product_flash_attention(
                qt, kt, vt, 0.0, True, False, scale=scale)
        except (RuntimeError, TypeError, AttributeError) as e:
            emit({"timing": "flash_bwd", "library_error": repr(e)})
            return None
        lib_out, lib_lse, cq, ck, mq, mk, rng, unused = lib[:8]
        return lambda: (torch.ops.aten.
                        _scaled_dot_product_flash_attention_backward(
                            gt, qt, kt, vt, lib_out, lib_lse, cq, ck, mq, mk,
                            0.0, True, rng, unused, scale=scale))

    def sdpa_fwd_bwd():
        a = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
        F.scaled_dot_product_attention(*a, is_causal=True).backward(gt)

    def port_fwd_bwd():
        from pytorch_operator_tpu_torch.ops import flash_attention

        a = [x.detach().requires_grad_(True) for x in (q, k, v)]
        flash_attention(*a, causal=True).backward(g)

    res["flash_bwd"] = {
        **timed(lambda: _flash_bwd_cuda(q, k, v, g, lse2, delta, scale, True,
                                        False),
                lambda: _flash_bwd_reference(q, k, v, g, lse2, delta, scale,
                                             True, False),
                lib_bwd(), slow),
        "library": "aten._scaled_dot_product_flash_attention_backward",
        "bound_ms": b_ms, "bound_by": b_by, "shape": [B, T, H, H, Dh],
        "port_fwd_bwd_ms": time_ms(port_fwd_bwd)["ms"],
        "sdpa_fwd_bwd_ms": time_ms(sdpa_fwd_bwd)["ms"]}
    for name, r in res.items():
        emit({"timing": name, **r})
    return res


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------


def run_main_path(torch) -> dict:
    import numpy as np

    from pytorch_operator_tpu_torch import kernels
    from pytorch_operator_tpu_torch.models import llama
    from pytorch_operator_tpu_torch.parallel.train import (
        TrainState,
        adamw,
        make_train_step,
    )

    cfg = llama.flagship()
    B, T = MAIN["B"], MAIN["T"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = llama.Llama(cfg, device="cuda", generator=gen)
    optimizer = adamw(model, 3e-4, weight_decay=0.1)
    state = TrainState(model, optimizer)
    step_fn = make_train_step(cfg, model, optimizer)
    batch = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T + 1))).cuda()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, times = [], [], []
    kernels.reset_launches()
    for _ in range(STEPS):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    counts = kernels.launch_counts()

    L = cfg.n_layers
    expect = {"rms_norm_fwd": 2 * L + 1, "flash_fwd": L, "flash_bwd": L}
    per_step = {k: counts[k] / STEPS for k in expect}
    n = llama.n_params(cfg)
    step_s = statistics.median(times[1:])
    tokens = B * T
    flops = 6.0 * n * tokens + 12.0 * L * B * T * T * cfg.dim * 0.5
    res = {"model": f"d{cfg.dim} L{L} h{cfg.n_heads} kv{cfg.n_kv_heads} "
                    f"ffn{cfg.ffn_dim} vocab{cfg.vocab_size}",
           "n_params": n, "batch": B, "seq": T, "steps": STEPS,
           "losses": losses, "grad_norms": norms,
           "step_ms_all": [t * 1e3 for t in times],
           "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
           "model_tflops_per_step": flops / 1e12,
           "mfu": flops / step_s / PEAK_BF16_FLOPS,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": counts, "launches_per_step": per_step}
    emit({"main_path": res})
    require(all(math.isfinite(x) for x in losses + norms),
            f"non-finite loss or grad norm: {losses} {norms}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    require(per_step == {k: float(v) for k, v in expect.items()},
            f"launches per step {per_step} != {expect}")
    res["profile"] = profile_step(torch, lambda: step_fn(state, batch))
    return res


KERNEL_CLASSES = (("rms_norm", ("rms_norm_kernel",)),
                  ("flash_fwd", ("flash_fwd_kernel",)),
                  ("flash_bwd", ("flash_bwd_kernel",)),
                  ("matmul", ("gemm", "nvjet", "cutlass", "xmma")))


def profile_step(torch, step) -> dict:
    """Device time of one more step, by kernel class and by kernel."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_class: dict[str, float] = {}
    top = []
    for e in device_events(prof):
        ms = e.device_time_total / 1e3
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k in e.key for k in keys)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + ms
        top.append((ms, e.count, e.key[:80]))
    top.sort(reverse=True)
    out = {"wall_ms_profiled": wall_ms, "device_ms": sum(by_class.values()),
           "device_ms_by_class": by_class,
           "top": [{"ms": ms, "count": n, "kernel": k}
                   for ms, n, k in top[:20]]}
    emit({"profile": out})
    return out


# --------------------------------------------------------------------------
# phase 5: the whole model with kernels on against kernels off
# --------------------------------------------------------------------------


def check_tiny_model(torch) -> dict:
    import numpy as np

    from pytorch_operator_tpu_torch.models import llama
    from pytorch_operator_tpu_torch.parallel.train import (
        TrainState,
        adamw,
        make_train_step,
    )

    # head_dim 64 (dim 128 / 2 heads) so the kernels take it; GQA 2:1
    cfg_k = llama.tiny(n_heads=2, n_kv_heads=1, dtype=torch.bfloat16,
                       remat=False, use_flash=True, use_fused_norm=True)
    cfg_p = dataclasses.replace(cfg_k, use_flash=False, use_fused_norm=False)
    cfg_f32 = dataclasses.replace(cfg_p, dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(1)
    mk = llama.Llama(cfg_k, device="cuda", generator=gen)
    mp = llama.Llama(cfg_p, device="cuda")
    mp.load_state_dict(mk.state_dict())
    # the same bf16 weights in f32, plain path: the exact answer that
    # both bf16 models round away from
    m32 = llama.Llama(cfg_f32, device="cuda")
    m32.load_state_dict(mk.state_dict())
    batch = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg_k.vocab_size, (2, 201))).cuda()
    with torch.no_grad():
        truth = m32(batch[:, :-1])
        ek = (mk(batch[:, :-1]) - truth).abs()
        ep = (mp(batch[:, :-1]) - truth).abs()
    del m32
    losses = {}
    for name, m, cfg in (("kernels", mk, cfg_k), ("plain", mp, cfg_p)):
        opt = adamw(m, 1e-3, weight_decay=0.1)
        step = make_train_step(cfg, m, opt)
        state = TrainState(m, opt)
        state, _ = step(state, batch)
        _, metrics = step(state, batch)
        losses[name] = float(metrics["loss"])
    dl = abs(losses["kernels"] - losses["plain"])
    # Both bf16 models round the same math at other places (the flash
    # kernel's output comes from unnormalised bf16 p, the dense path's
    # from normalised p; the head rounds every logit to bf16, an ulp of
    # 2^-7..2^-5 at |logit| 1..4), so they differ from each other by
    # about one ulp per logit.  The check is that the kernels add no
    # error of their own: against the f32 answer, the kernel model's
    # error is at most twice the plain bf16 model's (plus 1/4 ulp at 1),
    # at the max and on average; the loss after one AdamW step within
    # 1e-2 of the plain model's.
    mk_max, mk_mean = float(ek.max()), float(ek.mean())
    mp_max, mp_mean = float(ep.max()), float(ep.mean())
    ok = (mk_max <= 2 * mp_max + 2e-3 and mk_mean <= 2 * mp_mean + 2e-3
          and dl <= 1e-2)
    res = {"logits_vs_f32": {"kernels": {"max": mk_max, "mean": mk_mean},
                             "plain_bf16": {"max": mp_max,
                                            "mean": mp_mean}},
           "loss_after_step": losses, "loss_abs_err": dl,
           "tolerance": "logits: kernel model's max and mean error against "
                        "the f32 model <= 2 x the plain bf16 model's + 2e-3; "
                        "loss after one step within 1e-2 of the plain "
                        "model's (bf16)",
           "ok": ok}
    emit({"tiny_model": res})
    require(ok, "tiny model with kernels disagrees with the plain model")
    return res


# --------------------------------------------------------------------------


KERNEL_INFO = {
    "rms_norm_fwd": ("rms_norm", "pytorch_operator_tpu_torch/csrc/rms_norm.cu",
                     "pytorch_operator_tpu/ops/rms_norm.py:18"),
    "flash_fwd": ("flash_fwd", "pytorch_operator_tpu_torch/csrc/flash_fwd.cu",
                  "pytorch_operator_tpu/ops/flash_attention.py:118"),
    "flash_bwd": ("flash_bwd", "pytorch_operator_tpu_torch/csrc/flash_bwd.cu",
                  "pytorch_operator_tpu/ops/flash_attention.py:356"),
}


def run() -> tuple[str, list[dict]]:
    """Every phase; returns the card and the kernels' rows."""
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    if not os.path.isdir(os.path.join(REPO, "pytorch_operator_tpu_torch")):
        raise SmokeFailure("pytorch_operator_tpu_torch/ is not beside "
                           "chip_smoke.py")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from pytorch_operator_tpu_torch import kernels

    card = nvidia_smi()
    print(card, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"(torch {torch.__version__}, cuda {torch.version.cuda})",
          flush=True)
    t0 = time.perf_counter()
    so = kernels.build()
    kernels.load()
    build_s = time.perf_counter() - t0
    log = so.with_suffix(".log")
    ptxas = [ln.strip() for ln in (log.read_text().splitlines()
                                   if log.exists() else [])
             if "registers" in ln or "spill" in ln or ln.startswith("==")]
    emit({"build_s": build_s, "library": so.name, "ptxas": ptxas})

    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"rms_norm_fwd": check_rms_norm(torch, gen)}
    errs["flash_fwd"], errs["flash_bwd"] = check_flash(torch, gen)
    timing = time_kernels(torch, gen)
    main = run_main_path(torch)
    check_tiny_model(torch)

    rows = []
    for symbol, (short, src, replaces) in KERNEL_INFO.items():
        tm = timing[short]
        rows.append({"name": short, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": main["launches"][symbol],
                     "max_abs_err": errs[symbol]["max_abs_err"],
                     "ms": tm["ms"], "plain_ms": tm["plain_ms"],
                     "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
                     "library_ms": tm["library_ms"]})
    return card, rows


def main() -> int:
    try:
        card, rows = run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    import torch

    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
