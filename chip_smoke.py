#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py            # every phase, needs one CUDA card

Phases, in order; any failure exits non-zero and prints no ``ok`` line:

1. card     nvidia-smi's name and power limit, the device name, and the
            nvcc build of every kernel from pytorch_operator_tpu_torch/
            csrc (timed, with ptxas' register and spill counts);
2. kernels  each CUDA kernel against its plain PyTorch version on the
            card: the fused backward's route at the main path's shapes
            (plus GQA, T=1, a ragged T, non-causal, D=64/16, f32 and the
            (BH, T, D) flash_with_lse layout), the two-kernel route (dq,
            then dk/dv) at T4096 and on the same variety with the route
            forced; the WMMA forward and fused backward, which bf16 at
            D 64/128 no longer reaches, at the main path's shape; at the
            long path's full shape B1, B3 and B4 against their plain
            versions on two of the heads, the two-kernel route against
            the fused kernel, and dq bitwise equal over two runs;
3. timing   each kernel, its plain version and the one PyTorch library
            call that computes the same function (a yardstick only: the
            port never calls it): device time per call from
            torch.profiler (a profile that lost a record is taken
            again), with CUDA events around repeated calls beside it;
            the Hopper flash kernels and their WMMA predecessors on the
            same inputs in turns (new, old, old, new), the forward also
            at T16384; the backward kernels also at T8192 and T16384;
4. main     the flagship Llama (d2048 L16 h16 ffn5632, ~888M params) in
            bf16 through make_train_step with AdamW(3e-4, wd 0.1) at
            B2 x T2048 on one fixed seeded batch: loss finite and
            falling, exact kernel launch counts per step, step time,
            tokens/s, MFU and peak memory, then one profiled step's
            device time by kernel;
5. model    the tiny model in bf16 with the kernels on against the same
            weights with them off: logits and the loss after one step;
6. long     the flagship at B1 x T16384 with remat_policy save_attn+qkv
            and the tied head applied per 1024 tokens, as step 4 measures
            it: the backward takes the two-kernel route; then two steps
            of train_llama at that shape with --remat-policy auto;
7. tiers    the tiny model in bf16 through the kernels at every ported
            remat tier: grads against no remat and the flash forward's
            launches per step (L under save_attn*, 2L under full remat).

The last lines are the card (nvidia-smi), one ``{"kernels": [...]}``
JSON line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import math
import os
import re
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
# the long path: the JAX package's long-sequence configuration
# (scripts/bench_detail.py, T16384 row)
LONG = dict(B=1, T=16384, H=16, D=128)
LONG_STEPS = 5
LONG_POLICY = "save_attn+qkv"
PLAIN_T = 4096  # the plain backward versions' f32 (T, T) buffers fit here


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


def _lost_records(prof, events, iters: int) -> dict:
    """For a profile that lacks records: each call's host start and the
    device records of each kernel whose count is not a multiple of
    ``iters``, as [start, duration] in ms from the first call's start, so
    the output shows which call's record is missing."""
    calls = sorted(e.time_range.start for e in prof.events()
                   if e.name.startswith("time_ms call"))
    t0 = calls[0]
    short = {e.key: e.count for e in events if e.count % iters}
    records = {key: sorted([(e.time_range.start - t0) / 1e3,
                            (e.time_range.end - e.time_range.start) / 1e3]
                           for e in prof.events() if e.name == key
                           and not e.is_user_annotation
                           and e.device_type == events[0].device_type)
               for key in short}
    return {"iters": iters, "counts": short,
            "calls_ms": [(c - t0) / 1e3 for c in calls],
            "records_ms": records}


def time_ms(fn, warmup: int = 3, iters: int = 10, reps: int = 5,
            profiles: int = 3) -> dict:
    """Time per call of ``fn`` on the card, after ``warmup`` calls.

    ``ms``: the device time of the kernels and copies of ``iters`` calls
    under torch.profiler, per call.  It leaves out the gaps in which the
    device waits for the host: a 10 us kernel launched from Python is
    otherwise timed by its launch.  ``event_ms``, beside it: median over
    ``reps`` of the mean of ``iters`` calls between two CUDA events, gaps
    included.  Every call launches the same kernels, so each kernel's
    profiled count must be a multiple of ``iters``.  The profiler has
    dropped one record of a long kernel now and then; such a profile is
    taken again, up to ``profiles`` times in all, and the records it had
    are printed.  If none is whole the phase fails.  ``profiles`` counts
    the profiles taken."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

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
    for taken in range(1, profiles + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                with record_function(f"time_ms call {i}"):
                    fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        if events and all(e.count % iters == 0 for e in events):
            break
        emit({"profiler_lost_records": events and _lost_records(
            prof, events, iters)})
    else:
        raise SmokeFailure(f"the profiler lost records in each of "
                           f"{profiles} profiles")
    device = sum(e.device_time_total for e in events) / 1e3
    return {"ms": device / iters, "event_ms": statistics.median(times),
            "profiles": taken}


def timed(kernel, plain, library, plain_kw=None) -> dict:
    """``ms``, ``plain_ms`` and ``library_ms`` (None without a library
    call) of one kernel: profiler device time, with each one's CUDA-event
    time and the profiles taken beside it."""
    return timing_row(time_ms(kernel), time_ms(plain, **(plain_kw or {})),
                      library and time_ms(library))


def timing_row(kernel: dict, plain: dict, library: dict | None) -> dict:
    t = {"kernel": kernel, "plain": plain, "library": library}
    return {"ms": kernel["ms"], "plain_ms": plain["ms"],
            "library_ms": library and library["ms"],
            "event_ms": {k: v and v["event_ms"] for k, v in t.items()},
            "profiles": {k: v and v["profiles"] for k, v in t.items()}}


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


BF16, F32 = "bfloat16", "float32"

FLASH_CASES = {
    # name: (B, T, H, Hk, D, causal, bh_layout, dtype); T * D * 4 <= 4 MiB,
    # so the backward takes the fused kernel
    "main": (2, 2048, 16, 16, 128, True, False, BF16),
    "gqa_h16_kv4": (2, 2048, 16, 4, 128, True, False, BF16),
    "t1_gqa": (2, 1, 16, 4, 128, True, False, BF16),
    "ragged_t1000": (2, 1000, 16, 16, 128, True, False, BF16),
    "non_causal": (2, 2048, 16, 16, 128, False, False, BF16),
    "d64_gqa_ragged": (2, 333, 8, 2, 64, True, False, BF16),
    "d64_non_causal_bh": (1, 1000, 16, 4, 64, False, True, BF16),
    "d16_gqa": (2, 333, 8, 4, 16, True, False, BF16),
    "f32": (2, 1000, 16, 16, 128, True, False, F32),
    "f32_d16_gqa": (2, 333, 8, 4, 16, True, False, F32),
    "with_lse_bh": (1, 1000, 32, 16, 128, True, True, BF16),
}

# The two-kernel route: T4096 at the long path's heads, then the same
# variety with the route forced (_FUSED_DQ_BYTES = 0), as the JAX tests
# force it.
TWO_KERNEL_CASES = {
    "main": (1, 4096, 16, 16, 128, True, False, BF16),
    "gqa_h16_kv4": (1, 4096, 16, 4, 128, True, False, BF16),
    "ragged_t1000": (2, 1000, 16, 16, 128, True, False, BF16),
    "non_causal": (1, 2048, 16, 16, 128, False, False, BF16),
    "d64_gqa_ragged": (2, 333, 8, 2, 64, True, False, BF16),
    "d32": (2, 500, 8, 8, 32, True, False, BF16),
    "d16_gqa": (2, 500, 8, 4, 16, True, False, BF16),
    "f32": (1, 2048, 16, 16, 128, True, False, F32),
    "f32_d16_gqa": (2, 333, 8, 4, 16, True, False, F32),
    "with_lse_bh": (1, 1000, 32, 16, 128, True, True, BF16),
}


def _flash_inputs(torch, gen, B, T, H, Hk, D, bh, dtype=BF16):
    def r(h):
        shape = (B * h, T, D) if bh else (B, T, h, D)
        return torch.randn(*shape, generator=gen, device="cuda").to(
            getattr(torch, dtype))

    return r(H), r(Hk), r(Hk), r(H)


def _rel_errs(got, ref) -> tuple[float, float]:
    got, ref = got.detach().float(), ref.detach().float()
    d = got - ref
    return (float(d.abs().max()),
            float(d.norm() / ref.norm().clamp_min(1e-30)))


BWD_TOLERANCE = ("max|err| <= 1e-2 * max|ref| and rel <= 1e-2, against "
                 "autograd through the plain version in f32: p and ds are "
                 "rounded to the input type (bf16, or TF32 in the f32 "
                 "products) before their products, the grads are cast to "
                 "it, and the fused kernel's dq sums with f32 atomics in "
                 "an order that changes from run to run; where the grad is "
                 "exactly 0 (T = 1: one key, no gradient through the "
                 "softmax) max|err| <= 1e-5, f32 rounding of dp - delta")
# a gradient that is exactly zero has no relative error to speak of
GRAD_FLOOR = 1e-5


FLASH_SYMBOLS = ("flash_fwd_sm90", "flash_bwd_sm90", "flash_fwd", "flash_bwd",
                 "flash_bwd_dq", "flash_bwd_dkv")


def flash_launches(torch, dtype, D, two) -> dict:
    """The launches of one forward and backward: the Hopper kernels for
    bf16 at D 64/128 (ops/flash_attention.py _sm90), else the WMMA ones;
    the fused backward, or B3 + B4 on the two-kernel route."""
    from pytorch_operator_tpu_torch.ops.flash_attention import _sm90

    sm90 = _sm90(getattr(torch, dtype), D)
    return {"flash_fwd_sm90": int(sm90), "flash_fwd": int(not sm90),
            "flash_bwd_sm90": int(sm90 and not two),
            "flash_bwd": int(not sm90 and not two),
            "flash_bwd_dq": int(two), "flash_bwd_dkv": int(two)}


def check_flash(torch, gen, cases, route) -> dict:
    """Each case through _Flash against autograd through the f32 plain
    forward, with the launches the route makes.  Returns the "main"
    case's max abs errors of out, dq and dk/dv."""
    from pytorch_operator_tpu_torch import kernels
    from pytorch_operator_tpu_torch.ops.flash_attention import (
        _Flash,
        _flash_fwd_reference,
    )

    two = route == "two_kernel"
    worst = None
    for name, (B, T, H, Hk, D, causal, bh, dtype) in cases.items():
        want_launches = flash_launches(torch, dtype, D, two)
        q, k, v, g = _flash_inputs(torch, gen, B, T, H, Hk, D, bh, dtype)
        g_lse = (torch.randn(B * H, 1, T, generator=gen, device="cuda")
                 if bh else None)
        scale = D ** -0.5
        qk = [x.clone().requires_grad_(True) for x in (q, k, v)]
        before = {n: kernels.KERNELS[n].launches for n in FLASH_SYMBOLS}
        out, lse = _Flash.apply(*qk, scale, causal, bh)
        loss = (out.float() * g.float()).sum()
        if g_lse is not None:
            loss = loss + (lse * g_lse).sum()
        loss.backward()
        torch.cuda.synchronize()
        launched = {n: kernels.KERNELS[n].launches - before[n]
                    for n in FLASH_SYMBOLS}

        qf = [x.float().requires_grad_(True) for x in (q, k, v)]
        ref_out, ref_lse = _flash_fwd_reference(*qf, scale, causal, bh)
        ref_loss = (ref_out * g.float()).sum()
        if g_lse is not None:
            ref_loss = ref_loss + (ref_lse * g_lse).sum()
        ref_loss.backward()
        torch.cuda.synchronize()

        o_err, o_rel = _rel_errs(out, ref_out)
        l_err, _ = _rel_errs(lse, ref_lse)
        # out is rounded to the input type and so is p before p v: a few
        # bf16 ulps of |out| <~ 4; lse is f32 math on the products
        # (exact for bf16 inputs, TF32-rounded for f32 ones)
        l_tol = 1e-3 if dtype == BF16 else 1e-2
        fwd_ok = o_err <= 2e-2 and o_rel <= 1e-2 and l_err <= l_tol
        emit({"check": "flash_fwd", "route": route, "case": name,
              "shape": [B, T, H, Hk, D], "dtype": dtype, "causal": causal,
              "max_abs_err": o_err, "rel_fro_err": o_rel,
              "lse_max_abs_err": l_err,
              "tolerance": f"out: max|err| <= 2e-2 and rel <= 1e-2 "
                           f"(output and p before p v in the input type); "
                           f"lse: {l_tol} (f32 math on bf16-exact or TF32 "
                           f"products)",
              "ok": fwd_ok})
        require(fwd_ok, f"flash_fwd {route} {name} disagrees with its "
                        f"plain version")

        errs = {}
        bwd_ok = launched == want_launches
        for gname, a, b in zip(("dq", "dk", "dv"), qk, qf):
            err, rel = _rel_errs(a.grad, b.grad)
            scale_ref = float(b.grad.abs().max())
            errs[gname] = {"max_abs_err": err, "max_abs_ref": scale_ref,
                           "rel_fro_err": rel}
            bwd_ok &= (err <= 1e-2 * scale_ref and rel <= 1e-2
                       or scale_ref == 0.0 and err <= GRAD_FLOOR)
        emit({"check": "flash_bwd", "route": route, "case": name,
              "shape": [B, T, H, Hk, D], "dtype": dtype, "causal": causal,
              **errs, "launches": launched, "tolerance": BWD_TOLERANCE,
              "ok": bwd_ok})
        require(bwd_ok, f"flash backward ({route}) {name} disagrees with "
                        f"its plain version or launched {launched}")
        if name == "main":
            worst = {"out": o_err, "dq": errs["dq"]["max_abs_err"],
                     "dkv": max(errs["dk"]["max_abs_err"],
                                errs["dv"]["max_abs_err"])}
        del qk, qf, out, lse, ref_out, ref_lse
        torch.cuda.empty_cache()
    return worst


def check_two_kernel_route(torch, gen) -> dict:
    """The two-kernel cases, the route forced for the short ones."""
    import importlib

    fa = importlib.import_module(
        "pytorch_operator_tpu_torch.ops.flash_attention")

    saved = fa._FUSED_DQ_BYTES
    fa._FUSED_DQ_BYTES = 0
    try:
        return check_flash(torch, gen, TWO_KERNEL_CASES, "two_kernel")
    finally:
        fa._FUSED_DQ_BYTES = saved


def check_wmma_at_main(torch, gen) -> dict:
    """The WMMA forward and fused backward (flash_fwd.cu, flash_bwd.cu),
    which bf16 at D 64/128 no longer reaches, at the main path's shape
    against their plain versions, so that the yardstick phase 3 times
    beside the Hopper kernels computes the same function.  Returns their
    max abs errors."""
    from pytorch_operator_tpu_torch.ops.flash_attention import (
        BWD_KERNEL,
        FWD_KERNEL,
        _flash_bwd_cuda,
        _flash_bwd_reference,
        _flash_fwd_cuda,
        _flash_fwd_reference,
    )

    B, T, H, D = (MAIN[x] for x in "BTHD")
    q, k, v, g = _flash_inputs(torch, gen, B, T, H, H, D, False)
    scale = D ** -0.5
    out, lse = _flash_fwd_cuda(q, k, v, scale, True, False,
                               kernel=FWD_KERNEL)
    ref_out, ref_lse = _flash_fwd_reference(q.float(), k.float(), v.float(),
                                            scale, True, False)
    o_err, o_rel = _rel_errs(out, ref_out)
    l_err, _ = _rel_errs(lse, ref_lse)
    del ref_out, ref_lse
    lse2 = lse.reshape(B * H, T)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).reshape(
        B * H, T).contiguous()
    args = (q, k, v, g, lse2, delta, scale, True, False)
    got = _flash_bwd_cuda(*args, kernel=BWD_KERNEL)
    ref = _flash_bwd_reference(*args)
    torch.cuda.synchronize()
    ok = o_err <= 2e-2 and o_rel <= 1e-2 and l_err <= 1e-3
    errs = {}
    for gname, a, b in zip(("dq", "dk", "dv"), got, ref):
        err, rel = _rel_errs(a, b)
        scale_ref = float(b.abs().max())
        errs[gname] = {"max_abs_err": err, "max_abs_ref": scale_ref,
                       "rel_fro_err": rel}
        ok &= err <= 1e-2 * scale_ref and rel <= 1e-2
    del got, ref
    emit({"check": "wmma_at_main", "shape": [B, T, H, H, D],
          "out": {"max_abs_err": o_err, "rel_fro_err": o_rel,
                  "lse_max_abs_err": l_err}, **errs,
          "tolerance": "as the flash_fwd and flash_bwd checks, the "
                       "backward given the kernel's own lse and delta",
          "ok": ok})
    require(ok, "a WMMA flash kernel disagrees with its plain version at "
                "the main path's shape")
    return {"flash_fwd": o_err,
            "flash_bwd": max(e["max_abs_err"] for e in errs.values())}


def _bwd_args(torch, gen, B, T, H, D):
    """Backward-kernel arguments at (B, T, H, D) causal bf16: q, k, v, g,
    lse, delta, scale, causal, layout."""
    from pytorch_operator_tpu_torch.ops.flash_attention import (
        _flash_fwd_cuda,
    )

    q, k, v, g = _flash_inputs(torch, gen, B, T, H, H, D, False)
    scale = D ** -0.5
    out, lse = _flash_fwd_cuda(q, k, v, scale, True, False)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).reshape(
        B * H, T).contiguous()
    return (q, k, v, g, lse.reshape(B * H, T), delta, scale, True, False)


# The heads of the long shape held against the plain versions: with
# H == Hk each head is independent, and one head's f32 (T, T) buffer is
# 1 GiB at T16384, where all sixteen at once would take about 70 GB.
LONG_PLAIN_HEADS = (0, 15)


def check_long_routes(torch, gen) -> dict:
    """At the long path's full shape (B1 T16384 H16 D128 causal bf16):
    B1, B3 and B4 launched on every head, and their outputs on the heads
    LONG_PLAIN_HEADS held against the plain versions on those heads'
    inputs (B3 and B4 given B1's lse and the delta of its out).  Beside
    that, B3 + B4 against the fused kernel B2, and B3's dq bitwise equal
    over two runs.  Returns the max abs errors against the plain
    versions."""
    from pytorch_operator_tpu_torch.ops.flash_attention import (
        _flash_bwd_cuda,
        _flash_bwd_dkv_cuda,
        _flash_bwd_dkv_reference,
        _flash_bwd_dq_cuda,
        _flash_bwd_dq_reference,
        _flash_fwd_cuda,
        _flash_fwd_reference,
    )

    B, T, H, D = (LONG[x] for x in "BTHD")
    args = _bwd_args(torch, gen, B, T, H, D)
    q, k, v, g, lse, delta, scale, causal, bh = args
    out, _ = _flash_fwd_cuda(q, k, v, scale, causal, bh)
    dq = _flash_bwd_dq_cuda(*args)
    dq_again = _flash_bwd_dq_cuda(*args)
    dkp, dvp = _flash_bwd_dkv_cuda(*args)
    dq2, dkp2, dvp2 = _flash_bwd_cuda(*args)
    torch.cuda.synchronize()

    heads = list(LONG_PLAIN_HEADS)
    rows = [b * H + h for b in range(B) for h in heads]  # of (B*H, T)

    def sl(x):  # (B, T, H, D) -> the chosen heads, (B, T, len(heads), D)
        return x[:, :, heads].contiguous()

    sq, sk, sv, sg = (sl(x) for x in (q, k, v, g))
    ref_out, ref_lse = _flash_fwd_reference(sq.float(), sk.float(),
                                            sv.float(), scale, causal, bh)
    o_err, o_rel = _rel_errs(sl(out), ref_out)
    l_err = float((lse[rows] - ref_lse.reshape(len(rows), T)).abs().max())
    del ref_out, ref_lse
    plain_args = (sq, sk, sv, sg, lse[rows], delta[rows], scale, causal, bh)
    plain = {"dq": (dq, _flash_bwd_dq_reference(*plain_args))}
    plain.update(zip(("dk", "dv"), zip(
        (dkp, dvp), _flash_bwd_dkv_reference(*plain_args))))
    errs = {"out": {"max_abs_err": o_err, "rel_fro_err": o_rel,
                    "lse_max_abs_err": l_err}}
    plain_ok = o_err <= 2e-2 and o_rel <= 1e-2 and l_err <= 1e-3
    for name, (got, ref) in plain.items():
        err, rel = _rel_errs(sl(got), ref)
        scale_ref = float(ref.abs().max())
        errs[name] = {"max_abs_err": err, "max_abs_ref": scale_ref,
                      "rel_fro_err": rel}
        plain_ok &= err <= 1e-2 * scale_ref and rel <= 1e-2
    del plain

    bitwise = bool(torch.equal(dq, dq_again))
    vs_fused = {}
    fused_ok = True
    for name, a, b in (("dq", dq, dq2), ("dk", dkp, dkp2),
                       ("dv", dvp, dvp2)):
        err, rel = _rel_errs(a, b)
        scale_ref = float(b.abs().max())
        vs_fused[name] = {"max_abs_err": err, "max_abs_ref": scale_ref,
                          "rel_fro_err": rel}
        fused_ok &= err <= 1e-2 * scale_ref and rel <= 1e-2
    ok = plain_ok and bitwise and fused_ok
    res = {"check": "flash_bwd_long_routes", "shape": [B, T, H, H, D],
           "plain_heads": heads, "vs_plain": errs,
           "dq_bitwise_equal_over_two_runs": bitwise,
           "vs_fused": vs_fused,
           "tolerance": "against the plain versions on the heads "
                        f"{heads}: out and lse as the flash_fwd checks "
                        "(out max|err| <= 2e-2 and rel <= 1e-2, lse 1e-3), "
                        "dq and the dk/dv partials as the flash_bwd checks "
                        "(max|err| <= 1e-2 * max|ref| and rel <= 1e-2 "
                        "against the f32 plain versions: p and ds are "
                        "rounded to bf16 before their products, dq is "
                        "cast to bf16); B3 + B4 against the Hopper fused "
                        "B2 on every head, the same bounds (B2 rounds p "
                        "to bf16 before ds, B3/B4 after; B3 rounds dq to "
                        "bf16; B2's f32 atomics sum in another order); dq "
                        "of B3 bitwise equal over two runs",
           "ok": ok}
    emit(res)
    require(ok, "at the long shape a kernel disagrees with its plain "
                "version, the two-kernel backward with the fused one, or "
                "B3's dq is not bitwise stable")
    return {"out": o_err, "dq": errs["dq"]["max_abs_err"],
            "dkv": max(errs["dk"]["max_abs_err"], errs["dv"]["max_abs_err"])}


# --------------------------------------------------------------------------
# phase 3: timing
# --------------------------------------------------------------------------


def aten_flash_bwd(torch, q, k, v, g, scale):
    """The backward alone of PyTorch's flash attention (dq, dk and dv) on
    (B, T, H, D) causal inputs, as a callable: aten's private op, whose
    signature may move between releases (None if so)."""
    qt, kt, vt, gt = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    try:
        lib = torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, True, False, scale=scale)
    except (RuntimeError, TypeError, AttributeError) as e:
        emit({"timing": "aten flash backward", "library_error": repr(e)})
        return None
    lib_out, lib_lse, cq, ck, mq, mk, rng, unused = lib[:8]
    return lambda: (torch.ops.aten.
                    _scaled_dot_product_flash_attention_backward(
                        gt, qt, kt, vt, lib_out, lib_lse, cq, ck, mq, mk,
                        0.0, True, rng, unused, scale=scale))


def in_turns(new, old, **kw) -> tuple[dict, dict]:
    """``time_ms`` of two versions of one function on the same inputs in
    turns (new, old, old, new), so that neither gets the card warmer or
    cooler; each one's ``ms`` and ``event_ms`` averaged over its two turns,
    with the turns' ``ms`` beside them."""
    runs = [time_ms(fn, **kw) for fn in (new, old, old, new)]

    def merge(a, b):
        return {"ms": (a["ms"] + b["ms"]) / 2,
                "event_ms": (a["event_ms"] + b["event_ms"]) / 2,
                "profiles": a["profiles"] + b["profiles"],
                "turns_ms": [a["ms"], b["ms"]]}

    return merge(runs[0], runs[3]), merge(runs[1], runs[2])


def previous(new: dict, old: dict) -> dict:
    """A Hopper kernel's row: its WMMA predecessor's time from the same
    turns."""
    return {"previous_ms": old["ms"], "previous_event_ms": old["event_ms"],
            "turns_ms": new["turns_ms"], "previous_turns_ms": old["turns_ms"],
            "previous": "the WMMA kernel on the same inputs, in turns"}


def time_kernels(torch, gen) -> dict:
    import torch.nn.functional as F

    from pytorch_operator_tpu_torch.ops.flash_attention import (
        BWD_KERNEL,
        FWD_KERNEL,
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
    qt, kt, vt, gt = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    slow = dict(warmup=1, iters=3, reps=3)  # the plain versions
    fwd = {"library": "torch.nn.functional.scaled_dot_product_attention",
           "shape": [B, T, H, H, Dh],
           **dict(zip(("bound_ms", "bound_by"),
                      bound(4 * io + B * H * T * 4, 4 * Dh * pairs)))}
    new, old = in_turns(
        lambda: _flash_fwd_cuda(q, k, v, scale, True, False),
        lambda: _flash_fwd_cuda(q, k, v, scale, True, False,
                                kernel=FWD_KERNEL))
    plain = time_ms(lambda: _flash_fwd_reference(q, k, v, scale, True,
                                                 False), **slow)
    sdpa = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                          is_causal=True))
    res["flash_fwd_sm90"] = {**timing_row(new, plain, sdpa), **fwd,
                             **previous(new, old)}
    res["flash_fwd"] = {**timing_row(old, plain, sdpa), **fwd}

    out, lse = _flash_fwd_cuda(q, k, v, scale, True, False)
    args = (q, k, v, g, lse.reshape(B * H, T),
            (g.float() * out.float()).sum(-1).transpose(1, 2).reshape(
                B * H, T).contiguous(), scale, True, False)
    bwd = {"library": "aten._scaled_dot_product_flash_attention_backward",
           "shape": [B, T, H, H, Dh],
           **dict(zip(("bound_ms", "bound_by"),
                      bound(7 * io + 2 * B * H * T * 4, 10 * Dh * pairs)))}

    def sdpa_fwd_bwd():
        a = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
        F.scaled_dot_product_attention(*a, is_causal=True).backward(gt)

    def port_fwd_bwd():
        from pytorch_operator_tpu_torch.ops import flash_attention

        a = [x.detach().requires_grad_(True) for x in (q, k, v)]
        flash_attention(*a, causal=True).backward(g)

    new, old = in_turns(lambda: _flash_bwd_cuda(*args),
                        lambda: _flash_bwd_cuda(*args, kernel=BWD_KERNEL))
    plain = time_ms(lambda: _flash_bwd_reference(*args), **slow)
    library = aten_flash_bwd(torch, q, k, v, g, scale)
    aten = library and time_ms(library)
    res["flash_bwd_sm90"] = {**timing_row(new, plain, aten), **bwd,
                             **previous(new, old),
                             "port_fwd_bwd_ms": time_ms(port_fwd_bwd)["ms"],
                             "sdpa_fwd_bwd_ms": time_ms(sdpa_fwd_bwd)["ms"]}
    res["flash_bwd"] = {**timing_row(old, plain, aten), **bwd}
    for name, r in res.items():
        emit({"timing": name, **r})
    return res


def time_long_kernels(torch, gen) -> dict:
    """At the long path's shape: B1 (Hopper and WMMA in turns) beside
    SDPA's forward; the two-kernel backward beside its bounds, its plain
    versions at PLAIN_T and aten's flash backward (which computes dq, dk
    and dv: compare it with B3 + B4); then the fused kernel against B3 +
    B4 at T8192 (where the rule still takes the fused one) and T16384."""
    import torch.nn.functional as F

    from pytorch_operator_tpu_torch.ops.flash_attention import (
        FWD_KERNEL,
        _flash_bwd_cuda,
        _flash_bwd_dkv_cuda,
        _flash_bwd_dkv_reference,
        _flash_bwd_dq_cuda,
        _flash_bwd_dq_reference,
        _flash_fwd_cuda,
        _flash_fwd_reference,
        _use_fused_bwd,
    )

    B, T, H, D = (LONG[x] for x in "BTHD")
    few = dict(warmup=1, iters=2, reps=3)  # 5-60 ms calls
    slow = dict(warmup=1, iters=3, reps=3)
    args = _bwd_args(torch, gen, B, T, H, D)
    plain_args = _bwd_args(torch, gen, B, PLAIN_T, H, D)
    pairs = B * H * causal_pairs(T, True)
    io, f32 = B * T * H * D * 2, B * T * H * D * 4  # one bf16 / f32 tensor
    rows = 2 * B * H * T * 4  # lse and delta
    res = {}

    q, k, v, scale = *args[:3], args[6]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    new, old = in_turns(
        lambda: _flash_fwd_cuda(q, k, v, scale, True, False),
        lambda: _flash_fwd_cuda(q, k, v, scale, True, False,
                                kernel=FWD_KERNEL),
        warmup=1, iters=4, reps=3)
    plain = time_ms(lambda: _flash_fwd_reference(*plain_args[:3], scale,
                                                 True, False), **slow)
    sdpa = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                          is_causal=True),
                   warmup=1, iters=4, reps=3)
    del qt, kt, vt
    fwd = {"library": "torch.nn.functional.scaled_dot_product_attention",
           "shape": [B, T, H, H, D], "plain_shape": [B, PLAIN_T, H, H, D],
           **dict(zip(("bound_ms", "bound_by"),
                      bound(4 * io + B * H * T * 4, 4 * D * pairs)))}
    res["flash_fwd_sm90_long"] = {**timing_row(new, plain, sdpa), **fwd,
                                  **previous(new, old)}
    res["flash_fwd_long"] = {**timing_row(old, plain, sdpa), **fwd}
    for name in ("flash_fwd_sm90_long", "flash_fwd_long"):
        emit({"timing": name, **res[name]})

    library = aten_flash_bwd(torch, *args[:4], args[6])
    lib = library and time_ms(library, **few)
    for name, fn, plain, nbytes, flops in (
            ("flash_bwd_dq", _flash_bwd_dq_cuda, _flash_bwd_dq_reference,
             5 * io + rows, 6 * D * pairs),
            ("flash_bwd_dkv", _flash_bwd_dkv_cuda, _flash_bwd_dkv_reference,
             4 * io + rows + 2 * f32, 8 * D * pairs)):
        b_ms, b_by = bound(nbytes, flops)
        res[name] = {
            **timing_row(time_ms(lambda fn=fn: fn(*args), **few),
                         time_ms(lambda plain=plain: plain(*plain_args),
                                 **slow), lib),
            "library":"aten._scaled_dot_product_flash_attention_backward "
                       "(dq, dk and dv: compare with flash_bwd_dq + "
                       "flash_bwd_dkv)",
            "bound_ms": b_ms, "bound_by": b_by, "shape": [B, T, H, H, D],
            "plain_shape": [B, PLAIN_T, H, H, D]}
        emit({"timing": name, **res[name]})
    routes = {}
    for t in (8192, T):
        targs = args if t == T else _bwd_args(torch, gen, B, t, H, D)
        times = {name: time_ms(lambda fn=fn: fn(*targs), **few)
                 for name, fn in (("flash_bwd_sm90", _flash_bwd_cuda),
                                  ("flash_bwd_dq", _flash_bwd_dq_cuda),
                                  ("flash_bwd_dkv", _flash_bwd_dkv_cuda))}
        ms = {name: tm["ms"] for name, tm in times.items()}
        pairs_t = B * H * causal_pairs(t, True)
        routes[f"T{t}"] = {
            "shape": [B, t, H, H, D],
            "rule_takes": "fused" if _use_fused_bwd(t, D) else "two_kernel",
            "fused_ms": ms["flash_bwd_sm90"],
            "two_kernel_ms": ms["flash_bwd_dq"] + ms["flash_bwd_dkv"],
            "ms": ms,
            "event_ms": {name: tm["event_ms"] for name, tm in times.items()},
            "profiles": {name: tm["profiles"] for name, tm in times.items()},
            "fused_bound_ms": bound(0, 10 * D * pairs_t)[0],
            "two_kernel_bound_ms": bound(0, 14 * D * pairs_t)[0]}
    emit({"timing": "fused_vs_two_kernel", **routes})
    res["routes"] = routes
    return res


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------


def run_path(torch, label, cfg, B, T, steps, expect, **step_kw) -> dict:
    """Train ``cfg`` from seed 0 for ``steps`` steps on one seeded (B, T)
    batch through make_train_step with AdamW(3e-4, wd 0.1): every launch
    count reset just before and read just after, the loss finite and
    falling, launches per step exactly ``expect``; then one profiled
    step."""
    import numpy as np

    from pytorch_operator_tpu_torch import kernels
    from pytorch_operator_tpu_torch.models import llama
    from pytorch_operator_tpu_torch.parallel.train import (
        TrainState,
        adamw,
        make_train_step,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    model = llama.Llama(cfg, device="cuda", generator=gen)
    optimizer = adamw(model, 3e-4, weight_decay=0.1)
    state = TrainState(model, optimizer)
    step_fn = make_train_step(cfg, model, optimizer, **step_kw)
    batch = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T + 1))).cuda()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, times = [], [], []
    kernels.reset_launches()
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    counts = kernels.launch_counts()

    L = cfg.n_layers
    per_step = {k: counts[k] / steps for k in expect}
    n = llama.n_params(cfg)
    step_s = statistics.median(times[1:])
    tokens = B * T
    flops = 6.0 * n * tokens + 12.0 * L * B * T * T * cfg.dim * 0.5
    res = {"model": f"d{cfg.dim} L{L} h{cfg.n_heads} kv{cfg.n_kv_heads} "
                    f"ffn{cfg.ffn_dim} vocab{cfg.vocab_size}",
           "n_params": n, "batch": B, "seq": T, "steps": steps,
           "remat": cfg.remat, "remat_policy": cfg.remat_policy,
           "step_kw": step_kw, "losses": losses, "grad_norms": norms,
           "step_ms_all": [t * 1e3 for t in times],
           "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
           "model_tflops_per_step": flops / 1e12,
           "mfu": flops / step_s / PEAK_BF16_FLOPS,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": counts, "launches_per_step": per_step}
    emit({label: res})
    require(all(math.isfinite(x) for x in losses + norms),
            f"{label}: non-finite loss or grad norm: {losses} {norms}")
    require(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
    require(per_step == {k: float(v) for k, v in expect.items()},
            f"{label}: launches per step {per_step} != {expect}")
    res["profile"] = profile_step(torch, label,
                                  lambda: step_fn(state, batch), expect)
    return res


def run_main_path(torch) -> dict:
    """Phase 4: the flagship at B2 x T2048, no remat."""
    from pytorch_operator_tpu_torch.models import llama

    L = llama.flagship().n_layers
    expect = {"rms_norm_fwd": 2 * L + 1, "flash_fwd_sm90": L,
              "flash_bwd_sm90": L, "flash_fwd": 0, "flash_bwd": 0,
              "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    return run_path(torch, "main_path", llama.flagship(), MAIN["B"],
                    MAIN["T"], STEPS, expect)


def run_long_path(torch) -> dict:
    """Phase 6: the flagship at B1 x T16384 under save_attn+qkv with the
    chunked tied-head CE.  T * D * 4 = 8 MiB takes the two-kernel
    backward.  save_attn keeps each layer's flash (out, lse), so the
    forward kernel runs L times, not 2L; the recompute runs both norms
    again (the attention norm is the d/dW input of the saved q/k/v
    projections, the MLP norm feeds the recomputed gate/up): 2L+1 + 2L
    RMSNorm launches."""
    from pytorch_operator_tpu_torch.models import llama

    cfg = llama.flagship(max_seq_len=LONG["T"], remat=True,
                         remat_policy=LONG_POLICY)
    L = cfg.n_layers
    expect = {"rms_norm_fwd": 4 * L + 1, "flash_fwd_sm90": L,
              "flash_bwd_sm90": 0, "flash_fwd": 0, "flash_bwd": 0,
              "flash_bwd_dq": L, "flash_bwd_dkv": L}
    return run_path(torch, "long_path", cfg, LONG["B"], LONG["T"],
                    LONG_STEPS, expect, chunked_ce=True, ce_chunk=1024)


# the profile class of each kernel's launches
PROFILE_CLASS = {"rms_norm_fwd": "rms_norm",
                 "flash_fwd_sm90": "flash_fwd_sm90",
                 "flash_bwd_sm90": "flash_bwd_sm90", "flash_fwd": "flash_fwd",
                 "flash_bwd": "flash_bwd", "flash_bwd_dq": "flash_bwd_dq",
                 "flash_bwd_dkv": "flash_bwd_dkv"}
KERNEL_CLASSES = (("rms_norm", ("rms_norm_kernel",)),
                  ("flash_fwd_sm90", ("flash_fwd_sm90_kernel",)),
                  ("flash_bwd_sm90", ("flash_bwd_sm90_kernel",)),
                  ("flash_fwd", ("flash_fwd_kernel",)),
                  ("flash_bwd", ("flash_bwd_kernel",)),
                  ("flash_bwd_dq", ("flash_bwd_dq_kernel",)),
                  ("flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
                  ("matmul", ("gemm", "nvjet", "cutlass", "xmma")))


def profile_step(torch, label, step, expect) -> dict:
    """Device time of one more step, by kernel class and by kernel.  The
    port's kernels' profiled counts are held against the launches per
    step (``expect``): a shortfall means the profiler lost records, and
    ``complete`` says so."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_class: dict[str, float] = {}
    counts: dict[str, int] = {}
    top = []
    for e in device_events(prof):
        ms = e.device_time_total / 1e3
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k in e.key for k in keys)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + ms
        counts[cls] = counts.get(cls, 0) + e.count
        top.append((ms, e.count, e.key[:80]))
    top.sort(reverse=True)
    launched = {symbol: counts.get(PROFILE_CLASS[symbol], 0)
                for symbol in expect}
    out = {"path": label, "wall_ms_profiled": wall_ms,
           "device_ms": sum(by_class.values()),
           "device_ms_by_class": by_class, "kernel_counts": launched,
           "complete": launched == expect,
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


def run_long_cli(torch) -> dict:
    """Phase 6, the trainer's own entry at the long shape: two steps with
    --remat-policy auto, resolved from the card's memory."""
    from pytorch_operator_tpu_torch import train_llama

    argv = ["--model", "flagship", "--batch-size", str(LONG["B"]),
            "--seq-len", str(LONG["T"]), "--remat", "--remat-policy", "auto",
            "--chunked-ce", "--steps", "2", "--log-interval", "1"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_llama.main(argv)
    text = out.getvalue()
    picked = re.search(r"--remat-policy auto -> (\S+)", text)
    losses = [float(x) for x in re.findall(r"loss=(\S+)", text)]
    res = {"argv": argv, "rc": rc, "auto_picked": picked and picked.group(1),
           "losses": losses, "output": text.splitlines()}
    emit({"long_cli": res})
    require(rc == 0 and "training complete" in text and picked is not None
            and len(losses) == 2 and all(map(math.isfinite, losses)),
            f"train_llama at the long shape failed: {text}")
    return res


# --------------------------------------------------------------------------
# phase 7: the remat tiers through the kernels
# --------------------------------------------------------------------------


REMAT_TIERS = (None, "save_attn", "save_attn+qkv", "save_attn+gateup",
               "save_attn+normed", "save_attn+qkv+gateup+normed",
               "dots_saveable", "dots_with_no_batch_dims_saveable")


def check_remat_tiers(torch) -> dict:
    """The tiny model (bf16, head dim 16, GQA 8:4) through the kernels at
    every ported remat_policy: grads against no remat, and the forward
    kernels' launches in one forward + backward."""
    import numpy as np

    from pytorch_operator_tpu_torch import kernels
    from pytorch_operator_tpu_torch.models import llama
    from pytorch_operator_tpu_torch.parallel.train import cross_entropy_loss

    base = llama.tiny(dtype=torch.bfloat16, use_flash=True,
                      use_fused_norm=True, remat=False)
    L = base.n_layers
    weights = llama.Llama(base, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(2)).state_dict()
    batch = torch.from_numpy(np.random.default_rng(2).integers(
        0, base.vocab_size, (2, 129))).cuda()

    def grads(cfg):
        model = llama.Llama(cfg, device="cuda")
        model.load_state_dict(weights)
        kernels.reset_launches()
        cross_entropy_loss(model(batch[:, :-1]), batch[:, 1:]).backward()
        torch.cuda.synchronize()
        return ([p.grad.float() for p in model.parameters()],
                kernels.launch_counts())

    ref, ref_counts = grads(base)
    res = {"no_remat": {"flash_fwd": ref_counts["flash_fwd"],
                        "rms_norm_fwd": ref_counts["rms_norm_fwd"]}}
    for policy in REMAT_TIERS:
        got, counts = grads(dataclasses.replace(base, remat=True,
                                                remat_policy=policy))
        err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                  for a, b in zip(got, ref))
        save_attn = (policy or "").startswith("save_attn")
        want = {"flash_fwd": L if save_attn else 2 * L,
                "rms_norm_fwd": 2 * L + 1 + (
                    0 if "normed" in (policy or "") else 2 * L)}
        launched = {k: counts[k] for k in want}
        ok = err <= 2e-2 and launched == want
        res[str(policy)] = {"max_rel_grad_err": err, "launches": launched,
                            "ok": ok}
        require(ok, f"remat_policy {policy}: grads {err} off no remat or "
                    f"launches {launched} != {want}")
    res["tolerance"] = ("each grad within 2e-2 of its max under no remat: "
                        "the same bf16 math recomputed, but the fused "
                        "backward's dq sums with f32 atomics in an order "
                        "that changes from run to run")
    emit({"remat_tiers": res})
    return res


# --------------------------------------------------------------------------


KERNEL_INFO = {
    "rms_norm_fwd": ("rms_norm", "pytorch_operator_tpu_torch/csrc/rms_norm.cu",
                     "pytorch_operator_tpu/ops/rms_norm.py:18"),
    "flash_fwd_sm90": ("flash_fwd_sm90",
                       "pytorch_operator_tpu_torch/csrc/flash_fwd_sm90.cu",
                       "pytorch_operator_tpu/ops/flash_attention.py:118"),
    "flash_bwd_sm90": ("flash_bwd_sm90",
                       "pytorch_operator_tpu_torch/csrc/flash_bwd_sm90.cu",
                       "pytorch_operator_tpu/ops/flash_attention.py:356"),
    "flash_fwd": ("flash_fwd", "pytorch_operator_tpu_torch/csrc/flash_fwd.cu",
                  "pytorch_operator_tpu/ops/flash_attention.py:118"),
    "flash_bwd": ("flash_bwd", "pytorch_operator_tpu_torch/csrc/flash_bwd.cu",
                  "pytorch_operator_tpu/ops/flash_attention.py:356"),
    "flash_bwd_dq": ("flash_bwd_dq",
                     "pytorch_operator_tpu_torch/csrc/flash_bwd_dq.cu",
                     "pytorch_operator_tpu/ops/flash_attention.py:264"),
    "flash_bwd_dkv": ("flash_bwd_dkv",
                      "pytorch_operator_tpu_torch/csrc/flash_bwd_dkv.cu",
                      "pytorch_operator_tpu/ops/flash_attention.py:325"),
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
    phase = time.perf_counter()
    fused = check_flash(torch, gen, FLASH_CASES, "fused")
    check_two_kernel_route(torch, gen)
    wmma = check_wmma_at_main(torch, gen)
    # B3 and B4 run on the long path only: their errors at its shape
    long = check_long_routes(torch, gen)
    errs = {"rms_norm_fwd": check_rms_norm(torch, gen)["max_abs_err"],
            "flash_fwd_sm90": fused["out"],
            "flash_bwd_sm90": max(fused["dq"], fused["dkv"]), **wmma,
            "flash_bwd_dq": long["dq"], "flash_bwd_dkv": long["dkv"]}
    seconds = {"kernels": time.perf_counter() - phase}
    phase = time.perf_counter()
    timing = time_kernels(torch, gen)
    timing.update(time_long_kernels(torch, gen))
    seconds["timing"] = time.perf_counter() - phase
    phase = time.perf_counter()
    paths = {"main_path": run_main_path(torch)}
    check_tiny_model(torch)
    torch.cuda.empty_cache()
    paths["long_path"] = run_long_path(torch)
    torch.cuda.empty_cache()
    run_long_cli(torch)
    check_remat_tiers(torch)
    seconds["paths"] = time.perf_counter() - phase
    emit({"phase_seconds": seconds})

    rows = []
    for symbol, (short, src, replaces) in KERNEL_INFO.items():
        tm = timing[short]
        by_path = {p: r["launches"][symbol] for p, r in paths.items()}
        row = {"name": short, "route": "cuda", "source": src,
               "replaces": replaces,
               "launches": sum(by_path.values()),
               "launches_by_path": by_path,
               "max_abs_err": errs[symbol],
               "ms": tm["ms"], "plain_ms": tm["plain_ms"],
               "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
               "library_ms": tm["library_ms"],
               "ms_by": "torch.profiler device time per call",
               "event_ms": tm["event_ms"], "profiles": tm["profiles"],
               "shape": tm["shape"]}
        if "previous_ms" in tm:
            row["previous_ms"] = tm["previous_ms"]
        if short in ("flash_fwd", "flash_bwd"):
            row["path"] = ("f32 and D 16/32 only; timed at the main "
                           "path's shape as the yardstick")
        if short + "_long" in timing:  # B1 at the long path's shape
            lt = timing[short + "_long"]
            row["long"] = {k: lt.get(k) for k in (
                "shape", "ms", "previous_ms", "bound_ms", "bound_by",
                "library_ms", "plain_ms", "plain_shape")}
        rows.append(row)
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
