#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py    # every phase; needs a CUDA card (phase 13: two)

The phases run in the order 1-12, 14, 15, 16, 17, 13.

Phases, in order; any failure exits non-zero and prints no ``ok`` line:

1. card     nvidia-smi's name and power limit, the device name, and the
            nvcc build of every kernel from pytorch_operator_tpu_torch/
            csrc (timed, with ptxas' register and spill counts by kernel
            and instantiation; any spill byte in a _sm90 kernel fails;
            the CTAs per multiprocessor of every 16-bit Hopper kernel,
            B1-B4, and of the f32 B1, by the occupancy API),
            and what a TMA load of f32 gives back through a FLOAT32 and
            a TFLOAT32 tensor map (copied, rounded or truncated);
2. kernels  each CUDA kernel against its plain PyTorch version on the
            card: the fused backward's route at the main path's shapes
            (plus GQA, T=1, a ragged T, non-causal, D=64/16, f32, the
            (BH, T, D) flash_with_lse layout, fp16 (at the main shape
            too), head dims 48/96/200 zero-padded to the kernels'
            64/128/256, D 256 in fp16 and bf16 (the Hopper kernels, GQA
            at a ragged T, the bh layout), f32 on the Hopper TF32
            kernels (D 64 with GQA at a ragged T and in the bh layout,
            D 128 at the main shape, D 256 with the backward on
            clusters of two CTAs), the Hopper B1 and B2 on narrow slabs
            at bf16 and fp16 D 16/32 (GQA at a ragged T, T = 1 and 129,
            both layouts, causal and not), the Hopper TF32 B1 and B2 at
            f32 D 16/32 (GQA at a ragged T, T = 2 and 129, both layouts,
            causal and not) and B*H = 65,536), the
            two-kernel route (dq, then dk/dv) at T4096 and on the same
            variety with the route forced (the Hopper B3 at fp16, D 256
            and f32 D 64/128/256, at f32 D 256 B3 and B4 on clusters, the
            Hopper B3 and B4 at bf16 and fp16 D 16/32, the Hopper TF32
            B1, B3 and B4 at f32 D 16/32); the
            Hopper B4's dk/dv bit for bit B2's and the Hopper B3's dq
            bit for bit over two runs, and within bounds of B2's, at
            every bf16, fp16 and f32 instantiation; the WMMA forward and
            fused backward, which no call reaches, at the main path's
            shape in bf16 and f32, and the WMMA forward and dq kernel at
            phase 3's f32 D 32 and 16 shapes; at the long path's full
            shape B1 and the Hopper and WMMA B3 and B4 against their
            plain versions on two of the heads (the Hopper B4's dk error
            beside the WMMA B4's: both form dS from the f32 P), the
            two-kernel route against the fused kernel on every head, B3's
            dq bitwise equal over two runs and B4's dk/dv bitwise equal
            to B2's;
3. timing   each kernel, its plain version and the one PyTorch library
            call that computes the same function (a yardstick only: the
            port never calls it): device time per call from
            torch.profiler (a profile that lost a record is taken
            again), with CUDA events around repeated calls beside it;
            the Hopper flash kernels and their WMMA predecessors on the
            same inputs in turns (new, old, old, new), the forward also
            at T16384, B3 and B4 at T16384; the fused backward against
            B3 + B4 at T8192 and T16384; at T2048 fp16 and bf16 at D 256,
            fp16 at D 128 and f32 at D 64, 128 and 256 (the Hopper B1 and
            B2, each in turns with the WMMA kernel it replaced), bf16 at
            D 96 (padded), and B3 + B4 on the two-kernel route at each of
            those but D 96 (the Hopper B3 in turns with the WMMA one),
            bf16 and fp16 at D 32 (H64) and D 16 (H128), B1-B4 on
            narrow slabs in turns with their WMMA kernels, and f32
            there, the Hopper TF32 B1-B4 in turns with their WMMA
            kernels; the bounds count
            the tensor products and one exponential a score element
            (PEAK_EXP); the forward beside SDPA and the backward
            beside aten's flash backward (bf16, fp16) or SDPA's
            memory-efficient backward (f32, which aten's refuses); B1
            and B2 at the MoE's and the pipeline's length, B1 x T4096
            with 32 q heads over 8 kv heads, D128, beside SDPA and
            aten's backward on k and v expanded to 32 heads, and at the
            --pp microbatch, B1 x T4096 H32 (no GQA), D128; the
            short_t_forward rows: forward-only calls (torch.no_grad())
            through flash_attention's B1 against _dense_path, in turns,
            at T 128-2048 for the 1F1B tick (bf16 B1 H32 D128), the
            flagship's inference (bf16 B2 H16 D128) and the tiny model
            (f32 B1 H8/4 D16), each with B1's bound and a verdict, and
            the crossover they give (the port has no route: 0); B5
            at the 7B's row width (4096 x 4096 bf16) in turns with
            F.rms_norm;
4. main     the flagship Llama (d2048 L16 h16 ffn5632, ~888M params) in
            bf16 through make_train_step with AdamW(3e-4, wd 0.1) at
            B2 x T2048 on one fixed seeded batch: loss finite and
            falling, exact kernel launch counts per step, step time,
            tokens/s, MFU and peak memory, then one profiled step's
            device time by kernel;
5. model    the tiny model in bf16 with the kernels on against the same
            weights with them off: logits (the kernels-on forward under
            no_grad must launch B1 once a layer) and the loss after one
            step;
6. long     the flagship at B1 x T16384 with remat_policy save_attn+qkv
            and the tied head applied per 1024 tokens, as step 4 measures
            it: the backward takes the two-kernel route; then two steps
            of train_llama at that shape with --remat-policy auto;
7. tiers    the tiny model in bf16 through the kernels at every ported
            remat tier: grads against no remat and the Hopper flash
            forward's launches per step (L under save_attn*, 2L under
            full remat), and L of the fused backward's Hopper walk (head
            dim 16, both on narrow slabs, no WMMA launch); then
            train_llama's default model (the tiny Llama, f32, head dim
            16, full remat) for two steps as the trainer runs it and
            again with --no-remat: exact launches per step of the TF32
            B1 and B2 and of RMSNorm, no WMMA launch;
8. sharded  the T2048 path of phase 4 through the sharded code path at
            world size 1 over NCCL: make_mesh(1, 1, 1), sharded_init
            (at one rank the plain model: no FSDP2, no DTensor),
            make_train_step(mesh=...), the same seed and batch, its step
            wrapped in with_step_profiler: exact launch counts, losses
            within 2e-2 of phase 4's step by step, step time, device
            time and peak memory beside phase 4's, the profiler's
            tokens/s and 6·N·B·T MFU beside this script's; then the
            FSDP2 step on the card (the same model fully_shard-ed over
            the one rank, as sharded_init wraps it where dp x fsdp holds
            more than one): four steps whose losses must be within 2e-2
            of the plain step's and whose launches must be the same, and
            the host profile, by function, of its last step beside the
            plain step's;
9. resume   train_llama --model flagship --layers 2 at B2 x T2048 in a
            process that checkpoints at steps 2 and 4, a second process
            that restores step 4 and trains to step 6, and the same six
            steps uninterrupted: the log strings, no step retrained,
            steps 4-5 within 2e-2 of the uninterrupted run's, save and
            restore seconds;
10. mnist   train_mnist --device cuda on the synthetic digits until
            accuracy >= 0.98: images/s and seconds;
11. ring    the ring attention of 4 virtual ranks in this process (the
            loopback, parallel/ring_attention.py) at Llama-2-7B's
            attention shape B1 T32768 H32 D128 bf16 causal, contiguous
            and zigzag: out, the merged lse and dq/dk/dv against B1 and
            B3 + B4 over the full T32768, exactly 10 (contiguous) or 36
            (zigzag) chunk forward calls and as many backward ones, and
            its device time beside the full-T kernels';
12. sp      train_llama --model 7b --layers 4 --sp 1 --sp-impl ring at
            B1 x T32768 (full width, depth cut to 4) under save_attn+qkv
            with the chunked head, 4 steps, beside the same trainer
            without --sp: losses within 2e-2 step by step, exact launch
            counts, step time, tokens/s, MFU and peak memory;
13. cards   only with more than one card visible (else one line says it
            was skipped): first the ring over NCCL, one spawned process
            per card (up to 4) at phase 11's shape, contiguous and
            zigzag_pre, on the trainer's backward route and the
            two-kernel one: each rank's out, dq, dk and dv bit for bit
            the loopback ring's chunk on the same inputs (the fused
            route's dq, summed with f32 atomics, within one bf16 ulp)
            and its chunk-pair launches; then train_llama under
            torch.distributed.run, one process per card, Llama-2-7B at
            full width and depth 16, B1 x T32768: --sp 4 with ring,
            ring_zigzag and ulysses and --sp 1 on one card, then at B2
            --fsdp 2 --sp 2 and --dp 2 --sp 2 (ring_zigzag); losses
            within 2e-2 of the last run's on the same global batch step
            by step, the steady step time (median after step 1, the
            profiled one), tokens/s, MFU and the NCCL share of the
            profiled step's kernel time; then the flagship at B4 x T2048
            under --fsdp 2 --tp 2 and --dp 2 --fsdp 2.  The pipeline:
            one process per card runs it over NCCL P2P and the loopback
            on the same inputs (phase 14's width, two layers a stage),
            both schedules: each rank's layer outputs, input and
            parameter gradients and loss bit for bit the loopback's;
            with four cards reshard_state over NCCL (the flagship from
            fsdp 4 to fsdp 2 x tp 2 and back, bit for bit, and the step
            after it bit for bit the step of a state built there); then
            train_llama --pp 4 at Llama-2-7B's full depth of 32, B8 x
            T4096 in 8 microbatches, each schedule (losses within 2e-2,
            step time, tokens/s, MFU, each rank's peak memory and
            launches, rank 0's idle share beside the ideal bubble), and
            --layers 8 --pp 4 beside phase 14's run without --pp; with
            four cards the MoE of phase 15 over NCCL on (dp, fsdp, tp,
            ep) meshes through sharded_init and make_train_step: ep 4 at
            phase 15's depth (losses within 2e-2 of phase 15's), then
            ep 4 and tp 2 x ep 2 at depth 8 (launches per step exactly
            17/8/8 on every rank, step time, MFU, each rank's peak
            memory, the NCCL share); in each, the replicated weights bit
            for bit equal over ep; ResNet-50's global-batch BatchNorm
            over NCCL (one process per card, f32 with TF32 off, 64^2,
            global batch 32: the first step's loss, every gradient and
            the running statistics against one card's step on the whole
            batch, within RESNET_NCCL, and the step with each BatchNorm
            on its rank's rows reported beside it), train_resnet under
            torch.distributed.run at --batch-size 1024 (images/s beside
            n times phase 16's) and dist_allreduce on the cards;
14. pipe    (runs before 13) Llama-2-7B's full width at depth 8: the
            loopback pipeline of 4 virtual stages (make_pp_train_step,
            mesh=None) under GPipe and 1F1B beside the same model
            unpipelined, B4 x T4096 in 4 microbatches, 4 steps: losses
            within 2e-2, exact launches per step, step time, peak memory
            (1F1B's below GPipe's); then train_llama --layers 8 --pp 1
            --microbatches 4 under each schedule beside train_llama
            without --pp;
15. moe     (runs before 13) the MoE Llama at Mixtral-8x7B's width
            (d4096, 32 heads, 8 kv heads, 8 experts of width 14336,
            top-2, tied head, dense dispatch) at depth 2, B1 x T4096,
            through sharded_init and make_train_step on a (dp, fsdp, tp,
            ep) mesh of one rank, 4 steps: loss finite and falling,
            launches per step exactly 5/2/2 (RMSNorm, B1, B2), step
            time, tokens/s, MFU, peak memory, one profiled step's device
            time by kernel class (the experts' products a class of their
            own); the first step's gradients against the kernels-off
            ones of the same weights (worst leaf within MOE_GRAD_LIMIT
            with every expert chosen; at top-2 reported with the tokens
            the two routes send to other experts); at each step the
            loss of the same weights with the kernels off within 2e-2 of
            the kernels'.
16. resnet  (runs before 13) ResNet-50 at full width through
            train_resnet's entry points, B256 x 224^2, bf16,
            channels_last, SGD-Nesterov 0.1 / 0.9 under the cosine decay,
            8 steps on the pool of 4 batches: no launch of any of the
            port's kernels (the path runs none), the loss finite and
            falling, step time, images/s, conv-FLOP MFU, peak memory,
            one profiled step's device time by class (conv, batch_norm,
            optimizer, other); the bf16 model against f32 (TF32 off) of
            the same weights on the same batch within RESNET_BF16; then
            train_resnet from the command line, without --device, for 3
            steps.
17. pods    (runs before 13) the operator's env written out as the JAX
            controller renders it (operator_env: WORLD_SIZE = pods,
            RANK = pod, the master's MASTER_ADDR localhost, a free
            MASTER_PORT, no LOCAL_RANK), each pod a process of python
            -m pytorch_operator_tpu_torch.launch in a session of its
            own: one pod with every visible card runs dist_allreduce
            (the sum over every card) and train_resnet at B256 for 3
            steps (images/s beside phase 16's); with two cards or more,
            two pods at once, each with half the cards in its
            CUDA_VISIBLE_DEVICES, run dist_allreduce over all of them;
            with four, phase 13's flagship run (--fsdp 2 --tp 2, B4 x
            T2048) on 2 pods x 2 cards, whose losses must be within
            2e-2 of phase 13's and whose launches per rank must equal
            them (checked at the end of phase 13), and train_resnet at
            --batch-size 1024 on 2 pods (images/s beside phase 13's);
            then train_resnet started without the launcher under
            WORLD_SIZE=1 RANK=0 with several cards visible must exit
            non-zero naming the launcher (fault C4's guard).  Every
            launched rank reports its kernel launches, which the
            kernels line sums as the "pods" path.

The last lines are the card (nvidia-smi), one ``{"kernels": [...]}``
JSON line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): the bounds and MFU are stated
# against these, beside the card's own power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# the special-function units' rate (ex2 results a second): the
# FlashAttention-3 paper's figure for the H100 SXM5 (Shah et al. 2024,
# section 1: 3.9 TFLOPS of special functions), 132 SMs x 16 a clock x
# about 1.83 GHz.  Each flash kernel takes one ex2 a score element, which
# sets its bound at D 16/32.
PEAK_EXP = 3.9e12

MAIN = dict(B=2, T=2048, H=16, D=128)
STEPS = 6
# the long path: the JAX package's long-sequence configuration
# (scripts/bench_detail.py, T16384 row)
LONG = dict(B=1, T=16384, H=16, D=128)
LONG_STEPS = 5
LONG_POLICY = "save_attn+qkv"
# steps of the sharded path through with_step_profiler, after its timed
# steps (the profiler counts the first as its warm-up)
PROFILER_STEPS = 5
PLAIN_T = 4096  # the plain backward versions' f32 (T, T) buffers fit here
# phase 11: 4 virtual ranks at Llama-2-7B's attention shape
RING = dict(B=1, T=32768, H=32, D=128, n=4)
# phases 12 and 13: the trainer at Llama-2-7B's full width
SP_ARGV = ["--model", "7b", "--batch-size", "1", "--seq-len", "32768",
           "--remat", "--remat-policy", "save_attn+qkv", "--chunked-ce",
           "--log-interval", "1"]
SP_LAYERS, SP_STEPS = 4, 4
CARDS_LAYERS, CARDS_STEPS = 16, 6
# phase 14: the pipeline at Llama-2-7B's full width, depth cut to 8 (two
# layers a stage), B4 x T4096 in 4 microbatches of one sequence, no
# remat; phase 13 adds the full depth of 32 over 4 cards (B8, 8
# microbatches)
PIPE = dict(L=8, S=4, B=4, T=4096, M=4, steps=4)
PIPE_ARGV = ["--model", "7b", "--no-remat", "--seq-len", "4096",
             "--log-interval", "1"]
PIPE_CARDS = dict(L=32, B=8, M=8, steps=5)
# the WMMA kernels' f32 products run in TF32 (H100 SXM data sheet, dense)
PEAK_TF32_FLOPS = 495e12
# phase 15: the MoE at Mixtral-8x7B's width, depth cut to 2 (its state
# with AdamW is 24 GB), B1 x T4096, no remat
MOE = dict(L=2, B=1, T=4096, steps=4)
# phase 13's MoE runs on four cards: (label, (dp, fsdp, tp, ep), layers,
# steps, whether each step's loss is held against a kernels-off model of
# the same weights); depth 8 holds 26 GB of state a card
MOE_CARDS = (("ep4_L2", (1, 1, 1, 4), MOE["L"], MOE["steps"], True),
             ("ep4_L8", (1, 1, 1, 4), 8, 5, False),
             ("tp2_ep2_L8", (1, 1, 2, 2), 8, 5, False))


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


def ptxas_by_kernel(log: str) -> dict:
    """Registers and spill bytes of each kernel entry in nvcc's
    ``-Xptxas -v`` log, by demangled name without its arguments (c++filt
    where the machine has it; else the mangled name)."""
    by_entry, entry = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = m.group(1)
            by_entry[entry] = {"registers": None, "spill_stores": None,
                               "spill_loads": None}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            by_entry[entry]["spill_stores"] = int(m.group(1))
            by_entry[entry]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            by_entry[entry]["registers"] = int(m.group(1))
            entry = None
    names = list(by_entry)
    demangle = next((c for c in ("c++filt", "/usr/local/cuda/bin/cu++filt")
                     if shutil.which(c)), None)
    if demangle and names:
        out = subprocess.run([demangle], input="\n".join(names),
                             stdout=subprocess.PIPE, text=True, timeout=60)
        readable = out.stdout.splitlines()
        if out.returncode == 0 and len(readable) == len(names):
            # "void (anonymous namespace)::k<__half, 256>(...)" -> k<...>
            return {r.replace("(anonymous namespace)::", "").split("(")[0]
                    .removeprefix("void "): by_entry[n]
                    for n, r in zip(names, readable)}
    return by_entry


# The Hopper kernels' instantiations: B1, B2, B3 and B4 at bf16, fp16
# and f32 (TF32) at D 64/128/256 (9 each), at bf16 and fp16 at D 16/32
# (on narrow slabs, 4 each), and at f32 D 16/32 (2 each); B5 at f32, bf16
# and fp16
SM90_INSTANTIATIONS = 63


def check_sm90_ptxas(log: str) -> dict:
    """Phase 1's check of the Hopper kernels' build: every instantiation
    of a ``_sm90`` kernel (SM90_INSTANTIATIONS of them) spills no byte.
    Returns their ptxas counts."""
    sm90 = {name: c for name, c in ptxas_by_kernel(log).items()
            if "_sm90" in name}
    spilled = {name: c for name, c in sm90.items()
               if c["spill_stores"] or c["spill_loads"]}
    emit({"check": "sm90_ptxas", "kernels": sm90,
          "tolerance": "0 spill bytes in every _sm90 instantiation, "
                       f"{SM90_INSTANTIATIONS} of them",
          "ok": len(sm90) == SM90_INSTANTIATIONS and not spilled})
    require(len(sm90) == SM90_INSTANTIATIONS,
            f"ptxas reported {len(sm90)} _sm90 instantiations, not "
            f"{SM90_INSTANTIATIONS}: {sorted(sm90)}")
    require(not spilled, f"ptxas spilled in a Hopper kernel: {spilled}")
    return sm90


def sm90_ctas_per_sm() -> dict:
    """CTAs per multiprocessor of every 16-bit instantiation of the Hopper
    kernels (B1-B4) and of every f32 one of B1, by the occupancy API (the
    C entries
    ``flash_fwd_sm90_ctas_per_sm``, ``flash_bwd_sm90_ctas_per_sm``,
    ``flash_bwd_dq_sm90_ctas_per_sm`` and ``flash_bwd_dkv_sm90_ctas_per_sm``:
    THREADS threads and the kernel's shared memory).  Fails on one that
    fits no multiprocessor."""
    import ctypes

    from pytorch_operator_tpu_torch import kernels

    lib = kernels.load()
    res = {}
    for kernel in ("flash_fwd_sm90", "flash_bwd_sm90", "flash_bwd_dq_sm90",
                   "flash_bwd_dkv_sm90"):
        fn = getattr(lib, kernel + "_ctas_per_sm")
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        dtypes = ((BF16, 1), (F16, 2)) + (
            ((F32, 0),) if kernel == "flash_fwd_sm90" else ())
        for dtype, code in dtypes:
            for D in (16, 32, 64, 128, 256):
                ctas = ctypes.c_int(0)
                rc = fn(D, code, ctypes.byref(ctas))
                require(rc == 0, f"{kernel}_ctas_per_sm({D}, {dtype}) "
                                 f"returned CUDA error {rc}")
                res[f"{kernel}<{dtype}, {D}>"] = ctas.value
    ok = all(v >= 1 for v in res.values())
    emit({"check": "sm90_ctas_per_sm", "ctas": res,
          "tolerance": "every instantiation fits a multiprocessor",
          "ok": ok})
    require(ok, f"a Hopper instantiation fits no multiprocessor: {res}")
    return res


def probe_tma_tfloat32(torch) -> dict:
    """Phase 1: what one TMA load gives back of an 8 x 32 f32 tile
    (csrc/tma_tf32_probe.cu) through a tensor map of type FLOAT32 and of
    type TFLOAT32, as the f32 Hopper kernels map their inputs: the bits
    as they are, rounded to TF32 (to nearest, ties away or to even),
    truncated to it, or otherwise.  Reported, not gated: were the
    TFLOAT32 map to copy, wgmma would read the f32 operands as TF32 by
    dropping their low 13 mantissa bits, which the f32 bounds hold
    (tests/test_torch_flash_dtypes.py's truncation test)."""
    import ctypes

    from pytorch_operator_tpu_torch import kernels

    fn = kernels.load().tma_tf32_probe
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(8, 32, generator=gen, device="cuda")
    bits = x.view(torch.int32)
    low = bits & 0x1FFF
    trunc = bits & ~0x1FFF
    rna = (bits + 0x1000) & ~0x1FFF
    tie_even = (low == 0x1000) & ((bits & 0x2000) == 0)
    rne = torch.where(tie_even, trunc, rna)
    res = {}
    for name, mode in (("float32", 0), ("tfloat32", 1)):
        out = torch.full_like(x, float("nan"))
        rc = fn(kernels.ptr(x), kernels.ptr(out), mode,
                kernels.stream(x.device))
        torch.cuda.synchronize()
        if rc:
            res[name] = f"refused: CUDA error {rc}"
            continue
        got = out.view(torch.int32)
        res[name] = next((what for what, want in (
            ("copied", bits), ("rounded to nearest, ties away", rna),
            ("rounded to nearest, ties to even", rne),
            ("truncated", trunc)) if torch.equal(got, want)),
            f"other: {int((got != bits).sum())} of 256 values changed")
    emit({"check": "tma_tfloat32", "tile": [8, 32], "loads": res,
          "ok": True})
    return res


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
    dropped records of a long kernel now and then (at times the last two
    of ten 1 ms launches in each of three profiles); such a profile is
    taken again, up to ``profiles`` times in all, and the records it had
    are printed.  If none is whole, ``ms`` is each kernel's mean record
    times its launches a call, from the last profile's records, and a
    line says so.  The profiler has also returned profiles with no device
    record at all, three in a row; if the last one has none, ``ms`` is
    ``event_ms`` and ``clock`` says ``cuda_events`` (else ``profiler``).
    ``profiles`` counts the profiles taken and ``lost_records`` says
    whether none was whole; with ``profiles=0`` no profile is taken and
    ``ms`` is ``event_ms``, for calls long enough that the host runs
    ahead of the device."""
    import torch

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
    event_ms = statistics.median(times)
    if profiles == 0:
        return {"ms": event_ms, "event_ms": event_ms, "profiles": 0,
                "lost_records": False, "clock": "cuda_events"}
    for taken in range(1, profiles + 1):
        prof = profile_calls(fn, iters)
        events = device_events(prof)
        if events and all(e.count % iters == 0 for e in events):
            break
        emit({"profiler_lost_records": events and _lost_records(
            prof, events, iters)})
    else:
        if not events:
            emit({"profiler_recorded_no_device_time": {
                "profiles": profiles, "event_ms": event_ms}})
            return {"ms": event_ms, "event_ms": event_ms,
                    "profiles": profiles, "lost_records": True,
                    "clock": "cuda_events"}
        device = sum(e.device_time_total / e.count
                     * max(1, round(e.count / iters)) for e in events) / 1e3
        emit({"profiler_lost_records_in_every_profile": {
            "profiles": profiles, "ms_from_kept_records": device,
            "event_ms": event_ms}})
        return {"ms": device, "event_ms": event_ms, "profiles": profiles,
                "lost_records": True, "clock": "profiler"}
    device = sum(e.device_time_total for e in events) / 1e3
    return {"ms": device / iters, "event_ms": event_ms, "profiles": taken,
            "lost_records": False, "clock": "profiler"}


def profile_calls(fn, iters: int):
    """One profile of ``iters`` calls of ``fn``, each call in a
    record_function range of its own."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            with record_function(f"time_ms call {i}"):
                fn()
        torch.cuda.synchronize()
    return prof


def warm_profiler(torch, tries: int = 5) -> dict:
    """Profiles of a few small kernels until one records device time, up
    to ``tries``, before phase 3's first timing: the profiler's first
    sessions in a process have come back without device records."""
    x = torch.ones(1 << 20, device="cuda")
    for taken in range(1, tries + 1):
        events = device_events(profile_calls(lambda: x.mul_(1.0), 10))
        if events:
            break
    out = {"profiles": taken, "device_time": bool(events)}
    emit({"profiler_warmup": out})
    return out


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
            "profiles": {k: v and v["profiles"] for k, v in t.items()},
            "clock": {k: v and v["clock"] for k, v in t.items()}}


def bound(bytes_moved: float, flops: float,
          peak_flops: float = PEAK_BF16_FLOPS,
          exps: float = 0) -> tuple[float, str]:
    """The least time (ms) the card takes to move ``bytes_moved`` and do
    the operations: ``flops`` on the tensor cores at ``peak_flops`` and
    ``exps`` exponentials on the special-function units at PEAK_EXP,
    which run beside the tensor cores (the larger of the two counts);
    and which of bytes and operations sets it."""
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = max(flops / peak_flops, exps / PEAK_EXP) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def causal_pairs(T: int, causal: bool) -> int:
    return T * (T + 1) // 2 if causal else T * T


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------


def check_rms_norm(torch, gen) -> dict:
    """B5 against its plain version: the main path's rows, bf16, fp16 and
    f32, a weight in another dtype than x, the persistent walk's tail
    (N = 1, 4097), the general body (a ragged D, an x off 16 bytes), and
    the 7B's and Mixtral's width; then the row-block kernel it replaced,
    the yardstick, on the main rows.  Returns each one's largest error on the
    main rows."""
    from pytorch_operator_tpu_torch.ops.rms_norm import (
        ROWBLOCK_KERNEL,
        rms_norm_cuda,
        rms_norm_reference,
    )

    worst = {}
    main = MAIN["B"] * MAIN["T"]
    # label: (N, D, x dtype, weight dtype, x's offset in elements)
    for label, (N, D, dtype, wdtype, offset) in {
            "main": (main, 2048, BF16, BF16, 0),
            "ragged": (21, 100, BF16, BF16, 0),
            "f32": (main, 2048, F32, F32, 0),
            "fp16": (main, 2048, F16, F16, 0),
            "bf16_w_f32": (main, 2048, BF16, F32, 0),
            "n1": (1, 2048, BF16, BF16, 0),
            "n4097": (4097, 2048, BF16, BF16, 0),
            "unaligned": (main, 2048, BF16, BF16, 1),
            "d4096": (RMS_WIDE["N"], RMS_WIDE["D"], BF16, BF16, 0),
            "rowblock": (main, 2048, BF16, BF16, 0)}.items():
        dt = getattr(torch, dtype)
        buf = torch.randn(N * D + offset, generator=gen, device="cuda")
        x = buf.to(dt)[offset:].view(N, D)
        w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(
            getattr(torch, wdtype))
        kw = {"kernel": ROWBLOCK_KERNEL} if label == "rowblock" else {}
        got = rms_norm_cuda(x, w, 1e-5, **kw).float()
        ref = rms_norm_reference(x, w, 1e-5).float()
        torch.cuda.synchronize()
        err = (got - ref).abs()
        # both round the same f32 math (summed in another order) to the
        # output dtype: at most one ulp of it apart
        ulp = RMS_ULP[dtype]
        ok = bool((err <= ulp * ref.abs() + 1e-6).all())
        worst[label] = float(err.max())
        emit({"check": "rms_norm", "case": label, "shape": [N, D],
              "dtype": dtype, "weight_dtype": wdtype, "offset": offset,
              "max_abs_err": worst[label],
              "tolerance": "|err| <= 1 ulp of the output dtype * |ref|: "
                           "same f32 math, sum of squares in another "
                           "order", "ok": ok})
        require(ok, f"rms_norm {label} disagrees with its plain version")
    return {"max_abs_err": worst["main"], "rowblock": worst["rowblock"]}


# one ulp of B5's output, relative: bf16 and fp16 keep 7 and 10 bits
# after the point; f32's bound of 2^-22 leaves room for rsqrtf
RMS_ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10,
           "float32": 2.0 ** -22}


BF16, F32, F16 = "bfloat16", "float32", "float16"

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
    # the Hopper B1 and B2 on narrow slabs at 16-bit D 16/32: GQA at a
    # ragged T, fp16, T = 1, T = 129 (one 128-row q tile and a row), both
    # layouts, causal and not
    "d32_gqa_ragged": (2, 333, 8, 2, 32, True, False, BF16),
    "fp16_d16_gqa_ragged": (2, 333, 8, 4, 16, True, False, F16),
    "fp16_d32_gqa": (2, 1000, 16, 4, 32, True, False, F16),
    "d32_non_causal_bh": (1, 1000, 16, 4, 32, False, True, BF16),
    "d32_t1_gqa": (2, 1, 16, 4, 32, True, False, BF16),
    "d32_t129": (2, 129, 8, 8, 32, True, False, BF16),
    "d16_gqa_bh": (1, 500, 8, 2, 16, True, True, BF16),
    "fp16_d32_non_causal_bh": (1, 1000, 16, 4, 32, False, True, F16),
    "fp16_d16_non_causal": (2, 333, 8, 8, 16, False, False, F16),
    "f32": (2, 1000, 16, 16, 128, True, False, F32),
    "f32_d16_gqa": (2, 333, 8, 4, 16, True, False, F32),
    # the Hopper TF32 B1 (64-key tiles) and B2 (128-row q tiles) at f32 D
    # 32 and 16: GQA at a ragged T, non-causal in the bh layout, T = 2, T
    # = 129 (one 128-row q tile and a row).  Not T = 1: there the plain
    # grads are exactly 0 and a TF32 kernel's are not (dP from dO rounded
    # to TF32, delta from the f32 dO: tests/test_torch_cuda.py
    # test_sm90_f32_match_plain)
    "f32_d32_gqa_ragged": (2, 333, 8, 2, 32, True, False, F32),
    "f32_d32_non_causal_bh": (1, 1000, 16, 4, 32, False, True, F32),
    "f32_d32_t2_gqa": (2, 2, 16, 4, 32, True, False, F32),
    "f32_d32_t129": (2, 129, 8, 8, 32, True, False, F32),
    "f32_d16_bh": (1, 500, 8, 2, 16, True, True, F32),
    "f32_d16_t2_gqa_bh": (2, 2, 16, 4, 16, True, True, F32),
    "f32_d16_t129_non_causal": (2, 129, 8, 8, 16, False, False, F32),
    "with_lse_bh": (1, 1000, 32, 16, 128, True, True, BF16),
    # the MoE path's attention (phase 15, phase 13's MoE runs): Mixtral's
    # 32 heads over 8 kv heads at T4096, still the fused backward
    "moe_t4096_gqa": (1, 4096, 32, 8, 128, True, False, BF16),
    # fp16 and D 256 on the Hopper kernels (fp16 at the main
    # shape, D 256 in bf16 and fp16, GQA at a ragged T, the bh layout),
    # head dims zero-padded to the kernels' (96 -> 128, 48 -> 64 and 200 ->
    # 256, all Hopper) and B*H = 65,536 (the grid's y limit is 65,535)
    "fp16_d64_gqa": (2, 1000, 16, 4, 64, True, False, F16),
    "fp16_d128_main": (2, 2048, 16, 16, 128, True, False, F16),
    "fp16_d256": (1, 1000, 8, 8, 256, True, False, F16),
    "fp16_d256_gqa_ragged": (2, 333, 8, 2, 256, True, False, F16),
    "d256_bf16": (1, 1000, 8, 8, 256, True, False, BF16),
    "d256_bf16_bh": (1, 1000, 8, 4, 256, False, True, BF16),
    "d96_padded": (2, 1000, 16, 16, 96, True, False, BF16),
    "d48_padded_non_causal": (2, 333, 8, 2, 48, False, False, BF16),
    "d200_padded_bh": (1, 500, 8, 4, 200, True, True, BF16),
    "bh65536": (4096, 65, 16, 8, 64, True, False, BF16),
    # f32 at D 256 on the Hopper TF32 kernels (B2 on clusters of two CTAs,
    # C3), and D 160 padded to it
    "f32_d256_gqa": (2, 1000, 8, 4, 256, True, False, F32),
    "f32_d160_padded_bh": (1, 333, 8, 8, 160, False, True, F32),
    # f32 on the Hopper kernels (TF32 wgmma): D 64 with GQA at a ragged T
    # and in the bh layout, D 128 at the main shape
    "f32_d64_gqa_ragged": (2, 333, 8, 2, 64, True, False, F32),
    "f32_d64_bh": (1, 1000, 16, 4, 64, False, True, F32),
    "f32_d128_main": (2, 2048, 16, 16, 128, True, False, F32),
}

# The two-kernel route: T4096 at the long path's heads, then the same
# variety with the route forced (_FUSED_DQ_BYTES = 0), as the JAX tests
# force it.
TWO_KERNEL_CASES = {
    "main": (1, 4096, 16, 16, 128, True, False, BF16),
    "gqa_h16_kv4": (1, 4096, 16, 4, 128, True, False, BF16),
    "t1_gqa": (2, 1, 16, 4, 128, True, False, BF16),
    "ragged_t1000": (2, 1000, 16, 16, 128, True, False, BF16),
    "non_causal": (1, 2048, 16, 16, 128, False, False, BF16),
    "d64_gqa_ragged": (2, 333, 8, 2, 64, True, False, BF16),
    "d64_non_causal_bh": (1, 1000, 16, 4, 64, False, True, BF16),
    "d32": (2, 500, 8, 8, 32, True, False, BF16),
    "d16_gqa": (2, 500, 8, 4, 16, True, False, BF16),
    # the Hopper B1, B3 and B4 on narrow slabs at 16-bit D 16/32, as in
    # FLASH_CASES
    "d32_gqa_ragged": (2, 333, 8, 2, 32, True, False, BF16),
    "fp16_d16_gqa_ragged": (2, 333, 8, 4, 16, True, False, F16),
    "fp16_d32_gqa": (2, 1000, 16, 4, 32, True, False, F16),
    "d32_non_causal_bh": (1, 1000, 16, 4, 32, False, True, BF16),
    "d32_t1_gqa": (2, 1, 16, 4, 32, True, False, BF16),
    "d32_t129": (2, 129, 8, 8, 32, True, False, BF16),
    "d16_gqa_bh": (1, 500, 8, 2, 16, True, True, BF16),
    "fp16_d32_non_causal_bh": (1, 1000, 16, 4, 32, False, True, F16),
    "fp16_d16_non_causal": (2, 333, 8, 8, 16, False, False, F16),
    "f32": (1, 2048, 16, 16, 128, True, False, F32),
    "f32_d16_gqa": (2, 333, 8, 4, 16, True, False, F32),
    # the Hopper TF32 B1, B3 and B4 at f32 D 32 and 16, as in FLASH_CASES
    "f32_d32_gqa_ragged": (2, 333, 8, 2, 32, True, False, F32),
    "f32_d32_non_causal_bh": (1, 1000, 16, 4, 32, False, True, F32),
    "f32_d32_t2_gqa": (2, 2, 16, 4, 32, True, False, F32),
    "f32_d32_t129": (2, 129, 8, 8, 32, True, False, F32),
    "f32_d16_bh": (1, 500, 8, 2, 16, True, True, F32),
    "f32_d16_t2_gqa_bh": (2, 2, 16, 4, 16, True, True, F32),
    "f32_d16_t129_non_causal": (2, 129, 8, 8, 16, False, False, F32),
    "with_lse_bh": (1, 1000, 32, 16, 128, True, True, BF16),
    "fp16_d128": (2, 1000, 16, 4, 128, True, False, F16),
    "d96_padded": (2, 1000, 16, 16, 96, True, False, BF16),
    "d256_bf16": (1, 1000, 8, 8, 256, True, False, BF16),
    # the Hopper B3 and B4 at fp16 and D 256, and at f32 D 256 (both on
    # clusters of two CTAs)
    "fp16_d256": (1, 1000, 8, 8, 256, True, False, F16),
    "fp16_d256_gqa_bh": (1, 500, 8, 2, 256, False, True, F16),
    "bh65536_fp16": (4096, 65, 16, 8, 64, True, False, F16),
    "f32_d256": (1, 1000, 8, 8, 256, True, False, F32),
    "f32_d256_gqa_ragged": (2, 333, 8, 2, 256, True, False, F32),
    "f32_d256_gqa_bh": (1, 500, 8, 2, 256, False, True, F32),
    # the Hopper TF32 B3 and B4 at f32 D 64 and 128
    "f32_d64_gqa_ragged": (2, 333, 8, 2, 64, True, False, F32),
    "f32_d64_bh": (1, 1000, 16, 4, 64, False, True, F32),
    "f32_d128_main": (2, 2048, 16, 16, 128, True, False, F32),
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


def _grad_errs(got, ref) -> tuple[dict, bool]:
    """Max abs, max |ref| and Frobenius errors of one gradient, and
    whether it is within the flash_bwd checks' bounds."""
    err, rel = _rel_errs(got, ref)
    scale_ref = float(ref.abs().max())
    return ({"max_abs_err": err, "max_abs_ref": scale_ref,
             "rel_fro_err": rel},
            err <= 1e-2 * scale_ref and rel <= 1e-2)


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


FLASH_SYMBOLS = ("flash_fwd_sm90", "flash_bwd_sm90", "flash_bwd_dq_sm90",
                 "flash_bwd_dkv_sm90", "flash_fwd", "flash_bwd",
                 "flash_bwd_dq", "flash_bwd_dkv")


def flash_launches(torch, dtype, D, two) -> dict:
    """The launches of one forward and backward: each kernel's Hopper or
    WMMA version by the route (ops/flash_attention.py _sm90: B1-B4 Hopper
    at every dtype and D); the fused backward, or B3 + B4 on the
    two-kernel route."""
    from pytorch_operator_tpu_torch.ops.flash_attention import (
        _kernel_dim,
        _sm90,
    )

    dt, Dk = getattr(torch, dtype), _kernel_dim(D)
    want = dict.fromkeys(FLASH_SYMBOLS, 0)
    for kernel, name in (("fwd", "flash_fwd"), ("bwd", "flash_bwd"),
                         ("dq", "flash_bwd_dq"), ("dkv", "flash_bwd_dkv")):
        if {"fwd": True, "bwd": not two}.get(kernel, two):
            want[name + ("_sm90" if _sm90(kernel, dt, Dk) else "")] = 1
    return want


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


# Every instantiation of the Hopper B2 / B4 walk (dtype, D)
SM90_WALKS = ((BF16, 16), (BF16, 32), (BF16, 64), (BF16, 128), (BF16, 256),
              (F16, 16), (F16, 32), (F16, 64), (F16, 128), (F16, 256),
              (F32, 16), (F32, 32), (F32, 64), (F32, 128), (F32, 256))


def check_dkv_bitwise(torch, gen) -> dict:
    """The Hopper B4 is B2's walk without dq: at every instantiation its
    dk / dv equal B2's bit for bit on the same inputs (GQA H16 / Hk4,
    ragged T1000, causal in the (B, T, H, D) layout and not in the bh
    one)."""
    from pytorch_operator_tpu_torch.ops.flash_attention import (
        BWD_DKV_SM90_KERNEL,
        BWD_SM90_KERNEL,
        _flash_bwd_cuda,
        _flash_bwd_dkv_cuda,
    )

    res = {}
    for dtype, D in SM90_WALKS:
        for causal, bh in ((True, False), (False, True)):
            args = _bwd_args(torch, gen, 1, 1000, 16, D, dtype=dtype, Hk=4,
                             causal=causal, bh=bh)
            _, dkp, dvp = _flash_bwd_cuda(*args, kernel=BWD_SM90_KERNEL)
            dkp2, dvp2 = _flash_bwd_dkv_cuda(*args,
                                             kernel=BWD_DKV_SM90_KERNEL)
            torch.cuda.synchronize()
            res[f"{dtype}_d{D}_{'causal' if causal else 'bh'}"] = bool(
                torch.equal(dkp, dkp2) and torch.equal(dvp, dvp2))
            del args, dkp, dvp, dkp2, dvp2
    ok = all(res.values())
    emit({"check": "sm90_dkv_bitwise_b2", "cases": res,
          "tolerance": "B4's dk and dv bit for bit B2's", "ok": ok})
    require(ok, f"the Hopper B4's dk/dv differ from B2's: {res}")
    return res


# Every instantiation of the Hopper B3 (dtype, D)
SM90_DQS = ((BF16, 16), (BF16, 32), (BF16, 64), (BF16, 128), (BF16, 256),
            (F16, 16), (F16, 32), (F16, 64), (F16, 128), (F16, 256),
            (F32, 16), (F32, 32), (F32, 64), (F32, 128), (F32, 256))


def check_dq_bitwise(torch, gen) -> dict:
    """The Hopper B3 sums each dq element in one thread and writes it
    once: at every instantiation two runs on the same inputs give the
    same bits (GQA H16 / Hk4, ragged T1000, causal in the (B, T, H, D)
    layout and not in the bh one).  Beside that its dq against the
    Hopper B2's on the same inputs, within the flash_bwd checks' bounds
    (B3 rounds dq to the input type; B2 sums it in f32 atomics)."""
    from pytorch_operator_tpu_torch.ops.flash_attention import (
        BWD_DQ_SM90_KERNEL,
        BWD_SM90_KERNEL,
        _flash_bwd_cuda,
        _flash_bwd_dq_cuda,
    )

    res, vs_fused = {}, {}
    for dtype, D in SM90_DQS:
        for causal, bh in ((True, False), (False, True)):
            args = _bwd_args(torch, gen, 1, 1000, 16, D, dtype=dtype, Hk=4,
                             causal=causal, bh=bh)
            first = _flash_bwd_dq_cuda(*args, kernel=BWD_DQ_SM90_KERNEL)
            second = _flash_bwd_dq_cuda(*args, kernel=BWD_DQ_SM90_KERNEL)
            fused = _flash_bwd_cuda(*args, kernel=BWD_SM90_KERNEL)[0]
            torch.cuda.synchronize()
            case = f"{dtype}_d{D}_{'causal' if causal else 'bh'}"
            res[case] = bool(torch.equal(first, second))
            errs, close = _grad_errs(first, fused)
            vs_fused[case] = {**errs, "ok": close}
            del args, first, second, fused
    ok = all(res.values()) and all(e["ok"] for e in vs_fused.values())
    emit({"check": "sm90_dq_bitwise_stable", "cases": res,
          "vs_fused": vs_fused,
          "tolerance": "B3's dq bit for bit equal over two runs; against "
                       "B2's, max|err| <= 1e-2 * max|ref| and rel <= 1e-2",
          "ok": ok})
    require(ok, f"the Hopper B3's dq differs between two runs or from "
                f"B2's: {res}, {vs_fused}")
    return res


def check_wmma_at_main(torch, gen) -> dict:
    """The WMMA forward and fused backward (flash_fwd.cu, flash_bwd.cu),
    which no call reaches, at the main path's shape in bf16 and in f32
    against their plain versions, and the WMMA forward and dq kernel
    (flash_bwd_dq.cu) at phase 3's f32 D 32 and 16 shapes (B2 x T2048, H
    D 2048), so that the yardsticks phase 3 times beside the Hopper
    kernels compute the same function.  Returns the bf16 max abs errors."""
    from pytorch_operator_tpu_torch.ops.flash_attention import (
        BWD_DQ_KERNEL,
        BWD_KERNEL,
        FWD_KERNEL,
        _flash_bwd_cuda,
        _flash_bwd_dq_cuda,
        _flash_bwd_dq_reference,
        _flash_bwd_reference,
        _flash_fwd_cuda,
        _flash_fwd_reference,
    )

    B, T, H, D = (MAIN[x] for x in "BTHD")
    worst = {}
    for dtype in (BF16, F32):
        q, k, v, g = _flash_inputs(torch, gen, B, T, H, H, D, False, dtype)
        scale = D ** -0.5
        out, lse = _flash_fwd_cuda(q, k, v, scale, True, False,
                                   kernel=FWD_KERNEL)
        ref_out, ref_lse = _flash_fwd_reference(q.float(), k.float(),
                                                v.float(), scale, True,
                                                False)
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
        l_tol = 1e-3 if dtype == BF16 else 1e-2
        ok = o_err <= 2e-2 and o_rel <= 1e-2 and l_err <= l_tol
        errs = {}
        for gname, a, b in zip(("dq", "dk", "dv"), got, ref):
            errs[gname], grad_ok = _grad_errs(a, b)
            ok &= grad_ok
        del got, ref
        emit({"check": "wmma_at_main", "shape": [B, T, H, H, D],
              "dtype": dtype,
              "out": {"max_abs_err": o_err, "rel_fro_err": o_rel,
                      "lse_max_abs_err": l_err}, **errs,
              "tolerance": "as the flash_fwd and flash_bwd checks, the "
                           "backward given the kernel's own lse and delta",
              "ok": ok})
        require(ok, f"a WMMA flash kernel disagrees with its plain version "
                    f"at the main path's shape in {dtype}")
        if dtype == BF16:
            worst = {"flash_fwd": o_err,
                     "flash_bwd": max(e["max_abs_err"]
                                      for e in errs.values())}
        del q, k, v, g, out, lse, args
    for name in ("f32_d32", "f32_d16"):
        _, D, H = C3_CASES[name]
        q, k, v, g = _flash_inputs(torch, gen, B, T, H, H, D, False, F32)
        scale = D ** -0.5
        out, lse = _flash_fwd_cuda(q, k, v, scale, True, False,
                                   kernel=FWD_KERNEL)
        ref_out, ref_lse = _flash_fwd_reference(q, k, v, scale, True, False)
        o_err, o_rel = _rel_errs(out, ref_out)
        l_err, _ = _rel_errs(lse, ref_lse)
        del ref_out, ref_lse
        delta = (g * out).sum(-1).transpose(1, 2).reshape(B * H,
                                                          T).contiguous()
        args = (q, k, v, g, lse.reshape(B * H, T), delta, scale, True, False)
        got = _flash_bwd_dq_cuda(*args, kernel=BWD_DQ_KERNEL)
        dq, dq_ok = _grad_errs(got, _flash_bwd_dq_reference(*args))
        torch.cuda.synchronize()
        ok = o_err <= 2e-2 and o_rel <= 1e-2 and l_err <= 1e-2 and dq_ok
        emit({"check": "wmma_at_main", "shape": [B, T, H, H, D],
              "dtype": F32, "kernels": ["flash_fwd", "flash_bwd_dq"],
              "out": {"max_abs_err": o_err, "rel_fro_err": o_rel,
                      "lse_max_abs_err": l_err}, "dq": dq,
              "tolerance": "as the flash_fwd and flash_bwd checks, dq "
                           "given the kernel's own lse and delta",
              "ok": ok})
        require(ok, f"a WMMA flash kernel disagrees with its plain version "
                    f"at phase 3's {name} shape")
        del q, k, v, g, out, lse, args, got
        torch.cuda.empty_cache()
    return worst


def _bwd_args(torch, gen, B, T, H, D, dtype=BF16, Hk=None, causal=True,
              bh=False):
    """Backward-kernel arguments at (B, T, H, D), causal bf16 in the (B,
    T, H, D) layout unless said otherwise: q, k, v, g, lse, delta, scale,
    causal, layout."""
    from pytorch_operator_tpu_torch.ops.flash_attention import (
        _flash_fwd_cuda,
    )

    q, k, v, g = _flash_inputs(torch, gen, B, T, H, Hk or H, D, bh, dtype)
    scale = D ** -0.5
    out, lse = _flash_fwd_cuda(q, k, v, scale, causal, bh)
    delta = (g.float() * out.float()).sum(-1)
    if not bh:
        delta = delta.transpose(1, 2)
    return (q, k, v, g, lse.reshape(B * H, T),
            delta.reshape(B * H, T).contiguous(), scale, causal, bh)


# The heads of the long shape held against the plain versions: with
# H == Hk each head is independent, and one head's f32 (T, T) buffer is
# 1 GiB at T16384, where all sixteen at once would take about 70 GB.
LONG_PLAIN_HEADS = (0, 15)


def check_long_routes(torch, gen) -> dict:
    """At the long path's full shape (B1 T16384 H16 D128 causal bf16):
    B1 and the Hopper and WMMA B3 and B4 launched on every head, and
    their outputs on the heads LONG_PLAIN_HEADS held against the plain
    versions on those heads' inputs (B3 and B4 given B1's lse and the
    delta of its out).  Beside that, the Hopper B3 + B4 against the
    Hopper fused kernel B2 on every head: B4's dk/dv bitwise equal to
    B2's (the same walk), B3's dq within the bounds; and B3's dq bitwise
    equal over two runs.  Returns the max abs errors against the plain
    versions."""
    from pytorch_operator_tpu_torch.ops.flash_attention import (
        BWD_DKV_KERNEL,
        BWD_DQ_KERNEL,
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
    kernels = {"sm90": {"dq": dq, "dk": dkp, "dv": dvp},
               "wmma": dict(zip(("dq", "dk", "dv"), (
                   _flash_bwd_dq_cuda(*args, kernel=BWD_DQ_KERNEL),
                   *_flash_bwd_dkv_cuda(*args, kernel=BWD_DKV_KERNEL))))}
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
    plain = {"dq": _flash_bwd_dq_reference(*plain_args)}
    plain.update(zip(("dk", "dv"), _flash_bwd_dkv_reference(*plain_args)))
    errs = {"out": {"max_abs_err": o_err, "rel_fro_err": o_rel,
                    "lse_max_abs_err": l_err}}
    plain_ok = o_err <= 2e-2 and o_rel <= 1e-2 and l_err <= 1e-3
    for version, grads in kernels.items():
        errs[version] = {}
        for name, ref in plain.items():
            errs[version][name], ok = _grad_errs(sl(grads[name]), ref)
            plain_ok &= ok
    del plain

    bitwise = {"dq_over_two_runs": bool(torch.equal(dq, dq_again)),
               "dk_dv_equal_fused": bool(torch.equal(dkp, dkp2)
                                         and torch.equal(dvp, dvp2))}
    vs_fused = {}
    fused_ok = True
    for name, a, b in (("dq", dq, dq2), ("dk", dkp, dkp2),
                       ("dv", dvp, dvp2)):
        vs_fused[name], ok = _grad_errs(a, b)
        fused_ok &= ok
    ok = plain_ok and all(bitwise.values()) and fused_ok
    res = {"check": "flash_bwd_long_routes", "shape": [B, T, H, H, D],
           "plain_heads": heads, "vs_plain": errs, "bitwise": bitwise,
           "vs_fused": vs_fused,
           "tolerance": "against the plain versions on the heads "
                        f"{heads}: out and lse as the flash_fwd checks "
                        "(out max|err| <= 2e-2 and rel <= 1e-2, lse 1e-3), "
                        "dq and the dk/dv partials of the Hopper (sm90) and "
                        "WMMA B3/B4 as the flash_bwd checks (max|err| <= "
                        "1e-2 * max|ref| and rel <= 1e-2 against the f32 "
                        "plain versions: p or ds rounded to bf16 before "
                        "their products, dq cast to bf16); the Hopper B3 + "
                        "B4 against the Hopper fused B2 on every head, the "
                        "same bounds (B3 forms ds from the f32 p, B2 from p "
                        "rounded to bf16; B3 rounds dq to bf16; B2's f32 "
                        "atomics sum in another order), and B4's dk/dv "
                        "bitwise equal to B2's; dq of B3 bitwise equal "
                        "over two runs",
           "ok": ok}
    emit(res)
    require(ok, "at the long shape a kernel disagrees with its plain "
                "version, the two-kernel backward with the fused one, B3's "
                "dq is not bitwise stable or B4's dk/dv not bitwise B2's")
    worst = {version: {"dq": e["dq"]["max_abs_err"],
                       "dkv": max(e["dk"]["max_abs_err"],
                                  e["dv"]["max_abs_err"])}
             for version, e in errs.items() if version != "out"}
    # the Hopper B4's dk beside the WMMA B4's, both against the plain
    # version on the same heads
    emit({"dk_vs_plain_at_T16384": {v: errs[v]["dk"] for v in kernels}})
    return {"out": o_err, **worst}


# --------------------------------------------------------------------------
# phase 3: timing
# --------------------------------------------------------------------------


def aten_flash_bwd(torch, q, k, v, g, scale, errors=None):
    """The backward alone of PyTorch's flash attention (dq, dk and dv) on
    (B, T, H, D) causal inputs, as a callable: aten's private op, whose
    signature may move between releases, and which refuses some dtypes
    and head dims (None if so; the reason is printed and appended to
    ``errors``)."""
    qt, kt, vt, gt = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    try:
        lib = torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, True, False, scale=scale)
    except (RuntimeError, TypeError, AttributeError) as e:
        emit({"timing": "aten flash backward", "library_error": repr(e)})
        if errors is not None:
            errors.append(repr(e))
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
                "lost_records": a["lost_records"] or b["lost_records"],
                "clock": (a["clock"] if a["clock"] == b["clock"]
                          else "mixed"),
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

    res = {}
    # B5 at (a), the main path's rows, and the row-block kernel beside it
    res["rms_norm"] = time_rms_norm_row(torch, gen, *RMS_ROWS[0])
    res["rms_norm_rowblock"] = res["rms_norm"]["rowblock_row"]

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
                      bound(4 * io + B * H * T * 4, 4 * Dh * pairs,
                            exps=pairs)))}
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
                      bound(7 * io + 2 * B * H * T * 4, 10 * Dh * pairs,
                            exps=pairs)))}

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


# phase 3's short_t_forward rows: forward-only calls, which the JAX module
# sends to dense XLA at T <= 1024 (its TPU-tuned _DENSE_FWD_MAX_T), timed
# at each T through B1 and through the port's _dense_path; (B, H, Hk, D,
# dtype) a shape
SHORT_T = (128, 256, 512, 1024, 2048)
SHORT_T_SHAPES = {
    "a_pp_tick": (1, 32, 32, 128, BF16),  # the 1F1B forward tick (--pp)
    "b_flagship": (2, 16, 16, 128, BF16),  # inference of the flagship
    "c_tiny_f32": (1, 8, 4, 16, F32),  # llama.tiny, train_llama's default
}
# dense wins at a (shape, T) only where its device time is below B1's by
# more than this share in both of two in-turns timings
DENSE_WIN = 0.05
# the forward-only row of PERF.md's kernel table (the 1F1B tick at T1024),
# where B1 is also timed beside SDPA
SHORT_T_LIBRARY = ("a_pp_tick", 1024)


def _time_short_t_library(torch, b1, q, k, v, scale) -> dict:
    """B1 under no_grad in turns with ``F.scaled_dot_product_attention``
    on the same inputs, laid out (B, H, T, D) for it."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    new, lib = in_turns(b1, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale))
    return {"shape": list(SHORT_T_LIBRARY), "ms": new["ms"],
            "library_ms": lib["ms"], "turns_ms": new["turns_ms"],
            "library_turns_ms": lib["turns_ms"],
            "clock": [new["clock"], lib["clock"]],
            "library": "torch.nn.functional.scaled_dot_product_attention "
                       "under torch.no_grad(), in turns"}


def time_short_t_forward(torch, gen) -> dict:
    """Phase 3's short_t_forward rows: at each SHORT_T_SHAPES shape and T
    in SHORT_T, causal, under torch.no_grad(), ``flash_attention`` (B1)
    against ``_dense_path`` on the same inputs, in turns, twice.  A row's
    verdict is "dense" where the dense path's profiler device time is
    below B1's by more than DENSE_WIN in both timings, else "b1"; the
    timings are taken once more if a profile lost records in every take,
    and a row still not whole says "not_whole" and sets nothing.
    ``crossover_t`` is the largest T at which dense wins at that T and at
    every smaller one at both bf16 shapes (0: nowhere, which is what the
    port's dispatch assumes: it has no short-T dense route, so every
    call must launch B1)."""
    from pytorch_operator_tpu_torch import kernels
    from pytorch_operator_tpu_torch.ops.flash_attention import (
        _dense_path,
        flash_attention,
    )

    rows, verdicts, library = [], {}, None
    for shape, (B, H, Hk, D, dtype) in SHORT_T_SHAPES.items():
        peak = PEAK_TF32_FLOPS if dtype == F32 else PEAK_BF16_FLOPS
        size = 4 if dtype == F32 else 2
        for T in SHORT_T:
            q, k, v, _ = _flash_inputs(torch, gen, B, T, H, Hk, D, False,
                                       dtype)
            scale = D ** -0.5

            def b1(q=q, k=k, v=v):
                return flash_attention(q, k, v, causal=True)

            def dense(q=q, k=k, v=v, scale=scale):
                return _dense_path(q, k, v, scale, True)

            with torch.no_grad():
                before = kernels.KERNELS["flash_fwd_sm90"].launches
                err = _rel_errs(b1(), dense())
                launched = kernels.KERNELS["flash_fwd_sm90"].launches - before
                require(launched == 1,
                        f"short_t_forward {shape} T{T}: flash_attention "
                        f"launched B1 {launched} times under no_grad")
                if (shape, T) == SHORT_T_LIBRARY:
                    library = _time_short_t_library(torch, b1, q, k, v,
                                                    scale)
                for attempt in (1, 2):
                    turns = [in_turns(b1, dense) for _ in range(2)]
                    whole = not any(t["lost_records"] for pair in turns
                                    for t in pair)
                    if whole:
                        break
            pairs = B * H * causal_pairs(T, True)
            b_ms, b_by = bound(2 * B * T * (H + Hk) * D * size + B * H * T * 4,
                               4 * D * pairs, peak, exps=pairs)

            def side(i):
                return {"ms": statistics.mean(t[i]["ms"] for t in turns),
                        "event_ms": statistics.mean(t[i]["event_ms"]
                                                    for t in turns),
                        "timings_ms": [t[i]["ms"] for t in turns],
                        "timings_event_ms": [t[i]["event_ms"] for t in turns],
                        "profiles": sum(t[i]["profiles"] for t in turns),
                        "clock": sorted({t[i]["clock"] for t in turns})}

            wins = all(d["ms"] < (1 - DENSE_WIN) * b["ms"] for b, d in turns)
            event_wins = all(d["event_ms"] < (1 - DENSE_WIN) * b["event_ms"]
                             for b, d in turns)
            verdict = ("not_whole" if not whole
                       else "dense" if wins else "b1")
            verdicts[shape, T] = verdict
            rows.append({"shape": shape, "B": B, "T": T, "H": H, "Hk": Hk,
                         "D": D, "dtype": dtype, "b1": side(0),
                         "dense": side(1), "bound_ms": b_ms,
                         "bound_by": b_by, "b1_launches": launched,
                         "b1_vs_dense_max_abs_err": err[0],
                         "attempts": attempt, "whole": whole,
                         "verdict": verdict,
                         "event_verdict": "dense" if event_wins else "b1"})
    crossover = 0
    for T in SHORT_T:
        if not all(verdicts[s, T] == "dense" for s, spec in
                   SHORT_T_SHAPES.items() if spec[-1] == BF16):
            break
        crossover = T
    res = {"rows": rows, "crossover_t": crossover,
           "agrees_with_port": crossover == 0, "library": library,
           "rule": f"dense wins where its profiler device time is below "
                   f"B1's by more than {DENSE_WIN:.0%} in both of two "
                   f"in-turns timings (B1, dense, dense, B1); crossover_t: "
                   f"the largest T with dense winning there and at every "
                   f"smaller T at both bf16 shapes"}
    emit({"timing": "short_t_forward", **res})
    return res


# B5 at the row width of Llama-2-7B and Mixtral-8x7B (the SP, pipeline
# and MoE paths): B1 x T4096 tokens of D 4096
RMS_WIDE = dict(N=4096, D=4096)
# phase 3's B5 rows (label, N, D, dtype): (a) the flagship's B2 x T2048
# rows, (b) the 7B's and Mixtral's width, (c) fp16 and (d) f32 at (a)
RMS_ROWS = (("d2048", MAIN["B"] * MAIN["T"], 2048, "bfloat16"),
            ("d4096", RMS_WIDE["N"], RMS_WIDE["D"], "bfloat16"),
            ("fp16", MAIN["B"] * MAIN["T"], 2048, "float16"),
            ("f32", MAIN["B"] * MAIN["T"], 2048, "float32"))
# f32 outside the tensor cores (H100 SXM data sheet): B5's arithmetic
PEAK_F32_FLOPS = 67e12


def time_rms_norm_row(torch, gen, label, N, D, dtype) -> dict:
    """One of phase 3's B5 rows: the Hopper kernel in turns with the
    row-block kernel it replaced, then in turns with ``F.rms_norm``, on the same
    inputs (x and the weight in ``dtype``; four copies of x cycled, so
    that no launch finds its input in the 50 MB L2); its plain version;
    its byte bound and the share of it reached.  ``ms`` is the time from
    the turns with the library; ``gap_to_library`` its excess over the
    library's, ``spread`` the wider of the two functions' relative
    differences between their turns, ``loses_beyond_spread`` a gap wider
    than the spread.  ``rowblock_row``: the yardstick's row for the
    kernels line."""
    import torch.nn.functional as F

    from pytorch_operator_tpu_torch.ops.rms_norm import (
        ROWBLOCK_KERNEL,
        rms_norm_cuda,
        rms_norm_reference,
    )

    dt = getattr(torch, dtype)
    x = torch.randn(N, D, generator=gen, device="cuda").to(dt)
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(dt)
    b_ms, b_by = bound(2 * N * D * x.element_size() + D * w.element_size(),
                       4 * N * D, PEAK_F32_FLOPS)
    xs = itertools.cycle([x.clone() for _ in range(4)])
    new_rb, rowblock = in_turns(
        lambda: rms_norm_cuda(next(xs), w, 1e-5),
        lambda: rms_norm_cuda(next(xs), w, 1e-5, kernel=ROWBLOCK_KERNEL))
    new, lib = in_turns(lambda: rms_norm_cuda(next(xs), w, 1e-5),
                        lambda: F.rms_norm(next(xs), (D,), w, 1e-5))
    plain = time_ms(lambda: rms_norm_reference(next(xs), w, 1e-5))
    spread = max(abs(a - b) / min(a, b)
                 for a, b in (new["turns_ms"], lib["turns_ms"]))
    gap = new["ms"] / lib["ms"] - 1
    where = {"library": "torch.nn.functional.rms_norm", "bound_ms": b_ms,
             "bound_by": b_by, "shape": [N, D], "dtype": dtype}
    res = {**timing_row(new, plain, lib), **where,
           "bound_share": b_ms / new["ms"],
           "turns_ms": new["turns_ms"], "library_turns_ms": lib["turns_ms"],
           "gap_to_library": gap, "spread": spread,
           "loses_beyond_spread": gap > spread,
           "previous_ms": rowblock["ms"],
           "previous_event_ms": rowblock["event_ms"],
           "ms_beside_previous": new_rb["ms"],
           "turns_beside_previous_ms": new_rb["turns_ms"],
           "previous_turns_ms": rowblock["turns_ms"],
           "beats_previous_in_both_turns": all(
               a < b for a, b in zip(new_rb["turns_ms"],
                                     rowblock["turns_ms"])),
           "previous": "the row-block kernel it replaced "
                       "(rms_norm_rowblock_fwd) on the same inputs, in "
                       "turns"}
    emit({"timing": f"rms_norm_{label}", **res})
    res["rowblock_row"] = {**timing_row(rowblock, plain, lib), **where}
    return res


def time_rms_norm_wide(torch, gen) -> dict:
    """Phase 3's B5 rows (b)-(d) of RMS_ROWS, by label
    (``time_rms_norm_row``; (a) is ``time_kernels``')."""
    return {label: time_rms_norm_row(torch, gen, label, *shape)
            for label, *shape in RMS_ROWS[1:]}


def time_long_kernels(torch, gen) -> dict:
    """At the long path's shape: B1 (Hopper and WMMA in turns) beside
    SDPA's forward; B3 and B4 (Hopper and WMMA in turns) beside their
    bounds, their plain versions at PLAIN_T and aten's flash backward
    (which computes dq, dk and dv: compare it with B3 + B4); then the
    fused kernel against the Hopper B3 + B4 at T8192 (where the rule
    still takes the fused one) and T16384."""
    import torch.nn.functional as F

    from pytorch_operator_tpu_torch.ops.flash_attention import (
        BWD_DKV_KERNEL,
        BWD_DQ_KERNEL,
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
                      bound(4 * io + B * H * T * 4, 4 * D * pairs,
                            exps=pairs)))}
    res["flash_fwd_sm90_long"] = {**timing_row(new, plain, sdpa), **fwd,
                                  **previous(new, old)}
    res["flash_fwd_long"] = {**timing_row(old, plain, sdpa), **fwd}
    for name in ("flash_fwd_sm90_long", "flash_fwd_long"):
        emit({"timing": name, **res[name]})

    library = aten_flash_bwd(torch, *args[:4], args[6])
    lib = library and time_ms(library, **few)
    for name, fn, plain, wmma, nbytes, flops in (
            ("flash_bwd_dq", _flash_bwd_dq_cuda, _flash_bwd_dq_reference,
             BWD_DQ_KERNEL, 5 * io + rows, 6 * D * pairs),
            ("flash_bwd_dkv", _flash_bwd_dkv_cuda, _flash_bwd_dkv_reference,
             BWD_DKV_KERNEL, 4 * io + rows + 2 * f32, 8 * D * pairs)):
        b_ms, b_by = bound(nbytes, flops, exps=pairs)
        new, old = in_turns(lambda fn=fn: fn(*args),
                            lambda fn=fn, kn=wmma: fn(*args, kernel=kn),
                            **few)
        plain_t = time_ms(lambda plain=plain: plain(*plain_args), **slow)
        row = {"library": "aten._scaled_dot_product_flash_attention_backward"
                          " (dq, dk and dv: compare with B3 + B4)",
               "bound_ms": b_ms, "bound_by": b_by, "shape": [B, T, H, H, D],
               "plain_shape": [B, PLAIN_T, H, H, D]}
        res[name + "_sm90"] = {**timing_row(new, plain_t, lib), **row,
                               **previous(new, old)}
        res[name] = {**timing_row(old, plain_t, lib), **row}
        for key in (name + "_sm90", name):
            emit({"timing": key, **res[key]})
    routes = {}
    for t in (8192, T):
        targs = args if t == T else _bwd_args(torch, gen, B, t, H, D)
        times = {name: time_ms(lambda fn=fn: fn(*targs), **few)
                 for name, fn in (("flash_bwd_sm90", _flash_bwd_cuda),
                                  ("flash_bwd_dq_sm90", _flash_bwd_dq_cuda),
                                  ("flash_bwd_dkv_sm90",
                                   _flash_bwd_dkv_cuda))}
        ms = {name: tm["ms"] for name, tm in times.items()}
        pairs_t = B * H * causal_pairs(t, True)
        routes[f"T{t}"] = {
            "shape": [B, t, H, H, D],
            "rule_takes": "fused" if _use_fused_bwd(t, D) else "two_kernel",
            "fused_ms": ms["flash_bwd_sm90"],
            "two_kernel_ms": ms["flash_bwd_dq_sm90"]
            + ms["flash_bwd_dkv_sm90"],
            "ms": ms,
            "event_ms": {name: tm["event_ms"] for name, tm in times.items()},
            "profiles": {name: tm["profiles"] for name, tm in times.items()},
            "fused_bound_ms": bound(0, 10 * D * pairs_t, exps=pairs_t)[0],
            "two_kernel_bound_ms": bound(0, 14 * D * pairs_t,
                                         exps=2 * pairs_t)[0]}
    emit({"timing": "fused_vs_two_kernel", **routes})
    res["routes"] = routes
    return res


# the MoE's and the pipeline's attention length, at Mixtral's heads (32 q
# heads over 8 kv heads, D128): B1 and B2, the fused backward's route
GQA_T4096 = dict(B=1, T=4096, H=32, Hk=8, D=128)
# the pipeline's microbatch (train_llama --pp 4 at the 7B width: B8 in 8
# microbatches of B1 x T4096, 32 heads, no GQA): B1 and B2
PIPE_T4096 = dict(B=1, T=4096, H=32, Hk=32, D=128)


def time_gqa_kernels(torch, gen, shape=GQA_T4096, label="gqa_t4096"
                     ) -> dict:
    """Phase 3's GQA_T4096 (or PIPE_T4096) row: B1 and B2 (causal, bf16)
    at ``shape``, each beside its plain version, its bound (q, dO and dq
    at H heads, k, v, dk and dv at Hk; lse and delta) and the library
    call on the same inputs with k and v expanded to the H q heads
    (SDPA's forward; aten's flash backward, whose dk and dv come per q
    head, as B2's f32 partials do)."""
    import torch.nn.functional as F

    from pytorch_operator_tpu_torch.ops.flash_attention import (
        _flash_bwd_cuda,
        _flash_bwd_reference,
        _flash_fwd_cuda,
        _flash_fwd_reference,
    )

    B, T, H, Hk, D = (shape[x] for x in ("B", "T", "H", "Hk", "D"))
    q, k, v, g = _flash_inputs(torch, gen, B, T, H, Hk, D, False)
    scale = D ** -0.5
    pairs = B * H * causal_pairs(T, True)
    ioq, iok, rows = B * T * H * D * 2, B * T * Hk * D * 2, B * H * T * 4
    slow = dict(warmup=1, iters=3, reps=3)  # the plain versions
    ke, ve = (x.repeat_interleave(H // Hk, dim=2) for x in (k, v))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, ke, ve))
    fwd = timed(lambda: _flash_fwd_cuda(q, k, v, scale, True, False),
                lambda: _flash_fwd_reference(q, k, v, scale, True, False),
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True),
                plain_kw=slow)
    out, lse = _flash_fwd_cuda(q, k, v, scale, True, False)
    args = (q, k, v, g, lse.reshape(B * H, T),
            (g.float() * out.float()).sum(-1).transpose(1, 2).reshape(
                B * H, T).contiguous(), scale, True, False)
    bwd = timed(lambda: _flash_bwd_cuda(*args),
                lambda: _flash_bwd_reference(*args),
                aten_flash_bwd(torch, q, ke, ve, g, scale), plain_kw=slow)
    res = {"shape": [B, T, H, Hk, D],
           "fwd": {**fwd, "library": "scaled_dot_product_attention, k and "
                                     f"v expanded to {H} heads",
                   **dict(zip(("bound_ms", "bound_by"),
                              bound(2 * ioq + 2 * iok + rows,
                                    4 * D * pairs, exps=pairs)))},
           "bwd": {**bwd, "library": "aten._scaled_dot_product_flash_"
                                     "attention_backward, k and v expanded",
                   **dict(zip(("bound_ms", "bound_by"),
                              bound(3 * ioq + 4 * iok + 2 * rows,
                                    10 * D * pairs, exps=pairs)))}}
    emit({"timing": label, **res})
    return res


def sdpa_efficient_bwd(torch, q, k, v, g, errors=None):
    """The backward alone of SDPA's memory-efficient attention (dq, dk and
    dv) on (B, T, H, D) causal inputs, as a callable: autograd of
    F.scaled_dot_product_attention under
    sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION), the graph kept and the
    backward alone timed.  It takes f32, which aten's flash backward
    refuses (None if it refuses the inputs; the reason is printed and
    appended to ``errors``)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    gt = g.transpose(1, 2).contiguous()
    try:
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    except RuntimeError as e:
        emit({"timing": "SDPA memory-efficient backward",
              "library_error": repr(e)})
        if errors is not None:
            errors.append(repr(e))
        return None
    return lambda: torch.autograd.grad(out, (qt, kt, vt), gt,
                                       retain_graph=True)


# C3's cases at the main path's length: fp16 and bf16 at D 256 and fp16
# at D 128 (the Hopper kernels, each beside its WMMA predecessor), f32 at
# D 64, 128 and 256 (the Hopper TF32 kernels, each beside its WMMA
# predecessor; the backward at D 256 on clusters of two CTAs), bf16 at D
# 96, zero-padded to the Hopper kernels' 128, bf16 and fp16 at D 32 and
# 16 (the Hopper B1-B4 on narrow slabs, each beside its WMMA
# predecessor) and f32 at D 32 and 16 (the Hopper TF32 B1-B4, each beside
# its WMMA predecessor), heads such that H D = 2048 (1536 at D 96):
# (dtype, D, heads)
C3_CASES = {"fp16_d256": (F16, 256, 8), "bf16_d256": (BF16, 256, 8),
            "fp16_d128": (F16, 128, 16), "f32_d256": (F32, 256, 8),
            "f32_d128": (F32, 128, 16), "f32_d64": (F32, 64, 32),
            "bf16_d96_padded": (BF16, 96, 16),
            "bf16_d32": (BF16, 32, 64), "bf16_d16": (BF16, 16, 128),
            "fp16_d32": (F16, 32, 64), "fp16_d16": (F16, 16, 128),
            "f32_d32": (F32, 32, 64), "f32_d16": (F32, 16, 128)}
# the cases whose two-kernel route (B3 then B4) phase 3 also times: the
# Hopper B3 and B4 at fp16 D 128 and 256, bf16 D 256 and f32 D 64, 128
# and 256 and 16-bit and f32 D 32 and 16 (each beside the WMMA kernel it
# replaced; at f32 D 256 both on clusters of two CTAs)
C3_TWO_KERNEL = ("fp16_d256", "bf16_d256", "fp16_d128", "f32_d256",
                 "f32_d128", "f32_d64", "bf16_d32", "bf16_d16", "fp16_d32",
                 "fp16_d16", "f32_d32", "f32_d16")


def time_c3_kernels(torch, gen) -> dict:
    """Phase 3's C3 rows at B2 x T2048, causal: the forward and the fused
    backward through their wrappers (the padding and slicing included),
    and for C3_TWO_KERNEL the dq and dk / dv kernels of the two-kernel
    route, each beside its plain version, its bound (at the true D; f32
    against the TF32 peak, in which its products run; one exponential a
    score element against PEAK_EXP), the library call
    on the same inputs (SDPA's forward; aten's flash backward for bf16
    and fp16, SDPA's memory-efficient backward for f32, which aten's
    refuses) and, where the route takes a Hopper kernel, the WMMA kernel
    it replaced on the same inputs, in turns."""
    import torch.nn.functional as F

    from pytorch_operator_tpu_torch.ops.flash_attention import (
        BWD_DKV_KERNEL,
        BWD_DQ_KERNEL,
        BWD_KERNEL,
        FWD_KERNEL,
        _flash_bwd_cuda,
        _flash_bwd_dkv_cuda,
        _flash_bwd_dkv_reference,
        _flash_bwd_dq_cuda,
        _flash_bwd_dq_reference,
        _flash_bwd_reference,
        _flash_fwd_cuda,
        _flash_fwd_reference,
        _kernel_dim,
        _sm90,
    )

    B, T = MAIN["B"], MAIN["T"]
    slow = dict(warmup=1, iters=3, reps=3)
    res = {}
    for name, (dtype, D, H) in C3_CASES.items():
        dt = getattr(torch, dtype)
        q, k, v, g = _flash_inputs(torch, gen, B, T, H, H, D, False, dtype)
        scale = D ** -0.5
        pairs = B * H * causal_pairs(T, True)
        io = B * T * H * D * dt.itemsize
        f32 = B * T * H * D * 4
        rows = 2 * B * H * T * 4  # lse and delta
        peak = PEAK_TF32_FLOPS if dtype == F32 else PEAK_BF16_FLOPS
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        out, lse = _flash_fwd_cuda(q, k, v, scale, True, False)
        args = (q, k, v, g, lse.reshape(B * H, T),
                (g.float() * out.float()).sum(-1).transpose(1, 2).reshape(
                    B * H, T).contiguous(), scale, True, False)
        refused = []
        if dtype == F32:
            lib_bwd = sdpa_efficient_bwd(torch, q, k, v, g, refused)
            lib_bwd_name = ("SDPA memory-efficient backward (autograd under "
                            "sdpa_kernel(EFFICIENT_ATTENTION))")
        else:
            lib_bwd = aten_flash_bwd(torch, q, k, v, g, scale, refused)
            lib_bwd_name = "aten._scaled_dot_product_flash_attention_backward"
        row = {"shape": [B, T, H, H, D], "dtype": dtype,
               "kernel_dim": _kernel_dim(D)}
        parts = [
            ("fwd", "flash_fwd",
             lambda **kw: _flash_fwd_cuda(q, k, v, scale, True, False, **kw),
             lambda: _flash_fwd_reference(q, k, v, scale, True, False),
             FWD_KERNEL,
             lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                    is_causal=True),
             "scaled_dot_product_attention",
             4 * io + B * H * T * 4, 4 * D * pairs),
            ("bwd", "flash_bwd", lambda **kw: _flash_bwd_cuda(*args, **kw),
             lambda: _flash_bwd_reference(*args), BWD_KERNEL, lib_bwd,
             lib_bwd_name, 7 * io + rows, 10 * D * pairs)]
        if name in C3_TWO_KERNEL:
            two = lib_bwd_name + " (dq, dk and dv: compare with B3 + B4)"
            parts += [
                ("dq", "flash_bwd_dq",
                 lambda **kw: _flash_bwd_dq_cuda(*args, **kw),
                 lambda: _flash_bwd_dq_reference(*args), BWD_DQ_KERNEL,
                 lib_bwd, two, 5 * io + rows, 6 * D * pairs),
                ("dkv", "flash_bwd_dkv",
                 lambda **kw: _flash_bwd_dkv_cuda(*args, **kw),
                 lambda: _flash_bwd_dkv_reference(*args), BWD_DKV_KERNEL,
                 lib_bwd, two, 4 * io + rows + 2 * f32, 8 * D * pairs)]
        for (part, kname, kernel_fn, plain_fn, wmma, library, lib_name,
             nbytes, flops) in parts:
            hopper = _sm90(part, dt, _kernel_dim(D))
            if hopper:
                new, old = in_turns(kernel_fn,
                                    lambda f=kernel_fn, w=wmma: f(kernel=w))
            else:
                new = time_ms(kernel_fn)
            lib = library and time_ms(library)
            row[part] = {
                **timing_row(new, time_ms(plain_fn, **slow), lib),
                "kernel": kname + ("_sm90" if hopper else ""),
                "library": (lib_name if library
                            else f"refused: {refused[0]}"),
                **dict(zip(("bound_ms", "bound_by"),
                           bound(nbytes, flops, peak, exps=pairs)))}
            if hopper:
                row[part].update(previous(new, old))
        res[name] = row
        emit({"timing": f"c3_{name}", **row})
        del q, k, v, g, qt, kt, vt, out, lse, args, lib_bwd, parts
        torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------


def run_path(torch, label, cfg, B, T, steps, expect, mesh=None,
             **step_kw) -> dict:
    """Train ``cfg`` from seed 0 for ``steps`` steps on one seeded (B, T)
    batch through make_train_step with AdamW(3e-4, wd 0.1): every launch
    count reset just before and read just after, the loss finite and
    falling, launches per step exactly ``expect``; then one profiled
    step.  ``host_ms`` is the time until the step returns, before the
    wait for the device: a step whose host time reaches its step time is
    bound by the host.  With ``mesh`` the model is sharded_init's on it
    (the same values as the unsharded init), and PROFILER_STEPS more
    steps run through with_step_profiler, whose numbers are returned
    beside this function's."""
    import numpy as np
    from torch.distributed.tensor import DTensor

    from pytorch_operator_tpu_torch import kernels
    from pytorch_operator_tpu_torch.models import llama
    from pytorch_operator_tpu_torch.parallel.train import (
        TrainState,
        adamw,
        make_train_step,
        sharded_init,
        with_step_profiler,
    )

    if mesh is None:
        gen = torch.Generator(device="cuda").manual_seed(0)
        model = llama.Llama(cfg, device="cuda", generator=gen)
    else:
        model = sharded_init(cfg, mesh, seed=0)
    optimizer = adamw(model, 3e-4, weight_decay=0.1)
    state = TrainState(model, optimizer)
    step_fn = make_train_step(cfg, model, optimizer, mesh=mesh, **step_kw)
    batch = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T + 1))).cuda()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, times, host = [], [], [], []
    kernels.reset_launches()
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    counts = kernels.launch_counts()

    L = cfg.n_layers
    per_step = {k: counts[k] / steps for k in expect}
    n = cfg.n_params()
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
           "host_ms_all": [t * 1e3 for t in host],
           "host_ms": statistics.median(host[1:]) * 1e3,
           "model_tflops_per_step": flops / 1e12,
           "mfu": flops / step_s / PEAK_BF16_FLOPS,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": counts, "launches_per_step": per_step,
           "dtensor": any(isinstance(p, DTensor)
                          for p in model.parameters())}
    if mesh is not None:
        profiled, profiler = with_step_profiler(step_fn, cfg, mesh, batch=B,
                                                seq_len=T, job=label)
        for _ in range(PROFILER_STEPS):
            state, _ = profiled(state, batch)
        res["step_profiler"] = profiler.summary()
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
              "flash_bwd_sm90": L, "flash_bwd_dq_sm90": 0,
              "flash_bwd_dkv_sm90": 0, "flash_fwd": 0, "flash_bwd": 0,
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
              "flash_bwd_sm90": 0, "flash_bwd_dq_sm90": L,
              "flash_bwd_dkv_sm90": L, "flash_fwd": 0, "flash_bwd": 0,
              "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    return run_path(torch, "long_path", cfg, LONG["B"], LONG["T"],
                    LONG_STEPS, expect, chunked_ce=True, ce_chunk=1024)


def free_memory(torch) -> None:
    """Drop what an earlier phase left: an FSDP2 model's hooks hold
    reference cycles, which only the collector frees, and a path's peak
    memory would count them."""
    gc.collect()
    torch.cuda.empty_cache()


def run_sharded_path(torch, main: dict) -> dict:
    """Phase 8: the T2048 path of phase 4 through the sharded code path
    at world size 1 (NCCL), held against phase 4's run."""
    import torch.distributed as dist

    from pytorch_operator_tpu_torch.models import llama
    from pytorch_operator_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, 1, 1, "cuda")
    try:
        backend = dist.get_backend()
        require(backend == "nccl", f"the cuda mesh runs {backend}, not nccl")
        L = llama.flagship().n_layers
        expect = {"rms_norm_fwd": 2 * L + 1, "flash_fwd_sm90": L,
                  "flash_bwd_sm90": L, "flash_bwd_dq_sm90": 0,
                  "flash_bwd_dkv_sm90": 0, "flash_fwd": 0, "flash_bwd": 0,
                  "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        res = run_path(torch, "sharded_path", llama.flagship(), MAIN["B"],
                       MAIN["T"], STEPS, expect, mesh=mesh)
        free_memory(torch)
        host = profile_fsdp_host(torch, mesh, expect)
    finally:
        dist.destroy_process_group()
    diffs = [abs(a - b) for a, b in zip(res["losses"], main["losses"])]
    prof = res["step_profiler"]
    out = {"backend": backend, "mesh": {"dp": 1, "fsdp": 1, "tp": 1},
           "world_size": 1,
           "losses": {"sharded": res["losses"], "main": main["losses"]},
           "max_loss_abs_diff": max(diffs),
           "tolerance": "each step's loss within 2e-2 of phase 4's (bf16; "
                        "the fused backward's dq sums with atomics)",
           "step_ms": {"sharded": res["step_ms"], "main": main["step_ms"]},
           "step_ratio": res["step_ms"] / main["step_ms"],
           "model_holds_dtensor": res["dtensor"],
           "fsdp2_host_profile": host,
           "device_ms": {"sharded": res["profile"]["device_ms"],
                         "main": main["profile"]["device_ms"]},
           "peak_mem_gib": {"sharded": res["peak_mem_gib"],
                            "main": main["peak_mem_gib"]},
           "launches_per_step": {"sharded": res["launches_per_step"],
                                 "main": main["launches_per_step"]},
           "step_profiler": {
               "tokens_per_s": prof["tokens_per_sec"],
               "mfu_6nbt": prof["mfu"],
               "mean_step_ms": prof["mean_step_time_s"] * 1e3,
               "first_step_ms": prof["compile_time_s"] * 1e3,
               "convention": f"{PROFILER_STEPS} steps after the timed ones, "
                             f"the mean of all but the first; MFU = "
                             f"6·N·B·T / step time / 989 TFLOP/s "
                             f"(attention left out)"},
           "host_ms": {"sharded": res["host_ms"], "main": main["host_ms"]},
           "this_script": {
               "tokens_per_s": res["tokens_per_s"], "mfu": res["mfu"],
               "median_step_ms": res["step_ms"],
               "convention": "median of the steps after the first; MFU = "
                             "(6·N·B·T + 12·L·B·T²·D/2) / step time / "
                             "989 TFLOP/s"}}
    emit({"sharded_vs_main": out})
    require(len(diffs) == STEPS and max(diffs) <= 2e-2,
            f"sharded path's losses off phase 4's: {out['losses']}")
    require(res["profile"]["complete"],
            "the sharded step's profile lost kernel records")
    require(not res["dtensor"], "the world-1 model holds DTensors: "
                                "sharded_init applied FSDP2 at one rank")
    return res


def profile_fsdp_host(torch, mesh, expect) -> dict:
    """The FSDP2 step on the card, and where its host time goes: the
    flagship wrapped as sharded_init wraps it where dp x fsdp holds more
    than one rank (each Block, then the root, fully_shard-ed over (dp,
    fsdp)), here over the one rank; three steps and one profiled step,
    host time by function (the profiler's CPU self time, FSDP2's
    record_function ranges beside aten's ops), beside the plain step's
    on the same seed and batch.  The FSDP2 step's losses must be within
    2e-2 of the plain step's, step by step, and its launches ``expect``
    a step."""
    import numpy as np
    from torch.distributed.fsdp import (
        fully_shard,
        register_fsdp_forward_method,
    )
    from torch.profiler import ProfilerActivity, profile

    from pytorch_operator_tpu_torch import kernels
    from pytorch_operator_tpu_torch.models import llama
    from pytorch_operator_tpu_torch.parallel import train

    cfg = llama.flagship()
    batch = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MAIN["B"], MAIN["T"] + 1))).cuda()
    out = {}
    for name in ("fsdp2", "plain"):
        if name == "fsdp2":
            model = llama.Llama(cfg, device="meta")
            for block in model.layers:
                fully_shard(block, mesh=mesh["dp", "fsdp"])
            fully_shard(model, mesh=mesh["dp", "fsdp"])
            register_fsdp_forward_method(model, "forward_hidden")
            model.to_empty(device="cuda")
            llama.init_params(model, torch.Generator(
                device="cuda").manual_seed(0))
        else:
            model = llama.Llama(cfg, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(0))
        opt = train.adamw(model)

        def loss_fn(b, model=model):
            return train.cross_entropy_loss(model(b[:, :-1]), b[:, 1:])

        # the step make_train_step builds, without its check that a mesh
        # of one rank holds the plain model
        step = train._make_step(model, opt, mesh, loss_fn)
        state = train.TrainState(model, opt)
        losses = []
        torch.cuda.synchronize()
        kernels.reset_launches()
        for _ in range(3):
            state, m = step(state, batch)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
        losses.append(m["loss"])
        counts = kernels.launch_counts()
        rows = sorted(prof.key_averages(),
                      key=lambda e: -e.self_cpu_time_total)
        fsdp = [e for e in rows if e.key.startswith("FSDP")]
        out[name] = {
            "losses": [float(x) for x in losses],
            "launches_per_step": {k: counts[k] / len(losses)
                                  for k in expect},
            "host_ms": host_ms,
            "profiled_self_cpu_ms": sum(e.self_cpu_time_total
                                        for e in rows) / 1e3,
            "fsdp_ranges_ms": {e.key: e.cpu_time_total / 1e3 for e in fsdp},
            "top_self_cpu": [{"fn": e.key[:60], "count": e.count,
                              "self_ms": e.self_cpu_time_total / 1e3,
                              "total_ms": e.cpu_time_total / 1e3}
                             for e in rows[:25]]}
        del model, opt, state, step, prof
        free_memory(torch)
    emit({"fsdp2_host_profile": out})
    diffs = [abs(a - b) for a, b in zip(out["fsdp2"]["losses"],
                                        out["plain"]["losses"])]
    for name in out:
        require(out[name]["launches_per_step"] == {
            k: float(c) for k, c in expect.items()},
            f"the {name} step launched {out[name]['launches_per_step']} "
            f"a step, not {expect}")
    require(all(map(math.isfinite, out["fsdp2"]["losses"]))
            and max(diffs) <= 2e-2,
            f"the FSDP2 step's losses off the plain step's: "
            f"{out['fsdp2']['losses']} {out['plain']['losses']}")
    return {k: {"losses": v["losses"], "host_ms": v["host_ms"],
                "profiled_self_cpu_ms": v["profiled_self_cpu_ms"]}
            for k, v in out.items()}


# the profile class of each kernel's launches: the C symbol's name, but
# for RMSNorm
PROFILE_CLASS = {"rms_norm_fwd": "rms_norm",
                 "rms_norm_rowblock_fwd": "rms_norm_rowblock",
                 **{s: s for s in FLASH_SYMBOLS}}
# a device record's class is the first whose key is in its name: the
# Hopper kernels' __global__ names come first, though no WMMA key is a
# substring of them (nor the reverse)
KERNEL_CLASSES = (("rms_norm", ("rms_norm_sm90_kernel",)),
                  ("rms_norm_rowblock", ("rms_norm_rowblock_kernel",)),
                  ("flash_fwd_sm90", ("flash_fwd_sm90_kernel",
                                      "flash_fwd_sm90_tf32_kernel")),
                  ("flash_bwd_sm90", ("flash_bwd_sm90_kernel",
                                      "flash_bwd_sm90_tf32_kernel")),
                  ("flash_bwd_dq_sm90", ("flash_bwd_dq_sm90_kernel",
                                         "flash_bwd_dq_sm90_tf32_kernel")),
                  ("flash_bwd_dkv_sm90", ("flash_bwd_dkv_sm90_kernel",
                                          "flash_bwd_dkv_sm90_tf32_kernel")),
                  ("flash_fwd", ("flash_fwd_kernel",)),
                  ("flash_bwd", ("flash_bwd_kernel",)),
                  ("flash_bwd_dq", ("flash_bwd_dq_kernel",)),
                  ("flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
                  ("matmul", ("gemm", "nvjet", "cutlass", "xmma")))


def profile_step(torch, label, step, expect) -> dict:
    """Device time of one more step, by kernel class and by kernel, and
    the matmul class's time and launches by the operator that launched
    them (aten::mm, aten::bmm, ...).  The port's kernels' profiled counts
    are held against the launches per step (``expect``): a shortfall
    means the profiler lost records (ROADMAP B14), and ``complete`` says
    so.  A profile that lost records is taken again, on one more step,
    up to three times in all; each lost one is printed."""
    for taken in range(1, 4):
        out = _profile_one_step(torch, label, step, expect)
        if out["complete"]:
            break
        emit({"profile_lost_records": out})
    out["profiles"] = taken
    emit({"profile": out})
    return out


def _profile_one_step(torch, label, step, expect) -> dict:
    from torch.autograd import DeviceType
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
    matmul_keys = dict(KERNEL_CLASSES)["matmul"]
    by_op: dict[str, dict] = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        for k in e.kernels:
            if any(key in k.name for key in matmul_keys):
                op = by_op.setdefault(e.name, {"ms": 0.0, "count": 0})
                op["ms"] += k.duration / 1e3
                op["count"] += 1
    launched = {symbol: counts.get(PROFILE_CLASS[symbol], 0)
                for symbol in expect}
    out = {"path": label, "wall_ms_profiled": wall_ms,
           "device_ms": sum(by_class.values()),
           "device_ms_by_class": by_class, "kernel_counts": launched,
           "class_counts": counts, "matmul_by_op": by_op,
           "complete": launched == expect,
           "top": [{"ms": ms, "count": n, "kernel": k}
                   for ms, n, k in top[:20]]}
    return out


# --------------------------------------------------------------------------
# phase 5: the whole model with kernels on against kernels off
# --------------------------------------------------------------------------


def check_tiny_model(torch) -> dict:
    import numpy as np

    from pytorch_operator_tpu_torch import kernels
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
        before = kernels.KERNELS["flash_fwd_sm90"].launches
        ek = (mk(batch[:, :-1]) - truth).abs()
        torch.cuda.synchronize()
        # the forward-only call runs B1 (no short-T dense route), so the
        # kernel model's logits hold the kernel, not a second dense path
        b1 = kernels.KERNELS["flash_fwd_sm90"].launches - before
        ep = (mp(batch[:, :-1]) - truth).abs()
    del m32
    require(b1 == cfg_k.n_layers,
            f"tiny model: the kernels-on forward under no_grad launched B1 "
            f"{b1} times, not once a layer ({cfg_k.n_layers})")
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
           "b1_launches_in_forward": b1,
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
    every ported remat_policy: grads against no remat, and the Hopper
    forward's and fused backward's (both on narrow slabs) launches in one
    forward + backward, none of the WMMA ones."""
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
    res = {"no_remat": {k: ref_counts[k] for k in (
        "flash_fwd_sm90", "flash_fwd", "flash_bwd_sm90", "flash_bwd",
        "rms_norm_fwd")}}
    for policy in REMAT_TIERS:
        got, counts = grads(dataclasses.replace(base, remat=True,
                                                remat_policy=policy))
        err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                  for a, b in zip(got, ref))
        save_attn = (policy or "").startswith("save_attn")
        # head dim 16 in bf16: the Hopper forward and walk (B1, B2)
        want = {"flash_fwd_sm90": L if save_attn else 2 * L,
                "flash_fwd": 0, "flash_bwd_sm90": L, "flash_bwd": 0,
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


def check_default_trainer(torch) -> dict:
    """train_llama's default model (the tiny Llama: f32, head dim 16, GQA
    8:4, full remat) for two steps as the trainer runs it with no other
    argument, then with --no-remat: every launch count reset just before
    each run and read just after, exact launches per step (the Hopper
    TF32 B1 2L under full remat and L without, the Hopper TF32 B2 L,
    RMSNorm 4L + 1 and 2L + 1), none of a WMMA flash kernel, the losses
    finite.  Returns the default run's launches."""
    from pytorch_operator_tpu_torch import kernels, train_llama
    from pytorch_operator_tpu_torch.models import llama

    L, steps = llama.tiny().n_layers, 2
    res, default = {}, None
    for label, extra, fwd, norms in (
            ("default", [], 2 * L, 4 * L + 1),
            ("no_remat", ["--no-remat"], L, 2 * L + 1)):
        argv = ["--steps", str(steps), "--log-interval", "1", *extra]
        kernels.reset_launches()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = train_llama.main(argv)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        text = out.getvalue()
        losses = [float(x) for x in re.findall(r"loss=(\S+)", text)]
        want = {**dict.fromkeys(FLASH_SYMBOLS, 0),
                "flash_fwd_sm90": fwd * steps, "flash_bwd_sm90": L * steps,
                "rms_norm_fwd": norms * steps}
        launched = {n: counts[n] for n in want}
        ok = (rc == 0 and "training complete" in text
              and len(losses) == steps and all(map(math.isfinite, losses))
              and launched == want)
        res[label] = {"argv": argv, "rc": rc, "losses": losses,
                      "launches": launched, "want": want, "ok": ok}
        require(ok, f"train_llama {argv}: rc {rc}, losses {losses}, "
                    f"launches {launched} != {want}: {text}")
        if default is None:
            default = counts
    emit({"default_trainer": res})
    return {"launches": default}


# --------------------------------------------------------------------------
# phase 9: checkpoint and resume through the trainer
# --------------------------------------------------------------------------


RESUME_ARGV = ["--model", "flagship", "--layers", "2", "--batch-size", "2",
               "--seq-len", "2048", "--log-interval", "1"]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _trainer(argv: list[str], nproc: int = 1,
             module: str = "train_llama") -> str:
    """A trainer of the port (train_llama unless ``module`` names another
    entry) in a process of its own (the card's first process keeps its
    memory), or under torch.distributed.run with ``nproc`` processes (one
    per card); its output, or the phase fails.  The processes run in a
    session of their own, which is killed whole at the time limit."""
    import signal

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT"):
        env.pop(name, None)
    launch = [sys.executable]
    if nproc > 1:
        launch += ["-m", "torch.distributed.run", "--nproc-per-node",
                   str(nproc), "--master-addr", "127.0.0.1",
                   "--master-port", str(_free_port())]
    proc = subprocess.Popen(
        launch + ["-m", f"pytorch_operator_tpu_torch.{module}", *argv],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
    # under torch.distributed.run a rank's traceback comes before the
    # launcher's own report
    ranks = "\n".join(ln for ln in err.splitlines()
                      if ln.startswith("[rank"))
    require(proc.returncode == 0,
            f"{module} {argv} failed: {ranks[-4000:]}\n{err[-2000:]}")
    return out


def _step_losses(text: str) -> dict[int, float]:
    return {int(i): float(x) for i, x in re.findall(
        r"^step (\d+): loss=(\S+)", text, re.MULTILINE)}


def run_checkpoint_resume(torch) -> dict:
    """Phase 9: a process trains 4 steps and checkpoints at 2 and 4 (each
    checkpoint about 1 GB: bf16 params and both AdamW moments of the
    2-layer flagship at full width), a second one restores step 4 and
    trains to 6; the same 6 steps uninterrupted in this process give the
    losses the resumed steps must continue."""
    import tempfile

    from pytorch_operator_tpu_torch import train_llama

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = ["--checkpoint-dir", os.path.join(tmp, "ckpt"),
                "--checkpoint-every", "2"]
        t0 = time.perf_counter()
        first = _trainer(RESUME_ARGV + ckpt + ["--steps", "4"])
        t1 = time.perf_counter()
        second = _trainer(RESUME_ARGV + ckpt + ["--steps", "6"])
        t2 = time.perf_counter()
    free_memory(torch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_llama.main(RESUME_ARGV + ["--steps", "6"])
    whole = _step_losses(out.getvalue())
    resumed = _step_losses(second)
    saves = [float(x) for x in re.findall(
        r"checkpointed step \d+ in (\S+) s", first + second)]
    restore = re.search(r"restored checkpoint at step 4 onto 1 device\(s\) "
                        r"in (\S+) s", second)
    diffs = [abs(resumed.get(i, math.inf) - whole.get(i, math.inf))
             for i in (4, 5)]
    res = {"argv": RESUME_ARGV, "save_s": saves,
           "restore_s": restore and float(restore.group(1)),
           "process_s": [t1 - t0, t2 - t1],
           "losses": {"first": _step_losses(first), "resumed": resumed,
                      "uninterrupted": whole},
           "max_loss_abs_diff": max(diffs),
           "tolerance": "steps 4-5 within 2e-2 of the uninterrupted run's "
                        "(bf16; the fused backward's atomics)",
           "output": (first + second).splitlines()}
    emit({"checkpoint_resume": res})
    require("checkpointed step 2" in first and "checkpointed step 4" in first
            and "restored checkpoint" not in first,
            f"the first run did not checkpoint at 2 and 4: {first}")
    require(restore is not None and "checkpointed step 6" in second
            and "training complete" in second,
            f"the second run did not restore step 4: {second}")
    require(sorted(resumed) == [4, 5],
            f"the resumed run trained steps {sorted(resumed)}, not 4-5")
    require(rc == 0 and max(diffs) <= 2e-2,
            f"resumed losses {resumed} do not continue {whole}")
    return res


# --------------------------------------------------------------------------
# phase 10: dist-MNIST on the card
# --------------------------------------------------------------------------


MNIST_ARGV = ["--device", "cuda", "--synthetic-size", "16384",
              "--batch-size", "128", "--epochs", "5", "--lr", "0.05",
              "--momentum", "0.9", "--log-interval", "1000",
              "--target-accuracy", "0.98"]


def run_mnist(torch) -> dict:
    from pytorch_operator_tpu_torch import train_mnist

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train_mnist.main(MNIST_ARGV)
    seconds = time.perf_counter() - t0
    text = out.getvalue()
    acc = [float(a) for a in re.findall(r"^accuracy=(\S+)", text,
                                        re.MULTILINE)]
    rate = [float(r) for r in re.findall(r"(\d+) img/s", text)]
    res = {"argv": MNIST_ARGV, "rc": rc, "accuracy_by_epoch": acc,
           "img_per_s_by_epoch": rate, "seconds_to_target": seconds,
           "output": text.splitlines()[-6:]}
    emit({"mnist": res})
    require(rc == 0 and acc and acc[-1] >= 0.98,
            f"train_mnist did not reach 0.98: {acc}")
    return res


# --------------------------------------------------------------------------
# phase 11: the ring of virtual ranks on one card
# --------------------------------------------------------------------------


def check_ring(torch, gen) -> dict:
    """Phase 11: the loopback ring (4 virtual ranks, contiguous and
    zigzag) at B1 T32768 H32 D128 against B1 and B3 + B4 over the full
    T32768, with the chunk launches of one forward and backward reset
    just before and read just after, and both timed."""
    import importlib

    from pytorch_operator_tpu_torch import kernels
    from pytorch_operator_tpu_torch.ops import flash_attention
    from pytorch_operator_tpu_torch.ops.flash_attention import (
        _flash_bwd_dkv_cuda,
        _flash_bwd_dq_cuda,
        _flash_fwd_cuda,
        _use_fused_bwd,
    )

    ra = importlib.import_module(
        "pytorch_operator_tpu_torch.parallel.ring_attention")
    B, T, H, D, n = (RING[x] for x in ("B", "T", "H", "D", "n"))
    q, k, v, g = _flash_inputs(torch, gen, B, T, H, H, D, False)
    scale = D ** -0.5
    out_ref, lse_ref = _flash_fwd_cuda(q, k, v, scale, True, False)
    delta = (g.float() * out_ref.float()).sum(-1).transpose(1, 2).reshape(
        B * H, T).contiguous()
    args = (q, k, v, g, lse_ref.reshape(B * H, T), delta, scale, True, False)
    ref = {"out": out_ref, "dq": _flash_bwd_dq_cuda(*args)}
    # H == Hk: the per-q-head partials are dk and dv
    ref.update(zip(("dk", "dv"), _flash_bwd_dkv_cuda(*args)))
    lse_ref = lse_ref.view(B, H, T).transpose(1, 2)
    # CUDA events: calls of 70-110 ms whose host runs ahead (the profiler
    # lost the first call's records of these in two runs)
    few = dict(warmup=1, iters=2, reps=3, profiles=0)

    def full():
        xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
        flash_attention(*xs, causal=True).backward(g)

    res = {"shape": [B, T, H, H, D], "virtual_ranks": n,
           "ms_by": "CUDA events around 2 calls, median of 3",
           "full_T_fwd_bwd": time_ms(full, **few)}
    ok = True
    for layout in ("contiguous", "zigzag"):
        zig = layout == "zigzag"
        pairs = ra.ring_launches(n, True, "zigzag_pre" if zig else layout)
        chunk = T // n // (2 if zig else 1)
        fused = _use_fused_bwd(chunk, D)
        want = {s: 0 for s in FLASH_SYMBOLS}
        want["flash_fwd_sm90"] = pairs
        for s in (("flash_bwd_sm90",) if fused else
                  ("flash_bwd_dq_sm90", "flash_bwd_dkv_sm90")):
            want[s] = pairs
        xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = ra.ring_attention_loopback(*xs, n, causal=True, layout=layout)
        out.backward(g)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        launched = {s: counts[s] for s in FLASH_SYMBOLS}
        # the merged lse, from the forward bodies of the n ranks
        rows = (torch.from_numpy(ra.zigzag_layout(T, n)[0]).cuda() if zig
                else torch.arange(T, device="cuda"))
        chunks = [x[:, rows].chunk(n, 1) for x in (q, k, v)]
        merged = ra._lockstep([ra._ring_fwd(
            chunks[0][r], chunks[1][r], chunks[2][r], r, n, True,
            "zigzag_pre" if zig else layout, scale) for r in range(n)])
        lse = torch.empty(B, T, H, device="cuda")
        lse[:, rows] = torch.cat([m[1] for m in merged], 1)
        del merged, chunks
        o_err, o_rel = _rel_errs(out, ref["out"])
        l_err = float((lse - lse_ref).abs().max())
        errs = {"out": {"max_abs_err": o_err, "rel_fro_err": o_rel,
                        "lse_max_abs_err": l_err}}
        case_ok = (o_err <= 2e-2 and o_rel <= 1e-2 and l_err <= 1e-3
                   and launched == want)
        for name, x in zip(("dq", "dk", "dv"), xs):
            errs[name], grad_ok = _grad_errs(x.grad, ref[name])
            case_ok &= grad_ok
        del xs, out

        def ring(layout=layout):
            xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
            ra.ring_attention_loopback(*xs, n, causal=True,
                                       layout=layout).backward(g)

        res[layout] = {"chunk_pairs": pairs, "chunk_rows": chunk,
                       "backward_route": "fused" if fused else "two_kernel",
                       "launches": launched, "want": want, **errs,
                       "fwd_bwd": time_ms(ring, **few), "ok": case_ok}
        res[layout]["vs_full_T"] = (res[layout]["fwd_bwd"]["ms"]
                                    / res["full_T_fwd_bwd"]["ms"])
        res[layout]["launches_fwd_bwd"] = launched
        ok &= case_ok
        torch.cuda.empty_cache()
    res["tolerance"] = ("against B1 and B3 + B4 over the full T on the same "
                        "inputs: out max|err| <= 2e-2 and rel <= 1e-2, lse "
                        "1e-3 (phase 2's B1 bounds); dq, dk, dv max|err| <= "
                        "1e-2 * max|ref| and rel <= 1e-2 (phase 2's B3/B4 "
                        "bounds: each chunk rounds its p and ds to bf16, "
                        "the chunks' dq are summed in f32 in another order)")
    emit({"ring": res})
    require(ok, "the loopback ring disagrees with the full-T kernels or "
                "launched other than its chunk pairs")
    return res


# --------------------------------------------------------------------------
# phase 12: the sequence-parallel trainer on one card
# --------------------------------------------------------------------------


def _cli_steps(text: str, tokens: int) -> tuple[list, list]:
    """Losses and step times (s) from train_llama's log at
    --log-interval 1: its tokens/s is cumulative from the first step, so
    step i ends (i + 1) * tokens / tokens_per_s after the start."""
    rows = re.findall(r"^step (\d+): loss=(\S+) grad_norm=\S+ "
                      r"tokens/s=(\S+)", text, re.MULTILINE)
    ends = [(int(i) + 1) * tokens / float(tps) for i, _, tps in rows]
    return ([float(x) for _, x, _ in rows],
            [b - a for a, b in zip([0.0] + ends, ends)])


def run_sp_trainer(torch) -> dict:
    """Phase 12: train_llama --sp 1 --sp-impl ring (the sequence-parallel
    step, its attention through the ring of one rank) beside the same
    trainer without --sp, each in this process with every launch count
    reset just before and read just after."""
    from pytorch_operator_tpu_torch import kernels, train_llama
    from pytorch_operator_tpu_torch.models import llama

    argv = SP_ARGV + ["--layers", str(SP_LAYERS), "--steps", str(SP_STEPS)]
    cfg = llama.llama2_7b(n_layers=SP_LAYERS)
    L, T = SP_LAYERS, 32768
    # save_attn+qkv: the chunk's (out, lse) kept, the norms recomputed;
    # T * D * 4 = 16 MiB takes the two-kernel backward
    per_step = {s: 0 for s in FLASH_SYMBOLS}
    per_step.update({"rms_norm_fwd": 4 * L + 1, "flash_fwd_sm90": L,
                     "flash_bwd_dq_sm90": L, "flash_bwd_dkv_sm90": L})
    flops = 6.0 * llama.n_params(cfg) * T + 12.0 * L * T * T * cfg.dim * 0.5
    res = {}
    for name, extra in (("sp", ["--sp", "1", "--sp-impl", "ring"]),
                        ("plain", [])):
        free_memory(torch)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = train_llama.main(argv + extra)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        text = out.getvalue()
        losses, steps = _cli_steps(text, T)
        step_s = statistics.median(steps[1:]) if len(steps) > 1 else None
        res[name] = {
            "argv": argv + extra, "rc": rc, "losses": losses,
            "step_ms_all": [s * 1e3 for s in steps],
            "step_ms": step_s and step_s * 1e3,
            "tokens_per_s": step_s and T / step_s,
            "mfu": step_s and flops / step_s / PEAK_BF16_FLOPS,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": counts,
            "launches_per_step": {s: counts[s] / SP_STEPS for s in per_step},
            "output": text.splitlines()[:4]}
        require(rc == 0 and "training complete" in text
                and len(losses) == SP_STEPS
                and all(map(math.isfinite, losses)),
                f"train_llama {argv + extra} failed: {text}")
    diffs = [abs(a - b) for a, b in zip(res["sp"]["losses"],
                                        res["plain"]["losses"])]
    res.update({"model": f"llama2_7b width, {L} layers, B1 x T{T}",
                "model_tflops_per_step": flops / 1e12,
                "want_launches_per_step": per_step,
                "max_loss_abs_diff": max(diffs),
                "tolerance": "each step's loss within 2e-2 of the trainer "
                             "without --sp (bf16)"})
    emit({"sp_trainer": res})
    for name in ("sp", "plain"):
        require(res[name]["launches_per_step"] == {
            s: float(c) for s, c in per_step.items()},
            f"phase 12 {name}: launches per step "
            f"{res[name]['launches_per_step']} != {per_step}")
    require(max(diffs) <= 2e-2, f"--sp 1 losses off the plain trainer's: "
                                f"{res['sp']['losses']} "
                                f"{res['plain']['losses']}")
    return res["sp"]


# --------------------------------------------------------------------------
# phase 14: the pipeline on one card
# --------------------------------------------------------------------------


def pp_launches(L: int, M: int, S: int, schedule: str,
                stage: int | None = None, two_kernel: bool = False) -> dict:
    """Launches a step of the pipeline step, summed over every stage or
    stage ``stage``'s, at T4096 (the fused backward, or B3 + B4 with
    ``two_kernel``) without remat.  GPipe runs each layer once a
    microbatch forward (two RMSNorms, one B1) and once backward, and the
    last stage's final norm once a microbatch.  1F1B's stages 0..S-2 run
    their L/S layers again in the backward tick (B1 and both RMSNorms
    twice), while the last stage runs its layers once: its forward tick
    would compute what no stage reads (the JAX stage does, as SPMD
    must), so it only saves the input."""
    per = L // S
    fwd = rms = bwd = 0
    for s in range(S) if stage is None else [stage]:
        runs = 2 if schedule == "1f1b" and s < S - 1 else 1
        fwd += M * per * runs
        rms += M * 2 * per * runs + (M if s == S - 1 else 0)
        bwd += M * per
    counts = {k: 0 for k in FLASH_SYMBOLS}
    counts.update({"rms_norm_fwd": rms, "flash_fwd_sm90": fwd})
    if two_kernel:
        counts.update({"flash_bwd_dq_sm90": bwd, "flash_bwd_dkv_sm90": bwd})
    else:
        counts["flash_bwd_sm90"] = bwd
    return counts


def _pp_batches(torch, cfg, B, steps):
    """train_llama's batches: seeded by the step index."""
    import numpy as np

    return [torch.from_numpy(np.random.default_rng(i).integers(
        0, cfg.vocab_size, (B, PIPE["T"] + 1))).cuda() for i in range(steps)]


def pp_flops(cfg, B: int, T: int) -> float:
    from pytorch_operator_tpu_torch.models import llama

    return (6.0 * llama.n_params(cfg) * B * T
            + 12.0 * cfg.n_layers * B * T * T * cfg.dim * 0.5)


def run_pipeline_loopback(torch) -> dict:
    """Phase 14, first half: make_pp_train_step through the loopback of
    PIPE["S"] virtual stages (llama.pipeline_stages) under each schedule,
    beside make_train_step on the same model unpipelined, on
    train_llama's batches: each step's loss within 2e-2 of the
    unpipelined one's, launches per step exactly pp_launches, step time
    and peak memory; 1F1B's peak below GPipe's."""
    from pytorch_operator_tpu_torch import kernels
    from pytorch_operator_tpu_torch.models import llama
    from pytorch_operator_tpu_torch.parallel.train import (
        TrainState,
        adamw,
        make_pp_train_step,
        make_train_step,
    )

    L, S, B, T, M = (PIPE[x] for x in "LSBTM")
    steps = PIPE["steps"]
    cfg = llama.llama2_7b(n_layers=L, max_seq_len=T, use_flash=True,
                          use_fused_norm=True, remat=False)
    batches = _pp_batches(torch, cfg, B, steps)
    flops = pp_flops(cfg, B, T)
    res = {}
    for name in ("plain", "gpipe", "1f1b"):
        free_memory(torch)
        torch.cuda.reset_peak_memory_stats()
        if name == "plain":
            model = llama.Llama(cfg, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(0))
            optimizer = adamw(model, 3e-4, weight_decay=0.1)
            step = make_train_step(cfg, model, optimizer)
            expect = {s: 0 for s in FLASH_SYMBOLS}
            expect.update({"rms_norm_fwd": 2 * L + 1, "flash_fwd_sm90": L,
                           "flash_bwd_sm90": L})
        else:
            model = llama.pipeline_stages(cfg, S, device="cuda", seed=0)
            optimizer = adamw(model, 3e-4, weight_decay=0.1)
            step = make_pp_train_step(cfg, model, optimizer,
                                      n_microbatches=M, schedule=name)
            expect = pp_launches(L, M, S, name)
        state = TrainState(model, optimizer)
        torch.cuda.synchronize()
        kernels.reset_launches()
        losses, times = [], []
        for batch in batches:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
        counts = kernels.launch_counts()
        step_s = statistics.median(times[1:])
        res[name] = {
            "losses": losses, "step_ms_all": [t * 1e3 for t in times],
            "step_ms": step_s * 1e3, "tokens_per_s": B * T / step_s,
            "mfu": flops / step_s / PEAK_BF16_FLOPS,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": counts,
            "launches_per_step": {k: counts[k] / steps for k in expect},
            "want_launches_per_step": expect}
        del model, optimizer, step, state
    diffs = {name: max(abs(a - b) for a, b in zip(res[name]["losses"],
                                                  res["plain"]["losses"]))
             for name in ("gpipe", "1f1b")}
    res.update({"model": f"llama2_7b width, {L} layers, {S} virtual "
                         f"stages, B{B} x T{T}, {M} microbatches, no remat",
                "model_tflops_per_step": flops / 1e12,
                "max_loss_abs_diff": diffs,
                "tolerance": "each step's loss within 2e-2 of the "
                             "unpipelined step's (bf16; the microbatches' "
                             "means summed in another order)"})
    emit({"pipeline_loopback": res})
    for name in ("plain", "gpipe", "1f1b"):
        r = res[name]
        require(all(map(math.isfinite, r["losses"]))
                and r["launches_per_step"] == {
                    k: float(v) for k, v in r["want_launches_per_step"].items()},
                f"phase 14 {name}: losses {r['losses']} or launches per step "
                f"{r['launches_per_step']} != {r['want_launches_per_step']}")
    require(max(diffs.values()) <= 2e-2,
            f"the loopback pipeline's losses are off the unpipelined "
            f"step's: {diffs}")
    require(res["1f1b"]["peak_mem_gib"] < res["gpipe"]["peak_mem_gib"],
            "1F1B's peak memory is not below GPipe's")
    return res


def run_pipeline_cli(torch) -> dict:
    """Phase 14, second half: train_llama --model 7b --layers 8 --pp 1
    --microbatches 4 under each schedule beside train_llama without
    --pp, in this process, every launch count reset just before and read
    just after: losses within 2e-2, launches per step exact (a pipeline
    of one stage runs the layers once a microbatch)."""
    from pytorch_operator_tpu_torch import kernels, train_llama
    from pytorch_operator_tpu_torch.models import llama

    L, B, T, M = (PIPE[x] for x in "LBTM")
    steps = PIPE["steps"]
    argv = PIPE_ARGV + ["--layers", str(L), "--batch-size", str(B),
                        "--steps", str(steps)]
    flops = pp_flops(llama.llama2_7b(n_layers=L), B, T)
    plain = {s: 0 for s in FLASH_SYMBOLS}
    plain.update({"rms_norm_fwd": 2 * L + 1, "flash_fwd_sm90": L,
                  "flash_bwd_sm90": L})
    res = {}
    for name, extra, expect in (
            ("plain", [], plain),
            ("pp1_gpipe", ["--pp", "1", "--microbatches", str(M),
                           "--pp-schedule", "gpipe"],
             pp_launches(L, M, 1, "gpipe")),
            ("pp1_1f1b", ["--pp", "1", "--microbatches", str(M),
                          "--pp-schedule", "1f1b"],
             pp_launches(L, M, 1, "1f1b"))):
        free_memory(torch)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = train_llama.main(argv + extra)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        text = out.getvalue()
        losses, step_times = _cli_steps(text, B * T)
        step_s = statistics.median(step_times[1:])
        res[name] = {
            "argv": argv + extra, "rc": rc, "losses": losses,
            "step_ms_all": [t * 1e3 for t in step_times],
            "step_ms": step_s * 1e3, "tokens_per_s": B * T / step_s,
            "mfu": flops / step_s / PEAK_BF16_FLOPS,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": counts,
            "launches_per_step": {k: counts[k] / steps for k in expect},
            "want_launches_per_step": expect,
            "output": text.splitlines()[:3]}
        require(rc == 0 and "training complete" in text
                and len(losses) == steps and all(map(math.isfinite, losses)),
                f"train_llama {argv + extra} failed: {text}")
    diffs = {name: max(abs(a - b) for a, b in zip(res[name]["losses"],
                                                  res["plain"]["losses"]))
             for name in ("pp1_gpipe", "pp1_1f1b")}
    res.update({"max_loss_abs_diff": diffs,
                "tolerance": "each step's loss within 2e-2 of the trainer "
                             "without --pp (bf16)"})
    emit({"pipeline_cli": res})
    for name, r in res.items():
        if isinstance(r, dict) and "launches_per_step" in r:
            require(r["launches_per_step"] == {
                k: float(v) for k, v in r["want_launches_per_step"].items()},
                f"phase 14 {name}: launches per step "
                f"{r['launches_per_step']} != {r['want_launches_per_step']}")
    require(max(diffs.values()) <= 2e-2,
            f"--pp 1 losses off the trainer without --pp: {diffs}")
    return res


# --------------------------------------------------------------------------
# phase 15: the MoE Llama at Mixtral-8x7B's width on one card
# --------------------------------------------------------------------------


def moe_launches(L: int) -> dict:
    """Launches a step of the MoE step without remat at T4096: both
    RMSNorms of each layer and the final one, one flash forward a layer
    and its fused backward."""
    counts = {k: 0 for k in FLASH_SYMBOLS}
    counts.update({"rms_norm_fwd": 2 * L + 1, "flash_fwd_sm90": L,
                   "flash_bwd_sm90": L})
    return counts


def moe_flops(cfg, B: int, T: int) -> float:
    """A step's model FLOPs: 6·N·B·T with N every parameter (the dense
    dispatch runs every expert on every token), plus the attention as
    bench_detail.py counts it; counted once however many ranks repeat
    it."""
    return (6.0 * cfg.n_params() * B * T
            + 12.0 * cfg.n_layers * B * T * T * cfg.dim * 0.5)


def moe_loss(torch, model, batch):
    """The MoE step's loss, ce + AUX_LOSS_WEIGHT · aux, of ``model`` on
    ``batch``."""
    from pytorch_operator_tpu_torch.models import moe
    from pytorch_operator_tpu_torch.parallel.train import cross_entropy_loss

    logits, aux = model(batch[:, :-1])
    return (cross_entropy_loss(logits, batch[:, 1:])
            + moe.AUX_LOSS_WEIGHT * aux)


def _kernels_off(cfg):
    return dataclasses.replace(cfg, use_flash=False, use_fused_norm=False)


def _twin(torch, model, cfg):
    """A model of ``cfg`` whose parameters share ``model``'s storage: it
    sees every update of ``model``, and its gradients are its own."""
    from pytorch_operator_tpu_torch.models import moe

    twin = moe.MoELlama(cfg, device="meta")
    twin.load_state_dict(model.state_dict(), assign=True)
    return twin


# The limit on the worst leaf's relative gradient difference, kernels
# against kernels off, where every expert is chosen (moe_grad_check).
# On the H100 the clean value is 2.5e-2 (the kernels-off attention
# rounds its scores to bf16); the flash backward's dq scaled by 1.05
# gives 5.6e-2, one 64-key tile of dk and dv zeroed 0.14 (PERF.md §6).
MOE_GRAD_LIMIT = 4e-2


def moe_grad_check(torch, model, batch) -> dict:
    """One step's gradients of ``model`` (the kernels on) against those of
    the same weights with the kernels off, on ``batch``: each leaf's
    ||g - g_off|| / ||g_off||, the worst leaf and the worst of each kind,
    the share of elements whose sign differs (AdamW's first update is
    lr · sign(g), so that share is how far apart two first updates
    start), the tokens of each layer whose top-k experts differ, and
    each forward and backward's time.  Twice: at the config's top_k,
    and with every expert chosen (top_k = n_experts), where no token can
    change experts, the loss is smooth in the weights and what differs
    is the rounding of the two attention and norm routes."""
    from pytorch_operator_tpu_torch.models import moe

    real_ffn = moe.moe_ffn
    res = {}
    for top_k in (model.cfg.top_k, model.cfg.n_experts):
        runs = {}
        for route in ("kernels", "kernels_off"):
            cfg = dataclasses.replace(model.cfg, top_k=top_k)
            twin = _twin(torch, model, cfg if route == "kernels"
                         else _kernels_off(cfg))
            routes = []

            def recording(x, blk, routes=routes):
                with torch.no_grad():
                    routes.append((x @ blk.router).float().topk(
                        blk.cfg.top_k, dim=-1).indices.sort(-1).values)
                return real_ffn(x, blk)

            moe.moe_ffn = recording
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                moe_loss(torch, twin, batch).backward()
                torch.cuda.synchronize()
            finally:
                moe.moe_ffn = real_ffn
            runs[route] = ({n: p.grad for n, p in twin.named_parameters()},
                           routes, (time.perf_counter() - t0) * 1e3)
            del twin
        (g_on, r_on, ms_on), (g_off, r_off, ms_off) = runs.values()
        leaves, signs, total = {}, 0, 0
        for name, a in g_on.items():
            a, b = a.float(), g_off[name].float()
            leaves[name] = float((a - b).norm() / b.norm().clamp_min(1e-30))
            signs += int((a.sign() != b.sign()).sum())
            total += a.numel()
            del a, b
        by_kind: dict[str, float] = {}
        for name, err in leaves.items():
            parts = name.split(".")  # layers.<i>.<kind>[.weight] or <kind>
            kind = parts[2] if parts[0] == "layers" else parts[0]
            by_kind[kind] = max(by_kind.get(kind, 0.0), err)
        worst = max(leaves, key=leaves.get)
        res[f"top{top_k}"] = {
            "worst_leaf": worst, "worst_rel_err": leaves[worst],
            "rel_err_by_kind": by_kind,
            "sign_differs_share": signs / total,
            "tokens_rerouted_by_layer": [int((a != b).any(-1).sum())
                                         for a, b in zip(r_on, r_off)],
            "tokens": batch.shape[0] * (batch.shape[1] - 1),
            "fwd_bwd_ms": {"kernels": ms_on, "kernels_off": ms_off}}
        del runs, g_on, g_off
        free_memory(torch)
    return res


def moe_same_weights(torch, cfg, B: int, T: int, steps: int) -> dict:
    """The MoE of seed 0 on phase 15's batch: first ``moe_grad_check``;
    then trained through the kernels (make_train_step), with, before
    each step, the loss of the same weights with the kernels off (a twin
    that shares every parameter): each step's pair of losses."""
    import numpy as np

    from pytorch_operator_tpu_torch.models import moe
    from pytorch_operator_tpu_torch.parallel.train import (
        TrainState,
        adamw,
        make_train_step,
    )

    model = moe.MoELlama(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    batch = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T + 1))).cuda()
    grads = moe_grad_check(torch, model, batch)
    shadow = _twin(torch, model, _kernels_off(cfg))
    optimizer = adamw(model, 3e-4, weight_decay=0.1)
    step = make_train_step(cfg, model, optimizer)
    state = TrainState(model, optimizer)
    on, off = [], []
    for _ in range(steps):
        with torch.no_grad():
            off.append(float(moe_loss(torch, shadow, batch)))
        state, metrics = step(state, batch)
        on.append(float(metrics["loss"]))
    return {"kernels": on, "kernels_off": off, "grads": grads}


def run_moe_path(torch) -> dict:
    """Phase 15: the MoE Llama at Mixtral-8x7B's width, depth cut to
    MOE["L"], B1 x T4096, through sharded_init and make_train_step on a
    (dp, fsdp, tp, ep) = (1, 1, 1, 1) mesh (NCCL, world size 1: the
    plain model), as run_path measures it, the expert products (their
    aten::bmm, forward and backward) a class of their own in the
    profile.  Then the kernels against their plain versions on the
    model (``moe_same_weights``): the first step's gradients, the worst
    leaf within MOE_GRAD_LIMIT where every expert is chosen, and at each
    of the steps the loss of the same weights with the kernels off
    within 2e-2 of the kernels'."""
    import torch.distributed as dist

    from pytorch_operator_tpu_torch.models import moe
    from pytorch_operator_tpu_torch.parallel.mesh import make_named_mesh

    L, B, T, steps = (MOE[x] for x in ("L", "B", "T", "steps"))
    cfg = moe.mixtral_8x7b(n_layers=L, max_seq_len=T)
    mesh = make_named_mesh({"dp": 1, "fsdp": 1, "tp": 1, "ep": 1}, "cuda")
    try:
        on = run_path(torch, "moe_path", cfg, B, T, steps, moe_launches(L),
                      mesh=mesh)
        free_memory(torch)
        same = moe_same_weights(torch, cfg, B, T, steps)
        free_memory(torch)
    finally:
        dist.destroy_process_group()
    diffs = [abs(a - b) for a, b in zip(same["kernels"], same["kernels_off"])]
    prof = on["profile"]
    experts = prof["matmul_by_op"].get("aten::bmm", {"ms": 0.0, "count": 0})
    by_class = {**prof["device_ms_by_class"], "expert_matmul": experts["ms"]}
    by_class["matmul"] = by_class.get("matmul", 0.0) - experts["ms"]
    smooth = same["grads"][f"top{cfg.n_experts}"]
    out = {"model": f"mixtral_8x7b width, {L} layers (tied head, dense "
                    f"dispatch), B{B} x T{T}, no remat, ep 1",
           "n_params": on["n_params"], "losses": on["losses"],
           "same_weights": {"kernels": same["kernels"],
                            "kernels_off": same["kernels_off"],
                            "max_loss_abs_diff": max(diffs),
                            "tolerance": "each step's loss within 2e-2 of "
                                         "the kernels-off loss of the same "
                                         "weights (bf16)"},
           "grads": {**same["grads"],
                     "tolerance": f"with every expert chosen, the worst "
                                  f"leaf's ||g - g_off|| / ||g_off|| <= "
                                  f"{MOE_GRAD_LIMIT} (bf16 on both routes; "
                                  f"the kernels-off attention rounds its "
                                  f"scores to bf16)"},
           "step_ms": on["step_ms"], "host_ms": on["host_ms"],
           "tokens_per_s": on["tokens_per_s"], "mfu": on["mfu"],
           "model_tflops_per_step": on["model_tflops_per_step"],
           "peak_mem_gib": on["peak_mem_gib"],
           "step_profiler": on["step_profiler"],
           "launches_per_step": on["launches_per_step"],
           "device_ms": prof["device_ms"], "device_ms_by_class": by_class,
           # gate, up and down a layer, two products each backward: 9·L
           # bmm, more where the library splits one
           "expert_matmul_launches": experts["count"],
           "mfu_convention": "(6·N·B·T, N every parameter, + 12·L·B·T²·D/2) "
                             "/ median step after the first / 989 TFLOP/s"}
    emit({"moe_path": out})
    require(max(diffs) <= 2e-2,
            f"the MoE's losses with the kernels are off the kernels-off "
            f"losses of the same weights: {out['same_weights']}")
    require(smooth["worst_rel_err"] <= MOE_GRAD_LIMIT,
            f"the MoE's gradients with the kernels are off the kernels-off "
            f"gradients of the same weights: {smooth}")
    require(prof["complete"], "the MoE step's profile lost kernel records")
    return on


# --------------------------------------------------------------------------
# phase 16: ResNet-50 data-parallel training on one card
# --------------------------------------------------------------------------


# BASELINE config 4's model at its full width and the JAX example's
# defaults: B256 x 224^2 x 3, SGD-Nesterov 0.1 / 0.9 under the cosine decay
# over the run's steps, the pool of min(4, steps) batches
RESNET = dict(B=256, S=224, steps=8, lr=0.1, momentum=0.9)
# phase 13: the same per card, BASELINE config 4's global batch on four
RESNET_CARDS = dict(B=1024, steps=10)
# phase 16's bf16 step against f32 with TF32 off on the same weights and
# batch: the bound on each of the logits (max|err| / max|ref|), the first
# step's loss (|err|) and the running statistics (worst leaf's max|err| /
# max|ref|).  On the CPU at 64^2 B32 the errors were 1.35e-2, 2.1e-3 and
# 3.8e-3: bf16 rounds every conv's output and the BatchNorms' outputs.
RESNET_BF16 = dict(logits=5e-2, loss=2e-2, stats=2e-2)
# phase 13's global-batch BatchNorm over NCCL: ResNet-50 at 64^2 in f32
# with TF32 off, global batch 32, one step, against one card on the whole
# batch: the loss's relative error, the worst leaf's ||g - g1|| / ||g1||
# and the running statistics' worst leaf max|err| / max|ref|
RESNET_NCCL = dict(S=64, B=32, loss=1e-4, grad=1e-3, stats=1e-3)
# the profile's classes: the first whose key is in the name of an
# operator that (directly or through its callers) launched the kernel
RESNET_CLASSES = (("batch_norm", ("ptt.batch_norm",)),
                  ("optimizer", ("Optimizer.step",)),
                  ("conv", ("convolution",)))


def resnet_flops(model, image_size: int) -> float:
    """Forward FLOPs of one image: 2·Cout·Cin·k²·Hout·Wout for every conv
    (its output shape from a forward of one image) and 2·in·out for the
    head.  BatchNorm, ReLU, the max-pool, the residual adds and the mean
    are not counted.  ResNet-50 at 224^2: 8.18 GFLOP (4.09 GMAC)."""
    import torch

    from pytorch_operator_tpu_torch.models import resnet

    shapes = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: shapes.append((mod.weight.shape, out.shape)))
        for m in model.modules() if isinstance(m, resnet.Conv)]
    try:
        with torch.no_grad():
            resnet.apply(model, model.head.weight.new_zeros(
                (1, image_size, image_size, 3)), train=False)
    finally:
        for h in hooks:
            h.remove()
    conv = sum(2.0 * w.numel() * o[2] * o[3] for w, o in shapes)
    return conv + 2.0 * model.head.weight.numel()


def profile_resnet_step(torch, step) -> dict:
    """Device time of one more step by class (``RESNET_CLASSES``, else
    "other": ReLU, the pads and max-pool, the residual adds, the casts,
    the head and the loss): each kernel goes to the class of the
    innermost operator or range above its launch whose name has a key.
    The BatchNorm's key is its span, so the step runs with the port's
    spans on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pytorch_operator_tpu_torch.telemetry import spans

    with spans.enabled(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by_class: dict[str, float] = {}
    counts: dict[str, int] = {}
    attributed = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        cls, node = "other", e
        while node is not None and cls == "other":
            cls = next((c for c, keys in RESNET_CLASSES
                        if any(k in node.name for k in keys)), "other")
            node = node.cpu_parent
        for k in e.kernels:
            by_class[cls] = by_class.get(cls, 0.0) + k.duration / 1e3
            counts[cls] = counts.get(cls, 0) + 1
            attributed += k.duration / 1e3
    device = sum(e.device_time_total for e in device_events(prof)) / 1e3
    return {"device_ms": device, "device_ms_by_class": by_class,
            "kernel_counts": counts, "attributed_ms": attributed}


def resnet_same_weights(torch, images, labels) -> dict:
    """ResNet-50 of seed 0 in bf16 and in f32 (TF32 off) on the same
    batch: one forward in training mode each, its logits, loss and
    running statistics."""
    import torch.nn.functional as F

    from pytorch_operator_tpu_torch.models import resnet

    out = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        gen = torch.Generator(device="cuda").manual_seed(0)
        model = resnet.resnet50(dtype=dtype, device="cuda", generator=gen)
        with torch.no_grad():
            logits, stats = resnet.apply(model, images, train=True)
            out[name] = {"logits": logits.float(),
                         "loss": float(F.cross_entropy(logits, labels)),
                         "stats": {k: v.clone() for k, v in stats.items()}}
        del model
        free_memory(torch)
    a, b = out["bf16"], out["f32"]
    worst = max((float((a["stats"][k] - v).abs().max())
                 / max(float(v.abs().max()), 1e-12), k)
                for k, v in b["stats"].items())
    return {"logits_rel_err": float((a["logits"] - b["logits"]).abs().max())
            / float(b["logits"].abs().max()),
            "loss": [a["loss"], b["loss"]],
            "loss_abs_err": abs(a["loss"] - b["loss"]),
            "stats_worst_rel_err": worst[0], "stats_worst_leaf": worst[1],
            "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                     "matmul": torch.backends.cuda.matmul.allow_tf32},
            "tolerance": RESNET_BF16}


def run_resnet_path(torch) -> dict:
    """Phase 16: ResNet-50 (25.56M parameters) at its full width, B256 x
    224^2 x 3, bf16, channels_last, through train_resnet's entry points
    (resnet50, sgd, make_train_step, batch_pool): SGD-Nesterov 0.1 / 0.9
    under the cosine decay, 8 steps on the pool of 4 batches, every launch
    count reset just before and read just after (the path runs no kernel
    of the port: each count must stay 0).  Reported: the losses, finite
    and falling; the step time (median after the first), images/s and
    MFU against resnet_flops' conv + dense count, 3 x 8.18 GFLOP an image
    a step (forward, and twice that backward; BatchNorm not counted) over
    989 TFLOP/s; peak memory; one profiled step's device time by class
    (conv: cuDNN's kernels; batch_norm: the port's BatchNorm forward and
    backward; optimizer: SGD's step; other).  Then the bf16 model
    against the f32 one of the same weights with TF32 off on the first
    batch (``resnet_same_weights``, within RESNET_BF16), and three steps
    of ``train_resnet`` from the command line, without --device."""
    from pytorch_operator_tpu_torch import kernels, train_resnet
    from pytorch_operator_tpu_torch.models import resnet

    B, S, steps = RESNET["B"], RESNET["S"], RESNET["steps"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = resnet.resnet50(device="cuda", generator=gen)
    n_params = resnet.n_params(model)
    flops = 3.0 * resnet_flops(model, S) * B
    optimizer = train_resnet.sgd(model, RESNET["lr"], RESNET["momentum"])
    step = train_resnet.make_train_step(model, optimizer, RESNET["lr"],
                                        steps)
    pool = train_resnet.batch_pool(0, 0, 1, B, S, 1000, min(4, steps),
                                   torch.device("cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    kernels.reset_launches()
    for i in range(steps):
        t0 = time.perf_counter()
        loss = step(*pool[i % len(pool)])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = kernels.launch_counts()
    step_s = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_resnet_step(torch, lambda: step(*pool[0]))
    del model, optimizer, step
    free_memory(torch)
    same = resnet_same_weights(torch, *pool[0])
    del pool
    free_memory(torch)
    cli = io.StringIO()
    with contextlib.redirect_stdout(cli):
        rc = train_resnet.main(["--steps", "3", "--log-interval", "1"])
    text = cli.getvalue()
    cli_losses = [float(x) for x in re.findall(r"^step \d+: loss=(\S+)",
                                               text, re.MULTILINE)]
    free_memory(torch)
    out = {"model": "resnet50 (flax's SAME padding and BatchNorm, global "
                    "batch statistics), bf16, channels_last",
           "n_params": n_params,
           "batch": B, "image": S, "steps": steps, "losses": losses,
           "step_ms_all": [t * 1e3 for t in times],
           "step_ms": step_s * 1e3, "images_per_s": B / step_s,
           "train_tflops_per_step": flops / 1e12,
           "mfu": flops / step_s / PEAK_BF16_FLOPS,
           "peak_mem_gib": peak, "launches": counts,
           "profile": prof, "busy_share": prof["device_ms"] / (step_s * 1e3),
           "same_weights_f32": same,
           "cli": {"rc": rc, "losses": cli_losses,
                   "output": text.splitlines()},
           "mfu_convention": "3 x conv + dense FLOPs (resnet_flops) x B / "
                             "median step after the first / 989 TFLOP/s"}
    emit({"resnet_path": out})
    require(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
            f"ResNet-50's loss is not finite and falling: {losses}")
    require(not any(counts.values()),
            f"the ResNet path launched a kernel of the port: {counts}")
    require(same["logits_rel_err"] <= RESNET_BF16["logits"]
            and same["loss_abs_err"] <= RESNET_BF16["loss"]
            and same["stats_worst_rel_err"] <= RESNET_BF16["stats"],
            f"bf16 ResNet-50 is off the f32 one: {same}")
    require(rc == 0 and "training complete" in text and len(cli_losses) == 3
            and all(map(math.isfinite, cli_losses)),
            f"train_resnet failed: {text}")
    return out


# --------------------------------------------------------------------------
# phase 17: the operator's pods, one process a card through the launcher
# --------------------------------------------------------------------------


POD_JOB = "chip-smoke"
# phase 13's flagship run, as two pods of two cards each
PODS_FLAGSHIP = ["--model", "flagship", "--batch-size", "4", "--seq-len",
                 "2048", "--steps", str(CARDS_STEPS), "--log-interval", "1",
                 "--dp", "1", "--fsdp", "2", "--tp", "2"]


def operator_env(job: str, pods: int, rank: int, port: int) -> dict:
    """The env the JAX operator renders into pod ``rank`` (0 the Master,
    r the Worker r - 1) of PyTorchJob ``job`` with ``pods`` replicas and
    the master port ``port`` (``controller/tpu_env.py::build_cluster_env``,
    written out: this script imports nothing of the JAX package;
    ``tests/test_torch_launch.py`` holds it against the controller's
    rendering).  The port reads the c10d block; the TPU and JAX keys come
    along as the operator sets them."""
    hosts = [f"{job}-master-0"] + [f"{job}-worker-{i}"
                                   for i in range(pods - 1)]
    return {"MASTER_PORT": str(port),
            "MASTER_ADDR": "localhost" if rank == 0 else hosts[0],
            "WORLD_SIZE": str(pods), "RANK": str(rank),
            "PYTHONUNBUFFERED": "1", "PJRT_DEVICE": "TPU",
            "TPU_WORKER_ID": str(rank),
            "TPU_WORKER_HOSTNAMES": ",".join(hosts),
            "XRT_TPU_CONFIG": f"tpu_worker;{rank};"
                              + ",".join(f"{h}:8470" for h in hosts),
            "COORDINATOR_ADDRESS": f"{hosts[0]}:{port}",
            "NUM_PROCESSES": str(pods), "PROCESS_ID": str(rank)}


def _pods(torch, module: str, argv: list[str], pods: int,
          timeout: float = 600.0, cards_per_pod: int | None = None,
          launcher: bool = True) -> list[dict]:
    """``pods`` pods of one job on this host, started at once, each running
    ``python -m pytorch_operator_tpu_torch.launch
    pytorch_operator_tpu_torch.<module> argv`` (``launcher=False``: the
    module alone) under ``operator_env`` (the workers' MASTER_ADDR, the
    master's service, replaced by 127.0.0.1), a free MASTER_PORT, no
    LOCAL_RANK, and ``cards_per_pod`` of the visible cards (all of them
    over the pods) in its CUDA_VISIBLE_DEVICES.  Each pod runs in a
    session of its own; at the time limit each gets SIGTERM, on which the
    launcher ends its workers (they run in sessions of their own), then
    SIGKILL.  Each pod's rc, stdout and stderr."""
    import signal
    import tempfile

    seen = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = ([c.strip() for c in seen.split(",") if c.strip()] if seen
             else [str(i) for i in range(torch.cuda.device_count())])
    per = cards_per_pod or len(cards) // pods
    port = _free_port()
    procs = []
    for rank in range(pods):
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "GROUP_RANK",
                            "MASTER_ADDR", "MASTER_PORT")}
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env.update(operator_env(POD_JOB, pods, rank, port))
        if rank:
            env["MASTER_ADDR"] = "127.0.0.1"
        env["CUDA_VISIBLE_DEVICES"] = ",".join(cards[rank * per:
                                                     (rank + 1) * per])
        cmd = [sys.executable, "-m"] + (
            ["pytorch_operator_tpu_torch.launch"] if launcher else []) + [
            f"pytorch_operator_tpu_torch.{module}", *argv]
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        procs.append((subprocess.Popen(cmd, cwd=REPO, env=env, stdout=out,
                                       stderr=err, text=True,
                                       start_new_session=True), out, err))
    deadline = time.monotonic() + timeout
    try:
        for p, _, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, _, _ in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGTERM)
        for p, _, _ in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    res = []
    for p, out, err in procs:
        with out, err:
            out.seek(0)
            err.seek(0)
            res.append({"rc": p.returncode, "out": out.read(),
                        "err": err.read()})
    return res


def _check_allreduce(pods: list[dict], n: int) -> dict:
    text = "".join(p["out"] for p in pods)
    by_rank = _rank_reports(text)
    require(all(p["rc"] == 0 for p in pods)
            and text.count(f"all_reduce ok: psum(rank) == {n * (n - 1) // 2} "
                           f"on all {n} devices") == n
            and text.count("ppermute ring echo ok") == n
            and text.count("smoke-dist passed") == n
            and sorted(by_rank) == list(range(n)),
            f"dist_allreduce on {len(pods)} pod(s) over {n} cards failed: "
            + "; ".join(f"rc {p['rc']}: {p['out'][-1500:]} "
                        f"{p['err'][-1500:]}" for p in pods))
    return {"rcs": [p["rc"] for p in pods], "world": n, "by_rank": by_rank,
            "output": text.splitlines()}


def pod_launches(pods: dict) -> dict:
    """The port's kernel launches over every rank of every launched run
    of phase 17, from each rank's ``[worker r/n] ... launches=`` line (a
    kernel missing from a line fails here)."""
    return {s: sum(rep["launches"][s] for run in pods.values()
                   if isinstance(run, dict) and "by_rank" in run
                   for rep in run["by_rank"].values())
            for s in KERNEL_INFO}


def _launched_resnet(torch, pods: int, B: int, steps: int,
                     world: int) -> dict:
    """train_resnet on ``pods`` launched pods of ``world`` cards in all:
    its losses, step times (median after step 1), images/s and each
    rank's report."""
    argv = ["--batch-size", str(B), "--steps", str(steps),
            "--log-interval", "1"]
    t0 = time.perf_counter()
    runs = _pods(torch, "train_resnet", argv, pods)
    seconds = time.perf_counter() - t0
    text = "".join(p["out"] for p in runs)
    losses, times = _resnet_cli_steps(text, B)
    by_rank = _rank_reports(text)
    require(all(p["rc"] == 0 for p in runs) and len(losses) == steps
            and all(map(math.isfinite, losses))
            and "training complete" in text
            and sorted(by_rank) == list(range(world)),
            f"launched train_resnet on {pods} pod(s) failed: "
            + "; ".join(f"rc {p['rc']}: {p['out'][-1500:]} "
                        f"{p['err'][-2500:]}" for p in runs))
    step_s = statistics.median(times[1:])
    return {"pods": pods, "argv": argv, "losses": losses,
            "step_ms_all": [t * 1e3 for t in times],
            "steady_step_ms": step_s * 1e3, "images_per_s": B / step_s,
            "by_rank": by_rank, "process_s": seconds,
            "output": text.splitlines()[:3]}


def run_pods(torch, resnet_one_card: dict) -> dict:
    """Phase 17: the operator's env on this host, literally
    (``operator_env``), through ``python -m
    pytorch_operator_tpu_torch.launch``.  One pod with every visible card:
    dist_allreduce (the sum over every card) and train_resnet at B256
    for 3 steps (images/s beside phase 16's).  With two cards or more,
    two pods at once with half the cards each: dist_allreduce over all of
    them; with four, phase 13's flagship run (fsdp 2 x tp 2, B4 x T2048)
    on 2 pods x 2 cards (held against phase 13's run in ``check_pods``)
    and train_resnet at --batch-size RESNET_CARDS["B"]; then the C4
    guard: train_resnet started directly under WORLD_SIZE=1 RANK=0 with
    no LOCAL_RANK and every card visible exits non-zero, names the
    launcher, and trains no step."""
    import tempfile

    cards = torch.cuda.device_count()
    res = {"cards": cards}
    t0 = time.perf_counter()
    res["one_pod_allreduce"] = _check_allreduce(
        _pods(torch, "dist_allreduce", [], 1, timeout=300), cards)
    res["one_pod_allreduce"]["process_s"] = time.perf_counter() - t0
    r = res["one_pod_resnet"] = _launched_resnet(torch, 1, RESNET["B"], 3,
                                                 cards)
    r["phase16_images_per_s"] = resnet_one_card["images_per_s"]
    if cards >= 2:
        half = cards // 2
        t0 = time.perf_counter()
        res["two_pod_allreduce"] = _check_allreduce(
            _pods(torch, "dist_allreduce", [], 2, timeout=300), 2 * half)
        res["two_pod_allreduce"]["process_s"] = time.perf_counter() - t0
    if cards >= 4:
        with tempfile.TemporaryDirectory() as tmp:
            argv = PODS_FLAGSHIP + ["--profile-dir", tmp,
                                    "--profile-steps", "1"]
            t0 = time.perf_counter()
            runs = _pods(torch, "train_llama", argv, 2, cards_per_pod=2)
            seconds = time.perf_counter() - t0
            text = "".join(p["out"] for p in runs)
            require(all(p["rc"] == 0 for p in runs)
                    and "training complete" in text,
                    "the launched flagship failed: " + "; ".join(
                        f"rc {p['rc']}: {p['out'][-1500:]} "
                        f"{p['err'][-2500:]}" for p in runs))
            losses, times = _cli_steps(text, 4 * 2048)
            step_s = statistics.median(times[2:])
            res["flagship_pods"] = {
                "pods": 2, "cards_per_pod": 2, "argv": argv,
                "losses": losses, "step_ms_all": [t * 1e3 for t in times],
                "steady_step_ms": step_s * 1e3,
                "tokens_per_s": 4 * 2048 / step_s,
                "profiled_step": _nccl_share(os.path.join(
                    tmp, "trace_rank0.json")),
                "by_rank": _rank_reports(text), "process_s": seconds,
                "output": text.splitlines()[:3]}
        res["resnet_pods"] = _launched_resnet(torch, 2, RESNET_CARDS["B"],
                                              RESNET_CARDS["steps"], 4)
    if cards >= 2:
        [pod] = _pods(torch, "train_resnet", ["--steps", "1"], 1,
                      timeout=300, launcher=False)
        res["guard"] = {"rc": pod["rc"], "stderr": pod["err"][-600:]}
        require(pod["rc"] != 0
                and "pytorch_operator_tpu_torch.launch" in pod["err"]
                and not re.search(r"^step \d+:", pod["out"], re.M),
                f"train_resnet under the operator's env on {cards} cards "
                f"did not refuse: rc {pod['rc']} {pod['out'][-1000:]} "
                f"{pod['err'][-1000:]}")
    emit({"pods": res})
    return res


def check_pods(torch, pods: dict, cards: dict | None,
               resnet_cards: dict | None) -> dict:
    """Phase 17's four-card runs against phase 13's on the same work: the
    launched flagship's losses within 2e-2 of ``flagship_fsdp2_tp2``'s
    step by step and its launches equal on every rank; step times and
    images/s reported beside each other, not gated (NCCL between pods
    with disjoint CUDA_VISIBLE_DEVICES may not take the NVLink P2P
    path)."""
    require(cards is not None and "flagship_fsdp2_tp2" in cards,
            "phase 13's flagship_fsdp2_tp2 run is missing")
    got, ref = pods["flagship_pods"], cards["flagship_fsdp2_tp2"]
    diff = max(abs(a - b) for a, b in zip(got["losses"], ref["losses"]))
    launches = {r: (got["by_rank"].get(r, {}).get("launches"),
                    rep["launches"]) for r, rep in ref["by_rank"].items()}
    out = {"flagship": {
        "max_loss_abs_diff": diff, "losses": [got["losses"], ref["losses"]],
        "steady_step_ms": [got["steady_step_ms"], ref["steady_step_ms"]],
        "nccl_share": [got["profiled_step"].get("nccl_share"),
                       ref["profiled_step"].get("nccl_share")],
        "launches_equal": all(a == b for a, b in launches.values()),
        "tolerance": "each step's loss within 2e-2 of phase 13's "
                     "flagship_fsdp2_tp2 (bf16; the same seeded init and "
                     "batches)"},
        "resnet": resnet_cards and {
            "images_per_s": [pods["resnet_pods"]["images_per_s"],
                             resnet_cards["images_per_s"]],
            "ratio": pods["resnet_pods"]["images_per_s"]
            / resnet_cards["images_per_s"]},
        "order": "[2 pods through the launcher, phase 13 under "
                 "torch.distributed.run]"}
    emit({"pods_vs_cards": out})
    require(len(got["losses"]) == len(ref["losses"]) == CARDS_STEPS
            and diff <= 2e-2, f"the launched flagship's losses are off "
                              f"phase 13's: {out['flagship']}")
    require(len(launches) == 4 and out["flagship"]["launches_equal"],
            f"the launched flagship's launches differ: {launches}")
    return out


LAYOUT_STEPS = 16


def time_launch_layouts(torch) -> dict:
    """Not a phase (four cards, about 4 min): phase 17's flagship run
    (fsdp 2 x tp 2, B4 x T2048) in three layouts, in the order T, L1,
    L2, L1, T so that T and L1 each run early and late: under
    torch.distributed.run (T, phase 13's), through one launcher pod of
    the four cards (L1, what a pod renting four cards runs) and as two
    launcher pods of two cards each (L2, phase 17's).  LAYOUT_STEPS
    steps, no profiler; the steady step is the median of steps 2 on.
    Every run has NCCL_DEBUG=INFO, and the transports NCCL names for its
    channels (``via P2P/...``, ``via SHM/...``) are counted by run.
    Losses must be within 2e-2 of the first run's; times are reported.
    Run: ``python3 -c "import torch, chip_smoke as c; from
    pytorch_operator_tpu_torch import kernels; kernels.build();
    c.time_launch_layouts(torch)"``."""
    import collections

    require(torch.cuda.device_count() >= 4, "time_launch_layouts needs "
                                            "four cards")
    argv = list(PODS_FLAGSHIP)
    argv[argv.index("--steps") + 1] = str(LAYOUT_STEPS)
    nccl = {"NCCL_DEBUG": "INFO", "NCCL_DEBUG_SUBSYS": "INIT,P2P"}
    saved = {k: os.environ.get(k) for k in nccl}
    os.environ.update(nccl)
    runs = []
    try:
        for layout in ("T", "L1", "L2", "L1", "T"):
            t0 = time.perf_counter()
            if layout == "T":
                text = _trainer(argv, nproc=4)
            else:
                pods = _pods(torch, "train_llama", argv,
                             1 if layout == "L1" else 2, cards_per_pod=(
                                 4 if layout == "L1" else 2))
                text = "".join(p["out"] + p["err"] for p in pods)
                require(all(p["rc"] == 0 for p in pods)
                        and "training complete" in text,
                        f"{layout} failed: " + "; ".join(
                            f"rc {p['rc']}: {p['err'][-2500:]}"
                            for p in pods))
            losses, times = _cli_steps(text, 4 * 2048)
            require(len(losses) == LAYOUT_STEPS,
                    f"{layout}: {len(losses)} steps")
            steady = [t * 1e3 for t in times[2:]]
            runs.append({
                "layout": layout, "losses": losses,
                "steady_step_ms": statistics.median(steady),
                "min_ms": min(steady), "max_ms": max(steady),
                "step_ms_all": [t * 1e3 for t in times],
                "transports": dict(collections.Counter(
                    re.findall(r" via (\S+)", text))),
                "process_s": time.perf_counter() - t0})
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    diff = max(abs(a - b) for r in runs
               for a, b in zip(r["losses"], runs[0]["losses"]))
    out = {"runs": runs, "max_loss_abs_diff": diff,
           "median_of_runs_ms": {
               lay: statistics.median(r["steady_step_ms"] for r in runs
                                      if r["layout"] == lay)
               for lay in ("T", "L1", "L2")}}
    emit({"launch_layouts": out})
    require(diff <= 2e-2, f"the layouts' losses differ by {diff}")
    return out


# --------------------------------------------------------------------------
# phase 13: several cards
# --------------------------------------------------------------------------


def _nccl_share(trace_path: str) -> dict:
    """Device time of one profiled step from a Chrome trace: all kernels,
    and the NCCL kernels' share of it."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    total = sum(e["dur"] for e in kern) / 1e3
    nccl = sum(e["dur"] for e in kern if "nccl" in e["name"].lower()) / 1e3
    return {"device_ms": total, "nccl_ms": nccl,
            "nccl_share": nccl / total if total else None}


def _ring_nccl_worker(rank, n, port, out_dir) -> None:
    """One rank of ``check_ring_nccl``: rank 0's seeded inputs broadcast
    to all, then for each layout and backward route the ring through
    ``RingComm`` (NCCL P2P) on this rank's chunk, and the loopback ring
    of n virtual ranks on the whole sequence on this rank's card; its
    result (JSON) goes to ``out_dir/<rank>.json``."""
    import importlib

    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from pytorch_operator_tpu_torch import kernels

    # the modules (the packages export their functions under these names)
    fa = importlib.import_module("pytorch_operator_tpu_torch.ops."
                                 "flash_attention")
    ra = importlib.import_module("pytorch_operator_tpu_torch.parallel."
                                 "ring_attention")

    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank)
    try:
        B, T, H, D = (RING[x] for x in ("B", "T", "H", "D"))
        x = torch.empty(4, B, T, H, D, dtype=torch.bfloat16, device=device)
        if rank == 0:
            x.copy_(torch.randn(x.shape, device=device, generator=(
                torch.Generator(device=device).manual_seed(0))))
        dist.broadcast(x, 0)
        q, k, v, g = x.unbind(0)
        fused_bytes = fa._FUSED_DQ_BYTES
        res = {}
        for layout in ra.LAYOUTS:
            pairs = sum(len(ra._pairs(rank, (rank - s) % n, True, layout))
                        for s in range(n))
            for route, dq_bytes in (("default", fused_bytes),
                                    ("two_kernel", 0)):
                fa._FUSED_DQ_BYTES = dq_bytes
                fused = fa._use_fused_bwd(T // n // (
                    1 if layout == "contiguous" else 2), D)
                mine = [t.chunk(n, 1)[rank].detach().requires_grad_(True)
                        for t in (q, k, v)]
                kernels.reset_launches()
                out = ra.ring_attention(*mine, ra.RingComm(), causal=True,
                                        layout=layout)
                out.backward(g.chunk(n, 1)[rank])
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
                whole = [t.detach().requires_grad_(True) for t in (q, k, v)]
                ref = ra.ring_attention_loopback(*whole, n, causal=True,
                                                 layout=layout)
                ref.backward(g)
                got = dict(zip(("out", "dq", "dk", "dv"),
                               (out, *(t.grad for t in mine))))
                want = dict(zip(("out", "dq", "dk", "dv"),
                                (ref, *(t.grad for t in whole))))
                case = {"fused_bwd": fused}
                for name in got:
                    a = got[name].detach().float()
                    b = want[name].detach().chunk(n, 1)[rank].float()
                    d = (a - b).abs()
                    # the fused backward's dq sums with f32 atomics in an
                    # order that changes from run to run: one bf16 ulp
                    ulp = 2.0 ** -7 * torch.maximum(a.abs(), b.abs()) \
                        + 1e-5 * b.abs().max()
                    case[name] = {
                        "bitwise": torch.equal(a, b),
                        "unequal": int((d > 0).sum()),
                        "max_abs_diff": float(d.max()),
                        "within_one_ulp": bool((d <= ulp).all())}
                syms = (("flash_bwd_sm90",) if fused else
                        ("flash_bwd_dq_sm90", "flash_bwd_dkv_sm90"))
                want_counts = {s: 0 for s in FLASH_SYMBOLS}
                want_counts.update({s: pairs for s in
                                    ("flash_fwd_sm90",) + syms})
                case["launches"] = {s: counts[s] for s in FLASH_SYMBOLS}
                case["want_launches"] = want_counts
                res[f"{layout}/{route}"] = case
                del mine, whole, out, ref, got, want
        fa._FUSED_DQ_BYTES = fused_bytes
        with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _on_cards(worker, n: int, what: str, timeout: float = 300.0) -> list:
    """``worker(rank, n, port, out_dir)`` in one spawned process per card;
    each rank's JSON result (``out_dir/<rank>.json``), or the phase
    fails.  Processes still alive at the end are killed."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(worker, args=(n, _free_port(), tmp),
                                 nprocs=n, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > timeout:
                    raise SmokeFailure(f"{what} took over {timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise SmokeFailure(f"{what} failed: {e}") from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        ranks = []
        for r in range(n):
            with open(os.path.join(tmp, f"{r}.json")) as f:
                ranks.append(json.load(f))
    return ranks


def check_ring_nccl(torch, n: int) -> dict:
    """The ring over NCCL on n cards (one spawned process per card) at
    phase 11's shape, contiguous and zigzag_pre, on the trainer's
    backward route and on the two-kernel one: each rank's out, dq, dk
    and dv against the loopback ring's chunk on the same inputs, bit for
    bit (the same arithmetic in the same order; only the transport and
    its stream ordering differ), but the fused route's dq (f32 atomics)
    within one bf16 ulp; each rank's launches its chunk pairs."""
    t0 = time.perf_counter()
    ranks = _on_cards(_ring_nccl_worker, n, "the NCCL ring")
    seconds = time.perf_counter() - t0
    bad = []
    for r, res in enumerate(ranks):
        for case, c in res.items():
            for name in ("out", "dq", "dk", "dv"):
                exact = not (name == "dq" and c["fused_bwd"])
                if not (c[name]["bitwise"] if exact
                        else c[name]["within_one_ulp"]):
                    bad.append(f"rank {r} {case} {name}: {c[name]}")
            if c["launches"] != c["want_launches"]:
                bad.append(f"rank {r} {case} launches {c['launches']}")
    out = {"ranks": n, "backend": "nccl",
           "shape": [RING[x] for x in ("B", "T", "H", "D")],
           "seconds": seconds, "by_rank": ranks,
           "check": "each rank's out, dq, dk, dv bit for bit the loopback "
                    "ring's chunk; the fused backward's dq within one bf16 "
                    "ulp (f32 atomics); chunk-pair launches on each rank"}
    emit({"ring_nccl": out})
    require(not bad, "the NCCL ring disagrees with the loopback: "
                     + "; ".join(bad))
    return out


def _pp_record(torch, stages, comm, batch, M, schedule) -> dict:
    """``pipeline_value_and_grad`` of Llama stages with the pipeline
    step's functions, recording per stage, in the order of its autograd
    ticks, each output of its layers and the gradient of their input;
    then its parameters' gradients (before the sum over the stages) and,
    on the last stage, the loss."""
    from pytorch_operator_tpu_torch.parallel.pipeline import (
        PipeLoopback,
        pipeline_value_and_grad,
    )
    from pytorch_operator_tpu_torch.parallel.train import cross_entropy_loss

    index = {id(st): st.layer_ids.start // len(st.layer_ids)
             for st in stages}
    rec = {s: {"y": [], "dx": []} for s in index.values()}

    def stage_fn(stage, x):
        y = stage.run_layers(x)
        if torch.is_grad_enabled():  # the run that is backpropagated
            r = rec[index[id(stage)]]
            r["y"].append(y.detach().clone())
            x.register_hook(lambda g: r["dx"].append(g.detach().clone()))
        return y

    def last_fn(stage, y, targets):
        logits = stage.head(y, return_hidden=True) @ stage.embed.t()
        return cross_entropy_loss(logits.float(), targets) / M

    loss = pipeline_value_and_grad(
        lambda st, t: st.embed_tokens(t), stage_fn, last_fn,
        stages if isinstance(comm, PipeLoopback) else stages[0],
        batch[:, :-1], batch[:, 1:], comm, n_microbatches=M,
        schedule=schedule)
    for st in stages:
        r = rec[index[id(st)]]
        r["grads"] = {n: p.grad.clone() for n, p in st.named_parameters()
                      if p.grad is not None}
        r["loss"] = loss if index[id(st)] == comm.n - 1 else None
    return rec


def _same(a, b) -> dict:
    """Bitwise comparison of two lists (or dicts) of tensors."""
    if isinstance(a, dict):
        keys_ok = sorted(a) == sorted(b)
        a, b = [a[k] for k in sorted(a)], [b.get(k) for k in sorted(a)]
    else:
        keys_ok = len(a) == len(b)
    unequal = sum(int((x != y).sum()) for x, y in zip(a, b)
                  if y is not None and x.shape == y.shape)
    return {"bitwise": keys_ok and all(
        y is not None and x.shape == y.shape and bool((x == y).all())
        for x, y in zip(a, b)), "tensors": len(a), "unequal": unequal}


def _nccl_init(rank: int, n: int, port: int):
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank)
    return device


def _pipe_nccl_worker(rank, n, port, out_dir) -> None:
    """One rank of ``check_pipe_nccl``: rank 0's seeded batch broadcast
    to all; for each schedule this rank's stage through ``PipeComm``
    (NCCL P2P) and the loopback of every stage on this rank's card, with
    the two-kernel backward (its dq has no atomics, so reruns give the
    same bits); the comparison goes to ``out_dir/<rank>.json``."""
    import importlib

    import numpy as np
    import torch
    import torch.distributed as dist

    device = _nccl_init(rank, n, port)
    from pytorch_operator_tpu_torch import kernels
    from pytorch_operator_tpu_torch.models import llama
    from pytorch_operator_tpu_torch.parallel.mesh import make_named_mesh
    from pytorch_operator_tpu_torch.parallel.pipeline import (
        SCHEDULES,
        PipeComm,
        PipeLoopback,
    )
    from pytorch_operator_tpu_torch.parallel.train import sharded_init

    fa = importlib.import_module("pytorch_operator_tpu_torch.ops."
                                 "flash_attention")
    try:
        fa._FUSED_DQ_BYTES = 0
        L, B, T, M = 2 * n, PIPE["B"], PIPE["T"], PIPE["M"]
        cfg = llama.llama2_7b(n_layers=L, max_seq_len=T, use_flash=True,
                              use_fused_norm=True, remat=False)
        mesh = make_named_mesh({"pp": n}, device)
        comm = PipeComm(mesh["pp"].get_group())
        batch = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, T + 1))).to(device)
        dist.broadcast(batch, 0)
        res = {}
        for schedule in SCHEDULES:
            stage = sharded_init(cfg, mesh, seed=0,
                                 specs=llama.pp_param_specs(cfg, n))
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            got = _pp_record(torch, [stage], comm, batch, M, schedule)[rank]
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = kernels.launch_counts()
            del stage
            gc.collect()
            stages = llama.pipeline_stages(cfg, n, device=device, seed=0)
            want = _pp_record(torch, list(stages), PipeLoopback(n), batch, M,
                              schedule)[rank]
            del stages
            case = {name: _same(got[name], want[name])
                    for name in ("y", "dx", "grads")}
            if got["loss"] is not None:
                case["loss"] = {"p2p": float(got["loss"]),
                                "loopback": float(want["loss"]),
                                "bitwise": bool(torch.equal(got["loss"],
                                                            want["loss"]))}
            case["seconds"] = seconds
            case["launches"] = {k: counts[k] for k in FLASH_SYMBOLS
                                + ("rms_norm_fwd",)}
            case["want_launches"] = pp_launches(L, M, n, schedule, stage=rank,
                                                two_kernel=True)
            res[schedule] = case
            del got, want
            gc.collect()
            torch.cuda.empty_cache()
        with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def check_pipe_nccl(torch, n: int) -> dict:
    """The pipeline over NCCL on n cards (one spawned process per card)
    at phase 14's width, two layers a stage, B4 x T4096 in 4
    microbatches, both schedules: each rank's layer outputs, input
    gradients, parameter gradients and (last rank) loss bit for bit the
    loopback's on the same inputs, and each rank's launches its stage's
    share."""
    t0 = time.perf_counter()
    ranks = _on_cards(_pipe_nccl_worker, n, "the NCCL pipeline")
    seconds = time.perf_counter() - t0
    bad = []
    for r, res in enumerate(ranks):
        for schedule, c in res.items():
            for name in ("y", "dx", "grads", "loss"):
                if name in c and not c[name]["bitwise"]:
                    bad.append(f"rank {r} {schedule} {name}: {c[name]}")
            if ("loss" in c) != (r == n - 1):
                bad.append(f"rank {r} {schedule}: loss where none is due")
            if c["launches"] != c["want_launches"]:
                bad.append(f"rank {r} {schedule} launches {c['launches']}")
    out = {"ranks": n, "backend": "nccl",
           "shape": f"llama2_7b width, {2 * n} layers, B{PIPE['B']} x "
                    f"T{PIPE['T']}, {PIPE['M']} microbatches",
           "seconds": seconds, "by_rank": ranks,
           "check": "each rank's layer outputs, input gradients, parameter "
                    "gradients and loss bit for bit the loopback's "
                    "(two-kernel backward); launches its stage's share"}
    emit({"pipe_nccl": out})
    require(not bad, "the NCCL pipeline disagrees with the loopback: "
                     + "; ".join(bad))
    return out


def _reshard_nccl_worker(rank, n, port, out_dir) -> None:
    """One rank of ``check_reshard_nccl`` (the two-kernel backward, so
    that two steps on equal states give equal bits)."""
    import importlib

    import numpy as np
    import torch

    device = _nccl_init(rank, n, port)
    import torch.distributed as dist

    from pytorch_operator_tpu_torch.models import llama
    from pytorch_operator_tpu_torch.parallel.mesh import make_mesh
    from pytorch_operator_tpu_torch.parallel.train import (
        TrainState,
        adamw,
        make_train_step,
        reshard_state,
        sharded_init,
    )

    fa = importlib.import_module("pytorch_operator_tpu_torch.ops."
                                 "flash_attention")

    def gathered(state):
        out = {}
        for name, p in state.model.named_parameters():
            out[f"model/{name}"] = llama.full_value(p).detach().clone()
            for k, v in state.optimizer.state.get(p, {}).items():
                out[f"optim/{name}/{k}"] = llama.full_value(v).detach(
                    ).clone()
        return out

    try:
        fa._FUSED_DQ_BYTES = 0
        cfg = llama.flagship()
        mesh4 = make_mesh(1, n, 1, device)
        mesh22 = make_mesh(1, n // 2, 2, device)
        batch = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, MAIN["T"] + 1))).to(device)
        model = sharded_init(cfg, mesh4, seed=0)
        opt = adamw(model, 3e-4, weight_decay=0.1)
        state, _ = make_train_step(cfg, model, opt, mesh=mesh4)(
            TrainState(model, opt), batch)
        del model, opt
        first = gathered(state)
        res = {"values": len(first)}
        times = []
        for name, mesh in (("fsdp4_to_fsdp2_tp2", mesh22),
                           ("back_to_fsdp4", mesh4)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = reshard_state(state, cfg, mesh)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            res[name] = _same(first, gathered(state))
        res["reshard_s"] = times
        del state, first
        gc.collect()
        # one step from a resharded fresh state against one from a fresh
        # state built on fsdp 2 x tp 2: the same values, the same layout
        fresh = sharded_init(cfg, mesh4, seed=0)
        moved = reshard_state(TrainState(fresh, adamw(fresh, 3e-4,
                                                      weight_decay=0.1)),
                              cfg, mesh22)
        del fresh
        model22 = sharded_init(cfg, mesh22, seed=0)
        built = TrainState(model22, adamw(model22, 3e-4, weight_decay=0.1))
        losses = []
        for st in (moved, built):
            st, m = make_train_step(cfg, st.model, st.optimizer,
                                    mesh=mesh22)(st, batch)
            losses.append(float(m["loss"]))
        res["step_losses"] = losses
        res["step_bitwise"] = _same(gathered(moved), gathered(built))
        res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def check_reshard_nccl(torch, n: int) -> dict:
    """reshard_state over NCCL on n cards: the flagship after one AdamW
    step (B4 x T2048) from fsdp n to fsdp n/2 x tp 2 and back, every
    gathered parameter and moment bit for bit; then one step on fsdp
    n/2 x tp 2 from a resharded fresh state, bit for bit the step of a
    fresh state built on that mesh."""
    t0 = time.perf_counter()
    ranks = _on_cards(_reshard_nccl_worker, n, "reshard_state over NCCL")
    out = {"ranks": n, "model": "flagship", "seconds":
           time.perf_counter() - t0, "by_rank": ranks,
           "check": "gathered params and AdamW moments bit for bit after "
                    "each reshard; the step after a reshard bit for bit "
                    "the step of a state built on the new mesh"}
    emit({"reshard_nccl": out})
    bad = [f"rank {r}: {res}" for r, res in enumerate(ranks)
           if not (res["fsdp4_to_fsdp2_tp2"]["bitwise"]
                   and res["back_to_fsdp4"]["bitwise"]
                   and res["step_bitwise"]["bitwise"]
                   and res["step_losses"][0] == res["step_losses"][1])]
    require(not bad, "reshard_state over NCCL changed values: "
                     + "; ".join(bad))
    return out


def _moe_nccl_worker(rank, n, port, out_dir) -> None:
    """One rank of ``check_moe_nccl``: for each of MOE_CARDS' runs the
    MoE at Mixtral-8x7B's width on its (dp, fsdp, tp, ep) mesh over NCCL
    through sharded_init and make_train_step, on phase 15's seed and
    batch: losses, step times, launches, peak memory, one profiled
    step's NCCL share, and each parameter the ep ranks replicate against
    the other ep ranks' copies after the steps.  In the runs that say so,
    before each step, the whole weights are gathered into an unsharded
    model with the kernels off (one card's layout) and its loss taken."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.profiler import ProfilerActivity, profile

    device = _nccl_init(rank, n, port)
    from pytorch_operator_tpu_torch import kernels
    from pytorch_operator_tpu_torch.models import llama, moe
    from pytorch_operator_tpu_torch.parallel.mesh import make_named_mesh
    from pytorch_operator_tpu_torch.parallel.train import (
        TrainState,
        adamw,
        make_train_step,
        sharded_init,
    )

    B, T = MOE["B"], MOE["T"]
    res = {}
    try:
        for label, shape, L, steps, same_weights in MOE_CARDS:
            mesh = make_named_mesh(dict(zip(("dp", "fsdp", "tp", "ep"),
                                            shape)), device)
            cfg = moe.mixtral_8x7b(n_layers=L, max_seq_len=T)
            t0 = time.perf_counter()
            model = sharded_init(cfg, mesh, seed=0)
            optimizer = adamw(model, 3e-4, weight_decay=0.1)
            step = make_train_step(cfg, model, optimizer, mesh=mesh)
            state = TrainState(model, optimizer)
            batch = torch.from_numpy(np.random.default_rng(0).integers(
                0, cfg.vocab_size, (B, T + 1))).to(device)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            shadow = None
            if same_weights:
                shadow = moe.MoELlama(_kernels_off(cfg), device="meta"
                                      ).to_empty(device=device)
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            losses, times, off = [], [], []
            for _ in range(steps):
                if shadow is not None:
                    with torch.no_grad():
                        for p, q in zip(model.parameters(),
                                        shadow.parameters()):
                            q.copy_(llama.full_value(p))
                        off.append(float(moe_loss(torch, shadow, batch)))
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(float(metrics["loss"]))
            counts = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                state, _ = step(state, batch)
                torch.cuda.synchronize()
            events = device_events(prof)
            kernel_ms = sum(e.device_time_total for e in events) / 1e3
            nccl_ms = sum(e.device_time_total for e in events
                          if "nccl" in e.key.lower()) / 1e3
            ep = mesh["ep"].size()
            group = mesh["ep"].get_group()
            unequal, worst, checked = [], 0.0, 0
            with torch.no_grad():
                for name, p in model.named_parameters():
                    if name.rsplit(".", 1)[-1] in moe.EXPERT_BANKS:
                        continue
                    t = (p.to_local() if isinstance(p, DTensor)
                         else p).contiguous()
                    copies = [torch.empty_like(t) for _ in range(ep)]
                    dist.all_gather(copies, t, group=group)
                    checked += 1
                    for c in copies[1:]:
                        if not torch.equal(c, copies[0]):
                            unequal.append(name)
                            worst = max(worst, float(
                                (c.float() - copies[0].float()).abs().max()))
            step_s = statistics.median(times[1:])
            flops = moe_flops(cfg, B, T)
            res[label] = {
                "mesh": dict(zip(("dp", "fsdp", "tp", "ep"), shape)),
                "layers": L, "steps": steps,
                "losses": losses, "step_ms_all": [t * 1e3 for t in times],
                "step_ms": step_s * 1e3, "tokens_per_s": B * T / step_s,
                "model_tflops_per_step": flops / 1e12,
                "mfu": flops / step_s / (PEAK_BF16_FLOPS * n),
                "peak_mem_gib": peak, "init_s": init_s,
                "launches_per_step": {k: counts[k] / steps
                                      for k in moe_launches(L)},
                "want_launches_per_step": moe_launches(L),
                "profiled_step": {"device_ms": kernel_ms,
                                  "nccl_ms": nccl_ms, "nccl_share": (
                                      nccl_ms / kernel_ms if kernel_ms
                                      else None)},
                "replicated": {"checked": checked,
                               "unequal": sorted(set(unequal)),
                               "max_abs_diff": worst},
                "same_weights_one_card_off": off}
            del model, optimizer, step, state, prof, events, shadow
            gc.collect()
            torch.cuda.empty_cache()
        with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def check_moe_nccl(torch, n: int, one_card: dict | None) -> dict:
    """The MoE over NCCL on four cards (one spawned process per card),
    MOE_CARDS' runs: ep 4 at phase 15's depth, same seed and batch, each
    step's loss within 2e-2 of the loss an unsharded kernels-off model
    takes on the same (gathered) weights and of phase 15's
    (``one_card``); ep 4 and tp 2 x ep 2 at depth 8: launches per step
    exactly moe_launches on every rank, step time, MFU (the model's
    FLOPs counted once, over the four cards' peak), each rank's peak
    memory and the NCCL share of rank 0's profiled step.  In every run
    the weights the ep ranks replicate come out bit for bit equal after
    the steps (the step averages their gradients over ep)."""
    t0 = time.perf_counter()
    ranks = _on_cards(_moe_nccl_worker, n, "the MoE over NCCL",
                      timeout=900.0)
    seconds = time.perf_counter() - t0
    bad, out = [], {"ranks": n, "backend": "nccl", "seconds": seconds}
    for label, shape, L, steps, same_weights in MOE_CARDS:
        runs = [r[label] for r in ranks]
        r0 = runs[0]
        out[label] = {**{k: r0[k] for k in (
            "mesh", "layers", "steps", "losses",
            "step_ms_all", "step_ms", "tokens_per_s",
            "model_tflops_per_step", "mfu", "profiled_step",
            "same_weights_one_card_off")},
            "peak_mem_gib_by_rank": [r["peak_mem_gib"] for r in runs],
            "init_s_by_rank": [r["init_s"] for r in runs],
            "launches_per_step": r0["launches_per_step"],
            "replicated_by_rank": [r["replicated"] for r in runs]}
        for i, r in enumerate(runs):
            if r["launches_per_step"] != {
                    k: float(v) for k, v in r["want_launches_per_step"].items()}:
                bad.append(f"{label} rank {i} launches "
                           f"{r['launches_per_step']}")
            if not all(map(math.isfinite, r["losses"])):
                bad.append(f"{label} rank {i} losses {r['losses']}")
            if r["replicated"]["unequal"]:
                bad.append(f"{label} rank {i}: the replicated weights differ "
                           f"over ep: {r['replicated']}")
        if r0["losses"][-1] >= r0["losses"][0]:
            bad.append(f"{label}: the loss did not fall: {r0['losses']}")
        if same_weights:
            d = max(abs(a - b) for a, b in zip(
                r0["losses"], r0["same_weights_one_card_off"]))
            out[label]["same_weights_max_abs_diff"] = d
            if d > 2e-2:
                bad.append(f"{label}: its losses are off the one-card "
                           f"kernels-off losses of the same weights: "
                           f"{r0['losses']} {r0['same_weights_one_card_off']}")
    if one_card is not None:
        ref = one_card["losses"]
        got = out[MOE_CARDS[0][0]]["losses"]
        out["vs_one_card"] = {
            "one_card": ref,
            "abs_diff_by_step": [abs(a - b) for a, b in zip(got, ref)],
            "tolerance": "each step's loss within 2e-2 of phase 15's (bf16; "
                         "same seed and batch) and of the one-card "
                         "kernels-off loss of the same weights"}
        if max(out["vs_one_card"]["abs_diff_by_step"]) > 2e-2:
            bad.append(f"ep 4 off the one-card run: {out['vs_one_card']}")
    out["mfu_convention"] = ("(6·N·B·T + 12·L·B·T²·D/2) / median step after "
                             "the first / (989 TFLOP/s x cards): the "
                             "attention and head every ep rank repeats "
                             "counted once")
    emit({"moe_nccl": out})
    require(not bad, "the MoE over NCCL: " + "; ".join(bad))
    return out


def _resnet_bn_nccl_worker(rank, n, port, out_dir) -> None:
    """One rank of ``check_resnet_nccl``: ResNet-50 in f32 (TF32 off) of
    seed 0 takes one train_resnet step (DDP over the n cards) on this
    rank's rows of one seeded global batch, its BatchNorms over the
    global batch, and again with each BatchNorm on its rank's rows;
    rank 0 then takes the step on the whole batch alone and writes each
    variant's distance from it."""
    import numpy as np
    import torch
    import torch.distributed as dist

    device = _nccl_init(rank, n, port)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from pytorch_operator_tpu_torch import train_resnet
    from pytorch_operator_tpu_torch.models import resnet

    try:
        S, B = RESNET_NCCL["S"], RESNET_NCCL["B"]
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal(
            (B, S, S, 3), dtype=np.float32)).to(device)
        y = torch.from_numpy(rng.integers(0, 1000, B)).to(device)

        def one_step(group, rows, global_bn=True):
            model = resnet.resnet50(
                dtype=torch.float32, device=device, group=group,
                generator=torch.Generator(device=device).manual_seed(0))
            if not global_bn:
                for m in model.modules():
                    if isinstance(m, resnet.FlaxBatchNorm):
                        m.group = None
            optimizer = train_resnet.sgd(model, 0.1, 0.9)
            step = train_resnet.make_train_step(model, optimizer, 0.1, 1)
            loss = step(x[rows], y[rows])
            if group is not None:
                dist.all_reduce(loss)
                loss /= n
            return {"loss": float(loss),
                    "grads": {k: p.grad.clone()
                              for k, p in model.named_parameters()},
                    "stats": {k: b.clone()
                              for k, b in model.named_buffers()}}

        mine = slice(rank * B // n, (rank + 1) * B // n)
        runs = {"global_bn": one_step(dist.group.WORLD, mine),
                "per_rank_bn": one_step(dist.group.WORLD, mine, False)}
        res = {}
        if rank == 0:
            ref = one_step(None, slice(None))
            for label, r in runs.items():
                g = max((float((r["grads"][k] - v).norm())
                         / max(float(v.norm()), 1e-30), k)
                        for k, v in ref["grads"].items())
                st = max((float((r["stats"][k] - v).abs().max())
                          / max(float(v.abs().max()), 1e-30), k)
                         for k, v in ref["stats"].items())
                res[label] = {
                    "loss": r["loss"], "one_card_loss": ref["loss"],
                    "loss_rel_err": abs(r["loss"] - ref["loss"])
                    / abs(ref["loss"]),
                    "grad_worst_rel_err": g[0], "grad_worst_leaf": g[1],
                    "stats_worst_rel_err": st[0], "stats_worst_leaf": st[1]}
        with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def check_resnet_nccl(torch, n: int) -> dict:
    """The global-batch BatchNorm over NCCL: one spawned process per card
    takes train_resnet's step on its rows of one global batch
    (``_resnet_bn_nccl_worker``); the first step's loss, every gradient
    and the running statistics against one card's step on the whole
    batch, within RESNET_NCCL.  The same step with each BatchNorm on its
    rank's rows is reported beside it, and must miss the gradient bound
    by over ten times (the check can tell the two apart)."""
    t0 = time.perf_counter()
    res = _on_cards(_resnet_bn_nccl_worker, n, "the NCCL BatchNorm")[0]
    out = {"ranks": n, "backend": "nccl", "seconds": time.perf_counter() - t0,
           "model": f"resnet50 f32 (TF32 off) at {RESNET_NCCL['S']}^2, "
                    f"global batch {RESNET_NCCL['B']}, one step",
           "tolerance": RESNET_NCCL, **res}
    emit({"resnet_bn_nccl": out})
    g = res["global_bn"]
    require(g["loss_rel_err"] <= RESNET_NCCL["loss"]
            and g["grad_worst_rel_err"] <= RESNET_NCCL["grad"]
            and g["stats_worst_rel_err"] <= RESNET_NCCL["stats"],
            f"the global-batch BatchNorm over NCCL is off one card's: {g}")
    require(res["per_rank_bn"]["grad_worst_rel_err"]
            > 10 * RESNET_NCCL["grad"],
            f"per-rank BatchNorm is as close as the global one: {res}")
    return out


def _resnet_cli_steps(text: str, images: int) -> tuple[list, list]:
    """Losses and step times (s) from train_resnet's log at
    --log-interval 1: its images/sec is cumulative from the first step.
    The ranks share one pipe, so another rank's line can run into a step
    line at either end."""
    rows = re.findall(r"step (\d+): loss=(\S+?) images/sec=(\d+)", text)
    ends = [(int(i) + 1) * images / float(r) for i, _, r in rows]
    return ([float(x) for _, x, _ in rows],
            [b - a for a, b in zip([0.0] + ends, ends)])


def run_resnet_cards(torch, n: int, one_card: dict | None) -> dict:
    """train_resnet under torch.distributed.run, one process per card, at
    --batch-size RESNET_CARDS["B"] (BASELINE config 4's global batch:
    256 a card on four), its steady images/s (median of the steps after
    step 1) beside n times phase 16's; then dist_allreduce on the n
    ranks."""
    B, steps = RESNET_CARDS["B"], RESNET_CARDS["steps"]
    argv = ["--batch-size", str(B), "--steps", str(steps),
            "--log-interval", "1"]
    t0 = time.perf_counter()
    text = _trainer(argv, nproc=n, module="train_resnet")
    seconds = time.perf_counter() - t0
    losses, times = _resnet_cli_steps(text, B)
    step_s = statistics.median(times[2:])
    peaks = {int(r): float(g) for r, g in re.findall(
        r"\[worker (\d+)/\d+\] peak_mem_gib=(\d+\.\d{3})", text)}
    linear = one_card and n * one_card["images_per_s"]
    t1 = time.perf_counter()
    smoke = _trainer([], nproc=n, module="dist_allreduce")
    out = {"processes": n, "argv": argv, "losses": losses,
           "step_ms_all": [t * 1e3 for t in times],
           "steady_step_ms": step_s * 1e3, "images_per_s": B / step_s,
           "one_card_images_per_s_times_n": linear,
           "scaling": linear and B / step_s / linear,
           "peak_mem_gib_by_rank": peaks, "process_s": seconds,
           "output": text.splitlines()[:3],
           "dist_allreduce": {"process_s": time.perf_counter() - t1,
                              "output": smoke.splitlines()}}
    emit({"resnet_cards": out})
    require(len(losses) == steps and all(map(math.isfinite, losses))
            and "training complete" in text,
            f"train_resnet on {n} cards failed: {text}")
    require(smoke.count(f"all_reduce ok: psum(rank) == {n * (n - 1) // 2} "
                        f"on all {n} devices") == n
            and smoke.count("ppermute ring echo ok") == n
            and smoke.count("smoke-dist passed") == n,
            f"dist_allreduce on {n} cards failed: {smoke}")
    return out


def _rank_reports(text: str) -> dict:
    """Each rank's peak memory and launches from train_llama's output.
    The ranks write to one pipe and one rank's line can run into
    another's, so each report is found where it starts and its JSON read
    to its own end."""
    decoder = json.JSONDecoder()
    return {int(m[1]): {"peak_mem_gib": float(m[2]),
                        "launches": decoder.raw_decode(text, m.end())[0]}
            for m in re.finditer(
                r"\[worker (\d+)/\d+\] peak_mem_gib=(\S+) launches=", text)}


def pipeline_runs(n: int) -> list:
    """Phase 13's pipeline trainers on n cards: Llama-2-7B at its full
    depth under each schedule, then at phase 14's depth (GPipe)."""
    PL, PB, PM, PS = (PIPE_CARDS[x] for x in ("L", "B", "M", "steps"))
    pp_argv = PIPE_ARGV + ["--pp", str(n)]
    runs = [(f"pp{n}_{sched}", n, pp_argv + [
        "--microbatches", str(PM), "--batch-size", str(PB), "--steps",
        str(PS), "--pp-schedule", sched], PB, PIPE["T"], PL, PS)
        for sched in ("gpipe", "1f1b")]
    runs.append((f"pp{n}_L{PIPE['L']}_gpipe", n, pp_argv + [
        "--layers", str(PIPE["L"]), "--microbatches", str(PIPE["M"]),
        "--batch-size", str(PIPE["B"]), "--steps", str(PIPE["steps"])],
        PIPE["B"], PIPE["T"], PIPE["L"], PIPE["steps"]))
    return runs


def run_cards(torch, pipe_plain: dict | None = None,
              moe_one_card: dict | None = None,
              resnet_one_card: dict | None = None,
              pods: dict | None = None) -> dict | None:
    """Phase 13, with more than one card: the NCCL ring, pipeline,
    reshard and (four cards) MoE checks, the global-batch BatchNorm over
    NCCL, train_resnet and dist_allreduce on the cards, then train_llama
    under torch.distributed.run, one process per card (``train_runs``);
    with four cards phase 17's launched runs against these
    (``check_pods``).  A
    check that fails is reported and the phase goes on with the next,
    so that one call on several cards measures every path it can; the
    phase fails at its end if any check did."""
    cards = torch.cuda.device_count()
    if cards < 2:
        emit({"cards": {"skipped": True,
                        "reason": f"{cards} card visible: the multi-card "
                                  f"phase needs more than one"}})
        return None
    sp = min(cards, 4)
    failed = []

    def attempt(check, *args):
        try:
            return check(torch, *args)
        except Exception as e:  # noqa: BLE001 - reported, the phase fails
            detail = str(e) if isinstance(e, SmokeFailure) else \
                traceback.format_exc()[-3000:]
            failed.append(f"{check.__name__}: {detail}")
            emit({"cards_check_failed": failed[-1]})
            return None

    attempt(check_ring_nccl, sp)
    attempt(check_pipe_nccl, sp)
    if cards >= 4:
        attempt(check_reshard_nccl, 4)
        attempt(check_moe_nccl, 4, moe_one_card)
    attempt(check_resnet_nccl, sp)
    resnet_cards = attempt(run_resnet_cards, sp, resnet_one_card)
    T, L = 32768, CARDS_LAYERS
    long_argv = SP_ARGV + ["--layers", str(L), "--steps", str(CARDS_STEPS)]
    flag = ["--model", "flagship", "--batch-size", "4", "--seq-len", "2048",
            "--steps", str(CARDS_STEPS), "--log-interval", "1"]
    # (label, processes, argv, global batch, sequence length, layers,
    # steps)
    runs = [(f"sp{sp}_{impl}", sp, long_argv + ["--sp", str(sp),
                                                "--sp-impl", impl], 1, T, L,
             CARDS_STEPS)
            for impl in ("ring", "ring_zigzag", "ulysses")]
    runs.append(("sp1_ring", 1, long_argv + ["--sp", "1", "--sp-impl",
                                             "ring"], 1, T, L, CARDS_STEPS))
    if cards >= 4:
        # the JAX entry's rule: dp * fsdp divides the batch
        runs += [(f"{mesh}_sp2_ring_zigzag", 4, long_argv + [
            f"--{mesh[:-1]}", "2", "--sp", "2", "--sp-impl", "ring_zigzag",
            "--batch-size", "2"], 2, T, L, CARDS_STEPS)
            for mesh in ("fsdp2", "dp2")]
        runs += [("flagship_fsdp2_tp2", 4, flag + ["--dp", "1", "--fsdp",
                                                  "2", "--tp", "2"], 4, 2048,
                  16, CARDS_STEPS),
                 ("flagship_dp2_fsdp2", 4, flag + ["--dp", "2", "--fsdp",
                                                  "2", "--tp", "1"], 4,
                  2048, 16, CARDS_STEPS)]
    res = attempt(train_runs, runs + pipeline_runs(sp), pipe_plain)
    if pods is not None and "flagship_pods" in pods:
        attempt(check_pods, pods, res, resnet_cards)
    require(not failed, "phase 13: " + "; ".join(failed))
    return res


def train_runs(torch, runs: list, pipe_plain: dict | None = None) -> dict:
    """train_llama under torch.distributed.run for each run (label,
    processes, argv, global batch, sequence length, layers, steps).
    Runs on one global batch form a group whose losses are held against
    its last run's; the pipeline of phase 14's depth against phase 14's
    run without --pp (``pipe_plain``), and the pipeline runs' per-rank
    launches against ``pp_launches``."""
    import tempfile

    from pytorch_operator_tpu_torch.models import llama

    cards = torch.cuda.device_count()
    res, groups = {"cards": cards}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, nproc, argv, B, Tr, layers, steps in runs:
            argv = argv + ["--profile-dir", os.path.join(tmp, label),
                           "--profile-steps", "1"]
            t0 = time.perf_counter()
            text = _trainer(argv, nproc=nproc)
            seconds = time.perf_counter() - t0
            flagship = label.startswith("flagship")
            cfg = (llama.flagship() if flagship
                   else llama.llama2_7b(n_layers=layers))
            losses, step_times = _cli_steps(text, B * Tr)
            # step 0 builds and warms up, step 1 is the profiled one
            step_s = statistics.median(step_times[2:])
            flops = (6.0 * llama.n_params(cfg) * B * Tr
                     + 12.0 * cfg.n_layers * B * Tr * Tr * cfg.dim * 0.5)
            profiled = _nccl_share(os.path.join(tmp, label,
                                                "trace_rank0.json"))
            res[label] = {
                "processes": nproc, "batch": B, "seq": Tr, "layers": layers,
                "steps": steps, "argv": argv, "losses": losses,
                "step_ms_all": [t * 1e3 for t in step_times],
                "steady_step_ms": step_s * 1e3,
                "tokens_per_s": B * Tr / step_s,
                "mfu": flops / step_s / (PEAK_BF16_FLOPS * nproc),
                "profiled_step": profiled,
                "by_rank": _rank_reports(text),
                "process_s": seconds, "output": text.splitlines()[:3]}
            if label.startswith("pp"):
                # the share of the steady step rank 0 spends in no
                # kernel but NCCL's (which wait on the peers)
                compute = profiled["device_ms"] - profiled["nccl_ms"]
                res[label]["rank0_idle_share"] = 1 - compute / (step_s * 1e3)
                res[label]["ideal_bubble"] = (nproc - 1) / (
                    int(argv[argv.index("--microbatches") + 1]) + nproc - 1)
            emit({"cards_run": {label: res[label]}})
            groups.setdefault(("flagship" if flagship else "7b", layers, B,
                               Tr), []).append(label)
    diffs = {}
    for labels in groups.values():
        ref = res[labels[-1]]["losses"]
        for r in labels:
            diffs[r] = {"vs": labels[-1], "max_loss_abs_diff": max(
                abs(a - b) for a, b in zip(res[r]["losses"], ref))}
    pp = [r for r in res if r.startswith("pp")]
    pp_small = next((r for r in pp if r.endswith(f"_L{PIPE['L']}_gpipe")),
                    None)
    if pipe_plain is not None and pp_small is not None:
        diffs[pp_small] = {"vs": "phase 14, train_llama without --pp",
                           "max_loss_abs_diff": max(
                               abs(a - b) for a, b in zip(
                                   res[pp_small]["losses"],
                                   pipe_plain["losses"]))}
    bad_launches = []
    for label in pp:
        r = res[label]
        argv = r["argv"]
        sched = argv[argv.index("--pp-schedule") + 1] \
            if "--pp-schedule" in argv else "gpipe"
        M = int(argv[argv.index("--microbatches") + 1])
        for rank, rep in r["by_rank"].items():
            want = pp_launches(r["layers"], M, r["processes"], sched,
                               stage=rank)
            got = {k: rep["launches"].get(k, 0) / r["steps"] for k in want}
            if got != {k: float(v) for k, v in want.items()}:
                bad_launches.append(f"{label} rank {rank}: {got} != {want}")
    res["loss_diffs"] = diffs
    res["tolerance"] = ("each step's loss within 2e-2 of the last run's on "
                        "the same global batch (bf16; the same seeded init "
                        "and batches)")
    res["steady"] = ("median of the steps after step 1 (step 0 warms up, "
                     "step 1 is profiled); NCCL share: the NCCL kernels' "
                     "summed duration over all kernels' in the profiled "
                     "step on rank 0 (a transfer overlapped with compute "
                     "counts in both)")
    emit({"cards": {k: v for k, v in res.items()
                    if not isinstance(v, dict) or k == "loss_diffs"}})
    require(all(len(res[r]["losses"]) == res[r]["steps"] for r in diffs)
            and max(d["max_loss_abs_diff"] for d in diffs.values())
            <= 2e-2, f"the multi-card runs' losses disagree: {diffs}")
    require(not bad_launches, "pipeline launches per rank: "
                              + "; ".join(bad_launches))
    full = {r.rsplit("_", 1)[1]: res[r]["by_rank"][0]["peak_mem_gib"]
            for r in pp if res[r]["layers"] == PIPE_CARDS["L"]}
    require(full.get("1f1b", 0) < full.get("gpipe", 0),
            f"1F1B's rank-0 peak memory is not below GPipe's: {full}")
    return res


# --------------------------------------------------------------------------


KERNEL_INFO = {
    "rms_norm_fwd": ("rms_norm", "pytorch_operator_tpu_torch/csrc/rms_norm.cu",
                     "pytorch_operator_tpu/ops/rms_norm.py:18"),
    "rms_norm_rowblock_fwd": ("rms_norm_rowblock",
                              "pytorch_operator_tpu_torch/csrc/rms_norm.cu",
                              "pytorch_operator_tpu/ops/rms_norm.py:18"),
    "flash_fwd_sm90": ("flash_fwd_sm90",
                       "pytorch_operator_tpu_torch/csrc/flash_fwd_sm90.cu",
                       "pytorch_operator_tpu/ops/flash_attention.py:118"),
    "flash_bwd_sm90": ("flash_bwd_sm90",
                       "pytorch_operator_tpu_torch/csrc/flash_bwd_sm90.cu",
                       "pytorch_operator_tpu/ops/flash_attention.py:356"),
    "flash_bwd_dq_sm90": (
        "flash_bwd_dq_sm90",
        "pytorch_operator_tpu_torch/csrc/flash_bwd_dq_sm90.cu",
        "pytorch_operator_tpu/ops/flash_attention.py:264"),
    "flash_bwd_dkv_sm90": (
        "flash_bwd_dkv_sm90",
        "pytorch_operator_tpu_torch/csrc/flash_bwd_dkv_sm90.cu",
        "pytorch_operator_tpu/ops/flash_attention.py:325"),
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


def run_f32_phases(torch) -> dict:
    """Phases 1-3 for f32 alone, about two minutes (not a phase of
    ``run``): the build with its ptxas check and the TMA probe, every f32
    case of FLASH_CASES and TWO_KERNEL_CASES, B4 bitwise B2 and B3
    bitwise stable at f32, the WMMA kernels at the main shape, train_llama's
    default (f32) model, and the f32 C3 rows.  On the card:
    ``python3 -c "import torch, chip_smoke as c; c.run_f32_phases(torch)"``.
    Returns the C3 rows."""
    global FLASH_CASES, TWO_KERNEL_CASES, SM90_WALKS, SM90_DQS, C3_CASES
    from pytorch_operator_tpu_torch import kernels

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(nvidia_smi(), flush=True)
    so = kernels.build()
    check_sm90_ptxas(so.with_suffix(".log").read_text())
    probe_tma_tfloat32(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    FLASH_CASES = {k: v for k, v in FLASH_CASES.items() if v[-1] == F32}
    TWO_KERNEL_CASES = {k: v for k, v in TWO_KERNEL_CASES.items()
                        if v[-1] == F32}
    SM90_WALKS = tuple(w for w in SM90_WALKS if w[0] == F32)
    SM90_DQS = tuple(w for w in SM90_DQS if w[0] == F32)
    C3_CASES = {k: v for k, v in C3_CASES.items() if v[0] == F32}
    check_flash(torch, gen, FLASH_CASES, "fused")
    check_two_kernel_route(torch, gen)
    check_dkv_bitwise(torch, gen)
    check_dq_bitwise(torch, gen)
    check_wmma_at_main(torch, gen)
    check_default_trainer(torch)
    return time_c3_kernels(torch, gen)


def run() -> tuple[str, list[dict]]:
    """Every phase in order; returns the card and the kernels' rows."""
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
    # per kernel, in ptxas' order: its entry, spills and registers, and
    # any warning that wgmma products were serialized (C7512)
    ptxas = [ln.strip() for ln in (log.read_text().splitlines()
                                   if log.exists() else [])
             if any(key in ln for key in ("entry function", "registers",
                                          "spill", "wgmma"))
             or ln.startswith("==")]
    emit({"build_s": build_s, "library": so.name, "ptxas": ptxas})
    check_sm90_ptxas(log.read_text() if log.exists() else "")
    sm90_ctas_per_sm()
    probe_tma_tfloat32(torch)

    gen = torch.Generator(device="cuda").manual_seed(0)
    seconds, paths = {}, {}

    t = time.perf_counter()
    fused = check_flash(torch, gen, FLASH_CASES, "fused")
    check_two_kernel_route(torch, gen)
    check_dkv_bitwise(torch, gen)
    check_dq_bitwise(torch, gen)
    wmma = check_wmma_at_main(torch, gen)
    # B3 and B4 run on the long path only: their errors at its shape
    long = check_long_routes(torch, gen)
    rms = check_rms_norm(torch, gen)
    errs = {"rms_norm_fwd": rms["max_abs_err"],
            "rms_norm_rowblock_fwd": rms["rowblock"],
            "flash_fwd_sm90": fused["out"],
            "flash_bwd_sm90": max(fused["dq"], fused["dkv"]), **wmma,
            "flash_bwd_dq_sm90": long["sm90"]["dq"],
            "flash_bwd_dkv_sm90": long["sm90"]["dkv"],
            "flash_bwd_dq": long["wmma"]["dq"],
            "flash_bwd_dkv": long["wmma"]["dkv"]}
    seconds["kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    warm_profiler(torch)
    timing = time_kernels(torch, gen)
    timing.update(time_long_kernels(torch, gen))
    c3 = time_c3_kernels(torch, gen)
    gqa = time_gqa_kernels(torch, gen)
    pipe = time_gqa_kernels(torch, gen, PIPE_T4096, "pipe_t4096")
    short_t = time_short_t_forward(torch, gen)
    timing.update({f"rms_norm_{label}": row for label, row in
                   time_rms_norm_wide(torch, gen).items()})
    seconds["timing"] = time.perf_counter() - t
    t = time.perf_counter()
    paths["main_path"] = run_main_path(torch)
    check_tiny_model(torch)
    free_memory(torch)
    paths["long_path"] = run_long_path(torch)
    free_memory(torch)
    run_long_cli(torch)
    check_remat_tiers(torch)
    paths["default_trainer"] = check_default_trainer(torch)
    seconds["paths"] = time.perf_counter() - t
    t = time.perf_counter()
    free_memory(torch)
    paths["sharded_path"] = run_sharded_path(torch, paths["main_path"])
    free_memory(torch)
    run_checkpoint_resume(torch)
    run_mnist(torch)
    seconds["distributed"] = time.perf_counter() - t
    t = time.perf_counter()
    free_memory(torch)
    ring = check_ring(torch, gen)
    paths["ring_loopback"] = {"launches": {
        s: ring["contiguous"]["launches"].get(s, 0)
        + ring["zigzag"]["launches"].get(s, 0)
        for s in KERNEL_INFO}}
    paths["sp_path"] = run_sp_trainer(torch)
    seconds["sequence_parallel"] = time.perf_counter() - t
    t = time.perf_counter()
    free_memory(torch)
    loop = run_pipeline_loopback(torch)
    free_memory(torch)
    cli = run_pipeline_cli(torch)
    for path, res, runs in (("pp_loopback", loop, ("gpipe", "1f1b")),
                            ("pp_cli", cli, ("pp1_gpipe", "pp1_1f1b"))):
        paths[path] = {"launches": {s: sum(res[r]["launches"].get(s, 0)
                                           for r in runs)
                                    for s in KERNEL_INFO}}
    seconds["pipeline"] = time.perf_counter() - t
    t = time.perf_counter()
    free_memory(torch)
    paths["moe_path"] = run_moe_path(torch)
    seconds["moe"] = time.perf_counter() - t
    t = time.perf_counter()
    free_memory(torch)
    resnet_path = run_resnet_path(torch)
    paths["resnet_path"] = {"launches": resnet_path["launches"]}
    seconds["resnet"] = time.perf_counter() - t
    t = time.perf_counter()
    free_memory(torch)
    pods = run_pods(torch, resnet_path)
    paths["pods"] = {"launches": pod_launches(pods)}
    seconds["pods"] = time.perf_counter() - t
    t = time.perf_counter()
    run_cards(torch, cli["plain"], paths["moe_path"], resnet_path, pods)
    seconds["cards"] = time.perf_counter() - t
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
               "ms_by": ("torch.profiler device time per call"
                         if tm.get("clock", {}).get("kernel", "profiler")
                         == "profiler" else "CUDA events per call where "
                         "the profiler recorded no device time"),
               "event_ms": tm["event_ms"], "profiles": tm["profiles"],
               "shape": tm["shape"]}
        if "previous_ms" in tm:
            row["previous_ms"] = tm["previous_ms"]
        if "sm90" not in short and short != "rms_norm":
            row["path"] = ("on no route; timed beside its Hopper successor "
                           "at its shape as the yardstick")
        # C3's cases (phase 3) on the kernels they run through
        row_c3 = {case: c[part] for case, c in c3.items()
                  for part in ("fwd", "bwd", "dq", "dkv")
                  if part in c and c[part]["kernel"] == short}
        if row_c3:
            row["c3"] = row_c3
        if short in ("flash_fwd_sm90", "flash_bwd_sm90"):
            for key, r in (("gqa_t4096", gqa), ("pipe_t4096", pipe)):
                part = r[short.split("_")[1]]
                row[key] = {"shape": r["shape"], **{
                    k: part[k] for k in ("ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by")}}
        if short == "rms_norm":  # B5's rows (a)-(d), the row-block beside
            for label, *_ in RMS_ROWS:
                wt = tm if label == "d2048" else timing["rms_norm_" + label]
                row[label] = {k: wt[k] for k in (
                    "shape", "dtype", "ms", "previous_ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by", "bound_share",
                    "gap_to_library", "spread", "loses_beyond_spread",
                    "beats_previous_in_both_turns")}
        if short == "flash_fwd_sm90":  # forward-only calls at short T
            row["short_t_forward"] = {
                k: short_t[k] for k in ("crossover_t", "agrees_with_port",
                                        "library")}
        if short + "_long" in timing:  # B1 at the long path's shape
            lt = timing[short + "_long"]
            row["long"] = {k: lt.get(k) for k in (
                "shape", "ms", "previous_ms", "bound_ms", "bound_by",
                "library_ms", "plain_ms", "plain_shape")}
        rows.append(row)
    yardsticks = {r["name"]: r["launches"] for r in rows if "path" in r}
    require(not any(yardsticks.values()),
            f"a yardstick kernel ran on a path: {yardsticks}")
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
