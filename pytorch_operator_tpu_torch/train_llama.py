"""Single-GPU Llama pretraining on synthetic tokens.

Port of the single-device branch of ``examples/llama/train_llama.py``:

    python -m pytorch_operator_tpu_torch.train_llama --model flagship \\
        --batch-size 2 --seq-len 2048 --steps 10

Long-context training keeps the flash (out, lse) pair and the q/k/v
projections per layer and applies the tied head per 1024 tokens:

    python -m pytorch_operator_tpu_torch.train_llama --model flagship \
        --batch-size 1 --seq-len 16384 --remat \
        --remat-policy save_attn+qkv --chunked-ce

The CUDA kernels (flash attention, RMSNorm) are on by default on a GPU,
as the JAX entry turns the Pallas kernels on for a TPU.  Batches are
seeded per step index, as in the JAX entry.  The parallel layouts
(--dp/--fsdp/--tp/--pp/--sp) are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from pytorch_operator_tpu_torch.device import default_device
from pytorch_operator_tpu_torch.models import llama
from pytorch_operator_tpu_torch.parallel.train import (
    TrainState,
    adamw,
    make_train_step,
)

MODELS = {"7b": llama.llama2_7b, "tiny": llama.tiny,
          "flagship": llama.flagship}


def _flag(parser, name, dest, help_on):
    parser.add_argument(f"--{name}", dest=dest, action="store_true",
                        default=None, help=help_on)
    parser.add_argument(f"--no-{name}", dest=dest, action="store_false")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="single-GPU Llama training")
    parser.add_argument("--model", choices=sorted(MODELS), default="tiny")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--seq-len", type=int, default=256)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--lr", type=float, default=3e-4)
    _flag(parser, "flash", "use_flash",
          "CUDA flash-attention kernels (default: on for cuda)")
    _flag(parser, "fused-norm", "use_fused_norm",
          "CUDA RMSNorm kernel (default: on for cuda)")
    _flag(parser, "remat", "remat",
          "per-layer torch.utils.checkpoint (default: the model's config; "
          "on for 7b and tiny, off for flagship)")
    parser.add_argument("--remat-policy", type=str, default=None,
                        help="what each rematerialised layer keeps: "
                             "'save_attn[+qkv][+gateup][+normed]' (keep "
                             "the flash out+lse, never recompute the "
                             "O(T^2) attention forward; requires flash), "
                             "'dots_saveable', "
                             "'dots_with_no_batch_dims_saveable', or "
                             "'auto' (the richest save_attn tier that "
                             "fits the device); default: full remat")
    parser.add_argument("--chunked-ce", action="store_true",
                        help="apply the tied head per --ce-chunk tokens")
    parser.add_argument("--ce-chunk", type=int, default=1024)
    parser.add_argument("--log-interval", type=int, default=5)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.ce_chunk < 1:
        parser.error(f"--ce-chunk must be >= 1, got {args.ce_chunk}")
    _check_remat_policy(parser, args)
    return args


def _is_save_attn(policy: str) -> bool:
    return policy == "save_attn" or policy.startswith("save_attn+")


def _check_remat_policy(parser, args) -> None:
    """The JAX entry's checks on --remat-policy, against the defaults
    build_config will apply (remat on but for flagship, the kernels on
    for cuda)."""
    policy = args.remat_policy
    if policy is None:
        return
    save_attn = policy == "auto" or _is_save_attn(policy)
    groups = policy.split("+")[1:] if _is_save_attn(policy) else []
    if (not save_attn and policy not in llama.DOTS_POLICIES
            or not set(groups) <= set(llama.LAYER_SAVE_GROUPS)):
        parser.error(f"unknown or unported --remat-policy {policy!r}; "
                     f"ported: 'save_attn[+qkv][+gateup][+normed]', "
                     f"{', '.join(repr(p) for p in llama.DOTS_POLICIES)} "
                     f"or 'auto' (models/llama.py)")
    remat = args.model != "flagship" if args.remat is None else args.remat
    if not remat:
        parser.error("--remat-policy requires remat (add --remat)")
    flash = (torch.device(args.device).type == "cuda"
             if args.use_flash is None else args.use_flash)
    if save_attn and not flash:
        parser.error(f"--remat-policy {policy} resolves to the save_attn "
                     f"family, which saves the flash kernel's (out, lse) "
                     f"residuals and requires --flash")


def build_config(args: argparse.Namespace,
                 device: torch.device) -> llama.LlamaConfig:
    """The model's config from the command line.  --remat-policy auto
    resolves, as in the JAX entry, to the richest save_attn tier whose
    residuals fit the device's memory (the card's total memory on cuda,
    auto_remat_policy's default 16 GiB on the CPU)."""
    on_cuda = device.type == "cuda"
    kw = dict(max_seq_len=args.seq_len)
    if args.model != "flagship":
        kw["remat"] = True  # the JAX entry's default
    cfg = MODELS[args.model](**kw)
    cfg = dataclasses.replace(
        cfg,
        use_flash=on_cuda if args.use_flash is None else args.use_flash,
        use_fused_norm=(on_cuda if args.use_fused_norm is None
                        else args.use_fused_norm),
        remat=cfg.remat if args.remat is None else args.remat)
    if args.remat_policy != "auto":
        return dataclasses.replace(cfg, remat_policy=args.remat_policy)
    hbm = {} if not on_cuda else dict(
        hbm_gb=torch.cuda.get_device_properties(device).total_memory / 2 ** 30)
    policy = llama.auto_remat_policy(cfg, args.batch_size, args.seq_len,
                                     **hbm)
    print(f"[worker 0/1] --remat-policy auto -> {policy} (state/1, "
          f"tokens/1)", flush=True)
    return dataclasses.replace(cfg, remat_policy=policy)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = default_device(args.device)
    cfg = build_config(args, device)
    gen = torch.Generator(device=device).manual_seed(0)
    model = llama.Llama(cfg, device=device, generator=gen)
    optimizer = adamw(model, args.lr, weight_decay=0.1)
    state = TrainState(model, optimizer)
    step_fn = make_train_step(cfg, model, optimizer,
                              chunked_ce=args.chunked_ce,
                              ce_chunk=args.ce_chunk)
    print(f"model {args.model}: {llama.n_params(cfg)} params, flash="
          f"{cfg.use_flash} fused_norm={cfg.use_fused_norm} "
          f"remat={cfg.remat} remat_policy={cfg.remat_policy} on {device}",
          flush=True)

    tokens_per_step = args.batch_size * args.seq_len
    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = np.random.default_rng(i).integers(
            0, cfg.vocab_size, (args.batch_size, args.seq_len + 1))
        state, metrics = step_fn(state, batch)
        if i % args.log_interval == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])  # waits for the step
            dt = time.perf_counter() - t0
            print(f"step {i}: loss={loss:.4f} "
                  f"grad_norm={float(metrics['grad_norm']):.3f} "
                  f"tokens/s={(i + 1) * tokens_per_step / dt:.0f}",
                  flush=True)
    print("training complete", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
