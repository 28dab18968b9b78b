"""Llama pretraining on synthetic tokens, on one GPU or many.

Port of ``examples/llama/train_llama.py`` (its (dp, fsdp, tp) mesh,
sequence-parallel and pipeline branches):

    python -m pytorch_operator_tpu_torch.train_llama --model flagship \\
        --batch-size 2 --seq-len 2048 --steps 10

Multi-process runs read the env the operator injects (``WORLD_SIZE``,
``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``;
``torch.distributed.run`` sets the same), one process per GPU, NCCL
between them (gloo with ``--device cpu``).  ``--dp/--fsdp/--tp`` shape
the mesh (all 0: ``factor_devices`` over the world size, tp at most 4);
``--batch-size`` is the global batch:

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m pytorch_operator_tpu_torch.train_llama --model tiny \\
        --device cpu --fsdp 2 --tp 2 --dp 1 --checkpoint-dir ckpt

A pod of a PyTorchJob with several cards
(``manifests/pytorch_job_llama_fsdp.yaml``: 32 pods of 4 cards under
``--fsdp 32 --tp 4``) runs it through the launcher, one process a card;
started there directly it refuses to train on one card of several:

    python -m pytorch_operator_tpu_torch.launch \\
        pytorch_operator_tpu_torch.train_llama --model 7b --fsdp 32 --tp 4

Long-context training keeps the flash (out, lse) pair and the q/k/v
projections per layer and applies the tied head per 1024 tokens:

    python -m pytorch_operator_tpu_torch.train_llama --model flagship \
        --batch-size 1 --seq-len 16384 --remat \
        --remat-policy save_attn+qkv --chunked-ce

The CUDA kernels (flash attention, RMSNorm) are on by default on a GPU,
as the JAX entry turns the Pallas kernels on for a TPU.  Batches are
seeded per step index, as in the JAX entry, so a resumed run continues
the data stream.  ``--checkpoint-dir`` saves every
``--checkpoint-every`` steps and a new run restores the latest
checkpoint at whatever world size it has.

``--sp N`` trains on a (dp, fsdp, sp[, tp]) mesh: each rank holds T/N
rows of every activation, and attention runs ``--sp-impl`` over the sp
ranks (``ulysses``: all-to-all to heads; ``ring``: K/V around a ring;
``ring_zigzag``: the ring on the zigzag layout), each chunk through the
flash kernels on a GPU; ``--fsdp`` shards the weights and ``--tp`` the
heads beside it, as in the JAX entry:

    python -m torch.distributed.run --nproc-per-node 2 \
        -m pytorch_operator_tpu_torch.train_llama --model tiny \
        --device cpu --sp 2 --sp-impl ring_zigzag --seq-len 64

``--pp S`` (S the process count) splits the layers into S pipeline
stages, one a process, and the global batch into ``--microbatches``;
``--pp-schedule`` is ``gpipe`` (every forward, then every backward) or
``1f1b`` (interleaved; at most S stage inputs held a stage):

    python -m torch.distributed.run --nproc-per-node 2 \
        -m pytorch_operator_tpu_torch.train_llama --model tiny \
        --device cpu --pp 2 --microbatches 2 --pp-schedule 1f1b
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from pytorch_operator_tpu_torch import kernels
from pytorch_operator_tpu_torch.device import default_device
from pytorch_operator_tpu_torch.models import llama
from pytorch_operator_tpu_torch.parallel.mesh import (
    AXIS_PP,
    factor_devices,
    make_mesh,
    make_named_mesh,
    make_sp_mesh,
)
from pytorch_operator_tpu_torch.parallel.train import (
    TrainState,
    adamw,
    latest_checkpoint,
    make_pp_train_step,
    make_sp_train_step,
    make_train_step,
    restore_on_mesh,
    save_checkpoint,
    sharded_init,
)
from pytorch_operator_tpu_torch.telemetry.trace import StepTrace
from pytorch_operator_tpu_torch.utils import maybe_init_distributed

MODELS = {"7b": llama.llama2_7b, "tiny": llama.tiny,
          "flagship": llama.flagship}


def _flag(parser, name, dest, help_on):
    parser.add_argument(f"--{name}", dest=dest, action="store_true",
                        default=None, help=help_on)
    parser.add_argument(f"--no-{name}", dest=dest, action="store_false")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Llama training over a "
                                                 "(dp, fsdp[, sp], tp) or "
                                                 "(pp,) mesh")
    parser.add_argument("--model", choices=sorted(MODELS), default="tiny")
    parser.add_argument("--layers", type=int, default=None,
                        help="cut the model's depth to this many layers "
                             "(widths stay the model's)")
    parser.add_argument("--batch-size", type=int, default=8,
                        help="global batch size in sequences")
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
    parser.add_argument("--dp", type=int, default=0, help="0 = auto")
    parser.add_argument("--fsdp", type=int, default=0)
    parser.add_argument("--tp", type=int, default=0)
    parser.add_argument("--pp", type=int, default=0,
                        help="pipeline stages, one a process (must equal "
                             "the process count)")
    parser.add_argument("--microbatches", type=int, default=4,
                        help="pipeline microbatches when --pp is set")
    parser.add_argument("--pp-schedule", choices=["gpipe", "1f1b"],
                        default="gpipe",
                        help="pipeline schedule under --pp: GPipe (every "
                             "forward, then every backward; M graphs a "
                             "stage) or 1F1B (interleaved, the stage run "
                             "again in its backward; at most S stage "
                             "inputs a stage)")
    parser.add_argument("--sp", type=int, default=0,
                        help="sequence-parallel degree for long contexts; "
                             "composes with --dp/--fsdp/--tp "
                             "(dp*fsdp*sp*tp must equal the process count)")
    parser.add_argument("--sp-impl", choices=list(llama.SP_IMPLS),
                        default="ulysses",
                        help="attention under --sp: all-to-all head "
                             "re-shard (ulysses), K/V ring rotation "
                             "(ring), or the ring on the zigzag layout "
                             "that balances causal load (ring_zigzag)")
    parser.add_argument("--checkpoint-dir", type=str, default=None)
    parser.add_argument("--checkpoint-every", type=int, default=100)
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler trace (Chrome JSON, "
                             "one file per rank) of steps "
                             "2..--profile-steps here")
    parser.add_argument("--profile-steps", type=int, default=5)
    parser.add_argument("--log-interval", type=int, default=5)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.sp < 0:
        parser.error(f"--sp must be >= 0, got {args.sp}")
    mesh_flags = (args.dp, args.fsdp, args.tp)
    if not (args.sp or args.pp) and any(mesh_flags) and not all(mesh_flags):
        parser.error("--dp/--fsdp/--tp must be given together (or none)")
    if args.ce_chunk < 1:
        parser.error(f"--ce-chunk must be >= 1, got {args.ce_chunk}")
    if args.checkpoint_every < 1:
        parser.error(f"--checkpoint-every must be >= 1, got "
                     f"{args.checkpoint_every}")
    if args.layers is not None and args.layers < 1:
        parser.error(f"--layers must be >= 1, got {args.layers}")
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


def sp_mesh_shape(args: argparse.Namespace, world: int,
                  cfg: llama.LlamaConfig) -> tuple[int, int, int, int]:
    """(dp, fsdp, sp, tp) under --sp: each of --dp/--fsdp/--tp 1 when not
    given, with the JAX entry's checks and messages."""
    dp, fsdp, tp = args.dp or 1, args.fsdp or 1, args.tp or 1
    sp = args.sp

    def error(msg):
        raise SystemExit(f"train_llama: error: {msg}")

    if dp * fsdp * sp * tp != world:
        error(f"--dp*--fsdp*--sp*--tp = {dp * fsdp * sp * tp} != {world} "
              f"devices")
    if args.seq_len % sp:
        error(f"--seq-len {args.seq_len} not divisible by --sp")
    if args.batch_size % (dp * fsdp):
        error(f"--batch-size {args.batch_size} not divisible by "
              f"--dp*--fsdp = {dp * fsdp}")
    if tp > 1 and (cfg.n_heads % tp or cfg.n_kv_heads % tp):
        error(f"n_heads {cfg.n_heads}/n_kv_heads {cfg.n_kv_heads} not "
              f"divisible by --tp {tp}")
    if args.sp_impl == "ulysses" and (cfg.n_heads // tp) % sp:
        error(f"n_heads per tp shard ({cfg.n_heads // tp}) not divisible "
              f"by --sp (use --sp-impl ring)")
    return dp, fsdp, sp, tp


def pp_stages(args: argparse.Namespace, world: int,
              cfg: llama.LlamaConfig) -> int:
    """The stage count under --pp, with the JAX entry's checks and
    messages."""

    def error(msg):
        raise SystemExit(f"train_llama: error: {msg}")

    if args.sp:
        error("--pp and --sp are mutually exclusive layouts")
    if args.dp or args.fsdp or args.tp:
        error("--pp is a pure GPipe layout; it cannot be combined with "
              "--dp/--fsdp/--tp")
    if args.pp != world:
        error(f"--pp {args.pp} != {world} devices")
    if cfg.n_layers % args.pp:
        error(f"n_layers {cfg.n_layers} not divisible by --pp")
    if args.batch_size % args.microbatches:
        error(f"--batch-size {args.batch_size} not divisible by "
              f"--microbatches {args.microbatches}")
    return args.pp


def mesh_shape(args: argparse.Namespace, world: int) -> tuple[int, int, int]:
    """(dp, fsdp, tp) from the flags: all three given (parse_args
    refuses some without the others) and their product the world size,
    or none (``factor_devices`` over the world size, tp at most 4, as
    the JAX entry does)."""
    flags = (args.dp, args.fsdp, args.tp)
    if not all(flags):
        return factor_devices(world, tp_max=4)
    if args.dp * args.fsdp * args.tp != world:
        raise SystemExit(f"train_llama: --dp*--fsdp*--tp = "
                         f"{args.dp * args.fsdp * args.tp} != {world} "
                         f"processes")
    return flags


def build_config(args: argparse.Namespace, device: torch.device,
                 shape: tuple[int, int, int] = (1, 1, 1),
                 rank: int = 0, world: int = 1) -> llama.LlamaConfig:
    """The model's config from the command line.  --remat-policy auto
    resolves, as in the JAX entry, to the richest save_attn tier whose
    residuals fit the device's memory (the card's total memory on cuda,
    auto_remat_policy's default 16 GiB on the CPU), with the params and
    optimizer state divided by fsdp*tp and the tokens by dp*fsdp (times
    --sp) of the mesh ``shape``; under --pp the state by the stages and
    the tokens by nothing (the microbatches bound them), as in the JAX
    entry."""
    on_cuda = device.type == "cuda"
    kw = dict(max_seq_len=args.seq_len)
    if args.model != "flagship":
        kw["remat"] = True  # the JAX entry's default
    if args.layers is not None:
        kw["n_layers"] = args.layers
    cfg = MODELS[args.model](**kw)
    cfg = dataclasses.replace(
        cfg,
        use_flash=on_cuda if args.use_flash is None else args.use_flash,
        use_fused_norm=(on_cuda if args.use_fused_norm is None
                        else args.use_fused_norm),
        remat=cfg.remat if args.remat is None else args.remat)
    if args.remat_policy != "auto":
        return dataclasses.replace(cfg, remat_policy=args.remat_policy)
    dp, fsdp, tp = shape
    state_shards, token_shards = fsdp * tp, dp * fsdp * max(args.sp, 1)
    if args.pp:
        state_shards, token_shards = args.pp, 1
    hbm = {} if not on_cuda else dict(
        hbm_gb=torch.cuda.get_device_properties(device).total_memory / 2 ** 30)
    policy = llama.auto_remat_policy(cfg, args.batch_size, args.seq_len,
                                     state_shards=state_shards,
                                     token_shards=token_shards, **hbm)
    print(f"[worker {rank}/{world}] --remat-policy auto -> {policy} "
          f"(state/{state_shards}, tokens/{token_shards})", flush=True)
    return dataclasses.replace(cfg, remat_policy=policy)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = default_device(args.device)
    created_group = not dist.is_initialized()
    rank, world = maybe_init_distributed(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    if args.pp:
        shape = (1, 1, 1)
        layers = {} if args.layers is None else {"n_layers": args.layers}
        pp = pp_stages(args, world, MODELS[args.model](**layers))
    elif args.sp:
        dp, fsdp, sp, tp = sp_mesh_shape(args, world, MODELS[args.model]())
        shape = (dp, fsdp, tp)
    else:
        dp, fsdp, tp = shape = mesh_shape(args, world)
    cfg = build_config(args, device, shape, rank, world)
    if args.pp:
        mesh = make_named_mesh({AXIS_PP: pp}, device)
        print(f"[worker {rank}/{world}] {args.pp_schedule} pipeline mesh "
              f"pp={pp} microbatches={args.microbatches} over {world} "
              f"device(s)", flush=True)
    elif args.sp:
        mesh = make_sp_mesh(dp, sp, fsdp=fsdp, tp=tp, device=device)
        print(f"[worker {rank}/{world}] sequence-parallel mesh dp={dp} "
              f"fsdp={fsdp} sp={sp} tp={tp} ({args.sp_impl}) over {world} "
              f"device(s)", flush=True)
    else:
        mesh = make_mesh(dp, fsdp, tp, device)
        print(f"[worker {rank}/{world}] mesh dp={dp} fsdp={fsdp} tp={tp} "
              f"over {world} device(s)", flush=True)
    model = sharded_init(cfg, mesh, seed=0, specs=(
        llama.pp_param_specs(cfg, pp) if args.pp else None))
    optimizer = adamw(model, args.lr, weight_decay=0.1)
    state = TrainState(model, optimizer)
    if args.pp:
        step_fn = make_pp_train_step(cfg, model, optimizer, mesh=mesh,
                                     n_microbatches=args.microbatches,
                                     chunked_ce=args.chunked_ce,
                                     ce_chunk=args.ce_chunk,
                                     schedule=args.pp_schedule)
    elif args.sp:
        step_fn = make_sp_train_step(cfg, model, optimizer, mesh=mesh,
                                     impl=args.sp_impl,
                                     chunked_ce=args.chunked_ce,
                                     ce_chunk=args.ce_chunk)
    else:
        step_fn = make_train_step(cfg, model, optimizer, mesh=mesh,
                                  chunked_ce=args.chunked_ce,
                                  ce_chunk=args.ce_chunk)
    lead = rank == 0
    if lead:
        print(f"model {args.model}: {llama.n_params(cfg)} params, "
              f"layers={cfg.n_layers} flash={cfg.use_flash} "
              f"fused_norm={cfg.use_fused_norm} remat={cfg.remat} "
              f"remat_policy={cfg.remat_policy} on {device}", flush=True)

    start = 0
    if args.checkpoint_dir:
        latest = latest_checkpoint(args.checkpoint_dir)
        if latest is not None:
            # read into this run's own layout: the checkpoint may come
            # from another world size or mesh shape
            t = time.perf_counter()
            state = restore_on_mesh(args.checkpoint_dir, latest, state)
            start = latest
            if lead:
                print(f"restored checkpoint at step {latest} onto {world} "
                      f"device(s) in {time.perf_counter() - t:.3f} s",
                      flush=True)

    tokens_per_step = args.batch_size * args.seq_len
    trace = StepTrace(args.profile_dir, args.profile_steps, start, device,
                       rank)
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        trace.before(i)
        # synthetic LM batch, seeded per step index so that a resumed
        # run continues the data stream instead of replaying it
        batch = np.random.default_rng(i).integers(
            0, cfg.vocab_size, (args.batch_size, args.seq_len + 1))
        state, metrics = step_fn(state, batch)
        trace.after(i)
        if lead and (i % args.log_interval == 0 or i == args.steps - 1):
            loss = float(metrics["loss"])  # waits for the step
            dt = time.perf_counter() - t0
            print(f"step {i}: loss={loss:.4f} "
                  f"grad_norm={float(metrics['grad_norm']):.3f} "
                  f"tokens/s={(i - start + 1) * tokens_per_step / dt:.0f}",
                  flush=True)
        if args.checkpoint_dir and (i + 1) % args.checkpoint_every == 0:
            t = time.perf_counter()
            save_checkpoint(state, args.checkpoint_dir)
            if lead:
                print(f"checkpointed step {i + 1} in "
                      f"{time.perf_counter() - t:.3f} s", flush=True)
    trace.stop()
    if device.type == "cuda":
        # each rank's own: a pipeline stage's memory and launches differ
        print(f"[worker {rank}/{world}] peak_mem_gib="
              f"{torch.cuda.max_memory_allocated(device) / 2 ** 30:.3f} "
              f"launches={json.dumps(kernels.launch_counts())}", flush=True)
    if lead:
        print("training complete", flush=True)
    if created_group:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
