"""The model's weights as a function of (seed, leaf name).

Both sides take their weights from here: the harness writes them into the
port's parameters and the reference makes any leaf again by its name, so
neither reads the other's.  Each matrix is N(0, initializer_range) (the
published config's initializer, as Hugging Face initializes these
models), drawn in f32 on the device by a generator of its own, seeded
from (seed, name), and rounded to the dtype the model is served in; the
norms' weights are ones.  A mixture-of-experts bank is one leaf an
expert, so an expert-parallel rank makes only the experts it holds.
"""

from __future__ import annotations

import hashlib

import torch


def dims(config: dict) -> dict:
    """The sizes the benchmark reads from a published config."""
    D, H = config["hidden_size"], config["num_attention_heads"]
    return {"D": D, "L": config["num_hidden_layers"], "H": H,
            "Hk": config["num_key_value_heads"],
            "Dh": config.get("head_dim") or D // H,
            "F": config["intermediate_size"], "V": config["vocab_size"],
            "E": config.get("num_local_experts", 0),
            "k": config.get("num_experts_per_tok", 0),
            "theta": float(config["rope_theta"]),
            "eps": float(config["rms_norm_eps"]),
            "std": float(config["initializer_range"]),
            "aux_coef": float(config.get("router_aux_loss_coef", 0.0))}


def derive(seed: int, name: str) -> int:
    """A 63-bit generator seed for ``name`` under ``seed`` (any integer)."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def leaves(config: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every leaf; kind is "normal" or "ones".
    Projections are (out, in): y = x @ W^T; an expert's banks are (D, F)
    and (F, D): y = x @ W; the router is (D, E)."""
    d = dims(config)
    D, Dh, F, E = d["D"], d["Dh"], d["F"], d["E"]
    out = [("embed", (d["V"], D), "normal")]
    for i in range(d["L"]):
        p = f"layers.{i}."
        out += [(p + "attn_norm", (D,), "ones"),
                (p + "wq", (d["H"] * Dh, D), "normal"),
                (p + "wk", (d["Hk"] * Dh, D), "normal"),
                (p + "wv", (d["Hk"] * Dh, D), "normal"),
                (p + "wo", (D, d["H"] * Dh), "normal"),
                (p + "mlp_norm", (D,), "ones")]
        if E:
            out.append((p + "router", (D, E), "normal"))
            for e in range(E):
                out += [(p + f"w_gate.{e}", (D, F), "normal"),
                        (p + f"w_up.{e}", (D, F), "normal"),
                        (p + f"w_down.{e}", (F, D), "normal")]
        else:
            out += [(p + "w_gate", (F, D), "normal"),
                    (p + "w_up", (F, D), "normal"),
                    (p + "w_down", (D, F), "normal")]
    out.append(("final_norm", (D,), "ones"))
    return out


def make(seed: int, name: str, shape: tuple, kind: str, std: float,
         device, dtype: torch.dtype) -> torch.Tensor:
    """Leaf ``name``'s value, in ``dtype`` on ``device``."""
    if kind == "ones":
        return torch.ones(shape, device=device, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(derive(seed, name))
    w = torch.randn(shape, generator=gen, device=device,
                    dtype=torch.float32)
    return w.mul_(std).to(dtype)


def expert_of(name: str) -> int | None:
    """The expert index of an expert leaf (``layers.3.w_up.5`` -> 5)."""
    last = name.rsplit(".", 1)[-1]
    return int(last) if "w_" in name and last.isdigit() else None
