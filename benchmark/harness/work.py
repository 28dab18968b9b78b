"""The yardstick: a step's useful work, counted from shapes.

Nothing here reads the program: a later change to it cannot move these
counts.  ``bound`` and ``causal_pairs`` are frozen copies of
``chip_smoke.py``'s.  Model FLOPs are 6·N·B·T + 12·L·B·T²·D/2, with N the
parameters a token's forward touches (for a mixture of experts the
top-k routed experts, not every expert the dense dispatch runs), the
attention counted once however many ranks repeat it, and no recompute.
An attention backward's useful work is its five products, 2.5 times the
forward's, whichever route runs (the two-kernel route's recompute of S
and dP is not useful work), and one exponential a score element.
"""

from __future__ import annotations

from benchmark.harness.weights import dims

# H100 SXM data-sheet peaks (dense), at the card's full 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# the special-function units' exponentials a second (FlashAttention-3,
# Shah et al. 2024, section 1: 132 SMs x 16 a clock x about 1.83 GHz)
PEAK_EXP = 3.9e12


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


def routed_params(config: dict) -> int:
    """N: the parameters one token's forward touches (the embedding, which
    is also the tied head, the attention, the norms, the router and the
    top-k experts' SwiGLU; a dense model's whole SwiGLU)."""
    d = dims(config)
    D, Dh, F = d["D"], d["Dh"], d["F"]
    attn = D * d["H"] * Dh + 2 * D * d["Hk"] * Dh + d["H"] * Dh * D
    mlp = 3 * D * F * (d["k"] if d["E"] else 1)
    router = D * d["E"]
    per_layer = attn + 2 * D + router + mlp
    return d["V"] * D + d["L"] * per_layer + D


def model_flops(config: dict, B: int, T: int) -> float:
    """A training step's model FLOPs over a global batch of B x T."""
    d = dims(config)
    return (6.0 * routed_params(config) * B * T
            + 12.0 * d["L"] * B * T * T * d["D"] * 0.5)


def attention_work(config: dict, B: int, T: int) -> dict:
    """One causal attention call a layer at (B, T) with the config's heads:
    the forward's and the backward's FLOPs, exponentials and bytes (every
    input read once, every output written once, 16-bit tensors and f32
    row statistics)."""
    d = dims(config)
    H, Hk, Dh = d["H"], d["Hk"], d["Dh"]
    pairs = B * H * causal_pairs(T, True)
    q = B * T * H * Dh * 2          # one 16-bit tensor of the q heads
    kv = B * T * Hk * Dh * 2        # one of the kv heads
    rows = B * H * T * 4            # lse (or delta) in f32
    fwd_flops = 4.0 * Dh * pairs    # S = QK^T and O = PV
    return {
        "fwd": {"flops": fwd_flops, "exps": float(pairs),
                "bytes": 2 * q + 2 * kv + rows},
        # five products: S, dP, dV, dK, dQ; reads q, k, v, o, do, lse;
        # writes dq, dk, dv
        "bwd": {"flops": 2.5 * fwd_flops, "exps": float(pairs),
                "bytes": 4 * q + 4 * kv + rows},
    }


def attention_bound_ms(config: dict, B: int, T: int, which: str) -> float:
    """The least time (ms) of one step's attention ``which`` ("fwd" or
    "bwd") over every layer."""
    w = attention_work(config, B, T)[which]
    ms, _ = bound(w["bytes"], w["flops"], exps=w["exps"])
    return ms * dims(config)["L"]
