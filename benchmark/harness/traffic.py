"""The one traffic generator: a pool of token batches drawn Zipf-
distributed from the vocabulary.

Token ranks follow p(r) ~ r^-s (s = ``zipf_exponent``; 1.0 is the shape
of word frequencies in text), and which token holds each rank is a
seeded permutation of the vocabulary, so a seed changes which tokens are
common but not how skewed the mix is: every seed gives the same sizes
and the same amount of work.  On random weights such tokens give the
router skewed expert loads, as text does.  The pool is made on the
device in set-up and cycled; its batches all differ.
"""

from __future__ import annotations

import torch

from benchmark.harness.weights import derive


def token_pool(traffic: dict, vocab: int, seed: int, device
               ) -> torch.Tensor:
    """(pool_batches, batch, seq_len + 1) token ids (int64) on ``device``:
    each batch is a step's inputs and, shifted by one, its targets."""
    P, B, T = traffic["pool_batches"], traffic["batch"], traffic["seq_len"]
    gen = torch.Generator(device=device).manual_seed(derive(seed, "traffic"))
    perm = torch.randperm(vocab, generator=gen, device=device)
    ranks = torch.arange(1, vocab + 1, device=device, dtype=torch.float64)
    cdf = torch.cumsum(ranks ** -float(traffic["zipf_exponent"]), 0)
    cdf = cdf / cdf[-1]
    u = torch.rand(P * B * (T + 1), generator=gen, device=device,
                   dtype=torch.float64)
    idx = torch.searchsorted(cdf, u).clamp_(max=vocab - 1)
    return perm[idx].reshape(P, B, T + 1)
